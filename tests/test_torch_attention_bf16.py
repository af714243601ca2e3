"""bfloat16 attention in the port computes the JAX model's function, on the
CPU.

The JAX model's ``_sdpa`` (and the score block of its ``gqa_decode``)
rounds to bf16 at four points: the scores q.k, the scores divided by the
Python float ``dk ** 0.5`` (which JAX rounds to bf16 first: bf16(sqrt d)),
the normalised fp32 softmax probabilities, and P V (summed in fp32).  Its
gradient (``jax.vjp``) rounds the cotangents at the same points and sums
each kv head's dk and dv over its GQA group in fp32 before rounding once.

- The port's bf16 ``models.attention.sdpa`` and ``flash_attention_bwd_plain``
  against ``_sdpa`` and ``jax.vjp(_sdpa)``, and its ``decode_attention``
  against ``gqa_decode`` (identity projections, no rope, so that its
  output is the attention block's), at the head shapes (h, m, d) (4, 1,
  16), (15, 5, 64) (smollm-360m), (32, 32, 80) (zamba2-2.7b's shared
  block) and (3, 1, 20) (reduced smollm), causal and full: at most
  ``SHARE_TOL`` of the elements differ and the norm-wise gap is at most
  ``NORM_TOL``.  The function that keeps scores and probabilities in fp32
  (the port's bf16 attention before this repair) misses both at every
  shape (measured on the CPU: 45-61% of elements, 3.2e-3 to 5.2e-3
  norm-wise).
- fp32 is unchanged: seeded fp32 outputs and gradients of the plain
  versions hash to what they hashed to before the bf16 repair.
- The CUDA kernels' bf16 algebra in plain torch: the flash forward's two
  passes over 64-key tiles (row max and sum of the rounded scores, then
  P rounded to bf16 times V, no rescaling), the backward's D summed from
  the rounded dP, and the decode kernel's two launches (per-split
  statistics merged, then P_b V partials summed in split order).
- chip_smoke.py's tie witness, which holds the kernels' bf16 outputs on
  the card element by element: it reaches every element of JAX's
  outputs and of the kernels' algebra above, and rejects the function
  without the rounding and a quarter of its rows mixed into the plain
  output.
"""
import hashlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels.decode_attention.ops import (
    decode_attention, decode_attention_plain, fold_cache,
)
from repro_torch.kernels.flash_attention.ops import (
    flash_attention_bwd_plain, flash_attention_plain, fold_gqa,
)
from repro_torch.kernels.flash_attention.ref import (
    NEG_INF, bf16_divisor, round_scores,
)
from repro_torch.models.attention import sdpa

#: port vs the JAX model in bf16: the share of elements that differ and
#: ||port - jax|| / ||jax||.  Both round at the same points from fp32
#: values that differ in their last bits (sums in other orders, another
#: exp), so now and then one value rounds to the neighbouring bf16 value
#: (measured at most 0.16% of elements and 8.5e-5 norm-wise)
SHARE_TOL = 5e-3
NORM_TOL = 5e-4
#: (h, m, d) and (b, s): GQA groups of 4, 3 and 1, the zoo's head dims
HEADS = [(4, 1, 16, 2, 64), (15, 5, 64, 2, 40), (32, 32, 80, 1, 47),
         (3, 1, 20, 4, 64)]
BF16 = torch.bfloat16


def _pair(rng, *shape):
    """A seeded bf16 array as (jax, torch) holding the same values."""
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32),
                    jnp.bfloat16)
    return x, torch.from_numpy(np.array(x, np.float32)).to(BF16)


def _gaps(port: torch.Tensor, ref) -> tuple[float, float]:
    """(share of elements that differ, ||port - ref|| / ||ref||)."""
    a = port.float().numpy().astype(np.float64)
    b = (ref.float().numpy() if isinstance(ref, torch.Tensor)
         else np.asarray(jnp.asarray(ref, jnp.float32))).astype(np.float64)
    assert a.shape == b.shape
    return (float(np.mean(a != b)),
            float(np.linalg.norm(a - b) / np.linalg.norm(b)))


def _within(port, ref, what: str) -> None:
    share, norm = _gaps(port, ref)
    assert share <= SHARE_TOL and norm <= NORM_TOL, (what, share, norm)


def _attn_inputs(h, m, d, b, s, seed):
    rng = np.random.default_rng(seed)
    return (_pair(rng, b, s, h, d), _pair(rng, b, s, m, d),
            _pair(rng, b, s, m, d), _pair(rng, b, s, h, d))


def _unrounded(q, k, v, causal):
    """The port's bf16 attention before the repair: scores and
    probabilities kept in fp32, the scores multiplied by d**-0.5."""
    qf, kf, vf = (x.float() for x in fold_gqa(q, k, v))
    b, s, h, d = q.shape
    sc = torch.einsum("bqd,bkd->bqk", qf, kf) * d ** -0.5
    if causal:
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                            NEG_INF)
    o = torch.einsum("bqk,bkd->bqd", sc.softmax(dim=-1), vf)
    return o.to(BF16).reshape(b, h, s, d).transpose(1, 2)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("h,m,d,b,s", HEADS, ids=lambda v: str(v))
def test_sdpa_bf16_is_the_jax_models_function(h, m, d, b, s, causal):
    (jq, q), (jk, k), (jv, v), _ = _attn_inputs(h, m, d, b, s, seed=d)
    want = jattn._sdpa(jq, jk, jv, causal=causal)
    got = sdpa(q, k, v, causal=causal)
    assert got.dtype == BF16 and got.shape == q.shape
    _within(got, want, "o")
    share, norm = _gaps(_unrounded(q, k, v, causal), want)
    assert share > 10 * SHARE_TOL and norm > 2 * NORM_TOL, (share, norm)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("h,m,d,b,s", HEADS, ids=lambda v: str(v))
def test_bf16_gradients_are_jax_vjp_of_the_models_function(h, m, d, b, s,
                                                            causal):
    (jq, q), (jk, k), (jv, v), (jdo, do) = _attn_inputs(h, m, d, b, s,
                                                        seed=d + 1)
    _, vjp = jax.vjp(lambda a, b_, c: jattn._sdpa(a, b_, c, causal=causal),
                     jq, jk, jv)
    for name, got, want, like in zip(
            ("dq", "dk", "dv"),
            flash_attention_bwd_plain(q, k, v, do, causal=causal), vjp(jdo),
            (q, k, v)):
        assert got.dtype == BF16 and got.shape == like.shape
        _within(got, want, name)


def _jax_decode(jq, jk, jv, pos):
    """The JAX model's ``gqa_decode`` with identity projections and no
    rope: its output is the score/mask/softmax/PV block's, (b, h, d)."""
    b, h, d = jq.shape
    eye = jnp.eye(h * d, dtype=jnp.bfloat16)
    p = {"wq": eye.reshape(h * d, h, d), "wo": eye.reshape(h, d, h * d)}
    out, _, _ = jattn.gqa_decode(jq.reshape(b, 1, h * d), p, None, jk, jv,
                                 pos, update_cache=False, use_rope=False)
    return out.reshape(b, h, d)


@pytest.mark.parametrize("h,m,d,b,s", HEADS, ids=lambda v: str(v))
def test_decode_bf16_is_the_jax_models_function(h, m, d, b, s):
    rng = np.random.default_rng(d + 2)
    (jq, q), (jk, k), (jv, v) = (_pair(rng, b, h, d), _pair(rng, b, s, m, d),
                                 _pair(rng, b, s, m, d))
    for pos in (0, s // 2, s - 1):
        got = decode_attention(q, k, v, pos + 1)
        assert got.dtype == BF16
        _within(got, _jax_decode(jq, jk, jv, pos), f"decode pos {pos}")


def test_bf16_divisor_is_jaxs_rounding_of_sqrt_d():
    for d in range(1, 129):
        assert bf16_divisor(d ** -0.5) == float(
            jnp.asarray(d ** 0.5, jnp.bfloat16)), d
    assert bf16_divisor(80 ** -0.5) == 8.9375
    assert bf16_divisor(20 ** -0.5) == 4.46875


# ------------------------------------------------------- fp32 unchanged ----

def _digest(tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().numpy().tobytes())
    return h.hexdigest()


def _f32(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


#: sha256 of the fp32 plain versions' outputs and gradients on these
#: seeded inputs, as the port computed them before the bf16 repair
FP32_SHA256 = {
    (2, 47, 47, 6, 2, 20, True):
        "b7e5b47723890aa02b9a0e64fc930c70c8ca5d499252a24c75c99e3cd6cdfaea",
    (1, 33, 65, 4, 1, 16, False):
        "df968ad2793a588b145e8bdf48e0ba41e74f193e330e058a8b15261e7b4e1f37",
}
DECODE_FP32_SHA256 = \
    "4ec2bb54671dfc94999d83ac0c651ee38878af0736fef20f904355ec12e8cdaa"


@pytest.mark.parametrize("case", list(FP32_SHA256), ids=str)
def test_fp32_flash_plain_bits_unchanged(case):
    b, sq, sk, h, m, d, causal = case
    rng = np.random.default_rng(sq)
    q, k, v, do = (_f32(rng, b, sq, h, d), _f32(rng, b, sk, m, d),
                   _f32(rng, b, sk, m, d), _f32(rng, b, sq, h, d))
    o = flash_attention_plain(q, k, v, causal=causal)
    grads = flash_attention_bwd_plain(q, k, v, do, causal=causal)
    assert _digest([o, *grads]) == FP32_SHA256[case]


def test_fp32_decode_plain_bits_unchanged():
    rng = np.random.default_rng(5)
    q, k, v = _f32(rng, 2, 6, 20), _f32(rng, 2, 64, 2, 20), _f32(rng, 2, 64,
                                                                2, 20)
    assert _digest([decode_attention_plain(q, k, v, 40)]) == \
        DECODE_FP32_SHA256


# ------------------------------------------- the kernels' bf16 algebra ----
#
# csrc/flash_attention.cu's bf16 instance takes two passes over 64-key
# tiles (a one-pass online softmax cannot round normalised probabilities);
# csrc/flash_attention_bwd.cu sums D from the rounded dP; csrc/
# decode_attention.cu makes two launches (statistics per split, merged by
# every block of the second, which sums P_b V per split; the last block
# adds the splits' partials in order and rounds once).  Products of
# rounded bf16 values are exact in fp32, so here the products are plain
# fp32 matmuls; the sums run in the kernels' order of tiles.

TILE = 64


def _keep(sq, sk, causal):
    keep = torch.ones(sq, sk, dtype=torch.bool)
    return keep.tril() if causal else keep


def _scores(q, k, keep, divisor):
    """The kernels' bf16 scores of the rows and keys given, masked."""
    s = round_scores(q.float() @ k.float().transpose(1, 2), BF16, divisor)
    return s.masked_fill(~keep, NEG_INF)


def _two_pass_forward(q, k, v, *, causal):
    """Folded (bh, s, d) bf16 -> (o, lse): pass 1 an online row max m and
    sum l of exp(S - m) over the key tiles, pass 2 P = exp(S - m) / l
    rounded to bf16, its product with V summed per tile and added."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[2]
    keep, div = _keep(sq, sk, causal), bf16_divisor(d ** -0.5)
    m = torch.full((q.shape[0], sq, 1), NEG_INF)
    l = torch.zeros(q.shape[0], sq, 1)
    for k0 in range(0, sk, TILE):
        s = _scores(q, k[:, k0:k0 + TILE], keep[:, k0:k0 + TILE], div)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(
            dim=-1, keepdim=True)
        m = m_new
    acc = torch.zeros(q.shape[0], sq, d)
    for k0 in range(0, sk, TILE):
        s = _scores(q, k[:, k0:k0 + TILE], keep[:, k0:k0 + TILE], div)
        p = (torch.exp(s - m) / l).to(BF16).float()
        acc += p @ v[:, k0:k0 + TILE].float()
    return acc.to(BF16), m + torch.log(l)


def _backward_d_from_rounded_dp(q, k, v, do, lse, *, causal):
    """Folded bf16 -> (dq, dk, dv) per query head: P~ = exp(S - lse)
    renormalised by l = rowsum(P~), dP_b = bf16(dO V^T), D = rowsum(P~
    dP_b) / l, dS = P (dP_b - D), dS_1 = bf16(bf16(dS) / bf16(sqrt d)),
    dv = P_b^T dO, dq = dS_1 K, dk = dS_1^T Q, sums in fp32."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[2]
    keep, div = _keep(sq, sk, causal), bf16_divisor(d ** -0.5)
    pt = torch.where(keep, torch.exp(_scores(q, k, keep, div) - lse),
                     torch.zeros(()))
    dp = (do.float() @ v.float().transpose(1, 2)).to(BF16).float()
    l = pt.sum(dim=-1, keepdim=True)
    delta = (pt * dp).sum(dim=-1, keepdim=True) / l
    p = pt / l
    ds1 = round_scores(p * (dp - delta), BF16, div)
    return (ds1 @ k.float(), ds1.transpose(1, 2) @ q.float(),
            p.to(BF16).float().transpose(1, 2) @ do.float())


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("h,m,d,b,s", [(15, 5, 64, 2, 150),
                                       (32, 32, 80, 1, 47)],
                         ids=["smollm_s150", "zamba2_s47"])
def test_two_pass_bf16_forward_and_d_from_rounded_dp_hold_the_plain(
        h, m, d, b, s, causal):
    """The flash kernels' bf16 algebra against the plain versions: the
    forward's two passes over 64-key tiles give the plain bf16 output and
    the backward with D from the rounded dP gives its gradients, each
    within the bar the port is held to against JAX; the one-pass online
    softmax with fp32 probabilities (the kernel before the repair) does
    not."""
    (_, q), (_, k), (_, v), (_, do) = _attn_inputs(h, m, d, b, s, seed=s)
    qf, kf, vf = fold_gqa(q, k, v)
    dof = do.transpose(1, 2).reshape(b * h, s, d)
    o, lse = _two_pass_forward(qf, kf, vf, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    _within(o.reshape(b, h, s, d).transpose(1, 2), want, "o")
    dq, dk, dv = _backward_d_from_rounded_dp(qf, kf, vf, dof, lse,
                                             causal=causal)
    g = h // m
    fold = lambda x, heads: x.reshape(b, heads, s, d).transpose(1, 2)  # noqa
    group = lambda x: x.reshape(b * m, g, s, d).sum(dim=1)  # noqa: E731
    got = (fold(dq, h), fold(group(dk), m), fold(group(dv), m))
    for name, a, w in zip(("dq", "dk", "dv"), got,
                          flash_attention_bwd_plain(q, k, v, do,
                                                    causal=causal)):
        _within(a.to(BF16), w, name)
    share, norm = _gaps(_unrounded(q, k, v, causal), want)
    assert share > 10 * SHARE_TOL and norm > 2 * NORM_TOL, (share, norm)


def _two_launch_decode(q, k, v, length, per):
    """Folded (bm, g, d) bf16 decode as the kernel's two launches with
    ranges of ``per`` 64-position tiles: launch 1 a (max, sum) per range,
    launch 2 the global (max, sum) merged in range order, each range's
    P_b V in fp32, the ranges' partials summed in order, rounded once."""
    d = q.shape[-1]
    div = bf16_divisor(d ** -0.5)
    span = per * TILE
    stats, scores = [], []
    for lo in range(0, length, span):
        s = round_scores(q.float() @ k[:, lo:min(lo + span, length)].float()
                         .transpose(1, 2), BF16, div)
        mx = s.amax(dim=-1, keepdim=True)
        stats.append((mx, torch.exp(s - mx).sum(dim=-1, keepdim=True)))
        scores.append(s)
    m = torch.stack([mx for mx, _ in stats]).amax(dim=0)
    total = torch.zeros_like(m)
    for mx, l in stats:
        total = total + l * torch.exp(mx - m)
    acc = torch.zeros(*q.shape[:2], d)
    for i, lo in enumerate(range(0, length, span)):
        p = (torch.exp(scores[i] - m) / total).to(BF16).float()
        acc = acc + p @ v[:, lo:min(lo + span, length)].float()
    return acc.to(BF16)


@pytest.mark.parametrize("length", [1, 64, 65, 300, 577])
@pytest.mark.parametrize("h,m,d", [(15, 5, 64), (32, 32, 80)],
                         ids=["smollm", "zamba2"])
def test_two_launch_bf16_decode_holds_the_plain(h, m, d, length):
    rng = np.random.default_rng(length + d)
    b, S = 2, 577
    q, k, v = (_pair(rng, b, h, d)[1], _pair(rng, b, S, m, d)[1],
               _pair(rng, b, S, m, d)[1])
    want = decode_attention_plain(q, k, v, length)
    tiles = -(-length // TILE)
    for per in sorted({1, 2, tiles}):
        got = _two_launch_decode(*fold_cache(q, k, v), length, per)
        _within(got.reshape(q.shape), want, f"per {per}")


# ----------------------------------------------- chip_smoke's tie witness ----
#
# chip_smoke.py holds each bf16 attention kernel's forward output against
# the plain version element by element within the tie witness's reach
# (``_bf16_reach``): the bf16 values that rounding a row's near-tie scores
# and probabilities either way can give.  Here it must reach every element
# of two other sound evaluations of the JAX model's function (JAX's own
# ``_sdpa`` and ``gqa_decode``, the kernels' two-pass and two-launch
# algebra above), and miss most of the function without the rounding and
# a quarter of the rows taken from it.

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _witness(x, ref, rows) -> dict:
    return chip_smoke._bf16_gaps([x], [ref], rows)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("h,m,d,b,s", HEADS, ids=lambda v: str(v))
def test_tie_witness_reaches_sound_evaluations(h, m, d, b, s, causal):
    (jq, q), (jk, k), (jv, v), _ = _attn_inputs(h, m, d, b, s, seed=d + 3)
    ref = flash_attention_plain(q, k, v, causal=causal)
    rows = chip_smoke.flash_rows(q, k, v, causal)
    jax_o = torch.from_numpy(np.array(jattn._sdpa(jq, jk, jv, causal=causal),
                                      np.float32)).to(BF16)
    o, _ = _two_pass_forward(*fold_gqa(q, k, v), causal=causal)
    two_pass = o.reshape(b, h, s, d).transpose(1, 2)
    for name, x in (("jax", jax_o), ("two-pass", two_pass)):
        got = _witness(x, ref, rows)
        assert got["unexplained"] == 0 and got["plain_unexplained"] == 0, (
            name, got)
        assert not chip_smoke.bf16_misses(got), (name, got)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("h,m,d,b,s", HEADS, ids=lambda v: str(v))
def test_tie_witness_rejects_the_unrounded_function(h, m, d, b, s, causal):
    """The function without the rounding points (the kernels before the
    repair) leaves most of its differing elements outside the reach and
    misses the norm-wise limit; so does a quarter of its rows mixed into
    the plain output, by the witness."""
    (_, q), (_, k), (_, v), _ = _attn_inputs(h, m, d, b, s, seed=d + 4)
    ref = flash_attention_plain(q, k, v, causal=causal)
    rows = chip_smoke.flash_rows(q, k, v, causal)
    bad = _unrounded(q, k, v, causal)
    got = _witness(bad, ref, rows)
    assert got["unexplained"] > 0.2 * ref.numel(), got
    assert got["norm_rel"] > chip_smoke.ATTN_BF16_NORM_TOL, got
    mixed = ref.reshape(-1, d).clone()
    mixed[::4] = bad.reshape(-1, d)[::4]
    got = _witness(mixed.reshape(ref.shape), ref, rows)
    assert got["unexplained"] > 0.05 * ref.numel(), got
    assert chip_smoke.bf16_misses(got), got


@pytest.mark.parametrize("h,m,d", [(15, 5, 64), (32, 32, 80), (3, 1, 20)],
                         ids=["smollm", "zamba2", "reduced"])
def test_tie_witness_reaches_the_decode_evaluations(h, m, d):
    """Decode over a 577-position cache: JAX's ``gqa_decode`` and the
    decode kernel's two-launch algebra within reach of the plain version
    at every length; the unrounded function not."""
    rng = np.random.default_rng(d + 5)
    b, S = 3, 577
    (jq, q), (jk, k), (jv, v) = (_pair(rng, b, h, d), _pair(rng, b, S, m, d),
                                 _pair(rng, b, S, m, d))
    for length in (1, 65, 300, 577):
        ref = decode_attention_plain(q, k, v, length)
        rows = chip_smoke.decode_rows(q, k, v, length)
        two_launch = _two_launch_decode(*fold_cache(q, k, v), length,
                                        2).reshape(q.shape)
        for name, x in (("jax", _jax_decode(jq, jk, jv, length - 1)),
                        ("two-launch", two_launch)):
            x = torch.from_numpy(np.array(x, np.float32)).to(BF16) \
                if not isinstance(x, torch.Tensor) else x
            got = _witness(x, ref, rows)
            assert got["unexplained"] == 0 and not got["plain_unexplained"], (
                name, length, got)
    qf, kf, vf = (t.float() for t in fold_cache(q, k, v))
    sc = torch.einsum("bgd,bkd->bgk", qf, kf) * d ** -0.5
    bad = torch.einsum("bgk,bkd->bgd", sc.softmax(-1), vf).to(BF16)
    got = _witness(bad.reshape(q.shape), ref, rows)
    assert got["unexplained"] > 0.2 * ref.numel(), got


# ------------------------------------------- the backward's tie witness ----
#
# chip_smoke.py holds a bf16 backward's gradients, where they miss the
# gradient limits against the plain version, against the backward's tie
# witness instead: ``jax.vjp``'s function in float64 with its near-tie
# roundings (of q k^T, dO v^T, P and dS) taken the kernel's way.  Here the
# witness must hold two sound evaluations of that function (JAX's own and
# the plain version's) within the gradient limits, and the function
# without the rounding points must stay beyond them however its near ties
# are taken.

WIDE = [(4, 2, 24, 16, 2, 13), (2, 2, 192, 128, 1, 17), (3, 1, 16, 16, 2, 9)]


@pytest.mark.parametrize("h,m,dk,dv,b,s", WIDE, ids=lambda v: str(v))
def test_backward_tie_witness_holds_sound_evaluations(h, m, dk, dv, b, s):
    """jax.vjp's gradients of ``_sdpa`` and the plain version's (causal, dk
    != dv where given) within the gradient limits of the witness; the
    unrounded function's gradients (fp32 autograd, rounded once) beyond
    the norm-wise limit after the witness has taken every near tie their
    way."""
    rng = np.random.default_rng(dk + dv + 1)
    (jq, q), (jk, k), (jv, v), (jdo, do) = (
        _pair(rng, b, s, h, dk), _pair(rng, b, s, m, dk),
        _pair(rng, b, s, m, dv), _pair(rng, b, s, h, dv))
    _, vjp = jax.vjp(lambda q_, k_, v_: jattn._sdpa(q_, k_, v_, causal=True),
                     jq, jk, jv)
    jax_g = [torch.from_numpy(np.array(g, np.float32)).to(BF16)
             for g in vjp(jdo)]
    plain = list(flash_attention_bwd_plain(q, k, v, do, causal=True))
    for got in (jax_g, plain):
        ref, _ = chip_smoke._bf16_bwd_explained(q, k, v, do, True, got)
        gaps = chip_smoke._bf16_gaps(got, list(ref))
        assert not chip_smoke.bf16_misses(gaps, grads=True), gaps
    bad = [g.to(BF16) for g in flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), do.float(), causal=True)]
    ref, _ = chip_smoke._bf16_bwd_explained(q, k, v, do, True, bad)
    gaps = chip_smoke._bf16_gaps(bad, list(ref))
    assert gaps["norm_rel"] > chip_smoke.ATTN_BF16_GRAD_NORM_TOL, gaps
