"""The port's flash-attention and flash-decoding plain versions and their
``ops`` plumbing (GQA folding, layouts, ragged lengths) against the JAX
package: its ``attention_ref``/``decode_attention_ref`` oracles and its
Pallas kernels in interpret mode (as tests/test_kernels.py runs them), on
the CPU.

Tolerances are those of tests/test_kernels.py: 2e-5 for float32; 2e-2
(flash) and 3e-2 (decode) for bfloat16.  The CUDA kernels are held against
these plain versions on the card by ``chip_smoke.py``.  The last tests
state the tensor-core flash kernel's algebra in plain torch: its 3xTF32
products against one-pass TF32, and its fragment maps (the key order that
keeps P in registers, the head_dim layout of its wide loads).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jdec_ops
from repro.kernels.decode_attention.ref import decode_attention_ref as jdec_ref
from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention.ref import attention_ref as jfa_ref
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention

TOL = {"float32": 2e-5, "bfloat16": {"flash": 2e-2, "decode": 3e-2}}


def _tol(dtype: str, kind: str) -> float:
    t = TOL[dtype]
    return t[kind] if isinstance(t, dict) else t


def _arrays(shapes, dtype: str, seed: int):
    """Seeded numpy inputs, rounded to ``dtype`` once, as (jax, torch)
    pairs holding the same values."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        x = jnp.asarray(rng.standard_normal(shape).astype(np.float32), dtype)
        out.append((x, torch.from_numpy(np.array(x, np.float32))
                    .to(getattr(torch, dtype))))
    return out


def _close(port: torch.Tensor, ref, tol: float) -> None:
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


def _jax_flash_ref(q, k, v, causal):
    """The JAX package's oracle behind its wrapper's GQA plumbing
    (tests/test_kernels.py::test_flash_attention)."""
    b, sq, h, d = q.shape
    sk, m = k.shape[1], k.shape[2]
    g = h // m
    qf = q.transpose(0, 2, 1, 3).reshape(b * h, sq, d)
    kf = jnp.repeat(k.transpose(0, 2, 1, 3), g, 1).reshape(b * h, sk, d)
    vf = jnp.repeat(v.transpose(0, 2, 1, 3), g, 1).reshape(b * h, sk, d)
    o = jfa_ref(qf, kf, vf, causal=causal, sm_scale=d ** -0.5)
    return o.reshape(b, h, sq, d).transpose(0, 2, 1, 3)


def _jax_decode_ref(q, k, v, length):
    b, h, d = q.shape
    S, m = k.shape[1], k.shape[2]
    qf = q.reshape(b, m, h // m, d).reshape(b * m, h // m, d)
    kf = k.transpose(0, 2, 1, 3).reshape(b * m, S, d)
    vf = v.transpose(0, 2, 1, 3).reshape(b * m, S, d)
    o = jdec_ref(qf, kf, vf, length, sm_scale=d ** -0.5)
    return o.reshape(b, h, d)


# ------------------------------------------------------------ flash ----------

# (b, sq, sk, h, m, d, causal, dtype): g = h/m in {1, 3, 4}, d in {16, 20};
# lengths divisible by the Pallas blocks (64) so its kernel runs too
FLASH = [
    (2, 128, 128, 3, 1, 20, True, "float32"),
    (1, 128, 128, 4, 1, 16, False, "float32"),
    (2, 64, 64, 4, 4, 16, True, "float32"),
    (1, 64, 128, 3, 1, 20, False, "float32"),
    (1, 128, 128, 4, 1, 16, True, "bfloat16"),
]
# ragged lengths the Pallas kernel cannot take (it asserts divisibility)
FLASH_RAGGED = [
    (2, 47, 47, 3, 1, 20, True, "float32"),
    (1, 77, 100, 4, 4, 16, False, "float32"),
    (1, 33, 65, 4, 1, 16, True, "float32"),
    (1, 33, 33, 4, 1, 16, True, "bfloat16"),
]


def _flash_inputs(case, seed=0):
    b, sq, sk, h, m, d, causal, dtype = case
    return _arrays([(b, sq, h, d), (b, sk, m, d), (b, sk, m, d)], dtype,
                   seed), causal, dtype


@pytest.mark.parametrize("case", FLASH + FLASH_RAGGED, ids=str)
def test_flash_plain_matches_jax_oracle(case):
    ((jq, q), (jk, k), (jv, v)), causal, dtype = _flash_inputs(case)
    o = flash_attention(q, k, v, causal=causal)
    assert o.shape == q.shape and o.dtype == q.dtype
    _close(o, _jax_flash_ref(jq, jk, jv, causal), _tol(dtype, "flash"))


@pytest.mark.parametrize("case", FLASH, ids=str)
def test_flash_plain_matches_jax_pallas_interpret(case):
    ((jq, q), (jk, k), (jv, v)), causal, dtype = _flash_inputs(case, seed=1)
    want = jfa_ops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                   block_k=64, interpret=True)
    _close(flash_attention(q, k, v, causal=causal), want,
           _tol(dtype, "flash"))


def test_flash_gqa_reads_kv_head_i_over_g():
    """Query head i attends with kv head i // g: shifting kv head 1 of 2
    changes exactly the g = 3 query heads of its group (heads 3-5)."""
    ((_, q), (_, k), (_, v)), _, _ = _flash_inputs(
        (1, 16, 16, 6, 2, 16, True, "float32"))
    base = flash_attention(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 1] += 1.0
    v2[:, :, 1] += 1.0
    moved = (flash_attention(q, k2, v2, causal=True) - base).abs().amax(
        dim=(0, 1, 3))
    assert (moved[:3] == 0).all() and (moved[3:] > 0).all()


# ------------------------------------------------------------ decode ---------

# (b, h, m, d, S, length, dtype); S divisible by the Pallas block (64)
DECODE = [
    (2, 3, 1, 20, 256, 200, "float32"),
    (1, 4, 1, 16, 128, 128, "float32"),
    (3, 4, 4, 16, 128, 37, "float32"),
    (2, 6, 2, 20, 192, 1, "float32"),
    (2, 4, 1, 16, 256, 100, "bfloat16"),
]
DECODE_RAGGED = [
    (2, 3, 1, 20, 47, 47, "float32"),
    (1, 4, 4, 16, 577, 300, "float32"),
    (2, 4, 1, 16, 33, 20, "bfloat16"),
]


def _decode_inputs(case, seed=0):
    b, h, m, d, S, length, dtype = case
    return _arrays([(b, h, d), (b, S, m, d), (b, S, m, d)], dtype,
                   seed), length, dtype


@pytest.mark.parametrize("case", DECODE + DECODE_RAGGED, ids=str)
def test_decode_plain_matches_jax_oracle(case):
    ((jq, q), (jk, k), (jv, v)), length, dtype = _decode_inputs(case)
    o = decode_attention(q, k, v, length)
    assert o.shape == q.shape and o.dtype == q.dtype
    _close(o, _jax_decode_ref(jq, jk, jv, length), _tol(dtype, "decode"))


@pytest.mark.parametrize("case", DECODE, ids=str)
def test_decode_plain_matches_jax_pallas_interpret(case):
    ((jq, q), (jk, k), (jv, v)), length, dtype = _decode_inputs(case, seed=1)
    want = jdec_ops.decode_attention(jq, jk, jv, length, block_k=64,
                                     interpret=True)
    _close(decode_attention(q, k, v, length), want, _tol(dtype, "decode"))


def test_decode_ignores_cache_past_length():
    """Positions >= length do not move the output, whatever they hold."""
    ((_, q), (_, k), (_, v)), length, _ = _decode_inputs(
        (2, 6, 2, 16, 64, 40, "float32"))
    base = decode_attention(q, k, v, length)
    k[:, length:] = 1e4
    v[:, length:] = float("nan")
    torch.testing.assert_close(decode_attention(q, k, v, length), base,
                               rtol=0, atol=0)


# ------------------------------------------------------- the kernel route ----

@pytest.mark.parametrize("call", [
    lambda q, k: fa_kernel.flash_attention_kernel(q, k, k, causal=True),
    lambda q, k: dec_kernel.decode_attention_kernel(q[:, 0], k, k, 4),
], ids=["flash_attention", "decode_attention"])
def test_kernel_wrappers_take_cuda_tensors_only(call):
    """The wrappers launch on the card or raise: a CPU tensor never reaches
    them by accident, and no launch is counted."""
    q, k = torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 1, 16)
    before = {**fa_kernel.launches, **dec_kernel.launches}
    with pytest.raises(ValueError, match="CUDA"):
        call(q, k)
    flash_attention(q, k, k, causal=True)
    decode_attention(q[:, 0], k, k, 4)
    assert {**fa_kernel.launches, **dec_kernel.launches} == before


# ------------------------------------------------- split-KV plumbing ---------

def _split_merge(q, k, v, length, per, *, sm_scale):
    """The decode kernel's split algebra in plain torch on the folded
    layout: per range of ``per`` whole tiles, fp32 (max, sum, unnormalised
    accumulator); the ranges merged in order by the log-sum-exp rule."""
    span = per * dec_kernel.TILE
    parts = []
    for lo in range(0, length, span):
        kk = k[:, lo:min(lo + span, length)].float()
        vv = v[:, lo:min(lo + span, length)].float()
        s = torch.einsum("bgd,bkd->bgk", q.float(), kk) * sm_scale
        mx = s.amax(dim=-1)
        p = torch.exp(s - mx[..., None])
        parts.append((mx, p.sum(dim=-1), torch.einsum("bgk,bkd->bgd", p, vv)))
    m = torch.stack([mx for mx, _, _ in parts]).amax(dim=0)
    total, acc = torch.zeros_like(m), torch.zeros_like(parts[0][2])
    for mx, l, a in parts:
        f = torch.exp(mx - m)
        total = total + l * f
        acc = acc + a * f[..., None]
    return (acc / total[..., None]).to(q.dtype)


@pytest.mark.parametrize("length", [1, 63, 64, 65, 300, 577])
@pytest.mark.parametrize("g,d", [(1, 64), (3, 64), (1, 80), (3, 80)])
def test_split_merge_algebra_matches_decode_ref(g, d, length):
    """The partials of every split merged by log-sum-exp give the one-pass
    softmax, at any split of the prefix into whole tiles (fp32, 1e-6)."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    rng = np.random.default_rng(g * 1000 + d + length)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((2, g, d), (2, 577, d), (2, 577, d)))
    want = decode_attention_ref(q, k, v, length, sm_scale=d ** -0.5)
    tiles = -(-length // dec_kernel.TILE)
    for per in sorted({1, 2, 3, tiles}):
        got = _split_merge(q, k, v, length, per, sm_scale=d ** -0.5)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_units,length", [
    (40, 577), (20, 2048), (128, 48), (1, 300), (1, 1), (7, 0), (3, 64),
    (3, 65), (15, 577), (400, 4096), (1, 1 << 20), (132, 129), (2, 640),
])
def test_split_planner_covers_the_prefix_in_whole_tiles(n_units, length):
    """No empty split, never more splits than tiles, every tile covered,
    one split for at most one tile, and more than one split wherever the
    units leave SMs idle and the prefix has more than one tile."""
    sms = 132
    n, per = dec_kernel.plan_splits(n_units, length, sms)
    tiles = -(-length // dec_kernel.TILE)
    assert n >= 1
    if tiles <= 1:
        assert (n, per) == (1, tiles)
        return
    assert n <= tiles and (n - 1) * per < tiles <= n * per
    if n_units < sms:
        assert n > 1


def test_split_plans_of_the_serving_shapes():
    """smollm's timed decode shapes split, zamba2's one-tile caches do not;
    a group of 16 heads takes two blocks per kv head."""
    units, plan = dec_kernel.units, dec_kernel.plan_splits
    assert units(8, 15, 5) == 40 and plan(40, 577, 132) == (10, 1)
    assert units(4, 15, 5) == 20 and plan(20, 2048, 132) == (16, 2)
    assert units(4, 32, 32) == 128 and plan(128, 48, 132) == (1, 1)
    assert units(1, 128, 8) == 16


@pytest.mark.parametrize("d,esize,offsets,want", [
    (64, 4, (64 * 5 * 4, 64 * 4, 577 * 64 * 5 * 4), 16),
    (80, 2, (80 * 32 * 2, 80 * 2), 16),
    (20, 2, (20 * 3 * 2, 20 * 2), 8),
    (20, 4, (20 * 3 * 4, 20 * 4), 16),
    (21, 4, (21 * 4,), 4),
    (21, 2, (21 * 2,), 2),
    (64, 4, (64 * 4, 8), 8),
])
def test_copy_bytes_is_the_widest_that_divides_the_layout(d, esize, offsets,
                                                          want):
    assert dec_kernel.copy_bytes(d, esize, *offsets) == want


# ------------------------------------- the tensor-core kernel's algebra ------
#
# csrc/flash_attention.cu computes both products on the tensor cores as
# 3xTF32 (a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, hi = a rounded to TF32 by
# integer ops, lo = a - hi) with an online softmax over 64-key tiles, and
# keeps P in registers by reading K's rows in a permuted order.  The tests
# below state that algebra in plain torch on the CPU.

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (10 mantissa bits), rounded to nearest by the kernel's
    integer split: (bits + 0x1000) & ~0x1fff."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's three TF32 products, the small ones first
    (each operand rounded to TF32; the products exact, the sums fp32)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product: what the kernel must not do."""
    return _tf32(a) @ _tf32(b)


def _flash_tiles(q, k, v, *, causal: bool, mm, tile: int = 64):
    """The kernel's arithmetic on the folded layout (bh, s, d): scores and
    P V through ``mm``, an fp32 online softmax over ``tile``-key tiles,
    masked scores at -1e30, the row sums divided out at the end."""
    from repro_torch.kernels.flash_attention.ref import NEG_INF
    sq, sk, d = q.shape[1], k.shape[1], q.shape[2]
    m = torch.full((q.shape[0], sq, 1), NEG_INF)
    l = torch.zeros(q.shape[0], sq, 1)
    acc = torch.zeros(q.shape[0], sq, d)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, tile):
        kt, vt = k[:, k0:k0 + tile], v[:, k0:k0 + tile]
        s = mm(q, kt.transpose(1, 2)) * d ** -0.5
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[1])[None, :]
            s = s.masked_fill(keys > rows, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + mm(p, vt)
        m = m_new
    return acc / l.clamp_min(1e-30)


@pytest.mark.parametrize("d,h,m", [(64, 15, 5), (80, 32, 32)],
                         ids=["smollm", "zamba2"])
def test_3xtf32_products_hold_fp32_and_one_pass_tf32_does_not(d, h, m):
    """At the serving models' head dims, the kernel's algebra with 3xTF32
    products is within 2e-6 of fp32 ``attention_ref``; with one-pass TF32
    products it is not, so the port's fp32 tolerance catches the wrong
    precision.

    The emulation sums in fp32 with rounding to nearest.  The tensor cores
    truncate where they add (the lo operands' low bits and each mma's
    accumulation), which this does not model: it cannot tell summing each
    32 keys' P V from zero (the kernel's order) from summing P V straight
    into the running accumulator.  That difference is held on the card by
    chip_smoke.py's float64 gate."""
    from repro_torch.kernels.flash_attention.ops import fold_gqa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rng = np.random.default_rng(d)
    s = 150                       # three key tiles, the last one ragged
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
               for sh in ((1, s, h, d), (1, s, m, d), (1, s, m, d)))
    qf, kf, vf = fold_gqa(q, k, v)
    want = attention_ref(qf, kf, vf, causal=True, sm_scale=d ** -0.5)
    err3 = (_flash_tiles(qf, kf, vf, causal=True, mm=_mm_3xtf32)
            - want).abs().max()
    err1 = (_flash_tiles(qf, kf, vf, causal=True, mm=_mm_tf32)
            - want).abs().max()
    assert err3 <= 2e-6, err3
    assert err1 > 2e-6 * 50, err1


# the kernel's fragment maps (mma.sync m16n8k8, lane = 4 g + t)
def _key_of_b_lane(g: int) -> int:
    """The key of its 8-key group that lane group g reads into K's B
    fragment (score column g)."""
    return g // 2 + 4 * (g % 2)


def _score_c_fragment(g: int, t: int):
    """(row, key) of c0..c3 of a score tile: columns 2t, 2t + 1 of rows
    g, g + 8, where column n holds key _key_of_b_lane(n)."""
    return [(r, _key_of_b_lane(n)) for r in (g, g + 8)
            for n in (2 * t, 2 * t + 1)]


def _pv_a_fragment(g: int, t: int):
    """(row, key) of a0..a3 of P V's A fragment: k is the key in order."""
    return [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]


def test_permuted_score_fragment_is_the_pv_a_fragment():
    """With K's rows read in the permuted order, every lane's score values
    (c0, c2, c1, c3) are its A fragment of P V for V in natural key order:
    P never leaves the registers."""
    assert sorted(_key_of_b_lane(g) for g in range(8)) == list(range(8))
    for g in range(8):
        for t in range(4):
            c = _score_c_fragment(g, t)
            assert [c[0], c[2], c[1], c[3]] == _pv_a_fragment(g, t)


@pytest.mark.parametrize("nc", [1, 4, 5, 8])
def test_head_dim_permutations_cover_every_dim_once(nc):
    """QK^T's k-slots and P V's output columns as the kernel lays them out
    for head_dim padded to 16 nc: each lane's 16-byte K load and its four
    stored outputs are contiguous, and every dim is used exactly once."""
    dims = []                     # (k-step, k-slot) -> dim, Q and K alike
    for j in range(nc):
        for step in range(2):
            for t in range(4):
                for slot in (t, t + 4):
                    dims.append(16 * j + 4 * t + 2 * step + (slot >= 4))
    assert sorted(dims) == list(range(16 * nc))
    for i in range(nc):           # V's columns by (n-tile 2i + u, lane g)
        cols = {(u, g): 16 * i + 2 * g + u for u in range(2) for g in range(8)}
        assert sorted(cols.values()) == list(range(16 * i, 16 * i + 16))
        for t in range(4):
            # the lane's outputs as stored: acc[2i][0], acc[2i + 1][0],
            # acc[2i][1], acc[2i + 1][1] -- C fragment columns n = 2t, 2t + 1
            # of n-tiles 2i (u = 0) and 2i + 1 (u = 1), column n of n-tile
            # 2i + u holding V's column cols[(u, n)]
            got = [cols[(u, n)] for n, u in
                   ((2 * t, 0), (2 * t, 1), (2 * t + 1, 0), (2 * t + 1, 1))]
            assert got == [16 * i + 4 * t + e for e in (0, 1, 2, 3)]


@pytest.mark.parametrize("causal", [True, False])
def test_attention_with_keys_permuted_in_groups_of_8(causal):
    """Scores over keys permuted within each 8-key group, P taken back to
    key order by the fragment map and multiplied by V unpermuted, give
    ``attention_ref``; P V without the map does not."""
    from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref
    rng = np.random.default_rng(7)
    bh, s, d = 3, 40, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, s, d))
                                .astype(np.float32)) for _ in range(3))
    perm = torch.tensor([8 * (j // 8) + _key_of_b_lane(j % 8)
                         for j in range(s)])
    sc = torch.einsum("bqd,bkd->bqk", q, k[:, perm]) * d ** -0.5
    if causal:
        sc = sc.masked_fill(perm[None, :] > torch.arange(s)[:, None], NEG_INF)
    p = torch.softmax(sc, dim=-1)
    p_keys = torch.empty_like(p)
    p_keys[..., perm] = p        # score column n holds key perm[n]
    want = attention_ref(q, k, v, causal=causal, sm_scale=d ** -0.5)
    torch.testing.assert_close(p_keys @ v, want, rtol=1e-6, atol=1e-6)
    assert (p @ v - want).abs().max() > 1e-2
