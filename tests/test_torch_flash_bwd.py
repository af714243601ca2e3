"""The tensor-core backward kernel's algebra (``csrc/flash_attention_bwd.cu``)
stated in plain torch on the CPU, against ``flash_attention_bwd_plain``
(autograd of the plain version, which ``test_torch_attention.py`` holds
against ``jax.vjp`` of the JAX oracle).

The kernel recomputes P from the forward's log-sum-exp and renormalises
it by l = rowsum(P~), takes D = rowsum(P~ dP) / l from the same P~ and dP
(a first pass over the keys), does every product as 3xTF32 with each
step's dq, dk and dv contribution summed from zero, reads the streamed
rows in the forward's permuted order so that P, dS, P^T and dS^T never
leave the registers, and, at short sequences, splits the dk/dv work over
the query heads of a GQA group and sums their partials in head order.
The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import (
    flash_attention_bwd_plain, fold_gqa,
)
from repro_torch.kernels.flash_attention.ref import NEG_INF
from test_torch_attention import (
    _key_of_b_lane, _mm_3xtf32, _mm_tf32, _pv_a_fragment,
)

LOG2E = 1.4426950408889634
TILE = fa_kernel.BWD_TILE     # keys a dq block streams, rows a dk/dv block
DQ_STEP, DKDV_STEP = 32, 16   # keys / query rows a warp takes per step


def _keep(sq: int, sk: int, causal: bool) -> torch.Tensor:
    """(sq, sk) True where query row i sees key j (top-left causal)."""
    keep = torch.ones(sq, sk, dtype=torch.bool)
    return keep.tril() if causal else keep


def _forward_lse(q, k, v, *, causal: bool, mm):
    """The forward kernel's online softmax in base 2 over TILE-key tiles on
    the folded layout (bh, s, d): o and each row's natural log-sum-exp of
    its scaled scores, (m + log2 l) ln 2 in fp32, as it stores it for the
    backward."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[2]
    keep = _keep(sq, sk, causal)
    m = torch.full((q.shape[0], sq, 1), NEG_INF)
    l = torch.zeros(q.shape[0], sq, 1)
    acc = torch.zeros(q.shape[0], sq, d)
    for k0 in range(0, sk, TILE):
        kt, vt = k[:, k0:k0 + TILE], v[:, k0:k0 + TILE]
        s = mm(q, kt.transpose(1, 2)) * (d ** -0.5 * LOG2E)
        s = s.masked_fill(~keep[:, k0:k0 + TILE], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + mm(p, vt)
        m = m_new
    return acc / l, (m + torch.log2(l)) * math.log(2)


def _p_dp(q, k, v, do, m2, keep, mm):
    """P~ = exp2(S d^-1/2 log2 e - m2) (0 where masked) and dP = dO V^T
    for the rows and keys given."""
    d = q.shape[-1]
    s = mm(q, k.transpose(1, 2)) * (d ** -0.5 * LOG2E)
    return (torch.where(keep, torch.exp2(s - m2), torch.zeros(())),
            mm(do, v.transpose(1, 2)))


def _l_and_delta(q, k, v, do, m2, keep, mm):
    """The dq launch's first pass: l = rowsum(P~) and D = rowsum(P~ dP) /
    l, each TILE keys' part summed from zero and added."""
    l = torch.zeros(*q.shape[:2], 1)
    dn = torch.zeros_like(l)
    for k0 in range(0, k.shape[1], TILE):
        ks = slice(k0, k0 + TILE)
        pt, dp = _p_dp(q, k[:, ks], v[:, ks], do, m2, keep[:, ks], mm)
        l += pt.sum(dim=-1, keepdim=True)
        dn += (pt * dp).sum(dim=-1, keepdim=True)
    return l, dn / l


def _backward_tiles(q, k, v, do, *, causal: bool, mm, group: int):
    """The backward kernel's arithmetic on the folded layout: P from the
    forward's lse renormalised by l, D from the same P~ and dP; dq walks
    the keys DQ_STEP at a time, dk and dv the query rows DKDV_STEP at a
    time, each step's product summed from zero and added to the fp32 sum;
    dk and dv of the g query heads of a group summed in head order."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[2]
    keep = _keep(sq, sk, causal)
    _, lse = _forward_lse(q, k, v, causal=causal, mm=mm)
    m2 = lse * LOG2E
    l, delta = _l_and_delta(q, k, v, do, m2, keep, mm)
    dq = torch.zeros_like(q)
    for k0 in range(0, sk, DQ_STEP):
        ks = slice(k0, k0 + DQ_STEP)
        pt, dp = _p_dp(q, k[:, ks], v[:, ks], do, m2, keep[:, ks], mm)
        dq += mm(pt / l * (dp - delta), k[:, ks])
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for q0 in range(0, sq, DKDV_STEP):
        rs = slice(q0, q0 + DKDV_STEP)
        pt, dp = _p_dp(q[:, rs], k, v, do[:, rs], m2[:, rs], keep[rs], mm)
        p = pt / l[:, rs]
        dv += mm(p.transpose(1, 2), do[:, rs])
        dk += mm((p * (dp - delta[:, rs])).transpose(1, 2), q[:, rs])
    return dq * d ** -0.5, _group_sum(dk, group) * d ** -0.5, \
        _group_sum(dv, group)


def _group_sum(x: torch.Tensor, group: int) -> torch.Tensor:
    """(b*h, s, d) per query head -> (b*m, s, d): the g heads of each group
    summed in head order, as the kernel's last launch sums its partials."""
    parts = x.reshape(-1, group, *x.shape[1:])
    out = parts[:, 0].clone()
    for gi in range(1, group):
        out += parts[:, gi]
    return out


def _unfold(x: torch.Tensor, b: int, heads: int) -> torch.Tensor:
    """(b*heads, s, d) -> (b, s, heads, d)."""
    return x.reshape(b, heads, *x.shape[1:]).transpose(1, 2)


def _inputs(b, s, h, m, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
            for sh in ((b, s, h, d), (b, s, m, d), (b, s, m, d), (b, s, h, d))]


@pytest.mark.parametrize("b,s,h,m,d", [(2, 64, 15, 5, 64),
                                       (1, 150, 3, 1, 20)],
                         ids=["smollm_b2_s64", "d20_ragged_s150"])
def test_backward_algebra_3xtf32_holds_fp32_and_one_pass_tf32_does_not(
        b, s, h, m, d):
    """The kernel's backward algebra -- P from the forward's lse
    renormalised by l, D = rowsum(P~ dP) / l, 3xTF32 products summed step
    by step, the GQA partials summed in head order -- is within 1e-6 of
    the largest plain gradient at smollm's heads (d 64, g 3) and at d 20
    over 150 positions (the last tile ragged).  With one-pass TF32
    products it is not, so the card's fp32 gates catch the wrong
    precision.  (The emulation sums with rounding to nearest; the tensor
    cores truncate where they add, which chip_smoke.py's float64 gates
    hold on the card.)"""
    q, k, v, do = _inputs(b, s, h, m, d, seed=d)
    want = flash_attention_bwd_plain(q, k, v, do, causal=True)
    scale = max(float(w.abs().max()) for w in want)
    qf, kf, vf = fold_gqa(q, k, v)
    dof = do.transpose(1, 2).reshape(b * h, s, d)
    errs = {}
    for name, mm in (("3xtf32", _mm_3xtf32), ("tf32", _mm_tf32)):
        dq, dk, dv = _backward_tiles(qf, kf, vf, dof, causal=True, mm=mm,
                                     group=h // m)
        got = (_unfold(dq, b, h), _unfold(dk, b, m), _unfold(dv, b, m))
        errs[name] = max(float((g_ - w).abs().max())
                         for g_, w in zip(got, want)) / scale
    assert errs["3xtf32"] <= 1e-6, errs
    assert errs["tf32"] > 50 * 1e-6, errs


def test_renormalised_p_cancels_a_rounded_offset():
    """An offset off by a rounding common to the row (the fp32 lse near 8
    is off by up to half an ulp, ~5e-7) scales P~ by one factor per row;
    dividing by l = rowsum(P~) cancels it, so P is the softmax whatever
    the offset, and a D summed from the same P~ makes each row of dS sum
    to zero."""
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 150, 16))
                                    .astype(np.float32)) for _ in range(4))
    keep = _keep(150, 150, True)
    _, lse = _forward_lse(q, k, v, causal=True, mm=torch.matmul)
    want = torch.softmax((q @ k.transpose(1, 2) * 16 ** -0.5)
                         .masked_fill(~keep, NEG_INF), dim=-1)
    for off in (0.0, 4e-6):       # a few ulps of lse near 8
        m2 = (lse + off) * LOG2E
        pt, dp = _p_dp(q, k, v, do, m2, keep, torch.matmul)
        l, delta = _l_and_delta(q, k, v, do, m2, keep, torch.matmul)
        torch.testing.assert_close(pt / l, want, rtol=1e-6, atol=1e-7)
        ds_rows = (pt / l * (dp - delta)).sum(dim=-1)
        assert float(ds_rows.abs().max()) <= 1e-5
    # unrenormalised, the offset's error is the whole row's
    pt, _ = _p_dp(q, k, v, do, (lse + 4e-6) * LOG2E, keep, torch.matmul)
    assert float((pt - want).abs().max() / want.max()) > 2e-6


# the dk/dv launch's fragment map (mma.sync m16n8k8, lane = 4 g + t): the
# warp's 16 keys are S^T's rows (M), the streamed query rows its columns

def _score_t_c_fragment(g: int, t: int):
    """(key, query row) of c0..c3 of S^T = K Q^T: columns 2t, 2t + 1 of
    key rows g, g + 8, where column n holds the query row that B lane n
    reads, _key_of_b_lane(n) (the forward's permuted order)."""
    return [(r, _key_of_b_lane(n)) for r in (g, g + 8)
            for n in (2 * t, 2 * t + 1)]


def test_permuted_query_rows_put_p_t_in_the_dv_a_fragment():
    """With the query rows read into S^T's B fragment in the permuted
    order, every lane's P^T / dS^T values (c0, c2, c1, c3) are its A
    fragment of P^T dO and dS^T Q with dO and Q in natural row order: P^T
    and dS^T never leave the registers."""
    for g in range(8):
        for t in range(4):
            c = _score_t_c_fragment(g, t)
            assert [c[0], c[2], c[1], c[3]] == _pv_a_fragment(g, t)


@pytest.mark.parametrize("causal", [True, False])
def test_dk_dv_with_query_rows_permuted_in_groups_of_8(causal):
    """S^T over query rows permuted within each 8-row group, taken back to
    row order by the fragment map and multiplied by dO and Q unpermuted,
    gives the plain dv and dk; without the map it does not."""
    rng = np.random.default_rng(11)
    s, d = 40, 16
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, s, 1, d))
                                    .astype(np.float32)) for _ in range(4))
    _, dk, dv = flash_attention_bwd_plain(q, k, v, do, causal=causal)
    qf, kf, vf, dof = (x[:, :, 0] for x in (q, k, v, do))
    keep = _keep(s, s, causal)
    _, lse = _forward_lse(qf, kf, vf, causal=causal, mm=torch.matmul)
    m2 = lse * LOG2E
    l, delta = _l_and_delta(qf, kf, vf, dof, m2, keep, torch.matmul)
    perm = torch.tensor([8 * (j // 8) + _key_of_b_lane(j % 8)
                         for j in range(s)])
    # S^T's columns in the order the B fragment reads the query rows
    pt, dp = _p_dp(qf[:, perm], kf, vf, dof[:, perm], m2[:, perm],
                   keep[perm], torch.matmul)
    p = pt / l[:, perm]
    p_t, ds_t = p.transpose(1, 2), (p * (dp - delta[:, perm])).transpose(1, 2)
    p_rows, ds_rows = torch.empty_like(p_t), torch.empty_like(ds_t)
    p_rows[..., perm], ds_rows[..., perm] = p_t, ds_t
    torch.testing.assert_close(p_rows @ dof, dv[:, :, 0], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(ds_rows @ qf * d ** -0.5, dk[:, :, 0],
                               rtol=1e-5, atol=1e-5)
    assert (p_t @ dof - dv[:, :, 0]).abs().max() > 1e-2


# ---------------------------------------------- the GQA split at short s ----

def _dkdv_blocks(b: int, h: int, m: int, sk: int, split: bool):
    """The dk/dv launch's blocks as dkdv_kernel reads its grid -- x = batch
    row * units + unit (a query head when split, else a kv head, whose g
    query heads it walks), y = key tile -- as (batch row, query heads,
    first key)."""
    units, g = (h, 1) if split else (m, h // m)
    return [(x // units, tuple(range((x % units) * g, (x % units + 1) * g)),
             y * TILE)
            for y in range(-(-sk // TILE)) for x in range(b * units)]


@pytest.mark.parametrize("b,s,h,m,split", [
    (8, 64, 15, 5, True),      # the training path at full width: 40 -> 120
    (8, 64, 3, 1, True),       # its reduced config: 8 -> 24
    (4, 2048, 15, 5, False),   # the prefill's shape: 640 blocks already
    (8, 64, 4, 4, False),      # no group to split
])
def test_split_plan_covers_every_head_and_key_tile_once(b, s, h, m, split):
    """The dk/dv launch splits the group over its query heads where one
    block per (b, kv head, key tile) would leave the card short of blocks,
    and either way its blocks cover every (b, query head, key tile) once,
    each block within one kv head's group."""
    sms = 132                  # an H100 SXM
    assert fa_kernel.split_gqa(b, h, m, s, sms) == split
    blocks = _dkdv_blocks(b, h, m, s, split)
    tiles = -(-s // TILE)
    assert len(blocks) == b * (h if split else m) * tiles
    covered = sorted((bi, head, k0) for bi, heads, k0 in blocks
                     for head in heads)
    assert covered == sorted((bi, head, TILE * kt) for bi in range(b)
                             for head in range(h) for kt in range(tiles))
    g = h // m
    assert all(len({head // g for head in heads}) == 1
               for _, heads, _ in blocks)


def test_gqa_partials_summed_in_head_order_give_the_plain_dk_dv():
    """Each query head's own share of dk and dv (the plain gradient with
    its kv head repeated per query head), summed over the group in head
    order, is the plain GQA gradient."""
    b, s, h, m, d = 2, 47, 6, 2, 16
    q, k, v, do = _inputs(b, s, h, m, d, seed=5)
    _, dk, dv = flash_attention_bwd_plain(q, k, v, do, causal=True)
    g = h // m
    k_rep, v_rep = (x.repeat_interleave(g, dim=2) for x in (k, v))
    _, dk_h, dv_h = flash_attention_bwd_plain(q, k_rep, v_rep, do,
                                              causal=True)
    for full, share in ((dk, dk_h), (dv, dv_h)):
        parts = share.transpose(1, 2).reshape(b * h, s, d)
        got = _unfold(_group_sum(parts, g), b, m)
        torch.testing.assert_close(got, full, rtol=1e-6, atol=1e-6)
