"""The flash backward's float64 criterion, stated from the kernel's
arithmetic: ``ref.bwd_error_bound`` bounds, element by element, the error
of a 3xTF32 backward (each product's operands split into TF32 hi and lo
parts, lo x lo dropped, sums in fp32) against float64 gradients.

The kernel's algebra, emulated in plain torch (``test_torch_flash_bwd``'s
``_backward_tiles`` with 3xTF32 products), lies within the bound at every
element over 50 seeds at d 20 (the reduced smollm's h 3 / m 1) and d 64
(smollm's h 15 / m 5); a planted kernel that drops the hi x lo terms
(one-pass TF32 products) misses it on every seed.  ``chip_smoke.py``
holds the CUDA kernel's float64 error to the same bound on the card.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import fold_gqa
from repro_torch.kernels.flash_attention.ref import bwd_error_bound
from test_torch_attention import _mm_3xtf32, _mm_tf32
from test_torch_flash_bwd import _backward_tiles, _inputs, _unfold

SEEDS = 50


def _ratio(got, exact, bound) -> float:
    """The largest error over its bound, over the three gradients."""
    return max(float(((g.double() - e).abs() / b).max())
               for g, e, b in zip(got, exact, bound))


@pytest.mark.parametrize("b,s,h,m,d", [(1, 64, 3, 1, 20),
                                       (1, 64, 15, 5, 64)],
                         ids=["d20_h3_m1", "d64_h15_m5"])
def test_3xtf32_backward_within_the_bound_and_one_pass_tf32_not(b, s, h, m,
                                                                d):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        worst, planted = 0.0, float("inf")
        for seed in range(SEEDS):
            q, k, v, do = _inputs(b, s, h, m, d, seed)
            exact, bound = bwd_error_bound(q, k, v, do, causal=True)
            qf, kf, vf = fold_gqa(q, k, v)
            dof = do.transpose(1, 2).reshape(b * h, s, d)
            ratios = []
            for mm in (_mm_3xtf32, _mm_tf32):
                dq, dk, dv = _backward_tiles(qf, kf, vf, dof, causal=True,
                                             mm=mm, group=h // m)
                ratios.append(_ratio((_unfold(dq, b, h), _unfold(dk, b, m),
                                      _unfold(dv, b, m)), exact, bound))
            worst, planted = max(worst, ratios[0]), min(planted, ratios[1])
        assert worst <= 1.0, worst          # measured about 0.01
        assert planted > 1.0, planted       # measured 7.6 (d 64), 15 (d 20)
    finally:
        torch.set_num_threads(n)


def _float64_grads(q, k, v, do, causal: bool):
    """Autograd of attention computed in float64 end to end."""
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    b, s, h, d = q.shape
    qf, kf, vf = fold_gqa(*leaves)
    sc = torch.einsum("bqd,bkd->bqk", qf, kf) * d ** -0.5
    if causal:
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                            float("-inf"))
    o = torch.einsum("bqk,bkd->bqd", sc.softmax(dim=-1), vf)
    o = o.reshape(b, h, s, -1).transpose(1, 2)
    return torch.autograd.grad(o, leaves, do.double())


def test_bound_gradients_are_the_float64_gradients():
    """The bound's own float64 gradients are autograd's of float64
    attention (so it bounds the error against the exact function), GQA
    groups and a full (non-causal) mask included, and every bound is
    positive."""
    q, k, v, do = _inputs(2, 47, 4, 2, 24, seed=3)
    for causal in (True, False):
        exact, bound = bwd_error_bound(q, k, v, do, causal=causal)
        want = _float64_grads(q, k, v, do, causal)
        for e, w, bd in zip(exact, want, bound):
            assert e.shape == w.shape == bd.shape
            assert torch.allclose(e, w, rtol=1e-12, atol=1e-14)
            assert bool((bd > 0).all())
