"""Plain PyTorch attention on the folded layout: the one statement of the
flash kernel's math in the port (``ops`` runs it for CPU tensors, and
``chip_smoke.py`` holds the CUDA kernel of ``csrc/flash_attention.cu``
against it on the card)."""
from __future__ import annotations

import functools

import torch

NEG_INF = -1e30


@functools.lru_cache(maxsize=None)
def bf16_divisor(sm_scale: float) -> float:
    """1 / sm_scale rounded to bfloat16: bf16(sqrt(d)) for sm_scale =
    d**-0.5.  The JAX model divides its bf16 scores by the Python float
    ``dk ** 0.5``, which JAX first rounds to the scores' dtype (8.9375 for
    d = 80, not 8.944; 4.46875 for d = 20; 13.875 for MLA's dk = 192)."""
    return float(torch.tensor(1.0 / sm_scale, dtype=torch.float64)
                 .to(torch.bfloat16))


def round_scores(s: torch.Tensor, dtype, divisor: float) -> torch.Tensor:
    """fp32 scores q.k -> the JAX model's bf16 scores as fp32 values:
    bf16(bf16(s) / divisor), the division in fp32 (by a tensor: on the
    card PyTorch divides by a Python scalar as a multiply)."""
    div = torch.tensor(divisor, dtype=torch.float32, device=s.device)
    return (s.to(dtype).float() / div).to(dtype).float()


def attention_ref(q, k, v, *, causal: bool, sm_scale: float):
    """q (bh, sq, dk), k (bh, sk, dk), v (bh, sk, dv) -> (bh, sq, dv) in
    q's dtype; a causal mask keeps ``qpos >= kpos`` (top-left aligned).

    q's dtype decides the function.  float32: the scores times sm_scale,
    an fp32 softmax, P V in fp32.  bfloat16: the JAX model's ``_sdpa``,
    rounding where it rounds -- scores bf16(bf16(q.k) / bf16(1/sm_scale)),
    masked to -1e30 after the rounding, an fp32 softmax, P rounded to bf16,
    P V summed in fp32 and rounded once.  k and v may come widened to fp32
    (``ops.fold_gqa`` widens them before its GQA repeat); their values are
    bf16's all the same."""
    if q.dtype == torch.bfloat16:
        s = round_scores(torch.einsum("bqd,bkd->bqk", q.float(), k.float()),
                         q.dtype, bf16_divisor(sm_scale))
    else:
        s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~mask[None], NEG_INF)
    if q.dtype == torch.bfloat16:
        p = torch.softmax(s, dim=-1).to(q.dtype).float()
    else:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


# ---------------------------------------------- the backward's error bound --

#: fp32's unit roundoff, and the most one fp32 addition of the tensor cores
#: can err (they may truncate where they add: one ulp, not half)
FP32_U = 2.0 ** -24
ACC_U = 2.0 ** -23
#: one 3xTF32 product a*b: the lo x lo term it drops and the bits the
#: tensor cores drop from each lo part, each under 2^-22 |a b|
TF32X3_PRODUCT = 3 * 2.0 ** -22


def _gemm_err(n: int) -> float:
    """Relative (to |A| |B|) error of an n-term 3xTF32 product summed in
    fp32: each product's error, n additions, and the hi x hi and small
    products' sums added with rounding."""
    return TF32X3_PRODUCT + (n + 2) * ACC_U


def bwd_error_bound(q, k, v, do, *, causal: bool, heads_per_chunk: int = 8):
    """float64 gradients of fp32 attention and, element by element, a bound
    on the error of the 3xTF32 backward kernel (``csrc/flash_attention_bwd.cu``)
    against them: -> ((dq, dk, dv), (dq_bound, dk_bound, dv_bound)), each
    float64 in the layout of q, k and v (b, s, heads, d).

    A first-order running bound, every term from float64 values and
    absolute-value products (sigma = dk^-1/2, e(n) = :func:`_gemm_err`):
    S = sigma Q K^T errs by dS_ = sigma e(dk) |Q| |K|^T; P = P~ / l, with
    P~ = exp2 of the rounded scaled score less the forward's log-sum-exp
    (an offset that l's renormalisation cancels), errs relatively by
    dS_ij + sum_k P_ik dS_ik (the renormalisation) + 2u (|S_ij| + |lse_i|)
    (the exponent's rounding) + (sk + 4) u (exp2, l's sum, the division);
    dP = dO V^T by e(dv) |dO| |V|^T; D = rowsum(P dP) by the errors of its
    terms plus (sk + 1) u rowsum(P |dP|); dS = P (dP - D) by those terms
    plus 2u; then dV = P^T dO, dQ = sigma dS K and dK = sigma dS^T Q each
    by its inputs' errors through |.| products plus e(n) of its own sum; a
    GQA group's dk and dv add their heads' bounds and g u of their sum.
    The kernel's float64 error must lie within this at every element."""
    b, sq, h, dk = q.shape
    sk, m, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // m
    sigma = dk ** -0.5
    u = FP32_U

    def fold(x, heads):         # (b, s, heads, d) -> (b*h, s, d), float64
        x = x.double().transpose(1, 2)
        if heads != h:
            x = x.repeat_interleave(g, dim=1)
        return x.reshape(b * h, x.shape[2], x.shape[3])

    Q, K, V, dO = fold(q, h), fold(k, m), fold(v, m), fold(do, h)
    keep = None
    if causal:
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
    out = [torch.empty_like(Q), torch.empty_like(K), torch.empty_like(V)]
    bnd = [torch.empty_like(Q), torch.empty_like(K), torch.empty_like(V)]
    for c0 in range(0, b * h, heads_per_chunk):
        cs = slice(c0, c0 + heads_per_chunk)
        q_, k_, v_, do_ = Q[cs], K[cs], V[cs], dO[cs]
        s = sigma * (q_ @ k_.transpose(1, 2))
        if keep is not None:
            s = s.masked_fill(~keep, float("-inf"))
        lse = torch.logsumexp(s, dim=-1, keepdim=True)
        p = torch.exp(s - lse)
        s = s.masked_fill(p == 0, 0.0)
        d_s = sigma * _gemm_err(dk) * (q_.abs() @ k_.abs().transpose(1, 2))
        d_s = d_s * (p > 0)
        rel = d_s + (p * d_s).sum(-1, keepdim=True) \
            + 2 * u * (s.abs() + lse.abs()) + (sk + 4) * u
        d_p = p * rel
        dp = do_ @ v_.transpose(1, 2)
        d_dp = _gemm_err(dv) * (do_.abs() @ v_.abs().transpose(1, 2))
        dd = (p * dp).sum(-1, keepdim=True)
        d_dd = (d_p * dp.abs() + p * d_dp).sum(-1, keepdim=True) \
            + (sk + 1) * u * (p * dp.abs()).sum(-1, keepdim=True)
        gap = dp - dd
        ds = p * gap
        d_ds = d_p * gap.abs() + p * (d_dp + d_dd) + 2 * u * ds.abs()
        out[2][cs] = p.transpose(1, 2) @ do_
        bnd[2][cs] = d_p.transpose(1, 2) @ do_.abs() \
            + _gemm_err(sq) * (p.transpose(1, 2) @ do_.abs())
        out[0][cs] = sigma * (ds @ k_)
        bnd[0][cs] = sigma * (d_ds @ k_.abs()
                              + _gemm_err(sk) * (ds.abs() @ k_.abs()))
        out[1][cs] = sigma * (ds.transpose(1, 2) @ q_)
        bnd[1][cs] = sigma * (d_ds.transpose(1, 2) @ q_.abs()
                              + _gemm_err(sq) * (ds.abs().transpose(1, 2)
                                                 @ q_.abs()))

    def unfold(x, heads):       # (b*h, s, d) -> (b, s, heads, d), groups summed
        x = x.reshape(b, h, *x.shape[1:])
        if heads != h:
            x = x.reshape(b, heads, g, *x.shape[2:]).sum(dim=2)
        return x.transpose(1, 2)

    grads = (unfold(out[0], h), unfold(out[1], m), unfold(out[2], m))
    bounds = [unfold(bnd[0], h), unfold(bnd[1], m), unfold(bnd[2], m)]
    for i, (heads, x) in ((1, (m, out[1])), (2, (m, out[2]))):
        # the group's sum in fp32, and every gradient's own rounding
        bounds[i] = bounds[i] + g * u * unfold(x.abs(), heads)
    bounds = tuple(x + u * y.abs() for x, y in zip(bounds, grads))
    return grads, bounds
