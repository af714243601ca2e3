"""Public flash attention on the model's layout, with GQA.

A CUDA tensor goes to the CUDA kernel, which reads q (b, sq, h, dk), k (b,
sk, m, dk) and v (b, sk, m, dv) in place and maps query head i to kv head
i // g (dk and dv may differ: MLA's prefill attends at 192 / 128).  A CPU
tensor takes the plain version on the folded layout, with the JAX
wrapper's plumbing: heads flattened into the batch, each kv head repeated
g times.  The tensor's device decides; nothing falls back.

Gradients: on the card, when grad mode is on and q, k or v requires grad,
the call goes through :class:`FlashAttention`, whose forward is the CUDA
kernel (keeping each row's log-sum-exp) and whose backward is the CUDA
backward kernel, at every width the forward takes (dk and dv up to 192;
wider is refused with ``ValueError`` before any kernel runs).  On the CPU
autograd differentiates the plain version (:func:`flash_attention_bwd_plain`
states that gradient).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    FLASH_MAX_HEAD_DIM, check_attention_shapes, flash_attention_bwd_kernel,
    flash_attention_kernel,
)
from repro_torch.kernels.flash_attention.ref import attention_ref


def fold_gqa(q, k, v):
    """(b, sq, h, dk), (b, sk, m, dk), (b, sk, m, dv) -> (b*h, sq, dk),
    (b*h, sk, dk), (b*h, sk, dv).

    k and v are widened to at least fp32 before the repeat (a no-op in
    fp32 and float64), so that under autograd each kv head's gradient is
    summed over its g query heads in fp32 and rounded once, as the JAX
    model's einsum sums over the group; q keeps its dtype, which decides
    ``attention_ref``'s rounding."""
    b, sq, h, d = q.shape
    sk, m, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // m
    wide = torch.promote_types(k.dtype, torch.float32)
    qf = q.transpose(1, 2).reshape(b * h, sq, d)
    kf = (k.to(wide).transpose(1, 2).repeat_interleave(g, dim=1)
          .reshape(b * h, sk, d))
    vf = (v.to(wide).transpose(1, 2).repeat_interleave(g, dim=1)
          .reshape(b * h, sk, dv))
    return qf, kf, vf


def flash_attention_plain(q, k, v, *, causal: bool) -> torch.Tensor:
    """The plain version on any device: fold, ``attention_ref``, unfold;
    -> (b, sq, h, dv).  In bf16 it is the JAX model's ``_sdpa`` rounding
    for rounding (the divisor bf16(sqrt dk))."""
    b, sq, h, d = q.shape
    o = attention_ref(*fold_gqa(q, k, v), causal=causal, sm_scale=d ** -0.5)
    return o.reshape(b, h, sq, v.shape[-1]).transpose(1, 2)


def flash_attention_bwd_plain(q, k, v, do, *, causal: bool):
    """(dq, dk, dv): autograd of :func:`flash_attention_plain` at q, k, v
    for the upstream gradient ``do`` -- what the backward kernel computes.
    In bf16 that is ``jax.vjp`` of the JAX model's ``_sdpa``: dP_b =
    bf16(dO V^T), dV = bf16(P_b^T dO), D = rowsum(P dP_b) in fp32, dS = P
    (dP_b - D) (zero under the mask), dS_1 = bf16(bf16(dS) / bf16(sqrt
    dk)), dQ = bf16(dS_1 K), dK = bf16(dS_1^T Q), dk and dv summed over the
    GQA group in fp32 and rounded once.  dk and dv may differ: dq and dk
    come at dk, dv at dv."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = flash_attention_plain(*leaves, causal=causal)
        return torch.autograd.grad(o, leaves, do)


class FlashAttention(torch.autograd.Function):
    """The CUDA forward and backward kernels as one differentiable call."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_attention_kernel(q, k, v, causal=causal,
                                        with_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        if do.stride(-1) != 1:           # the kernel reads head_dim in rows
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd_kernel(q, k, v, do, lse,
                                                causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (b, sq, h, dk), k (b, sk, m, dk), v (b, sk, m, dv) with h % m == 0
    (GQA) -> (b, sq, h, dv) in q's dtype.  Off the CPU the widths are
    checked first (dk and dv up to ``FLASH_MAX_HEAD_DIM``, ``ValueError``
    before any kernel)."""
    if q.device.type != "cpu":
        check_attention_shapes("flash_attention", q, k, v,
                               max_head_dim=FLASH_MAX_HEAD_DIM, v_width=True)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            return FlashAttention.apply(q, k, v, causal)
        return flash_attention_kernel(q, k, v, causal=causal)
    return flash_attention_plain(q, k, v, causal=causal)
