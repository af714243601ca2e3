"""Public SSD scan on the model's layout: x (b, s, h, p), dt (b, s, h),
a_log (h,), B/C (b, s, n) -> (y (b, s, h, p) fp32, state (b, h, p, n) fp32).

A CUDA tensor goes to the CUDA kernel, which reads every input in place
and B/C at batch row ``bh // h``.  A CPU tensor takes the chunked plain
version (``ref.ssd_scan_chunked``, the JAX model's ``ssd_scan``).  The
tensor's device decides; nothing falls back.  ``ssd_scan_recurrence`` is
the exact recurrence behind the JAX wrapper's plumbing (heads folded into
the batch, B/C broadcast over the heads), for holding either one.

Gradients: on the card, when grad mode is on and an input requires grad,
the call goes through :class:`SSDScan`, whose forward is the CUDA kernel
(keeping each chunk's entering state when there are several) and whose
backward is the CUDA backward kernel.  On the CPU autograd differentiates
the chunked plain version (``ref.ssd_scan_chunked_bwd`` states that
gradient in closed form).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import (
    ssd_scan_bwd_kernel, ssd_scan_kernel,
)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked, ssd_scan_ref


def decay_rates(a_log: torch.Tensor) -> torch.Tensor:
    """A = -exp(a_log) in fp32 (float64 for float64), one per head."""
    return -torch.exp(a_log.to(torch.promote_types(a_log.dtype,
                                                   torch.float32)))


def fold_heads(x, dt, A, B, C):
    """The JAX wrapper's layout: (b, s, h, p), (b, s, h), (h,), (b, s, n)
    x2 -> (b*h, s, p), (b*h, s), (b*h,), (b*h, s, n) x2."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    xf = x.transpose(1, 2).reshape(b * h, s, p)
    dtf = dt.transpose(1, 2).reshape(b * h, s)
    af = A[None, :].expand(b, h).reshape(b * h)
    Bf = B[:, None].expand(b, h, s, n).reshape(b * h, s, n)
    Cf = C[:, None].expand(b, h, s, n).reshape(b * h, s, n)
    return xf, dtf, af, Bf, Cf


def ssd_scan_recurrence(x, dt, a_log, B, C, init_state=None):
    """The exact sequential recurrence on any device: fold, ``ssd_scan_ref``
    in fp32 (float64 for float64 x), unfold -> (y (b, s, h, p), state
    (b, h, p, n)) in that type."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    ct = torch.promote_types(x.dtype, torch.float32)
    init = None if init_state is None else init_state.reshape(b * h, p, n)
    y, st = ssd_scan_ref(*fold_heads(x.to(ct), dt.to(ct),
                                     decay_rates(a_log.to(ct)), B.to(ct),
                                     C.to(ct)), init)
    return y.reshape(b, h, s, p).transpose(1, 2), st.reshape(b, h, p, n)


class SSDScan(torch.autograd.Function):
    """The CUDA forward and backward kernels as one differentiable call:
    (x, dt, A, B, C, init_state) -> (y, final state)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, init_state):
        y, state, entering = ssd_scan_kernel(x, dt, A, B, C, init_state,
                                             keep_states=True)
        ctx.save_for_backward(x, dt, A, B, C,
                              init_state if entering is None else entering)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, prev = ctx.saved_tensors
        return ssd_scan_bwd_kernel(x, dt, A, B, C, prev, dy, dstate,
                                   with_dinit=ctx.needs_input_grad[5])


def ssd_scan_fused(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
                   init_state: torch.Tensor | None = None):
    """The model-facing contract of the JAX package's ``ssd_scan_fused``
    (plus ``init_state``).  ``chunk`` is the plain version's; the kernel
    takes its own (the rounding moves, not the function)."""
    if x.device.type != "cpu":
        A = decay_rates(a_log)
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (x, dt, a_log, B, C, init_state)):
            return SSDScan.apply(x, dt, A, B, C, init_state)
        return ssd_scan_kernel(x, dt, A, B, C, init_state)
    return ssd_scan_chunked(x, dt, a_log, B, C, chunk, init_state)
