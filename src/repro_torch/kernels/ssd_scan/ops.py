"""Public SSD scan on the model's layout: x (b, s, h, p), dt (b, s, h),
a_log (h,), B/C (b, s, n) -> (y (b, s, h, p) fp32, state (b, h, p, n) fp32).

A CUDA tensor goes to the CUDA kernel, which reads every input in place
and B/C at batch row ``bh // h``.  A CPU tensor takes the chunked plain
version (``ref.ssd_scan_chunked``, the JAX model's ``ssd_scan``).  The
tensor's device decides; nothing falls back.  ``ssd_scan_recurrence`` is
the exact recurrence behind the JAX wrapper's plumbing (heads folded into
the batch, B/C broadcast over the heads), for holding either one.

The kernel has no backward yet: on a non-CPU tensor, a call that autograd
would have to differentiate raises (ROADMAP.md queue A6, SSD backward)
instead of handing back an output no gradient flows through.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
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


SSD_BACKWARD_ITEM = "ROADMAP.md queue A6, SSD backward"


def check_no_grad(*tensors) -> None:
    """Raise when grad mode is on and any input requires grad: the CUDA
    scan sits outside autograd."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"ssd_scan_fused: the SSD scan kernel has no backward yet "
            f"({SSD_BACKWARD_ITEM}); training the ssm and hybrid families "
            f"runs on the CPU only")


def ssd_scan_fused(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
                   init_state: torch.Tensor | None = None):
    """The model-facing contract of the JAX package's ``ssd_scan_fused``
    (plus ``init_state``).  ``chunk`` is the plain version's; the kernel
    takes its own (the rounding moves, not the function)."""
    if x.device.type != "cpu":
        check_no_grad(x, dt, a_log, B, C, init_state)
        return ssd_scan_kernel(x, dt, decay_rates(a_log), B, C, init_state)
    return ssd_scan_chunked(x, dt, a_log, B, C, chunk, init_state)
