"""Public any-shape top-k EF filter.

tau (a global k-selection) is taken with ``torch.topk`` outside the
kernel, as the JAX package takes it with ``lax.top_k``; the threshold
application is where the bytes move.  The filter is elementwise, so no
block padding is needed.  A CUDA tensor goes to the CUDA kernel, a CPU
tensor to the plain version: the tensor's device decides.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.topk_ef.kernel import topk_ef_kernel
from repro_torch.kernels.topk_ef.ref import topk_ef_ref, topk_tau_ref


def topk_ef(x: torch.Tensor, k: int):
    """Keep the >= k largest-|x| elements of any-shape x, zero the rest.

    Returns (kept, residual) both shaped like x with
    ``kept + residual == x`` bitwise.  Ties at the k-th magnitude are all
    kept, so the nonzero count can exceed k on tied data.  k is clamped to
    [1, x.numel()].
    """
    k = max(1, min(int(k), x.numel()))
    flat = x.to(torch.float32).reshape(-1).contiguous()
    tau = topk_tau_ref(flat, k)
    fn = topk_ef_ref if flat.device.type == "cpu" else topk_ef_kernel
    out, res = fn(flat, tau)
    return out.reshape(x.shape), res.reshape(x.shape)
