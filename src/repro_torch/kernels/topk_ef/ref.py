"""Plain PyTorch top-k threshold filter with residual (the one statement of
its math in the port; the CPU path runs it and ``chip_smoke.py`` holds the
CUDA kernel of ``csrc/topk_ef.cu`` against it on the card, bitwise)."""
from __future__ import annotations

import torch


def topk_tau_ref(x: torch.Tensor, k: int) -> torch.Tensor:
    """tau = k-th largest |x| over the flat tensor (1 <= k <= n), as a 0-d
    tensor on x's device (no host synchronisation)."""
    a = x.to(torch.float32).abs().reshape(-1)
    return torch.topk(a, k).values[-1]


def topk_ef_ref(x: torch.Tensor, tau: torch.Tensor):
    """(kept, residual): keep |x| >= tau (ties all kept), rest to residual.

    Each element lands unmodified in exactly one output, so
    ``kept + residual == x`` holds bitwise.
    """
    xf = x.to(torch.float32)
    keep = xf.abs() >= tau
    zero = torch.zeros((), dtype=torch.float32, device=xf.device)
    return torch.where(keep, xf, zero), torch.where(keep, zero, xf)
