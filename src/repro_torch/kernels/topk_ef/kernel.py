"""Wrapper of the CUDA top-k EF threshold kernel (``csrc/topk_ef.cu``).

The wrapper takes a flat fp32 CUDA tensor and the threshold as a 0-d fp32
CUDA tensor, checks what the kernel takes, allocates ``kept`` and
``residual`` with ``torch.empty``, launches on the current stream, raises
if the launch was refused, and adds one to :data:`launches`.  It replaces
the Pallas TPU kernel of the JAX package's ``kernels/topk_ef/kernel.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_launch, load

#: launches since the last reset (chip_smoke reads it)
launches = {"topk_ef": 0}

_P, _N = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {"topk_ef_launch": [_P, _P, _P, _P, _N, _P]}


def reset_launches() -> None:
    launches["topk_ef"] = 0


def topk_ef_kernel(x: torch.Tensor, tau: torch.Tensor):
    """x (n,) fp32, tau 0-d fp32 on the same card -> (kept (n,), residual)."""
    if x.device.type != "cuda":
        raise ValueError(f"topk_ef: the CUDA kernel takes a CUDA tensor, "
                         f"got one on {x.device}")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"topk_ef: want a contiguous 1-d float32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("topk_ef: the kernel needs 16-byte aligned data")
    if (tau.device != x.device or tau.dtype != torch.float32
            or tau.numel() != 1):
        raise ValueError(f"topk_ef: tau must be one float32 on {x.device}")
    n = x.numel()
    kept = torch.empty_like(x)
    res = torch.empty_like(x)
    if n:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = load("topk_ef", _SIGNATURES).topk_ef_launch(
                x.data_ptr(), tau.data_ptr(), kept.data_ptr(), res.data_ptr(),
                n, stream)
        check_launch(rc, "topk_ef")
        launches["topk_ef"] += 1
    return kept, res
