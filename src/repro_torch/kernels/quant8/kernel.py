"""Wrappers of the CUDA blockwise int8 kernels (``csrc/quant8.cu``).

Each wrapper takes flat fp32 CUDA tensors, checks what the kernel takes
(device, dtype, shape, contiguity, 16-byte alignment), allocates the
outputs with ``torch.empty``, launches on the current stream, raises if the
launch was refused, and adds one to its entry of :data:`launches`.  Outputs
cover the ``ceil(n/256)`` real blocks only: codes ``(blocks, 256)`` int8
(the tail block's padding codes are 0), scales ``(blocks, 1)`` fp32, and
the dequantized values and residual as ``(n,)`` fp32.

The kernels replace the Pallas TPU kernels of the JAX package's
``kernels/quant8/kernel.py`` (see the note at the top of the ``.cu``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_launch, load

BLOCK = 256          # quantization block (elements)

#: launches per wrapper since the last reset (chip_smoke reads these to
#: show that the main path went through the kernels)
launches = {"quantize8_ef": 0, "quantize8": 0, "dequantize8": 0}

_P, _N = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {
    "quantize8_ef_launch": [_P, _P, _P, _P, _P, _N, _P],
    "quantize8_launch": [_P, _P, _P, _N, _P],
    "dequantize8_launch": [_P, _P, _P, _N, _P],
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, dim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel takes a CUDA tensor, "
                         f"got one on {t.device}")
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{what}: want a contiguous {dim}-d {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: the kernel needs 16-byte aligned data")


def _launch(fn: str, what: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(load("quant8", _SIGNATURES), fn)(*args, stream)
    check_launch(rc, what)
    launches[what] += 1


def _blocks(n: int) -> int:
    return -(-n // BLOCK)


def quantize8_ef_kernel(x: torch.Tensor):
    """x (n,) fp32 -> (codes, scales, deq (n,), residual (n,)) in one pass."""
    _check(x, "quantize8_ef", torch.float32, 1)
    n, dev = x.numel(), x.device
    q = torch.empty((_blocks(n), BLOCK), dtype=torch.int8, device=dev)
    s = torch.empty((_blocks(n), 1), dtype=torch.float32, device=dev)
    deq = torch.empty(n, dtype=torch.float32, device=dev)
    res = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        _launch("quantize8_ef_launch", "quantize8_ef", dev, x.data_ptr(),
                q.data_ptr(), s.data_ptr(), deq.data_ptr(), res.data_ptr(), n)
    return q, s, deq, res


def quantize8_kernel(x: torch.Tensor):
    """x (n,) fp32 -> (codes (blocks, 256) int8, scales (blocks, 1))."""
    _check(x, "quantize8", torch.float32, 1)
    n, dev = x.numel(), x.device
    q = torch.empty((_blocks(n), BLOCK), dtype=torch.int8, device=dev)
    s = torch.empty((_blocks(n), 1), dtype=torch.float32, device=dev)
    if n:
        _launch("quantize8_launch", "quantize8", dev, x.data_ptr(),
                q.data_ptr(), s.data_ptr(), n)
    return q, s


def dequantize8_kernel(q: torch.Tensor, s: torch.Tensor, n: int):
    """codes (blocks, 256) int8, scales (blocks, 1) -> values (n,) fp32."""
    _check(q, "dequantize8", torch.int8, 2)
    _check(s, "dequantize8", torch.float32, 2)
    blocks = q.shape[0]
    if (q.shape[1] != BLOCK or s.shape != (blocks, 1)
            or _blocks(int(n)) != blocks or s.device != q.device):
        raise ValueError(f"dequantize8: codes {tuple(q.shape)} and scales "
                         f"{tuple(s.shape)} do not hold {n} elements")
    out = torch.empty(int(n), dtype=torch.float32, device=q.device)
    if n:
        _launch("dequantize8_launch", "dequantize8", q.device, q.data_ptr(),
                s.data_ptr(), out.data_ptr(), int(n))
    return out
