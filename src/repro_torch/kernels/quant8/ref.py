"""Plain PyTorch versions of the blockwise int8 quantizer (the one statement
of its math in the port).

The CPU path of :mod:`.ops` runs these, the tests hold them against the
JAX package bitwise, and ``chip_smoke.py`` holds the CUDA kernels of
``csrc/quant8.cu`` against them on the card, bitwise.

The scale is ``max|x| * fp32(1/127)``, a multiply by the reciprocal: that
is what the JAX reference computes, because XLA rewrites its division by
the constant 127 into that multiply.  ``x / scale`` is a tensor-by-tensor
division, a true IEEE division on every device (on CUDA, PyTorch turns a
division by a Python scalar into a multiply by its reciprocal).
``torch.round`` rounds half to even, like ``jnp.round`` and the kernels'
``rintf``.
"""
from __future__ import annotations

import torch

#: 1/127, rounded to fp32 (bits 0x3c010204) where it is used -- the CUDA
#: kernels' ``kInv127``
INV127 = 1 / 127


def quantize8_ref(x: torch.Tensor, axis: int = -1):
    """x (.., n) -> (q int8, scales (.., 1)) with one scale per `axis` slice."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=axis, keepdim=True).clamp_min(1e-12)
    scale = amax * torch.full((), INV127, dtype=torch.float32,
                              device=x.device)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize8_ref(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * s


def quantize8_ef_ref(x: torch.Tensor, axis: int = -1):
    """Error-feedback variant: (q, scale, deq, residual), with
    ``residual = x - deq`` from the emitted deq."""
    q, scale = quantize8_ref(x, axis=axis)
    deq = dequantize8_ref(q, scale)
    return q, scale, deq, x.to(torch.float32) - deq
