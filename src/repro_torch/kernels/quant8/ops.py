"""Public any-shape quantizer: flat fp32 vectors <-> 256-element blocks.

A CUDA tensor goes to the CUDA kernels (:mod:`.kernel`), which mask the
ragged tail block themselves.  A CPU tensor goes to the plain versions
(:mod:`.ref`) through :func:`pad_blocks`: the flat tensor is zero-padded to
a multiple of 256 and viewed as ``(blocks, 256)``.  Zero padding never
changes a block's max-abs, so the codes, scales, dequantized values and
residuals of the real elements equal the unpadded math bitwise, and the
returned codes and scales cover the ``ceil(n/256)`` real blocks only.
There is no backend switch: the tensor's device decides.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant8.kernel import (
    BLOCK, dequantize8_kernel, quantize8_ef_kernel, quantize8_kernel,
)
from repro_torch.kernels.quant8.ref import (
    dequantize8_ref, quantize8_ef_ref, quantize8_ref,
)


def pad_blocks(flat: torch.Tensor) -> torch.Tensor:
    """flat (n,) -> zero-padded (ceil(n/256), 256) tiles."""
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).reshape(-1).contiguous()


# plain versions of the kernel wrappers, on the flat vector (any device):
# what the CPU path runs and what chip_smoke.py holds the kernels against

def quantize8_ef_plain(flat: torch.Tensor):
    n = flat.numel()
    q, s, deq, res = quantize8_ef_ref(pad_blocks(flat))
    return q, s, deq.reshape(-1)[:n], res.reshape(-1)[:n]


def quantize8_plain(flat: torch.Tensor):
    return quantize8_ref(pad_blocks(flat))


def dequantize8_plain(q: torch.Tensor, s: torch.Tensor, n: int):
    return dequantize8_ref(q, s).reshape(-1)[:n]


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def quantize8(x: torch.Tensor):
    """Any-shape fp tensor -> (codes int8 (blocks, 256), scales (blocks, 1))."""
    flat = _flat(x)
    return (quantize8_plain if _on_cpu(flat) else quantize8_kernel)(flat)


def dequantize8(q: torch.Tensor, s: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= int(d)
    fn = dequantize8_plain if _on_cpu(q) else dequantize8_kernel
    return fn(q, s, n).reshape(tuple(shape))


def int8_roundtrip(x: torch.Tensor):
    """Fused EF quantize of any-shape x.

    Returns (codes (blocks, 256) int8, scales (blocks, 1) f32, deq shaped
    like x, residual shaped like x), with residual == x - deq bitwise.  One
    fused kernel pass on CUDA.
    """
    flat = _flat(x)
    fn = quantize8_ef_plain if _on_cpu(flat) else quantize8_ef_kernel
    q, s, deq, err = fn(flat)
    return q, s, deq.reshape(x.shape), err.reshape(x.shape)
