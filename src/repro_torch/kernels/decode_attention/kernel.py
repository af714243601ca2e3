"""Wrapper of the CUDA flash-decoding kernel (``csrc/decode_attention.cu``).

The wrapper takes one query step q (b, h, d) and the KV cache k/v
(b, S, m, d) on one card, in the model's layout (head_dim contiguous, any
other strides: the cache is read in place, never transposed), and the
valid prefix ``length`` as a Python int (no host sync).  It checks what
the kernel takes, allocates o (b, h, d) with ``torch.empty``, launches on
the current stream, raises if the launch was refused, and adds one to
:data:`launches`.  It replaces the Pallas TPU kernel of the JAX package's
``kernels/decode_attention/kernel.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_launch, load
from repro_torch.kernels.flash_attention.kernel import (
    DTYPE_CODES, check_attention_inputs,
)

#: launches since the last reset (chip_smoke reads it)
launches = {"decode_attention": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"decode_attention_launch": [
    _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, _P]}


def reset_launches() -> None:
    launches["decode_attention"] = 0


def decode_attention_kernel(q: torch.Tensor, cache_k: torch.Tensor,
                            cache_v: torch.Tensor, length: int) -> torch.Tensor:
    """q (b, h, d); cache_k/v (b, S, m, d), h % m == 0; positions
    ``>= length`` masked -> o (b, h, d) in q's dtype."""
    check_attention_inputs("decode_attention", q, cache_k, cache_v)
    if q.dim() != 3 or cache_k.dim() != 4:
        raise ValueError("decode_attention: want q (b, h, d) and the cache "
                         "(b, S, m, d)")
    b, h, d = q.shape
    S, m = cache_k.shape[1], cache_k.shape[2]
    length = int(length)
    if h % m or not 0 <= length <= S:
        raise ValueError(f"decode_attention: {h} query heads over {m} kv "
                         f"heads, length {length} of a {S}-position cache")
    o = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 10)(
        *q.stride()[:2], *cache_k.stride()[:3], *cache_v.stride()[:3],
        *o.stride()[:2])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = load("decode_attention", _SIGNATURES).decode_attention_launch(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), o.data_ptr(),
            DTYPE_CODES[q.dtype], b, h, m, length, d, strides, d ** -0.5,
            stream)
    check_launch(rc, "decode_attention")
    launches["decode_attention"] += 1
    return o
