"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

The wrapper takes q (b, sq, h, d) and k/v (b, sk, m, d) on one card, in
the model's layout (any batch/position/head strides, head_dim contiguous),
checks what the kernel takes, allocates o (b, sq, h, d) with
``torch.empty``, launches on the current stream, raises if the launch was
refused, and adds one to :data:`launches`.  It replaces the Pallas TPU
kernel of the JAX package's ``kernels/flash_attention/kernel.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_launch, load

#: launches since the last reset (chip_smoke reads it)
launches = {"flash_attention": 0}

MAX_HEAD_DIM = 128
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"flash_attention_launch": [
    _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, _I, _P]}


def reset_launches() -> None:
    launches["flash_attention"] = 0


def check_attention_inputs(what: str, q, k, v) -> None:
    """The checks both attention kernels share: one card, one supported
    dtype, head_dim contiguous and <= 128, k and v alike, GQA heads."""
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors on "
                             f"one card, got {q.device}/{k.device}/{v.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPE_CODES:
            raise ValueError(f"{what}: want float32 or bfloat16 alike, got "
                             f"{q.dtype}/{k.dtype}/{v.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: head_dim must be contiguous")
    d = q.shape[-1]
    if k.shape != v.shape or k.shape[-1] != d or k.shape[0] != q.shape[0]:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head_dim {d} not in [1, {MAX_HEAD_DIM}]")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool) -> torch.Tensor:
    """q (b, sq, h, d), k/v (b, sk, m, d), h % m == 0 -> o (b, sq, h, d)
    in q's dtype; sm_scale = d**-0.5; causal keeps qpos >= kpos."""
    check_attention_inputs("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: want q (b, sq, h, d) and k/v "
                         "(b, sk, m, d)")
    b, sq, h, d = q.shape
    sk, m = k.shape[1], k.shape[2]
    if h % m or sk < 1:
        raise ValueError(f"flash_attention: {h} query heads over {m} kv "
                         f"heads, {sk} keys")
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = load("flash_attention", _SIGNATURES).flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            DTYPE_CODES[q.dtype], b, h, m, sq, sk, d, strides, d ** -0.5,
            int(causal), stream)
    check_launch(rc, "flash_attention")
    launches["flash_attention"] += 1
    return o
