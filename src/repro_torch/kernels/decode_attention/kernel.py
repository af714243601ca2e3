"""Wrapper of the CUDA flash-decoding kernel (``csrc/decode_attention.cu``).

The wrapper takes one query step q (b, h, d) and the KV cache k/v
(b, S, m, d) on one card, in the model's layout (head_dim contiguous, any
other strides: the cache is read in place, never transposed), and the
valid prefix ``length`` as a Python int (no host sync).  It checks what
the kernel takes, plans the split of the prefix over blocks
(:func:`plan_splits`), picks the widest copy the cache's layout allows
(:func:`copy_bytes`), allocates o (b, h, d) and, for more than one split,
the fp32 partials with ``torch.empty``, launches once on the current
stream (bf16: twice, statistics then P_b V, with the partials at any
number of splits and a scratch of the rounded scores), raises if a launch
was refused, and adds one to :data:`launches`.  It replaces the Pallas TPU kernel of the JAX package's
``kernels/decode_attention/kernel.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_launch, load, sm_count
from repro_torch.kernels.flash_attention.kernel import (
    DTYPE_CODES, check_attention_inputs,
)
from repro_torch.kernels.flash_attention.ref import bf16_divisor

#: launches since the last reset (chip_smoke reads it)
launches = {"decode_attention": 0}

#: cache positions per tile, query heads per block and blocks per SM the
#: split planner aims at: the kernel's constants
TILE, HEADS_PER_BLOCK, BLOCKS_PER_SM = 64, 8, 3

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"decode_attention_launch": [
    _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_float, _P]}

#: per card: the kernel's ticket counters (int32, zero between calls: the
#: last block of each unit sets its counter back to 0)
_TICKETS: dict[int, torch.Tensor] = {}


def reset_launches() -> None:
    launches["decode_attention"] = 0


def units(b: int, h: int, m: int) -> int:
    """Blocks per split: one per (batch row, kv head, chunk of up to
    HEADS_PER_BLOCK query heads of its group)."""
    return b * m * -(-(h // m) // HEADS_PER_BLOCK)


def plan_splits(n_units: int, length: int, sms: int) -> tuple[int, int]:
    """(n_splits, tiles_per_split) for a prefix of ``length`` positions:
    whole TILE-position tiles, about BLOCKS_PER_SM blocks per SM in all,
    never more splits than tiles and never an empty split; one split for
    at most one tile."""
    tiles = -(-length // TILE)
    want = -(-BLOCKS_PER_SM * sms // max(n_units, 1))
    n = max(1, min(tiles, want))
    per = -(-tiles // n)
    return (-(-tiles // per) if per else 1), per


def copy_bytes(d: int, esize: int, *offsets: int) -> int:
    """The widest copy (16, 8 or 4 bytes; 2 for bfloat16) that divides a
    cache row (d * esize bytes) and every byte offset given (the caches'
    strides and addresses)."""
    for width in (16, 8, 4, 2):
        if width >= esize and all(x % width == 0 for x in (d * esize,
                                                           *offsets)):
            return width
    raise ValueError(f"decode_attention: no copy width fits head_dim {d} "
                     f"and offsets {offsets}")


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    t = _TICKETS.get(device.index)
    if t is None or t.numel() < n:
        t = _TICKETS[device.index] = torch.zeros(n, dtype=torch.int32,
                                                 device=device)
    return t


def decode_attention_kernel(q: torch.Tensor, cache_k: torch.Tensor,
                            cache_v: torch.Tensor, length: int) -> torch.Tensor:
    """q (b, h, d); cache_k/v (b, S, m, d), h % m == 0; positions
    ``>= length`` masked -> o (b, h, d) in q's dtype (bf16: rounded where
    the JAX model's ``gqa_decode`` rounds, ``ref.decode_attention_ref``)."""
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
    n_units = units(b, h, m)
    n_splits, per = plan_splits(n_units, length, sm_count(q.device))
    esize = q.element_size()
    piece = copy_bytes(d, esize, *(st * esize for st in (
        *cache_k.stride()[:3], *cache_v.stride()[:3])),
        cache_k.data_ptr(), cache_v.data_ptr())
    part = tickets = scores = None
    rounds = q.dtype == torch.bfloat16
    if n_splits > 1 or rounds:
        part = torch.empty(n_units * n_splits * HEADS_PER_BLOCK * (d + 2),
                           dtype=torch.float32, device=q.device)
    if n_splits > 1:
        tickets = _tickets(q.device, n_units)
    if rounds:
        scores = torch.empty(max(1, n_units * HEADS_PER_BLOCK * TILE
                                 * -(-length // TILE)),
                             dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 10)(
        *q.stride()[:2], *cache_k.stride()[:3], *cache_v.stride()[:3],
        *o.stride()[:2])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = load("decode_attention", _SIGNATURES).decode_attention_launch(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), o.data_ptr(),
            None if part is None else part.data_ptr(),
            None if tickets is None else tickets.data_ptr(),
            None if scores is None else scores.data_ptr(),
            DTYPE_CODES[q.dtype], b, h, m, length, d, n_splits, per, piece,
            strides, d ** -0.5, bf16_divisor(d ** -0.5), stream)
    check_launch(rc, "decode_attention")
    launches["decode_attention"] += 1
    return o
