"""Wrapper of the CUDA SSD scan kernel (``csrc/ssd_scan.cu``).

The wrapper takes x (b, s, h, p), dt (b, s, h), A (h,) and B/C (b, s, n)
on one card, in the model's layout (p and n contiguous, any other
strides: B and C are read at batch row ``bh // h``, never broadcast over
the heads), and an optional fp32 initial state (b, h, p, n).  It checks
what the kernel takes, allocates y (b, s, h, p) and the final state
(b, h, p, n), both fp32, and one fp32 scratch tensor for every chunk's
own state, C B^T per (b, chunk) and every chunk's decay
(:func:`scratch_floats`) with ``torch.empty``, picks the 16-byte copies
the layouts allow, makes the kernel's three launches on the current
stream, raises if one was refused, and adds one to :data:`launches`.  It
replaces the Pallas TPU kernel of the JAX package's
``kernels/ssd_scan/kernel.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_launch, load

#: launches since the last reset (chip_smoke reads it)
launches = {"ssd_scan": 0}

MAX_HEAD_DIM = 128
MAX_STATE = 128
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's chunk
CHUNK = 64

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ssd_scan_launch": [
    _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
    ctypes.POINTER(ctypes.c_longlong), _P]}


def n_chunks(s: int) -> int:
    """The kernel's chunks over s positions (the last one may be ragged)."""
    return -(-s // CHUNK)


def scratch_floats(b: int, s: int, h: int, p: int, n: int) -> int:
    """Every (b, h, chunk)'s own state (p and n padded to multiples of 32),
    C B^T per (b, chunk), and every (b, h, chunk)'s decay exp(cum_end)."""
    nc = n_chunks(s)
    pad = lambda v: -(-v // 32) * 32  # noqa: E731
    return b * h * nc * pad(p) * pad(n) + b * nc * CHUNK * CHUNK + b * h * nc


def aligned16(t: torch.Tensor) -> bool:
    """Rows of ``t``'s last dim may be copied 16 bytes at a time: the row,
    every other stride and the address are multiples of 16 bytes."""
    es = t.element_size()
    return all(x % 16 == 0 for x in (t.shape[-1] * es, t.data_ptr(),
                                     *(st * es for st in t.stride()[:-1])))


def reset_launches() -> None:
    launches["ssd_scan"] = 0


def _check(x, dt, A, B, C, init_state) -> None:
    ts = [x, dt, A, B, C] + ([] if init_state is None else [init_state])
    if any(t.device.type != "cuda" or t.device != x.device for t in ts):
        raise ValueError("ssd_scan: the CUDA kernel takes CUDA tensors on one "
                         "card, got " + "/".join(str(t.device) for t in ts))
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan: want x, B, C float32 or bfloat16 alike, "
                         f"got {x.dtype}/{B.dtype}/{C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"ssd_scan: want dt and A in float32, got "
                         f"{dt.dtype}/{A.dtype}")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3:
        raise ValueError("ssd_scan: want x (b, s, h, p), dt (b, s, h), "
                         "A (h,), B/C (b, s, n)")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if (dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, n)
            or C.shape != B.shape):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)} do not match")
    if not (1 <= p <= MAX_HEAD_DIM and 1 <= n <= MAX_STATE):
        raise ValueError(f"ssd_scan: head_dim {p} or state {n} not in "
                         f"[1, {MAX_HEAD_DIM}] / [1, {MAX_STATE}]")
    if x.stride(-1) != 1 or B.stride(-1) != 1 or C.stride(-1) != 1:
        raise ValueError("ssd_scan: head_dim of x and the state dim of B/C "
                         "must be contiguous")
    if not A.is_contiguous():
        raise ValueError("ssd_scan: A must be contiguous")
    if init_state is not None and (
            init_state.dtype != torch.float32
            or init_state.shape != (b, h, p, n)
            or not init_state.is_contiguous()):
        raise ValueError(f"ssd_scan: init_state must be a contiguous float32 "
                         f"(b, h, p, n) = {(b, h, p, n)}, got "
                         f"{init_state.dtype} {tuple(init_state.shape)}")


def ssd_scan_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor,
                    init_state: torch.Tensor | None = None):
    """x (b, s, h, p); dt (b, s, h) fp32; A (h,) fp32, negative; B/C
    (b, s, n); init_state (b, h, p, n) fp32 or None (zeros) ->
    (y (b, s, h, p) fp32, final state (b, h, p, n) fp32)."""
    _check(x, dt, A, B, C, init_state)
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if b * h == 0:
        return y, state
    scratch = torch.empty(max(scratch_floats(b, s, h, p, n), 1),
                          dtype=torch.float32, device=x.device)
    vec = aligned16(x) | aligned16(B) << 1 | aligned16(C) << 2
    strides = (ctypes.c_longlong * 10)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = load("ssd_scan", _SIGNATURES).ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
            DTYPE_CODES[x.dtype], b, h, s, p, n, vec, strides, stream)
    check_launch(rc, "ssd_scan")
    launches["ssd_scan"] += 1
    return y, state
