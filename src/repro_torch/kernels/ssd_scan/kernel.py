"""Wrappers of the CUDA SSD scan kernel (``csrc/ssd_scan.cu``) and of its
gradient (``csrc/ssd_scan_bwd.cu``).

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
``kernels/ssd_scan/kernel.py``.  Asked to (``keep_states``), it also hands
back each chunk's entering state, which the backward reads, from its
scratch when there are several chunks.  The backward wrapper takes the
forward's inputs, those entering states (or the initial state) and the
cotangents of y and the final state, and returns (dx, ddt, dA, dB, dC,
d init_state); the JAX package has no backward kernel (its models
differentiate the jnp scan).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_launch, load

#: launches since the last reset (chip_smoke reads it)
launches = {"ssd_scan": 0, "ssd_scan_bwd": 0}

MAX_HEAD_DIM = 128
MAX_STATE = 128
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's chunk
CHUNK = 64

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ssd_scan_launch": [
    _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
    ctypes.POINTER(ctypes.c_longlong), _P]}
_BWD_SIGNATURES = {"ssd_scan_bwd_launch": [
    _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
    _I, _I, _I, ctypes.POINTER(ctypes.c_longlong), _P]}
#: the shared memory a block of the card may take (H100: 227 KB)
MAX_SMEM = 232448


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


def entering_states(scratch: torch.Tensor, b: int, s: int, h: int, p: int,
                    n: int) -> torch.Tensor:
    """Each chunk's entering state (b, h, nc, p, n) from the forward's
    scratch, where the pass launch leaves it in the tensor cores'
    accumulator order: state (pp, nn) as 16 x 8 tiles, row-major over the
    tiles; in a tile lane 4 g + t holds the float4 (g, 2t), (g, 2t + 1),
    (g + 8, 2t), (g + 8, 2t + 1)."""
    nc = n_chunks(s)
    pad = lambda v: -(-v // 32) * 32  # noqa: E731
    pp, nn = pad(p), pad(n)
    st = scratch[:b * h * nc * pp * nn].view(
        b, h, nc, pp // 16, nn // 8, 8, 4, 2, 2)      # R, Cj, g, t, hr, jj
    st = st.permute(0, 1, 2, 3, 7, 5, 4, 6, 8).reshape(b, h, nc, pp, nn)
    return st[..., :p, :n].contiguous()


def bwd_smem_bytes(p: int, n: int) -> int:
    """The shared memory of the backward's largest launch, fp32 tiles with
    padded rows (p and n padded to multiples of 8): the local launch's C
    B^T, the head's dM o L and M (64 x 72 each), x dt and dy (64 x (p +
    4)), float64 decays and sums; the terms launch's dy or x dt (64 x (p +
    8)), C or B (64 x (n + 8)) and S_prev or G (p x (n + 8)); the dB/dC
    launch's summed dM o L (64 x 72) and C or B (64 x (n + 8))."""
    pp, nn = -(-p // 8) * 8, -(-n // 8) * 8
    ld = CHUNK + 8
    local = 8 * (CHUNK * (2 + 4)) + 4 * (3 * CHUNK * ld + 2 * CHUNK * (pp + 4)
                                         + 2 * CHUNK)
    terms = 8 * (CHUNK + 4) + 4 * (CHUNK * (pp + 8) + CHUNK * (nn + 8)
                                   + pp * (nn + 8) + 4 * CHUNK)
    dbc = 4 * CHUNK * (ld + nn + 8)
    return max(local, terms, dbc)


def bwd_scratch_floats(b: int, s: int, h: int, p: int, n: int,
                       states: bool, terms: bool) -> int:
    """C B^T per (b, chunk) and each head's dM o L (b, nc, h, 64, 64);
    with ``terms`` (an entering state or a state gradient somewhere) a
    float64 per (b, h, chunk) (an even count, so the rest stays 16-byte
    aligned), each head's W xc G and e Z (b, s, h, n), W B G^T (b, s, h,
    p) and the segment terms (b, s, h, 2); with ``states`` (several
    chunks, or the initial state's gradient wanted) each chunk's sum_t e_t
    dy_t C_t^T and state gradient (b, h, nc, p, n) and its decay."""
    nc = n_chunks(s)
    out = b * nc * CHUNK * CHUNK * (1 + h)
    if terms:
        out += 2 * (-(-b * h * nc // 2) * 2) + b * s * h * (2 * n + p + 2)
    if states:
        out += 2 * b * h * nc * p * n + b * h * nc
    return out


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


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


def _strides(x, dt, B, C):
    return (ctypes.c_longlong * 10)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2])


def ssd_scan_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor,
                    init_state: torch.Tensor | None = None, *,
                    keep_states: bool = False):
    """x (b, s, h, p); dt (b, s, h) fp32; A (h,) fp32, negative; B/C
    (b, s, n); init_state (b, h, p, n) fp32 or None (zeros) ->
    (y (b, s, h, p) fp32, final state (b, h, p, n) fp32), and with
    ``keep_states`` each chunk's entering state (b, h, nc, p, n) fp32 when
    there are several chunks, else None (the initial state is the one)."""
    _check(x, dt, A, B, C, init_state)
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if b * h == 0:
        return (y, state, None) if keep_states else (y, state)
    scratch = torch.empty(max(scratch_floats(b, s, h, p, n), 1),
                          dtype=torch.float32, device=x.device)
    vec = aligned16(x) | aligned16(B) << 1 | aligned16(C) << 2
    strides = _strides(x, dt, B, C)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = load("ssd_scan", _SIGNATURES).ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
            DTYPE_CODES[x.dtype], b, h, s, p, n, vec, strides, stream)
    check_launch(rc, "ssd_scan")
    launches["ssd_scan"] += 1
    if not keep_states:
        return y, state
    return y, state, (entering_states(scratch, b, s, h, p, n)
                      if n_chunks(s) > 1 else None)


def ssd_scan_bwd_kernel(x, dt, A, B, C, prev, dy, dstate, *,
                        with_dinit: bool):
    """The gradient of :func:`ssd_scan_kernel` at its inputs.  ``prev``:
    each chunk's entering state (b, h, nc, p, n) (``keep_states``), or for
    one chunk the initial state (b, h, p, n) or None; dy (b, s, h, p) and
    dstate (b, h, p, n) the cotangents of y and the final state (None:
    zeros).  -> (dx in x's dtype, ddt fp32, dA (h,) fp32, dB and dC in B's
    dtype, d init_state fp32 if ``with_dinit`` else None)."""
    _check(x, dt, A, B, C, None)
    b, s, h, p = x.shape
    n = B.shape[-1]
    if bwd_smem_bytes(p, n) > MAX_SMEM:
        raise ValueError(f"ssd_scan backward: head_dim {p} with state {n} "
                         f"needs {bwd_smem_bytes(p, n)} bytes of shared "
                         f"memory a block, over the card's {MAX_SMEM}")
    f32 = dict(dtype=torch.float32, device=x.device)
    for name, t, shape in (("dy", dy, (b, s, h, p)),
                           ("dstate", dstate, (b, h, p, n))):
        if t is not None and (t.dtype != torch.float32 or t.shape != shape
                              or t.device != x.device):
            raise ValueError(f"ssd_scan backward: {name} must be float32 "
                             f"{shape} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    want_prev = ((b, h, n_chunks(s), p, n) if n_chunks(s) > 1
                 else (b, h, p, n))
    if prev is not None and (prev.dtype != torch.float32
                             or prev.shape != want_prev):
        raise ValueError(f"ssd_scan backward: entering states must be "
                         f"float32 {want_prev}, got {prev.dtype} "
                         f"{tuple(prev.shape)}")
    if b * h * s == 0:                   # y is empty: the state passes on
        return (torch.zeros_like(x), torch.zeros_like(dt),
                torch.zeros((h,), **f32), torch.zeros_like(B),
                torch.zeros_like(C),
                (torch.zeros((b, h, p, n), **f32) if dstate is None
                 else dstate.clone()) if with_dinit else None)
    dy = torch.zeros((b, s, h, p), **f32) if dy is None else dy.contiguous()
    dstate = None if dstate is None else dstate.contiguous()
    prev = None if prev is None else prev.contiguous()
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    ddt = torch.empty((b, s, h), **f32)
    dda = torch.empty((b, s, h), **f32)
    dB = torch.empty((b, s, n), dtype=B.dtype, device=x.device)
    dC = torch.empty((b, s, n), dtype=C.dtype, device=x.device)
    dinit = torch.empty((b, h, p, n), **f32) if with_dinit else None
    states = n_chunks(s) > 1 or with_dinit
    terms = n_chunks(s) > 1 or prev is not None or dstate is not None
    scratch = torch.empty(
        max(bwd_scratch_floats(b, s, h, p, n, states, terms), 1), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = load("ssd_scan_bwd", _BWD_SIGNATURES).ssd_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(), ptr(dstate), ptr(prev),
            scratch.data_ptr(), ptr(dinit), dx.data_ptr(), ddt.data_ptr(),
            dda.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            DTYPE_CODES[x.dtype], b, h, s, p, n, _strides(x, dt, B, C),
            stream)
    check_launch(rc, "ssd_scan_bwd")
    launches["ssd_scan_bwd"] += 1
    dA = (dda * dt).sum(dim=(0, 1))
    return dx, ddt, dA, dB, dC, dinit
