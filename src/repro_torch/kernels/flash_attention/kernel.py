"""Wrappers of the CUDA flash-attention kernels (``csrc/flash_attention.cu``
and its gradient, ``csrc/flash_attention_bwd.cu``).

The forward wrapper takes q (b, sq, h, dk), k (b, sk, m, dk) and v (b, sk,
m, dv) on one card, in the model's layout (any batch/position/head strides,
head_dim contiguous; dk and dv up to 192, MLA's 192 / 128 among them),
checks what the kernel takes, allocates o (b, sq, h, dv) -- and,
when asked, the rows' log-sum-exp (b, h, sq) -- with ``torch.empty``,
launches on the current stream, raises if the launch was refused, and adds
one to :data:`launches`.  It replaces the Pallas TPU kernel of the JAX
package's ``kernels/flash_attention/kernel.py``.  The backward wrapper
takes the forward's inputs, its log-sum-exp and the upstream gradient (b,
sq, h, dv), and returns (dq, dk, dv) at every width the forward takes;
the JAX package has no backward kernel (its models differentiate the jnp
attention).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_launch, load, sm_count
from repro_torch.kernels.flash_attention.ref import bf16_divisor

#: launches since the last reset (chip_smoke reads it)
launches = {"flash_attention": 0, "flash_attention_bwd": 0}

MAX_HEAD_DIM = 128
#: flash attention's widest head dims (dk and dv), forward and backward:
#: MLA's 128 + 64
FLASH_MAX_HEAD_DIM = 192
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {"flash_attention_launch": [
    _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
    ctypes.POINTER(ctypes.c_longlong), _F, _F, _I, _P]}
_BWD_SIGNATURES = {"flash_attention_bwd_launch": [
    _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
    ctypes.POINTER(ctypes.c_longlong), _F, _F, _I, _P]}

#: rows of the backward's blocks (query rows of a dq block, keys of a dk/dv
#: block); its dk/dv launch splits the GQA group over its query heads when
#: one block per (b, kv head, key tile) would give fewer than
#: SPLIT_BELOW_BLOCKS_PER_SM blocks per SM
BWD_TILE = 64
SPLIT_BELOW_BLOCKS_PER_SM = 2


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def check_attention_shapes(what: str, q, k, v, *,
                           max_head_dim: int = MAX_HEAD_DIM,
                           v_width: bool = False) -> None:
    """q's and k's head_dim equal, every head_dim in [1,
    ``max_head_dim``], k and v alike (with ``v_width``: alike but for v's
    head_dim, dv), one batch."""
    d = q.shape[-1]
    alike = (k.shape[:-1] == v.shape[:-1] if v_width
             else k.shape == v.shape)
    if not alike or k.shape[-1] != d or k.shape[0] != q.shape[0]:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    for dim in {d, v.shape[-1]}:
        if not 1 <= dim <= max_head_dim:
            raise ValueError(f"{what}: head_dim {dim} not in "
                             f"[1, {max_head_dim}]")


def check_attention_inputs(what: str, q, k, v, **widths) -> None:
    """The checks the attention kernels share: one card, one supported
    dtype, head_dim contiguous, and :func:`check_attention_shapes` (its
    keywords: the kernel's widths)."""
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors on "
                             f"one card, got {q.device}/{k.device}/{v.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPE_CODES:
            raise ValueError(f"{what}: want float32 or bfloat16 alike, got "
                             f"{q.dtype}/{k.dtype}/{v.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: head_dim must be contiguous")
    check_attention_shapes(what, q, k, v, **widths)


def _strides(*tensors):
    """The (batch, position, head) strides of each tensor, as C integers."""
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(s for t in tensors for s in t.stride()[:3]))


def split_gqa(b: int, h: int, m: int, sk: int, sms: int) -> bool:
    """Whether the backward's dk/dv launch runs one block per (b, query
    head, key tile), each writing its head's fp32 share, summed over the
    group in head order by a third launch -- rather than one block per (b,
    kv head, key tile) walking the group's heads."""
    tiles = -(-sk // BWD_TILE)
    return h > m and b * m * tiles < SPLIT_BELOW_BLOCKS_PER_SM * sms


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool, with_lse: bool = False):
    """q (b, sq, h, dk), k (b, sk, m, dk), v (b, sk, m, dv), h % m == 0
    -> o (b, sq, h, dv) in q's dtype; causal keeps qpos >= kpos.  fp32:
    sm_scale = dk**-0.5; bf16: the JAX model's rounding
    (``ref.attention_ref``), the scores divided by bf16(sqrt dk).  With
    ``with_lse`` -> (o, lse): lse (b, h, sq) fp32, each row's natural
    log-sum-exp of its scaled (bf16: rounded), masked scores (what the
    backward needs)."""
    check_attention_inputs("flash_attention", q, k, v,
                           max_head_dim=FLASH_MAX_HEAD_DIM, v_width=True)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: want q (b, sq, h, dk), k (b, sk, "
                         "m, dk) and v (b, sk, m, dv)")
    b, sq, h, d = q.shape
    sk, m, dv = k.shape[1], k.shape[2], v.shape[-1]
    if h % m or sk < 1:
        raise ValueError(f"flash_attention: {h} query heads over {m} kv "
                         f"heads, {sk} keys")
    o = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if o.numel() == 0:
        return (o, lse) if with_lse else o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = load("flash_attention", _SIGNATURES).flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            DTYPE_CODES[q.dtype], b, h, m, sq, sk, d, dv,
            _strides(q, k, v, o), d ** -0.5, bf16_divisor(d ** -0.5),
            int(causal), stream)
    check_launch(rc, "flash_attention")
    launches["flash_attention"] += 1
    return (o, lse) if with_lse else o


def flash_attention_bwd_kernel(q, k, v, do, lse, *, causal: bool):
    """The gradient of :func:`flash_attention_kernel`: q (b, sq, h, dk), k
    (b, sk, m, dk), v (b, sk, m, dv), do (b, sq, h, dv), lse (b, h, sq)
    fp32 from the forward -> (dq, dk, dv), contiguous, in q's dtype (bf16:
    rounded where ``jax.vjp`` of the JAX model's ``_sdpa`` rounds)."""
    check_attention_inputs("flash_attention_bwd", q, k, v,
                           max_head_dim=FLASH_MAX_HEAD_DIM, v_width=True)
    b, sq, h, d = q.shape
    sk, m, dv_d = k.shape[1], k.shape[2], v.shape[-1]
    if (do.shape != (b, sq, h, dv_d) or do.dtype != q.dtype
            or do.device != q.device or do.stride(-1) != 1):
        raise ValueError(f"flash_attention_bwd: do must be "
                         f"{(b, sq, h, dv_d)} {q.dtype} with head_dim "
                         f"contiguous, got {tuple(do.shape)} {do.dtype}")
    if h % m or sk < 1:
        raise ValueError(f"flash_attention_bwd: {h} query heads over {m} kv "
                         f"heads, {sk} keys")
    if (lse.shape != (b, h, sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be fp32 "
                         f"{(b, h, sq)} contiguous, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, m, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, m, dv_d), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    rows = torch.empty((b, h, sq, 2), dtype=torch.float32, device=q.device)
    part = (torch.empty((b, h, sk, d + dv_d), dtype=torch.float32,
                        device=q.device)
            if split_gqa(b, h, m, sk, sm_count(q.device)) else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = load("flash_attention_bwd",
                  _BWD_SIGNATURES).flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), rows.data_ptr(),
            None if part is None else part.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), DTYPE_CODES[q.dtype], b, h, m, sq,
            sk, d, dv_d, _strides(q, k, v, do), d ** -0.5,
            bf16_divisor(d ** -0.5), int(causal), stream)
    check_launch(rc, "flash_attention_bwd")
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv
