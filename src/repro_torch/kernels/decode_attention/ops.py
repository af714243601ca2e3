"""Public flash decoding: (b, h, d) query + (b, S, m, d) cache -> (b, h, d).

A CUDA tensor goes to the CUDA kernel, which reads the cache in place.  A
CPU tensor takes the plain version on the folded layout, with the JAX
wrapper's plumbing: q as (b*m, g, d) and the cache transposed to
(b*m, S, d).  The tensor's device decides; nothing falls back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.kernel import decode_attention_kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def fold_cache(q, cache_k, cache_v):
    """(b, h, d), (b, S, m, d) x2 -> (b*m, g, d), (b*m, S, d) x2."""
    b, h, d = q.shape
    S, m = cache_k.shape[1], cache_k.shape[2]
    qf = q.reshape(b * m, h // m, d)
    kf = cache_k.transpose(1, 2).reshape(b * m, S, d)
    vf = cache_v.transpose(1, 2).reshape(b * m, S, d)
    return qf, kf, vf


def decode_attention_plain(q, cache_k, cache_v, length: int) -> torch.Tensor:
    """The plain version on any device: fold, ``decode_attention_ref``,
    unfold."""
    o = decode_attention_ref(*fold_cache(q, cache_k, cache_v), length,
                             sm_scale=q.shape[-1] ** -0.5)
    return o.reshape(q.shape)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, length: int) -> torch.Tensor:
    """q (b, h, dk); cache_k/v (b, S, m, dk); length = valid prefix length
    (a Python int)."""
    if q.device.type != "cpu":
        return decode_attention_kernel(q, cache_k, cache_v, length)
    return decode_attention_plain(q, cache_k, cache_v, length)
