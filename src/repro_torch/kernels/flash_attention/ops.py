"""Public flash attention on the model's layout, with GQA.

A CUDA tensor goes to the CUDA kernel, which reads q (b, sq, h, d) and
k/v (b, sk, m, d) in place and maps query head i to kv head i // g.  A CPU
tensor takes the plain version on the folded layout, with the JAX
wrapper's plumbing: heads flattened into the batch, each kv head repeated
g times.  The tensor's device decides; nothing falls back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref


def fold_gqa(q, k, v):
    """(b, sq, h, d), (b, sk, m, d) x2 -> (b*h, sq, d), (b*h, sk, d) x2."""
    b, sq, h, d = q.shape
    sk, m = k.shape[1], k.shape[2]
    g = h // m
    qf = q.transpose(1, 2).reshape(b * h, sq, d)
    kf = k.transpose(1, 2).repeat_interleave(g, dim=1).reshape(b * h, sk, d)
    vf = v.transpose(1, 2).repeat_interleave(g, dim=1).reshape(b * h, sk, d)
    return qf, kf, vf


def flash_attention_plain(q, k, v, *, causal: bool) -> torch.Tensor:
    """The plain version on any device: fold, ``attention_ref``, unfold."""
    b, sq, h, d = q.shape
    o = attention_ref(*fold_gqa(q, k, v), causal=causal, sm_scale=d ** -0.5)
    return o.reshape(b, h, sq, d).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (b, sq, h, d); k/v (b, sk, m, d) with h % m == 0 (GQA) ->
    (b, sq, h, d) in q's dtype."""
    if q.device.type != "cpu":
        return flash_attention_kernel(q, k, v, causal=causal)
    return flash_attention_plain(q, k, v, causal=causal)
