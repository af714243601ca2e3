"""Plain PyTorch flash decoding on the folded layout: the one statement of
the decode kernel's math in the port (``ops`` runs it for CPU tensors, and
``chip_smoke.py`` holds the CUDA kernel of ``csrc/decode_attention.cu``
against it on the card)."""
from __future__ import annotations

import torch


def decode_attention_ref(q, k, v, length: int, *, sm_scale: float):
    """q (bm, g, d); k/v (bm, S, d); only cache positions ``< length``
    count (the JAX oracle masks the rest to -1e30, which gives them weight
    0; here, as in the kernel, they are not read at all).
    -> (bm, g, d) in q's dtype, fp32 softmax."""
    k, v = k[:, :length].float(), v[:, :length].float()
    s = torch.einsum("bgd,bkd->bgk", q.float(), k) * sm_scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bgk,bkd->bgd", p, v).to(q.dtype)
