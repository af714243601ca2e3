"""Plain PyTorch flash decoding on the folded layout: the one statement of
the decode kernel's math in the port (``ops`` runs it for CPU tensors, and
``chip_smoke.py`` holds the CUDA kernel of ``csrc/decode_attention.cu``
against it on the card)."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import bf16_divisor, round_scores


def decode_attention_ref(q, k, v, length: int, *, sm_scale: float):
    """q (bm, g, d); k/v (bm, S, d); only cache positions ``< length``
    count (the JAX oracle masks the rest to -1e30, which gives them weight
    0; here, as in the kernel, they are not read at all).
    -> (bm, g, d) in q's dtype, fp32 softmax.  In bfloat16 it rounds where
    the JAX model's ``gqa_decode`` rounds: the scores, the scores divided
    by bf16(1/sm_scale), the probabilities (see ``attention_ref``)."""
    k, v = k[:, :length].float(), v[:, :length].float()
    s = torch.einsum("bgd,bkd->bgk", q.float(), k)
    if q.dtype == torch.bfloat16:
        s = round_scores(s, q.dtype, bf16_divisor(sm_scale))
        p = torch.softmax(s, dim=-1).to(q.dtype).float()
    else:
        s = s * sm_scale
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bgk,bkd->bgd", p, v).to(q.dtype)
