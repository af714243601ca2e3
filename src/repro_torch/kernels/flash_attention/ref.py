"""Plain PyTorch attention on the folded layout: the one statement of the
flash kernel's math in the port (``ops`` runs it for CPU tensors, and
``chip_smoke.py`` holds the CUDA kernel of ``csrc/flash_attention.cu``
against it on the card)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool, sm_scale: float):
    """q (bh, sq, d); k/v (bh, sk, d) -> (bh, sq, d). fp32 softmax; a causal
    mask keeps ``qpos >= kpos`` (top-left aligned)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~mask[None], NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
