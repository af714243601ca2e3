"""Plain PyTorch attention on the folded layout: the one statement of the
flash kernel's math in the port (``ops`` runs it for CPU tensors, and
``chip_smoke.py`` holds the CUDA kernel of ``csrc/flash_attention.cu``
against it on the card)."""
from __future__ import annotations

import functools

import torch

NEG_INF = -1e30


@functools.lru_cache(maxsize=None)
def bf16_divisor(sm_scale: float) -> float:
    """1 / sm_scale rounded to bfloat16: bf16(sqrt(d)) for sm_scale =
    d**-0.5.  The JAX model divides its bf16 scores by the Python float
    ``dk ** 0.5``, which JAX first rounds to the scores' dtype (8.9375 for
    d = 80, not 8.944; 4.46875 for d = 20; 13.875 for MLA's dk = 192)."""
    return float(torch.tensor(1.0 / sm_scale, dtype=torch.float64)
                 .to(torch.bfloat16))


def round_scores(s: torch.Tensor, dtype, divisor: float) -> torch.Tensor:
    """fp32 scores q.k -> the JAX model's bf16 scores as fp32 values:
    bf16(bf16(s) / divisor), the division in fp32 (by a tensor: on the
    card PyTorch divides by a Python scalar as a multiply)."""
    div = torch.tensor(divisor, dtype=torch.float32, device=s.device)
    return (s.to(dtype).float() / div).to(dtype).float()


def attention_ref(q, k, v, *, causal: bool, sm_scale: float):
    """q (bh, sq, dk), k (bh, sk, dk), v (bh, sk, dv) -> (bh, sq, dv) in
    q's dtype; a causal mask keeps ``qpos >= kpos`` (top-left aligned).

    q's dtype decides the function.  float32: the scores times sm_scale,
    an fp32 softmax, P V in fp32.  bfloat16: the JAX model's ``_sdpa``,
    rounding where it rounds -- scores bf16(bf16(q.k) / bf16(1/sm_scale)),
    masked to -1e30 after the rounding, an fp32 softmax, P rounded to bf16,
    P V summed in fp32 and rounded once.  k and v may come widened to fp32
    (``ops.fold_gqa`` widens them before its GQA repeat); their values are
    bf16's all the same."""
    if q.dtype == torch.bfloat16:
        s = round_scores(torch.einsum("bqd,bkd->bqk", q.float(), k.float()),
                         q.dtype, bf16_divisor(sm_scale))
    else:
        s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~mask[None], NEG_INF)
    if q.dtype == torch.bfloat16:
        p = torch.softmax(s, dim=-1).to(q.dtype).float()
    else:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
