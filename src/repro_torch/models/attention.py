"""Attention blocks, GQA half: causal/bidirectional self-attention and the
one-token decode path against a KV cache.

``sdpa`` is the function of the JAX model's ``_sdpa`` (GQA by head
grouping, fp32 softmax); ``gqa_decode``'s score/mask/softmax/PV block is
flash decoding with ``length = pos + 1``.  Both go through the kernel
packages, whose ``ops`` pick by the tensor's device: on the card the CUDA
kernels of ``csrc/``, on the CPU their plain versions.  (The JAX model
computes these in jnp and never calls its Pallas kernels; the port's
models call theirs on CUDA -- the same function, held against the JAX
model on the CPU.)  MLA waits with the MoE family (ROADMAP.md queue A6).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import rope, spec


def gqa_spec(cfg: ModelConfig):
    d = cfg.d_model
    h, m, k = cfg.num_heads, cfg.kv_heads, cfg.hdim
    return {
        "wq": spec((d, h, k), ("embed", "heads", "head_dim"), d ** -0.5),
        "wk": spec((d, m, k), ("embed", "kv_heads", "head_dim"), d ** -0.5),
        "wv": spec((d, m, k), ("embed", "kv_heads", "head_dim"), d ** -0.5),
        "wo": spec((h, k, d), ("heads", "head_dim", "embed"),
                   (h * k) ** -0.5 / (2 * cfg.num_layers) ** 0.5),
    }


def sdpa(q, k, v, *, causal: bool):
    """q (b,s,h,dk), k/v (b,t,m,dk) -> (b,s,h,dk); GQA by head grouping
    (query head i reads kv head i // (h/m)), causal mask qpos >= kpos.
    fp32: scores scaled by dk**-0.5, fp32 softmax.  bf16: the JAX model's
    ``_sdpa`` rounding for rounding -- scores q.k rounded to bf16, divided
    by bf16(sqrt(dk)) and rounded again, masked, an fp32 softmax, the
    probabilities rounded to bf16, P V summed in fp32 and rounded once;
    its gradient rounds where ``jax.vjp`` of ``_sdpa`` does and sums dk
    and dv over the GQA group in fp32."""
    return flash_attention(q, k, v, causal=causal)


def gqa_prefill_kv(x, p, cfg: ModelConfig, *, positions):
    """K/V as stored in the decode cache: (b, t, m, dk) each."""
    k = torch.einsum("btd,dmk->btmk", x, p["wk"])
    v = torch.einsum("btd,dmk->btmk", x, p["wv"])
    return rope(k, positions, cfg.rope_theta), v


def gqa_attention(x, p, cfg: ModelConfig, *, causal: bool, positions,
                  kv=None):
    """Self-attention of x (b, s, d) -> (b, s, d).  ``kv``: this layer's
    (k, v) already computed by :func:`gqa_prefill_kv` (prefill stores them
    in the cache and reuses them here)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q = rope(q, positions, cfg.rope_theta)
    k, v = kv if kv is not None else gqa_prefill_kv(x, p, cfg,
                                                    positions=positions)
    out = sdpa(q, k, v, causal=causal)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def gqa_decode(x1, p, cfg: ModelConfig, cache_k, cache_v, pos: int):
    """One-token decode. x1 (b,1,d); cache_k/v (b,S,m,dk); pos: int.

    Writes this token's K/V into the cache at ``pos`` IN PLACE (the JAX
    package's ``dynamic_update_slice`` on a carried value) and returns
    ``(out (b,1,d), cache_k, cache_v)`` with the same cache tensors."""
    b = x1.shape[0]
    positions = torch.full((1,), pos, device=x1.device)
    q = rope(torch.einsum("bsd,dhk->bshk", x1, p["wq"]), positions,
             cfg.rope_theta)
    k1, v1 = gqa_prefill_kv(x1, p, cfg, positions=positions)
    cache_k[:, pos] = k1[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v1[:, 0].to(cache_v.dtype)
    h, dk = q.shape[2], q.shape[3]
    out = decode_attention(q.reshape(b, h, dk), cache_k, cache_v, pos + 1)
    out = out.reshape(b, 1, h, cache_v.shape[-1])
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache_k, cache_v
