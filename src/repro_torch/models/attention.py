"""Attention blocks: GQA (causal/bidirectional self-attention, the vlm's
cross attention on image K/V, and the one-token decode paths against a KV
cache and the primed image K/V) and MLA (DeepSeek's latent
attention: the prefill materialises per-head K/V from the latent, the
decode attends in the latent space with the absorbed projections).

``sdpa`` is the function of the JAX model's ``_sdpa`` (GQA by head
grouping, fp32 softmax; dk and dv may differ, as MLA's 192 / 128);
``gqa_decode``'s score/mask/softmax/PV block is flash decoding with
``length = pos + 1``.  Both go through the kernel packages, whose ``ops``
pick by the tensor's device: on the card the CUDA kernels of ``csrc/``, on
the CPU their plain versions.  (The JAX model computes these in jnp and
never calls its Pallas kernels; the port's models call theirs on CUDA --
the same function, held against the JAX model on the CPU.)  MLA's decode
is plain products, as in the JAX model.

``positions`` is a tensor or a :class:`~repro_torch.models.common.Rotary`
(the model builds one per forward or decode step, so every layer shares
rope's tables).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import bf16_divisor
from repro_torch.models.common import rotary, softmax_fp32, spec


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


def mla_spec(cfg: ModelConfig):
    d, h = cfg.d_model, cfg.num_heads
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    return {
        "wq": spec((d, h, dn + dr), ("embed", "heads", "head_dim"),
                   d ** -0.5),
        "w_kv_down": spec((d, r + dr), ("embed", "lora"), d ** -0.5),
        "w_k_up": spec((r, h, dn), ("lora", "heads", "head_dim"), r ** -0.5),
        "w_v_up": spec((r, h, dv), ("lora", "heads", "head_dim"), r ** -0.5),
        "wo": spec((h, dv, d), ("heads", "head_dim", "embed"),
                   (h * dv) ** -0.5 / (2 * cfg.num_layers) ** 0.5),
    }


def sdpa(q, k, v, *, causal: bool):
    """q (b,s,h,dk), k (b,t,m,dk), v (b,t,m,dv) -> (b,s,h,dv); GQA by head
    grouping (query head i reads kv head i // (h/m)), causal mask qpos >=
    kpos.  fp32: scores scaled by dk**-0.5, fp32 softmax.  bf16: the JAX
    model's ``_sdpa`` rounding for rounding -- scores q.k rounded to bf16,
    divided by bf16(sqrt(dk)) and rounded again, masked, an fp32 softmax,
    the probabilities rounded to bf16, P V summed in fp32 and rounded once;
    its gradient rounds where ``jax.vjp`` of ``_sdpa`` does and sums dk
    and dv over the GQA group in fp32."""
    return flash_attention(q, k, v, causal=causal)


def gqa_prefill_kv(x, p, cfg: ModelConfig, *, positions,
                   use_rope: bool = True):
    """K/V as stored in the decode cache: (b, t, m, dk) each (k rotated
    unless ``use_rope`` is off: cross attention's image K/V)."""
    k = torch.einsum("btd,dmk->btmk", x, p["wk"])
    v = torch.einsum("btd,dmk->btmk", x, p["wv"])
    if use_rope:
        k = rotary(positions, cfg.rope_theta)(k)
    return k, v


def gqa_attention(x, p, cfg: ModelConfig, *, causal: bool, positions,
                  kv=None, kv_src=None, use_rope: bool = True):
    """Self- or cross-attention of x (b, s, d) -> (b, s, d).  ``kv``: this
    layer's (k, v) already computed by :func:`gqa_prefill_kv` (prefill
    stores them in the cache and reuses them here).  ``kv_src``: the
    sequence (b, t, d) K/V are taken from for cross attention (the vlm's
    image embeddings); ``use_rope`` off rotates neither q nor k, and
    ``positions`` is then unused."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    rot = None
    if use_rope:
        rot = rotary(positions, cfg.rope_theta)
        q = rot(q)
    if kv is None:
        src = x if kv_src is None else kv_src
        kv = gqa_prefill_kv(src, p, cfg, positions=rot, use_rope=use_rope)
    out = sdpa(q, *kv, causal=causal)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _decode_rotary(positions, pos: int, device, theta: float):
    """The step's Rotary: the one given, else one at ``pos``."""
    if positions is None:
        positions = torch.full((1,), pos, device=device)
    return rotary(positions, theta)


def gqa_decode(x1, p, cfg: ModelConfig, cache_k, cache_v, pos: int,
               positions=None):
    """One-token decode. x1 (b,1,d); cache_k/v (b,S,m,dk); pos: int;
    ``positions``: the step's :class:`Rotary` (default: made at pos).

    Writes this token's K/V into the cache at ``pos`` IN PLACE (the JAX
    package's ``dynamic_update_slice`` on a carried value) and returns
    ``(out (b,1,d), cache_k, cache_v)`` with the same cache tensors."""
    b = x1.shape[0]
    rot = _decode_rotary(positions, pos, x1.device, cfg.rope_theta)
    q = rot(torch.einsum("bsd,dhk->bshk", x1, p["wq"]))
    k1, v1 = gqa_prefill_kv(x1, p, cfg, positions=rot)
    cache_k[:, pos] = k1[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v1[:, 0].to(cache_v.dtype)
    h, dk = q.shape[2], q.shape[3]
    out = decode_attention(q.reshape(b, h, dk), cache_k, cache_v, pos + 1)
    out = out.reshape(b, 1, h, cache_v.shape[-1])
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache_k, cache_v


def cross_decode(x1, p, cfg: ModelConfig, cache_xk, cache_xv):
    """One token's cross attention against the primed image K/V. x1
    (b,1,d); cache_xk/xv (b,T,m,dk) -> (b,1,d).  The JAX model computes it
    inline in its vlm ``decode_step`` (no rope, every image position
    valid): ``gqa_decode``'s function at ``length = T``, so it goes
    through :func:`decode_attention`, the kernel on the card and its plain
    version on the CPU.  In bf16 the rounding is the same: scores divided
    by bf16(sqrt(dk)), an fp32 softmax, probabilities rounded to bf16."""
    b = x1.shape[0]
    q = torch.einsum("bsd,dhk->bshk", x1, p["wq"])
    h, dk = q.shape[2], q.shape[3]
    out = decode_attention(q.reshape(b, h, dk), cache_xk, cache_xv,
                           cache_xk.shape[1])
    out = out.reshape(b, 1, h, cache_xv.shape[-1])
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


# ------------------------------------------------------------- MLA block -----

def _mla_qkv(x, p, cfg: ModelConfig, rot):
    """-> q_nope (b,s,h,dn), q_rope (b,s,h,dr) (rotated), c_kv (b,s,r),
    k_rope (b,s,dr) (rotated, one head shared by all)."""
    dn, r = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope, q_rope = q[..., :dn], rot(q[..., dn:])
    down = torch.einsum("bsd,dr->bsr", x, p["w_kv_down"])
    c_kv, k_rope = down[..., :r], down[..., r:]
    return q_nope, q_rope, c_kv, rot(k_rope[:, :, None, :])[:, :, 0, :]


def mla_attention(x, p, cfg: ModelConfig, *, causal: bool, positions):
    """Training/prefill MLA: per-head K/V materialised from the latent,
    attended at dk = nope + rope (192 at full width) and dv."""
    rot = rotary(positions, cfg.rope_theta)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(x, p, cfg, rot)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["w_k_up"])
    v = torch.einsum("bsr,rhv->bshv", c_kv, p["w_v_up"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        -1, -1, cfg.num_heads, -1)], dim=-1)
    out = sdpa(q, k, v, causal=causal)
    return torch.einsum("bshv,hvd->bsd", out, p["wo"])


def mla_decode(x1, p, cfg: ModelConfig, cache_ckv, cache_krope, pos: int,
               positions=None):
    """Absorbed-projection MLA decode: attend in the latent space.

    cache_ckv (b,S,r); cache_krope (b,S,dr), this token's latent and rope
    key written at ``pos`` in place.  W_uk is absorbed into the query
    (q_lat = q_nope W_uk), so the scores (q_lat . c_kv + q_rope . k_rope)
    / sqrt(dn + dr) are taken against the cached latent; W_uv after the
    probabilities.  Plain products, as the JAX model's: in bf16 each
    einsum, the sum and the division (by bf16(sqrt(dn + dr)), 13.875 at
    full width) round to bf16 where its ``mla_decode`` rounds.  Returns
    ``(out (b,1,d), cache_ckv, cache_krope)``."""
    rot = _decode_rotary(positions, pos, x1.device, cfg.rope_theta)
    q_nope, q_rope, c_kv1, k_rope1 = _mla_qkv(x1, p, cfg, rot)
    cache_ckv[:, pos] = c_kv1[:, 0].to(cache_ckv.dtype)
    cache_krope[:, pos] = k_rope1[:, 0].to(cache_krope.dtype)
    S = cache_ckv.shape[1]
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["w_k_up"])
    scores = (torch.einsum("bshr,btr->bhst", q_lat, cache_ckv)
              + torch.einsum("bshk,btk->bhst", q_rope, cache_krope))
    # JAX divides by the Python float sqrt(dn + dr), weakly typed: in the
    # scores' dtype (bf16(sqrt) in bf16).  A tensor divisor: on the card
    # PyTorch divides by a Python scalar as a multiply by its reciprocal
    div = (dn + dr) ** 0.5
    if scores.dtype == torch.bfloat16:
        div = bf16_divisor((dn + dr) ** -0.5)
    scores = scores / torch.tensor(div, dtype=scores.dtype,
                                   device=scores.device)
    valid = torch.arange(S, device=x1.device)[None, None, None, :] <= pos
    probs = softmax_fp32(scores, where=valid)
    out_lat = torch.einsum("bhst,btr->bshr", probs.to(cache_ckv.dtype),
                           cache_ckv)
    out = torch.einsum("bshr,rhv->bshv", out_lat, p["w_v_up"])
    return (torch.einsum("bshv,hvd->bsd", out, p["wo"]), cache_ckv,
            cache_krope)
