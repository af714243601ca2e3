"""Every family of the zoo, built from its config: the JAX package's
``models/transformer.py`` for smollm-360m, stablelm-3b, phi3-medium-14b,
llama3-405b (dense), grok-1-314b and deepseek-v2-lite-16b (moe: top-k
routed experts; deepseek with MLA, shared experts and a dense first
layer), hubert-xlarge (encoder: bidirectional, frames in, no embed, no
decode), llama-3.2-vision-90b (vlm: groups of ``cross_attn_every`` layers,
``cross_attn_every - 1`` self-attention blocks and one cross-attention
block on the image embeddings), mamba2-370m (ssm) and zamba2-2.7b (hybrid:
groups of ``attn_every`` Mamba2 layers, each followed by ONE shared
attention block).

Stacked ``(L, ...)`` parameters as in the JAX package; its scan over layers
is a Python loop here.  RMSNorm, RoPE (its tables built once per forward
or decode step), fp32 logits from ``decode_step``, and a decode path
against an explicit cache (KV for attention, MLA's latent and rope key,
conv and SSM state for Mamba2, the vlm's primed image K/V) whose layer
slices are updated in place.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    DTYPES, Rotary, cross_entropy, is_spec, rms_norm, spec, stack_spec,
    tree_map,
)

AUX_COEF = 0.01  # load-balance loss weight (the MoE layers' aux)

# ================================================================ specs ======

def mlp_spec(cfg: ModelConfig, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    out_scale = f ** -0.5 / (2 * cfg.num_layers) ** 0.5
    s = {"w_up": spec((d, f), ("embed", "ff"), d ** -0.5),
         "w_down": spec((f, d), ("ff", "embed"), out_scale)}
    if cfg.act == "swiglu":
        s["w_gate"] = spec((d, f), ("embed", "ff"), d ** -0.5)
    return s


def _attn_spec(cfg: ModelConfig):
    return attn.mla_spec(cfg) if cfg.use_mla else attn.gqa_spec(cfg)


def _block_spec(cfg: ModelConfig, kind: str):
    ln = lambda: spec((cfg.d_model,), ("embed",), 1.0)  # noqa: E731
    if kind == "attn_mlp":
        return {"ln1": ln(), "attn": _attn_spec(cfg), "ln2": ln(),
                "mlp": mlp_spec(cfg)}
    if kind == "attn_moe":
        return {"ln1": ln(), "attn": _attn_spec(cfg), "ln2": ln(),
                "moe": moe_mod.moe_spec(cfg)}
    if kind == "attn_dense_first":  # deepseek layer 0
        return {"ln1": ln(), "attn": _attn_spec(cfg), "ln2": ln(),
                "mlp": mlp_spec(cfg, cfg.dense_d_ff)}
    if kind == "cross":                                   # vlm: GQA always
        return {"ln1": ln(), "attn": attn.gqa_spec(cfg), "ln2": ln(),
                "mlp": mlp_spec(cfg)}
    if kind == "ssm":
        return {"ln": ln(), "mixer": ssm_mod.ssm_spec(cfg)}
    raise ValueError(kind)


def _groups(cfg: ModelConfig, k: int, what: str) -> int:
    if k < 1 or cfg.num_layers % k:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not "
                         f"split into groups of {what}={k}")
    return cfg.num_layers // k


def model_spec(cfg: ModelConfig):
    d, v = cfg.d_model, cfg.vocab_size
    s: dict[str, Any] = {}
    if not cfg.is_encoder:                     # an encoder reads frames
        s["embed"] = spec((v, d), ("vocab", "embed"), 1.0 / (d ** 0.5))
    s["final_norm"] = spec((d,), ("embed",), 1.0)
    s["unembed"] = spec((d, v), ("embed", "vocab"), d ** -0.5)
    fam = cfg.family
    if fam in ("dense", "encoder"):
        s["blocks"] = stack_spec(_block_spec(cfg, "attn_mlp"), cfg.num_layers)
    elif fam == "moe":
        if cfg.first_k_dense:
            s["first"] = stack_spec(_block_spec(cfg, "attn_dense_first"),
                                    cfg.first_k_dense)
        s["blocks"] = stack_spec(_block_spec(cfg, "attn_moe"),
                                 cfg.num_layers - cfg.first_k_dense)
    elif fam == "vlm":
        k = cfg.cross_attn_every
        s["blocks"] = stack_spec({
            "self": stack_spec(_block_spec(cfg, "attn_mlp"), k - 1, "inner"),
            "cross": _block_spec(cfg, "cross"),
        }, _groups(cfg, k, "cross_attn_every"))
    elif fam == "ssm":
        s["blocks"] = stack_spec(_block_spec(cfg, "ssm"), cfg.num_layers)
    elif fam == "hybrid":
        k = cfg.attn_every
        s["blocks"] = stack_spec(
            {"ssm": stack_spec(_block_spec(cfg, "ssm"), k, "inner")},
            _groups(cfg, k, "attn_every"))
        s["shared_attn"] = _block_spec(cfg, "attn_mlp")  # ONE copy, reused
    else:
        raise ValueError(fam)
    return s


# ============================================================ forward ========

def mlp_apply(x, p, cfg: ModelConfig):
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")   # jax.nn.gelu default
    return h @ p["w_down"]


def _slice(tree, i):
    """Slice ``i`` of every leaf of a stacked tree (views, no copies)."""
    return tree_map(lambda a: a[i], tree)


def layer(params, i: int):
    """Layer (or hybrid group) ``i``'s slice of the stacked blocks."""
    return _slice(params["blocks"], i)


def _self_attn(h, p, cfg, *, causal, positions, cache=None, i=None):
    """Self-attention (MLA or GQA) of the normed h.  With ``cache``, layer
    ``i``'s K/V (GQA) are written to it at positions ``[0, s)``
    (prefill)."""
    if cfg.use_mla:
        return attn.mla_attention(h, p, cfg, causal=causal,
                                  positions=positions)
    kv = None
    if cache is not None:
        kv = attn.gqa_prefill_kv(h, p, cfg, positions=positions)
        s = h.shape[1]
        cache["k"][i, :, :s] = kv[0].to(cache["k"].dtype)
        cache["v"][i, :, :s] = kv[1].to(cache["v"].dtype)
    return attn.gqa_attention(h, p, cfg, causal=causal, positions=positions,
                              kv=kv)


def _attn_block(x, p, cfg, *, causal, positions, cache=None, i=None):
    """One pre-norm attention + MLP block (see :func:`_self_attn`)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + _self_attn(h, p["attn"], cfg, causal=causal, positions=positions,
                       cache=cache, i=i)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(h, p["mlp"], cfg)


def _cross_block(x, p, cfg, *, img):
    """The vlm's cross-attention + MLP block: q from x, K/V from the image
    embeddings ``img``, no rope, non-causal."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn.gqa_attention(h, p["attn"], cfg, causal=False,
                               positions=None, kv_src=img, use_rope=False)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(h, p["mlp"], cfg)


def _moe_block(x, p, cfg, *, positions, cache=None, i=None):
    """One pre-norm attention + MoE block -> (x, aux)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + _self_attn(h, p["attn"], cfg, causal=True, positions=positions,
                       cache=cache, i=i)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = moe_mod.moe_block(h, p["moe"], cfg)
    return x + y, aux


def _ssm_block(x, p, cfg):
    return x + ssm_mod.mamba2_block(rms_norm(x, p["ln"], cfg.norm_eps),
                                    p["mixer"], cfg)


def forward(params, batch, cfg: ModelConfig, *, last_only: bool = False,
            cache=None):
    """-> (logits (b,s,v), aux fp32 scalar: the MoE layers' load-balance
    losses summed, else 0).  Logits stay in the model dtype, except with
    ``last_only`` (unembed the final position only, in fp32, as the JAX
    package's prefill lowering does).  ``cache``: fill it with every
    layer's K/V (dense and GQA moe families; see :func:`prefill`).

    The batch: ``tokens``, or ``frames`` (b, s, d) for an encoder (cast to
    the model dtype; its attention is bidirectional); the vlm also reads
    ``image_embeds`` (b, T, d), cast to the activations' dtype."""
    dev = params["final_norm"].device
    if cfg.is_encoder:
        x = torch.as_tensor(batch["frames"], device=dev).to(DTYPES[cfg.dtype])
    else:
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        x = params["embed"][tokens]
    causal = not cfg.is_encoder
    positions = Rotary(torch.arange(x.shape[1], device=x.device),
                       cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("dense", "encoder"):
        for i in range(cfg.num_layers):
            x = _attn_block(x, layer(params, i), cfg, causal=causal,
                            positions=positions, cache=cache, i=i)
    elif cfg.family == "moe":
        nf = cfg.first_k_dense
        for i in range(nf):
            x = _attn_block(x, _slice(params["first"], i), cfg, causal=True,
                            positions=positions, cache=cache, i=i)
        for i in range(cfg.num_layers - nf):
            x, a = _moe_block(x, layer(params, i), cfg, positions=positions,
                              cache=cache, i=nf + i)
            aux = aux + a
    elif cfg.family == "vlm":
        img = torch.as_tensor(batch["image_embeds"], device=dev).to(x.dtype)
        for g in range(cfg.num_layers // cfg.cross_attn_every):
            bp = layer(params, g)
            for j in range(cfg.cross_attn_every - 1):
                x = _attn_block(x, _slice(bp["self"], j), cfg, causal=True,
                                positions=positions)
            x = _cross_block(x, bp["cross"], cfg, img=img)
    elif cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x = _ssm_block(x, layer(params, i), cfg)
    else:                                                 # hybrid
        shared = params["shared_attn"]
        for g in range(cfg.num_layers // cfg.attn_every):
            inner = layer(params, g)["ssm"]
            for j in range(cfg.attn_every):
                x = _ssm_block(x, _slice(inner, j), cfg)
            x = _attn_block(x, shared, cfg, causal=True, positions=positions)
    if last_only:
        x = x[:, -1:, :]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, params["unembed"])
    return (logits.float() if last_only else logits), aux


def loss_fn(params, batch, cfg: ModelConfig):
    logits, aux = forward(params, batch, cfg)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=logits.device)
    loss = cross_entropy(logits, labels, mask)
    return loss + AUX_COEF * aux, {"loss": loss, "aux": aux}


def value_and_grad(params, batch, cfg: ModelConfig, grads=None,
                   with_metrics: bool = False):
    """-> (loss, gradient of :func:`loss_fn`, a tree of ``params``' shape),
    and with ``with_metrics`` also :func:`loss_fn`'s metrics ({"loss": the
    cross entropy, "aux"}, detached), as ``jax.value_and_grad(...,
    has_aux=True)`` gives them.

    Each stacked leaf (its leading "layers" / "inner" axes in the spec)
    enters the model as nested lists of its per-layer slices, each an
    autograd leaf whose ``.grad`` is preset to its slice of ``grads`` (a
    zeroed tree; by default a new one), so autograd adds every layer's
    gradient there in place.  Indexing a stacked leaf instead would make
    each layer's backward write a zeroed copy of the whole stack.  At its
    peak the call holds the parameters, one gradient and the
    activations."""
    if grads is None:
        grads = tree_map(torch.zeros_like, params)

    def per_layer(p, g, axes):
        if axes and axes[0] in ("layers", "inner"):
            return [per_layer(p[i], g[i], axes[1:])
                    for i in range(p.shape[0])]
        leaf = p.detach().requires_grad_(True)
        leaf.grad = g
        return leaf

    def split(s, p, g):
        if is_spec(s):
            return per_layer(p, g, s[1])
        return {k: split(s[k], p[k], g[k]) for k in s}

    live = split(model_spec(cfg), params, grads)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch, cfg)
        loss.backward()
    if with_metrics:
        return loss.detach(), grads, {k: v.detach()
                                      for k, v in metrics.items()}
    return loss.detach(), grads


# ============================================================= cache =========

def cache_struct(cfg: ModelConfig, batch: int, max_seq: int):
    """-> {name: (shape, logical_axes, dtype)} of the decode cache, the JAX
    package's leaves: K/V per layer (dense, and moe without MLA); MLA's
    latent and rope key per layer (moe with MLA); per group and inner
    self-attention layer K/V, and per group the image K/V (vlm); conv
    inputs and the fp32 SSM state per layer (ssm); per group and inner
    layer, plus the shared block's K/V per group (hybrid).  An encoder has
    no decode cache and raises ``ValueError``, as in the JAX package."""
    dt = DTYPES[cfg.dtype]
    if cfg.family == "vlm":
        g = cfg.num_layers // cfg.cross_attn_every
        m, hd = cfg.kv_heads, cfg.hdim
        kv = ((g, cfg.cross_attn_every - 1, batch, max_seq, m, hd),
              ("layers", "layers", "batch", "kv_seq", "kv_heads",
               "head_dim"), dt)
        xkv = ((g, batch, cfg.num_image_tokens, m, hd),
               ("layers", "batch", "img_seq", "kv_heads", "head_dim"), dt)
        return {"k": kv, "v": kv, "xk": xkv, "xv": xkv}
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise ValueError(f"{cfg.family} has no decode cache")
    if cfg.family == "moe" and cfg.use_mla:
        nl = cfg.num_layers
        return {
            "ckv": ((nl, batch, max_seq, cfg.kv_lora_rank),
                    ("layers", "batch", "kv_seq", "lora"), dt),
            "krope": ((nl, batch, max_seq, cfg.qk_rope_head_dim),
                      ("layers", "batch", "kv_seq", "head_dim"), dt),
        }
    if cfg.family in ("dense", "moe"):
        shape = (cfg.num_layers, batch, max_seq, cfg.kv_heads, cfg.hdim)
        axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        return {"k": (shape, axes, dt), "v": (shape, axes, dt)}
    w = cfg.conv_width
    if cfg.family == "ssm":
        stack, stack_axes = (cfg.num_layers,), ("layers",)
    else:
        stack = (cfg.num_layers // cfg.attn_every, cfg.attn_every)
        stack_axes = ("layers", "layers")
    out = {
        "conv_x": (stack + (batch, w - 1, cfg.d_inner),
                   stack_axes + ("batch", "conv", "ff"), dt),
        "conv_B": (stack + (batch, w - 1, cfg.ssm_state),
                   stack_axes + ("batch", "conv", "state"), dt),
        "conv_C": (stack + (batch, w - 1, cfg.ssm_state),
                   stack_axes + ("batch", "conv", "state"), dt),
        "state": (stack + (batch, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state),
                  stack_axes + ("batch", "heads", None, "state"),
                  torch.float32),
    }
    if cfg.family == "hybrid":
        kv = ((stack[0], batch, max_seq, cfg.kv_heads, cfg.hdim),
              ("layers", "batch", "kv_seq", "kv_heads", "head_dim"), dt)
        out.update(attn_k=kv, attn_v=kv)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    return {name: torch.zeros(shape, dtype=dt, device=device)
            for name, (shape, _axes, dt) in
            cache_struct(cfg, batch, max_seq).items()}


# ============================================================ decode =========

def prime_cross_cache(params, cache, image_embeds, cfg: ModelConfig):
    """vlm: fill every group's image K/V (``cache["xk"]``, ``["xv"]``) from
    the image embeddings (b, T, d), in place, once before decoding (they do
    not depend on the position).  Returns the same cache dict."""
    if cfg.family != "vlm":
        raise ValueError(f"{cfg.name}: only the vlm family has a cross "
                         f"cache to prime")
    img = torch.as_tensor(image_embeds, device=params["final_norm"].device
                          ).to(DTYPES[cfg.dtype])
    for g in range(cfg.num_layers // cfg.cross_attn_every):
        p = layer(params, g)["cross"]["attn"]
        k, v = attn.gqa_prefill_kv(img, p, cfg, positions=None,
                                   use_rope=False)
        cache["xk"][g] = k.to(cache["xk"].dtype)
        cache["xv"][g] = v.to(cache["xv"].dtype)
    return cache


def _attn_block_decode(x1, p, cfg, ck, cv, pos, positions=None):
    h = rms_norm(x1, p["ln1"], cfg.norm_eps)
    a, ck, cv = attn.gqa_decode(h, p["attn"], cfg, ck, cv, pos, positions)
    x1 = x1 + a
    h = rms_norm(x1, p["ln2"], cfg.norm_eps)
    return x1 + mlp_apply(h, p["mlp"], cfg), ck, cv


def _cross_block_decode(x1, p, cfg, xk, xv):
    """The vlm's cross block for one token against its group's image K/V."""
    h = rms_norm(x1, p["ln1"], cfg.norm_eps)
    x1 = x1 + attn.cross_decode(h, p["attn"], cfg, xk, xv)
    h = rms_norm(x1, p["ln2"], cfg.norm_eps)
    return x1 + mlp_apply(h, p["mlp"], cfg)


def _self_attn_decode(h, p, cfg, cache, i: int, pos: int, positions):
    """Layer ``i``'s attention of one token (MLA or GQA); its cache slices
    are updated in place."""
    if cfg.use_mla:
        return attn.mla_decode(h, p, cfg, cache["ckv"][i],
                               cache["krope"][i], pos, positions)[0]
    return attn.gqa_decode(h, p, cfg, cache["k"][i], cache["v"][i], pos,
                           positions)[0]


def _moe_layer_decode(x1, p, cfg, cache, i: int, pos: int, positions):
    """Layer ``i`` of the moe family (a dense first layer or an MoE one)
    for one token; the MoE routes the batch's b tokens as one group."""
    h = rms_norm(x1, p["ln1"], cfg.norm_eps)
    x1 = x1 + _self_attn_decode(h, p["attn"], cfg, cache, i, pos, positions)
    h = rms_norm(x1, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        return x1 + moe_mod.moe_block(h, p["moe"], cfg)[0]
    return x1 + mlp_apply(h, p["mlp"], cfg)


def _ssm_block_decode(x1, p, cfg, cache, idx):
    """One Mamba2 layer's single step; its cache slices ``cache[k][idx]``
    are overwritten in place with the new conv inputs and state."""
    h = rms_norm(x1, p["ln"], cfg.norm_eps)
    sl = {k: cache[k][idx] for k in ssm_mod.CACHE_LEAVES}
    y, new = ssm_mod.mamba2_block(h, p["mixer"], cfg, cache=sl,
                                  single_step=True)
    for k in ssm_mod.CACHE_LEAVES:
        sl[k].copy_(new[k])
    return x1 + y


def decode_step(params, cache, token, pos: int, cfg: ModelConfig):
    """token (b,) int; pos an int -> (logits (b,v) fp32, cache).  The
    cache's layer slices are updated in place (K/V at ``pos``, conv inputs
    and SSM state whole); the returned cache is the same dict.  The vlm
    reads its image K/V as :func:`prime_cross_cache` left them (zeros if
    it was never called, as in the JAX package).  An encoder raises
    ``ValueError``."""
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.family} does not support decode")
    token = torch.as_tensor(token, device=params["embed"].device).long()
    x = params["embed"][token[:, None]]                       # (b,1,d)
    rot = Rotary(torch.full((1,), pos, device=x.device), cfg.rope_theta)
    if cfg.family == "dense":
        for i in range(cfg.num_layers):
            x, _, _ = _attn_block_decode(x, layer(params, i), cfg,
                                         cache["k"][i], cache["v"][i], pos,
                                         rot)
    elif cfg.family == "moe":
        nf = cfg.first_k_dense
        for i in range(nf):
            x = _moe_layer_decode(x, _slice(params["first"], i), cfg, cache,
                                  i, pos, rot)
        for i in range(cfg.num_layers - nf):
            x = _moe_layer_decode(x, layer(params, i), cfg, cache, nf + i,
                                  pos, rot)
    elif cfg.family == "vlm":
        for g in range(cfg.num_layers // cfg.cross_attn_every):
            bp = layer(params, g)
            for j in range(cfg.cross_attn_every - 1):
                x, _, _ = _attn_block_decode(x, _slice(bp["self"], j), cfg,
                                             cache["k"][g, j],
                                             cache["v"][g, j], pos, rot)
            x = _cross_block_decode(x, bp["cross"], cfg, cache["xk"][g],
                                    cache["xv"][g])
    elif cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x = _ssm_block_decode(x, layer(params, i), cfg, cache, i)
    else:                                                     # hybrid
        shared = params["shared_attn"]
        for g in range(cfg.num_layers // cfg.attn_every):
            inner = layer(params, g)["ssm"]
            for j in range(cfg.attn_every):
                x = _ssm_block_decode(x, _slice(inner, j), cfg, cache,
                                      (g, j))
            x, _, _ = _attn_block_decode(x, shared, cfg, cache["attn_k"][g],
                                         cache["attn_v"][g], pos, rot)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    # fp32 product of the model-dtype operands (bf16 -> fp32 is exact),
    # as the JAX package's preferred_element_type=f32 einsum
    logits = torch.einsum("bsd,dv->bsv", x.float(), params["unembed"].float())
    return logits[:, 0, :], cache


# ============================================================ prefill ========

def prefill(params, batch, cfg: ModelConfig, max_seq: int | None = None):
    """Run the prompt, return (logits_last (b,v) fp32, filled cache).

    The dense family and the moe family without MLA (grok), as in the JAX
    package.  One forward pass (the JAX package runs the forward and then a
    second pass for the K/V): each layer's K/V are written into a cache
    sized to ``max_seq`` (default the prompt length) as the layer computes
    them.  The other families raise ``NotImplementedError``, as in the
    JAX package."""
    if cfg.family not in ("dense", "moe") or cfg.use_mla:
        raise NotImplementedError(
            f"prefill cache capture for family {cfg.family!r}: use "
            "decode-from-scratch or the serving layer")
    tokens = torch.as_tensor(batch["tokens"])
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_seq or s, device=params["embed"].device)
    logits, _ = forward(params, batch, cfg, last_only=True, cache=cache)
    return logits[:, -1, :], cache
