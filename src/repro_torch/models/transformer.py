"""Model builder, the dense, ssm and hybrid families: the JAX package's
``models/transformer.py`` for smollm-360m, stablelm-3b, phi3-medium-14b,
llama3-405b (dense), mamba2-370m (ssm) and zamba2-2.7b (hybrid: groups of
``attn_every`` Mamba2 layers, each followed by ONE shared attention block).

Stacked ``(L, ...)`` parameters as in the JAX package; its scan over layers
is a Python loop here.  RMSNorm, RoPE, fp32 logits from ``decode_step``,
and a decode path against an explicit cache (KV for attention, conv and
SSM state for Mamba2) whose layer slices are updated in place.  The other
families raise ``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (
    DTYPES, cross_entropy, rms_norm, spec, stack_spec, tree_map,
)

AUX_COEF = 0.01  # load-balance loss weight (0 aux for the built families)

#: the families the port builds
BUILT = ("dense", "ssm", "hybrid")
#: where each family the port does not build yet is queued
_QUEUED = {
    "moe": "ROADMAP.md queue A6 (MoE and MLA)",
    "vlm": "ROADMAP.md queue A6 (vlm cross-attention)",
    "encoder": "ROADMAP.md queue A6 (encoder)",
}


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in BUILT:
        raise NotImplementedError(
            f"{cfg.name}: the port builds the {'/'.join(BUILT)} families; "
            f"family {cfg.family!r} is "
            f"{_QUEUED.get(cfg.family, 'not queued')}")


# ================================================================ specs ======

def mlp_spec(cfg: ModelConfig, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    out_scale = f ** -0.5 / (2 * cfg.num_layers) ** 0.5
    s = {"w_up": spec((d, f), ("embed", "ff"), d ** -0.5),
         "w_down": spec((f, d), ("ff", "embed"), out_scale)}
    if cfg.act == "swiglu":
        s["w_gate"] = spec((d, f), ("embed", "ff"), d ** -0.5)
    return s


def _block_spec(cfg: ModelConfig, kind: str):
    ln = lambda: spec((cfg.d_model,), ("embed",), 1.0)  # noqa: E731
    if kind == "attn_mlp":
        return {"ln1": ln(), "attn": attn.gqa_spec(cfg), "ln2": ln(),
                "mlp": mlp_spec(cfg)}
    if kind == "ssm":
        return {"ln": ln(), "mixer": ssm_mod.ssm_spec(cfg)}
    raise NotImplementedError(f"block kind {kind!r}: ROADMAP.md queue A6")


def model_spec(cfg: ModelConfig):
    check_family(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    s: dict[str, Any] = {
        "embed": spec((v, d), ("vocab", "embed"), 1.0 / (d ** 0.5)),
        "final_norm": spec((d,), ("embed",), 1.0),
        "unembed": spec((d, v), ("embed", "vocab"), d ** -0.5),
    }
    fam = cfg.family
    if fam == "dense":
        s["blocks"] = stack_spec(_block_spec(cfg, "attn_mlp"), cfg.num_layers)
    elif fam == "ssm":
        s["blocks"] = stack_spec(_block_spec(cfg, "ssm"), cfg.num_layers)
    else:                                                 # hybrid
        k = cfg.attn_every
        if k < 1 or cfg.num_layers % k:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not "
                             f"split into groups of attn_every={k}")
        s["blocks"] = stack_spec(
            {"ssm": stack_spec(_block_spec(cfg, "ssm"), k, "inner")},
            cfg.num_layers // k)
        s["shared_attn"] = _block_spec(cfg, "attn_mlp")  # ONE copy, reused
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


def _attn_block(x, p, cfg, *, causal, positions, cache=None, i=None):
    """One pre-norm attention + MLP block.  With ``cache``, layer ``i``'s
    K/V are written to it at positions ``[0, s)`` (prefill)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    kv = None
    if cache is not None:
        kv = attn.gqa_prefill_kv(h, p["attn"], cfg, positions=positions)
        s = x.shape[1]
        cache["k"][i, :, :s] = kv[0].to(cache["k"].dtype)
        cache["v"][i, :, :s] = kv[1].to(cache["v"].dtype)
    x = x + attn.gqa_attention(h, p["attn"], cfg, causal=causal,
                               positions=positions, kv=kv)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(h, p["mlp"], cfg)


def _ssm_block(x, p, cfg):
    return x + ssm_mod.mamba2_block(rms_norm(x, p["ln"], cfg.norm_eps),
                                    p["mixer"], cfg)


def forward(params, batch, cfg: ModelConfig, *, last_only: bool = False,
            cache=None):
    """-> (logits (b,s,v), aux scalar).  Logits stay in the model dtype,
    except with ``last_only`` (unembed the final position only, in fp32,
    as the JAX package's prefill lowering does).  ``cache``: fill it with
    every layer's K/V (dense family; see :func:`prefill`)."""
    check_family(cfg)
    tokens = torch.as_tensor(batch["tokens"],
                             device=params["embed"].device).long()
    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], device=x.device)
    if cfg.family == "dense":
        for i in range(cfg.num_layers):
            x = _attn_block(x, layer(params, i), cfg, causal=True,
                            positions=positions, cache=cache, i=i)
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
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return (logits.float() if last_only else logits), aux


def loss_fn(params, batch, cfg: ModelConfig):
    logits, aux = forward(params, batch, cfg)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=logits.device)
    loss = cross_entropy(logits, labels, mask)
    return loss + AUX_COEF * aux, {"loss": loss, "aux": aux}


# ============================================================= cache =========

def cache_struct(cfg: ModelConfig, batch: int, max_seq: int):
    """-> {name: (shape, logical_axes, dtype)} of the decode cache, the JAX
    package's leaves: K/V per layer (dense); conv inputs and the fp32 SSM
    state per layer (ssm); per group and inner layer, plus the shared
    block's K/V per group (hybrid)."""
    check_family(cfg)
    dt = DTYPES[cfg.dtype]
    if cfg.family == "dense":
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

def _attn_block_decode(x1, p, cfg, ck, cv, pos):
    h = rms_norm(x1, p["ln1"], cfg.norm_eps)
    a, ck, cv = attn.gqa_decode(h, p["attn"], cfg, ck, cv, pos)
    x1 = x1 + a
    h = rms_norm(x1, p["ln2"], cfg.norm_eps)
    return x1 + mlp_apply(h, p["mlp"], cfg), ck, cv


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
    and SSM state whole); the returned cache is the same dict."""
    check_family(cfg)
    token = torch.as_tensor(token, device=params["embed"].device).long()
    x = params["embed"][token[:, None]]                       # (b,1,d)
    if cfg.family == "dense":
        for i in range(cfg.num_layers):
            x, _, _ = _attn_block_decode(x, layer(params, i), cfg,
                                         cache["k"][i], cache["v"][i], pos)
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
                                         cache["attn_v"][g], pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    # fp32 product of the model-dtype operands (bf16 -> fp32 is exact),
    # as the JAX package's preferred_element_type=f32 einsum
    logits = torch.einsum("bsd,dv->bsv", x.float(), params["unembed"].float())
    return logits[:, 0, :], cache


# ============================================================ prefill ========

def prefill(params, batch, cfg: ModelConfig, max_seq: int | None = None):
    """Run the prompt, return (logits_last (b,v) fp32, filled cache).

    Dense family only, as in the JAX package.  One forward pass (the JAX
    package runs the forward and then a second pass for the K/V): each
    layer's K/V are written into a cache sized to ``max_seq`` (default the
    prompt length) as the layer computes them."""
    check_family(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"prefill cache capture for family {cfg.family!r}: use "
            "decode-from-scratch or the serving layer")
    tokens = torch.as_tensor(batch["tokens"])
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_seq or s, device=params["embed"].device)
    logits, _ = forward(params, batch, cfg, last_only=True, cache=cache)
    return logits[:, -1, :], cache
