"""Model builder, dense family: the JAX package's ``models/transformer.py``
for ``family == "dense"`` (smollm-360m, stablelm-3b, phi3-medium-14b,
llama3-405b).

Stacked ``(L, ...)`` parameters as in the JAX package; its scan over layers
is a Python loop here.  RMSNorm, RoPE, fp32 logits from ``decode_step``,
and a decode path against an explicit KV cache that is updated in place.
The other families raise ``NotImplementedError`` naming their ROADMAP.md
item.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    DTYPES, cross_entropy, rms_norm, spec, stack_spec, tree_map,
)

AUX_COEF = 0.01  # load-balance loss weight (0 aux for the dense family)

#: where each family the port does not build yet is queued
_QUEUED = {
    "moe": "ROADMAP.md queue A6 (MoE and MLA)",
    "ssm": "ROADMAP.md queue A6 with kernel B5 (models/ssm.py)",
    "hybrid": "ROADMAP.md queue A6 (hybrid, after models/ssm.py)",
    "vlm": "ROADMAP.md queue A6 (vlm cross-attention)",
    "encoder": "ROADMAP.md queue A6 (encoder)",
}


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the port builds the dense family only; family "
            f"{cfg.family!r} is {_QUEUED.get(cfg.family, 'not queued')}")


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
    if kind != "attn_mlp":
        raise NotImplementedError(f"block kind {kind!r}: ROADMAP.md queue A6")
    ln = lambda: spec((cfg.d_model,), ("embed",), 1.0)  # noqa: E731
    return {"ln1": ln(), "attn": attn.gqa_spec(cfg), "ln2": ln(),
            "mlp": mlp_spec(cfg)}


def model_spec(cfg: ModelConfig):
    check_family(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    s: dict[str, Any] = {
        "embed": spec((v, d), ("vocab", "embed"), 1.0 / (d ** 0.5)),
        "final_norm": spec((d,), ("embed",), 1.0),
        "unembed": spec((d, v), ("embed", "vocab"), d ** -0.5),
    }
    s["blocks"] = stack_spec(_block_spec(cfg, "attn_mlp"), cfg.num_layers)
    return s


# ============================================================ forward ========

def mlp_apply(x, p, cfg: ModelConfig):
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"], approximate="tanh")   # jax.nn.gelu default
    return h @ p["w_down"]


def layer(params, i: int):
    """Layer ``i``'s slice of the stacked blocks (views, no copies)."""
    return tree_map(lambda a: a[i], params["blocks"])


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


def forward(params, batch, cfg: ModelConfig, *, last_only: bool = False,
            cache=None):
    """-> (logits (b,s,v), aux scalar).  Logits stay in the model dtype,
    except with ``last_only`` (unembed the final position only, in fp32,
    as the JAX package's prefill lowering does).  ``cache``: fill it with
    every layer's K/V (see :func:`prefill`)."""
    check_family(cfg)
    tokens = torch.as_tensor(batch["tokens"],
                             device=params["embed"].device).long()
    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.num_layers):
        x = _attn_block(x, layer(params, i), cfg, causal=True,
                        positions=positions, cache=cache, i=i)
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
    """-> {"k", "v"}: (shape, logical_axes, dtype) of the decode cache."""
    check_family(cfg)
    shape = (cfg.num_layers, batch, max_seq, cfg.kv_heads, cfg.hdim)
    axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    kv = (shape, axes, DTYPES[cfg.dtype])
    return {"k": kv, "v": kv}


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


def decode_step(params, cache, token, pos: int, cfg: ModelConfig):
    """token (b,) int; pos an int -> (logits (b,v) fp32, cache).  The
    cache's layer slices are updated in place at ``pos``; the returned
    cache is the same dict."""
    check_family(cfg)
    token = torch.as_tensor(token, device=params["embed"].device).long()
    x = params["embed"][token[:, None]]                       # (b,1,d)
    for i in range(cfg.num_layers):
        x, _, _ = _attn_block_decode(x, layer(params, i), cfg,
                                     cache["k"][i], cache["v"][i], pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    # fp32 product of the model-dtype operands (bf16 -> fp32 is exact),
    # as the JAX package's preferred_element_type=f32 einsum
    logits = torch.einsum("bsd,dv->bsv", x.float(), params["unembed"].float())
    return logits[:, 0, :], cache


# ============================================================ prefill ========

def prefill(params, batch, cfg: ModelConfig, max_seq: int | None = None):
    """Run the prompt, return (logits_last (b,v) fp32, filled cache).

    One forward pass (the JAX package runs the forward and then a second
    pass for the K/V): each layer's K/V are written into a cache sized to
    ``max_seq`` (default the prompt length) as the layer computes them."""
    tokens = torch.as_tensor(batch["tokens"])
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_seq or s, device=params["embed"].device)
    logits, _ = forward(params, batch, cfg, last_only=True, cache=cache)
    return logits[:, -1, :], cache
