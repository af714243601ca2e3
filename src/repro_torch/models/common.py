"""Shared utilities for the model zoo: param specs, init, dtype policy.

Parameters are plain nested dicts of tensors, with the JAX package's keys
and its stacked ``(L, ...)`` leaves.  Every leaf is described by a
``ParamSpec = (shape, logical_axes, init_scale)``; the spec tree drives
initialization and the parameter count.  The logical axes are carried as
data: the port's zoo runs on one card and shards nothing.
"""
from __future__ import annotations

import math
from typing import Any

import torch

ParamSpec = tuple  # (shape: tuple[int,...], axes: tuple[str|None,...], scale: float)
SpecTree = Any     # nested dict of ParamSpec
Params = Any       # nested dict of torch.Tensor

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def spec(shape, axes, scale=0.02) -> ParamSpec:
    assert len(shape) == len(axes), (shape, axes)
    return (tuple(shape), tuple(axes), float(scale))


def is_spec(x) -> bool:
    return isinstance(x, tuple) and len(x) == 3 and isinstance(x[0], tuple)


def tree_map(fn, tree, is_leaf=None):
    """Apply ``fn`` to every leaf of a nested dict (a leaf is anything that
    is not a dict, or where ``is_leaf`` says so)."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, is_leaf=None) -> list:
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return [x for v in tree.values() for x in tree_leaves(v, is_leaf)]
    return [tree]


def stack_spec(tree: SpecTree, n: int, axis_name: str = "layers") -> SpecTree:
    """Add a leading stacking dim of size n to every leaf (one slice per
    layer, as the JAX package stacks them for its scan over layers)."""
    def f(s: ParamSpec) -> ParamSpec:
        shape, axes, scale = s
        return ((n,) + shape, (axis_name,) + axes, scale)
    return tree_map(f, tree, is_spec)


def param_count(tree: SpecTree) -> int:
    return sum(math.prod(s[0]) for s in tree_leaves(tree, is_spec))


def init_params(gen: torch.Generator, tree: SpecTree, dtype: str,
                device=None) -> Params:
    """Truncated normal in [-2, 2] x scale (drawn in fp32, then cast), ones
    for norm scales, zeros for scale 0 -- the JAX package's rule.  The
    values come from ``gen`` (a ``torch.Generator`` on ``device``), so they
    differ from JAX's; shapes and scales do not."""
    dt = DTYPES[dtype]

    def one(s: ParamSpec) -> torch.Tensor:
        shape, _axes, scale = s
        if scale == 0.0:
            return torch.zeros(shape, dtype=dt, device=device)
        if scale == 1.0 and len(shape) == 1:          # norm scales
            return torch.ones(shape, dtype=dt, device=device)
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, a=-2.0, b=2.0, generator=gen)
        return (w * scale).to(dt)

    return tree_map(one, tree, is_spec)


# ---------------------------------------------------------------- numerics ----

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Variance reduction in fp32; the elementwise step stays in x.dtype
    (the JAX package's policy)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., s, heads, d); positions: (s,)."""
    d = x.shape[-1]
    assert d % 2 == 0, d
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = 1.0 / (theta ** exps)
    angles = positions.to(torch.float32)[..., None] * freqs        # (s, d/2)
    cos = torch.cos(angles)[..., None, :]                          # (s, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softmax_fp32(x: torch.Tensor, dim: int = -1, where=None) -> torch.Tensor:
    xf = x.float()
    if where is not None:
        xf = xf.masked_fill(~where, -1e30)
    return torch.softmax(xf, dim=dim)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None):
    """Mean token CE. logits (..., V); labels int; mask optional bool."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - ll
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()
