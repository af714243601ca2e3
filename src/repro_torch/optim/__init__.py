"""Optimizers: SGD / AdamW / AdamW with 8-bit block-quantized moments.

Interface (functional, as the JAX package's):
    opt = make_optimizer(train_cfg)
    state = opt.init(params)
    new_params, new_state, stats = opt.update(grads, state, params)

Trees are nested dicts of tensors; the update is plain PyTorch, leaf by
leaf (no ``torch.optim``), and returns new tensors.  It computes the
function the JAX package's ``update`` compiles to under ``jax.jit`` (its
training step) on XLA's CPU backend, the reference the port is tested
against:

- a Python float meets a tensor as JAX's weak type: rounded to the
  tensor's dtype (bf16(lr) for bf16 gradients);
- XLA fuses each leaf's elementwise update, so the products inside it are
  not rounded to bf16 on the way (they are computed in fp32 here), and
  the moments' ``b * m + ...`` and the step's ``p - lr * u`` are fused
  multiply-adds (:func:`_fma`); XLA's other rewrites of the update (it
  folds ``m / c1 / (sqrt(v / c2) + eps)`` into one division) are not
  copied, so AdamW's update can part from JAX's in its last bits while
  SGD's and the moments are JAX's bit for bit;
- square roots are correctly rounded (:func:`_sqrt`), as XLA's are;
- on the card both are native fp32 operations (``addcmul``, whose kernel
  the compiler fuses into one multiply-add, and ``sqrt``); on the CPU,
  whose ``a + b * c`` rounds twice and whose fp32 ``sqrt`` is not
  correctly rounded, they go through float64 (:func:`_fma64`,
  :func:`_sqrt64`).  The two give the same bits (``chip_smoke.py`` holds
  hubert-xlarge's whole AdamW update on the card against the float64
  route, and the card's steps against the CPU's; PERF.md has what the
  float64 route would cost the card);
- ``max|x| / 127.0`` is a multiply by fp32(1/127), as XLA compiles a
  division by a constant; every other division is a true one, written
  with a tensor divisor (on CUDA, PyTorch divides by a Python scalar as
  a multiply by its reciprocal);
- the global norm sums the leaves in JAX's flattening order (dict keys
  sorted); each leaf's own sum runs in PyTorch's order, so the norm can
  differ from JAX's in its last bits, and so can clipped gradients.

8-bit states (``adamw8bit``) store m and sqrt(v) as int8 codes with fp32
scales per 256-block *along the last dim* (the whole last dim where 256
does not divide it); the codes keep the parameter's shape.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import TrainConfig

BLOCK = 256
#: fp32(1/127): XLA's compiled form of ``/ 127.0``
INV_127 = 1.0 / 127.0


def _block_of(last: int) -> int:
    return BLOCK if last % BLOCK == 0 else last


def _blocks(x: torch.Tensor) -> torch.Tensor:
    shape = tuple(x.shape)
    last = shape[-1] if shape else 1
    b = _block_of(last)
    return x.reshape(shape[:-1] + (max(last // b, 1), b))


def _weak(c: float, t: torch.Tensor) -> torch.Tensor:
    """The Python float ``c`` as JAX's weak type meets ``t``: rounded to
    t's dtype, as a 0-dim fp32 tensor on t's device."""
    return torch.tensor(c, dtype=t.dtype, device=t.device).float()


def _weak_value(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``, as a Python float (exact in float64)."""
    return torch.tensor(c, dtype=dtype).item()


def quantize_blockwise(x: torch.Tensor):
    """fp32 tensor -> (int8 codes, same shape; fp32 scales (..., last /
    block))."""
    xb = _blocks(x.float())
    amax = xb.abs().amax(dim=-1).clamp_min(1e-12)
    scale = amax * _weak(INV_127, amax)
    q = torch.round(xb / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q.reshape(x.shape), scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (_blocks(q.float()) * scale[..., None]).reshape(q.shape)


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    #: (grads, state, params, sq_sums=None): ``sq_sums`` as
    #: :func:`clip_by_global_norm`'s
    update: Callable[..., tuple]
    state_axes: Callable[[Any], Any]  # param axes tree -> state axes tree


def _flat(tree, path=()) -> list:
    """[(path, leaf)] in JAX's flattening order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    return [(path, tree)]


def _map(fn, *trees):
    """``fn`` over the leaves of ``trees[0]`` and what stands at the same
    path in the others (a whole subtree there, as an 8-bit {"q", "s"}
    state) -> a tree."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _map_n(fn, n: int, *trees) -> tuple:
    """As :func:`_map`, ``fn`` returning n values per leaf -> n trees."""
    if isinstance(trees[0], dict):
        outs = {k: _map_n(fn, n, *(t[k] for t in trees)) for k in trees[0]}
        return tuple({k: o[i] for k, o in outs.items()} for i in range(n))
    return fn(*trees)


def clip_by_global_norm(grads, max_norm: float, sq_sums=None):
    """-> (clipped grads, the global norm).  The norm is accumulated in
    fp32 (each leaf's sum of squares, added in JAX's leaf order); the
    clipped grads keep their input dtype (x bf16(scale) for bf16 grads).
    ``sq_sums``: a function from the leaves' own sums of squares (a list
    in JAX's leaf order) to the ones to add, where the leaves are shards
    (``distributed.step`` sums each shard's over its ranks)."""
    sums = [g.float().square().sum() for _path, g in _flat(grads)]
    if sq_sums is not None:
        sums = sq_sums(sums)
    gsq = sums[0]
    for s in sums[1:]:
        gsq = gsq + s
    gnorm = torch.sqrt(gsq)
    scale = torch.minimum(_weak(1.0, gnorm),
                          _weak(max_norm, gnorm)
                          / torch.maximum(gnorm, _weak(1e-9, gnorm)))
    return _map(lambda g: g * scale.to(g.dtype), grads), gnorm


def _step(state) -> torch.Tensor:
    return state["step"] + 1


def _fma64(a: float, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded to fp32 once, as a fused multiply-add (``a`` a
    Python float exact in fp32): the product of two fp32 values is exact
    in float64, so its float64 sum rounds once (a second rounding, to
    fp32, could differ only where that sum lands on an fp32 midpoint)."""
    return c.double().add_(b.double(), alpha=a).float()


def _sqrt64(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded fp32 square root, as XLA's: the float64 root
    rounded to fp32 (53 >= 2 x 24 + 2 bits, so the second rounding is
    exact).  PyTorch's fp32 ``sqrt`` is not correctly rounded on the CPU
    (0.7% of elements one ulp off)."""
    return torch.sqrt(x.double()).float()


def _fma(a: float, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in fp32, rounded once: one fused multiply-add on the card,
    :func:`_fma64` elsewhere."""
    if c.is_cuda:
        return torch.addcmul(c.float(), b.float(), torch.tensor(
            a, dtype=torch.float32, device=c.device))
    return _fma64(a, b, c)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded fp32 square root: the card's own, :func:`_sqrt64`
    elsewhere."""
    return x.sqrt() if x.is_cuda else _sqrt64(x)


def _adamw_math(g, m, v, p, cfg: TrainConfig, t):
    """-> (m, v, update), fp32; g in its own dtype, m and v fp32.  The
    moments are b * m + ((1 - b) * g) with the first product fused into
    the add, as XLA compiles them; g's square is rounded to g's dtype
    (XLA computes it apart), the products by 1 - b are not."""
    b1, b2 = (_weak_value(b, torch.float32) for b in (cfg.beta1, cfg.beta2))
    m = _fma(b1, m, _weak(1 - cfg.beta1, g) * g.float())
    v = _fma(b2, v, _weak(1 - cfg.beta2, g) * g.square().float())
    mh = m / (1 - _weak(cfg.beta1, t) ** t)
    vh = v / (1 - _weak(cfg.beta2, t) ** t)
    pf = p.float()
    upd = mh / (_sqrt(vh) + 1e-8) + _weak(cfg.weight_decay, pf) * pf
    return m, v, upd


def _descend(p, u, lr: float):
    """p - lr * u in p's dtype: one fused multiply-add to fp32 (as
    :func:`_fma`, lr rounded to u's dtype), then p's dtype."""
    return _fma(-_weak_value(lr, u.dtype), u, p).to(p.dtype)


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    lr = cfg.learning_rate

    def zero_step(params):
        leaf = _flat(params)[0][1]
        return torch.zeros((), dtype=torch.int32, device=leaf.device)

    if cfg.optimizer == "sgd":
        def init(params):
            return {"step": zero_step(params)}

        def update(grads, state, params, sq_sums=None):
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, sq_sums)
            new = _map(lambda p, g: _descend(p, g, lr), params, grads)
            return new, {"step": _step(state)}, {"grad_norm": gnorm}

        return Optimizer(init, update, lambda paxes: {"step": ()})

    if cfg.optimizer == "adamw":
        def init(params):
            def z(p):
                return torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
            return {"m": _map(z, params), "v": _map(z, params),
                    "step": zero_step(params)}

        def update(grads, state, params, sq_sums=None):
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, sq_sums)
            t = _step(state).float()

            def f(p, g, m, v):
                m2, v2, u = _adamw_math(g, m, v, p, cfg, t)
                return _descend(p, u, lr), m2, v2

            new_p, new_m, new_v = _map_n(f, 3, params, grads, state["m"],
                                         state["v"])
            return new_p, {"m": new_m, "v": new_v, "step": _step(state)}, \
                {"grad_norm": gnorm}

        def state_axes(paxes):
            return {"m": paxes, "v": paxes, "step": ()}

        return Optimizer(init, update, state_axes)

    if cfg.optimizer == "adamw8bit":
        def init(params):
            def qz(p):
                q, s = quantize_blockwise(torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device))
                return {"q": q, "s": s}
            return {"m": _map(qz, params), "v": _map(qz, params),
                    "step": zero_step(params)}

        def update(grads, state, params, sq_sums=None):
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, sq_sums)
            t = _step(state).float()

            def f(p, g, mq, vq):
                m = dequantize_blockwise(mq["q"], mq["s"])
                v = dequantize_blockwise(vq["q"], vq["s"]).square()  # v >= 0
                m2, v2, u = _adamw_math(g, m, v, p, cfg, t)
                nmq, nms = quantize_blockwise(m2)
                nvq, nvs = quantize_blockwise(_sqrt(v2))  # sqrt(v) kept
                return (_descend(p, u, lr), {"q": nmq, "s": nms},
                        {"q": nvq, "s": nvs})

            new_p, new_m, new_v = _map_n(f, 3, params, grads, state["m"],
                                         state["v"])
            return new_p, {"m": new_m, "v": new_v, "step": _step(state)}, \
                {"grad_norm": gnorm}

        def state_axes(paxes):
            # codes and per-block scales share the param's axes (the last
            # dim shrinks by the block factor)
            return {"m": _map(lambda ax: {"q": ax, "s": ax}, paxes),
                    "v": _map(lambda ax: {"q": ax, "s": ax}, paxes),
                    "step": ()}

        return Optimizer(init, update, state_axes)

    raise ValueError(cfg.optimizer)

