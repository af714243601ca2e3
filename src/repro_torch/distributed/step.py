"""Step builders: train / prefill / serve steps over process groups.

The port's counterpart of the JAX package's ``distributed/step.py``.  The
communication pattern follows the paper's AllReduce-vs-ScatterReduce
design axis:

- ``allreduce``      -> pure data parallel (DDP's pattern): parameters
                        replicated, each gradient averaged over the data
                        ranks by one all-reduce.
- ``scatter_reduce`` -> FSDP's pattern: each parameter and its optimizer
                        state sharded along the dim that
                        :meth:`ShardingCtx.param_pspec` names (so the port
                        shards exactly what JAX's GSPMD shards), parameters
                        all-gathered on use and gradients reduce-scattered
                        (every rank reduces its own partition).

A step takes each rank's own tensors (shards under FSDP:
:meth:`BuiltStep.shard` cuts them from full trees, :meth:`BuiltStep.gather`
joins them) and the global batch, of which each rank computes its rows.
The global gradient norm of the clip sums each shard's squares over its
ranks (:func:`_global_sq_sums`).  At world size 1 the step runs the same
code; its collectives are over a one-rank group (NCCL on the card, gloo
on the CPU), or the identity without a process group.  Every collective
goes through :class:`Collectives`, which counts the calls and the bytes
each rank sends into :data:`COMM_LOG`.

Tensor parallelism ("model" > 1 with weights on it) is not ported
(ROADMAP.md queue A10).  ``TrainConfig.remat`` is not ported: the port's
training fits the card without recomputation (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.distributed.sharding import (
    ShardingCtx, local_shard, shard_count, shard_index, use_sharding,
)
from repro_torch.models import transformer as tfm
from repro_torch.models.common import is_spec, tree_map
from repro_torch.optim import _flat, _map, make_optimizer

#: (group name, collective) -> calls, and (group name, "bytes") -> bytes
#: each rank sent, since the last ``clear()``
COMM_LOG: Counter = Counter()

#: the SSD kernels round bf16 per this many positions (csrc/ssd_scan.cu)
SSD_KERNEL_ROUNDING = 64


class Collectives:
    """The collectives of one step over one process group (``None``: one
    rank, each collective the identity), each call counted in
    :data:`COMM_LOG` under ``name``.  Means divide by a tensor (on CUDA,
    PyTorch divides by a Python scalar as a multiply by its reciprocal)."""

    def __init__(self, group, name: str):
        import torch.distributed as dist
        self.group, self.name = group, name
        self.world = dist.get_world_size(group) if group is not None else 1

    def _log(self, op: str, nbytes: int) -> None:
        COMM_LOG[(self.name, op)] += 1
        COMM_LOG[(self.name, "bytes")] += nbytes

    def _div(self, x: torch.Tensor) -> torch.Tensor:
        return x / torch.tensor(self.world, dtype=x.dtype, device=x.device)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        self._log("all_reduce", x.numel() * x.element_size())
        if self.group is None:
            return x
        x = x.clone()
        dist.all_reduce(x, group=self.group)
        return x

    def all_reduce_mean(self, x: torch.Tensor) -> torch.Tensor:
        return self._div(self.all_reduce_sum(x))

    def reduce_scatter_mean(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's 1/world piece of ``x`` along ``dim``, averaged over
        the group."""
        import torch.distributed as dist
        self._log("reduce_scatter", x.numel() * x.element_size())
        if self.group is None:
            return self._div(x)
        xm = x.movedim(dim, 0).contiguous()
        out = torch.empty((xm.shape[0] // self.world,) + xm.shape[1:],
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, xm, group=self.group)
        return self._div(out.movedim(0, dim))

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' pieces joined along ``dim``, in rank order."""
        import torch.distributed as dist
        self._log("all_gather", x.numel() * x.element_size())
        if self.group is None:
            return x
        xm = x.movedim(dim, 0).contiguous()
        out = torch.empty((xm.shape[0] * self.world,) + xm.shape[1:],
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, xm, group=self.group)
        return out.movedim(0, dim)


# ------------------------------------------------------------- specs --------

def param_axes(cfg) -> dict:
    """The parameter tree's logical axes (the JAX ``Model.axes()``)."""
    return tree_map(lambda s: s[1], tfm.model_spec(cfg), is_spec)


def abstract_params(cfg) -> dict:
    """The parameter tree on the ``meta`` device (shapes and dtypes)."""
    from repro_torch.models.common import DTYPES
    dt = DTYPES[cfg.dtype]
    return tree_map(lambda s: torch.empty(s[0], dtype=dt, device="meta"),
                    tfm.model_spec(cfg), is_spec)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def resolve_shardings(ctx: ShardingCtx, axes_tree, abstract_tree):
    """axes tree (+ matching tree of tensors or shapes) -> spec tree."""
    def walk(ax, t):
        if _is_axes(ax):
            return ctx.param_pspec(tuple(t.shape), ax)
        return {k: walk(ax[k], t[k]) for k in ax}
    return walk(axes_tree, abstract_tree)


_BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "mask": ("batch", "seq"),
    "frames": ("batch", "seq", "embed"),
    "image_embeds": ("batch", "img_seq", "embed"),
}


def batch_shardings(ctx: ShardingCtx, batch_specs: dict) -> dict:
    return {k: ctx.value_pspec(tuple(v.shape), _BATCH_AXES[k])
            for k, v in batch_specs.items()}


def _effective_ctx(arch: ArchConfig, mesh, kind: str = "train",
                   global_batch: int | None = None) -> ShardingCtx:
    rules = arch.sharding
    if arch.train.comm_pattern == "allreduce":
        rules = dataclasses.replace(rules, fsdp_axis=None)
    if rules.dp_over_model:
        n_dp = 1
        for a in mesh.axis_names:
            n_dp *= mesh.shape[a]
        if kind != "train" or (global_batch is not None
                               and global_batch % n_dp != 0):
            # pure DP needs batch % (all mesh axes) == 0; inference batches
            # (32/128/1) and multi-pod 256-batch train don't divide -- keep
            # the arch's TP layout instead
            rules = dataclasses.replace(rules, dp_over_model=False)
    return ShardingCtx(mesh, rules)


def refuse_tensor_parallel(ctx: ShardingCtx) -> None:
    """A "model" axis above 1 whose rules put weights on it is tensor
    parallelism, which the port does not run."""
    if ctx.mesh.shape.get("model", 1) > 1 and not ctx.rules.dp_over_model:
        raise NotImplementedError(
            f"{ctx.mesh.shape}: model={ctx.mesh.shape['model']} with "
            f"weights on the model axis is tensor parallelism, not ported "
            f"(ROADMAP.md queue A10); use model=1 or an arch whose rules "
            f"take the batch over the model axis (dp_over_model)")


def fence_ssd_rounding(arch: ArchConfig, seq_len: int) -> None:
    """The SSD kernels round bf16 per 64 positions while the model rounds
    per its own chunk (``ssm_chunk``, or s where it does not divide s):
    refuse an ssm or hybrid arch in bf16 wherever the two differ."""
    m = arch.model
    if m.family not in ("ssm", "hybrid") or m.dtype != "bfloat16":
        return
    chunk = m.ssm_chunk if seq_len % m.ssm_chunk == 0 else seq_len
    if chunk != min(SSD_KERNEL_ROUNDING, seq_len):
        raise NotImplementedError(
            f"{m.name} in bf16 at s={seq_len}: the model's SSD chunk is "
            f"{chunk} positions and the SSD kernels round per "
            f"{SSD_KERNEL_ROUNDING} (ROADMAP.md queue C 3); train it in "
            f"fp32 or at s <= {SSD_KERNEL_ROUNDING}")


# -------------------------------------------------------------- layout ------

@dataclass
class Layout:
    """Where each leaf of a tree lives across the ranks: its spec, and the
    one dim it is cut along over the rank axes (None: whole on every
    rank)."""
    specs: Any
    dims: Any
    sizes: dict
    coords: dict

    def shard(self, tree):
        """Each leaf's piece that this rank holds (views of ``tree``)."""
        return _map(lambda x, s: local_shard(x, s, self.sizes, self.coords),
                    tree, self.specs)


def _cut_dim(spec: tuple, sizes: dict) -> int | None:
    dims = [d for d in range(len(spec)) if shard_count(spec, d, sizes) > 1]
    if len(dims) > 1:
        raise NotImplementedError(f"spec {spec} cuts {len(dims)} dims over "
                                  f"the ranks; the port cuts one")
    return dims[0] if dims else None


def _layout(spec_tree, mesh) -> Layout:
    sizes = mesh.rank_sizes
    dims = tree_map(lambda s: _cut_dim(s, sizes), spec_tree)
    return Layout(spec_tree, dims, sizes, mesh.coords)


def _state_specs(tc, pspecs):
    """The optimizer state's specs: each moment takes its parameter's (8-bit
    codes and scales alike), the step counter is replicated."""
    if tc.optimizer == "sgd":
        return {"step": ()}
    if tc.optimizer == "adamw":
        return {"m": pspecs, "v": pspecs, "step": ()}
    both = tree_map(lambda s: {"q": s, "s": s}, pspecs)
    return {"m": both, "v": both, "step": ()}


def _check_8bit_blocks(tc, params_abs, layout: Layout) -> None:
    """8-bit moments are quantised per 256-block along the last dim: a
    shard cut along the last dim keeps the full tensor's blocks only where
    both widths are multiples of 256."""
    if tc.optimizer != "adamw8bit":
        return
    for (path, p), (_, spec), (_, d) in zip(
            _flat(params_abs), _flat(layout.specs), _flat(layout.dims)):
        if d is None or d != p.ndim - 1:
            continue
        n = p.shape[-1] // shard_count(spec, d, layout.sizes)
        if p.shape[-1] % 256 or n % 256:
            raise NotImplementedError(
                f"{'/'.join(path)} {tuple(p.shape)}: adamw8bit's 256-blocks "
                f"would split across the FSDP shards of its last dim")


def _gather(comm: Collectives, dims, tree):
    """Each cut leaf all-gathered along its dim; whole leaves as they are."""
    return _map(lambda x, d: x if d is None else comm.all_gather(x, d),
                      tree, dims)


# --------------------------------------------------------------- core -------

def _global_sq_sums(comm: Collectives, dims):
    """``clip_by_global_norm``'s ``sq_sums`` for a sharded tree: the sharded
    leaves' sums of squares added over the ranks (one all-reduce of them
    all), the replicated leaves' counted once."""
    cut = [d is not None for _p, d in _flat(dims)]

    def sq_sums(sums):
        idx = [i for i, c in enumerate(cut) if c]
        if not idx:
            return sums
        total = comm.all_reduce_sum(torch.stack([sums[i] for i in idx]))
        out = list(sums)
        for j, i in enumerate(idx):
            out[i] = total[j]
        return out
    return sq_sums


def _rows(batch: dict, specs: dict, sizes: dict, coords: dict) -> dict:
    return {k: local_shard(torch.as_tensor(v), specs[k], sizes, coords)
            for k, v in batch.items()}


def _grads(cfg, params, batch, k: int):
    """(metrics, gradient) of the loss over ``batch``, over ``k``
    micro-batches: gradients accumulated in fp32 and divided by k, metrics
    averaged (the JAX step's ``lax.scan``)."""
    if k <= 1:
        _loss, grads, metrics = tfm.value_and_grad(params, batch, cfg,
                                                   with_metrics=True)
        return metrics, grads
    mb = {key: v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))
          for key, v in batch.items()}
    acc, ms = None, []
    for i in range(k):
        _loss, g, m = tfm.value_and_grad(
            params, {key: v[i] for key, v in mb.items()}, cfg,
            with_metrics=True)
        acc = (tree_map(lambda x: x.float(), g) if acc is None
               else _map(lambda a, x: a + x.float(), acc, g))
        ms.append(m)
    kk = torch.tensor(k, dtype=torch.float32,
                      device=params["final_norm"].device)
    grads = tree_map(lambda a: a / kk, acc)
    metrics = {key: torch.stack([m[key] for m in ms]).mean()
               for key in ms[0]}
    return metrics, grads


def train_step_fn(arch: ArchConfig, layout: Layout, state_layout: Layout,
                  batch_specs: dict, comm: Collectives) -> Callable:
    """One optimizer step over the ranks of ``comm``: parameters gathered
    on use, the local rows' gradient reduced (all-reduce for whole leaves,
    reduce-scatter for cut ones), the clip's norm over the shards, the
    update on each rank's own pieces."""
    cfg, tc = arch.model, arch.train
    opt = make_optimizer(tc)
    k = max(tc.micro_batches, 1)
    sq_sums = _global_sq_sums(comm, layout.dims)

    def step(params, opt_state, batch):
        full = _gather(comm, layout.dims, params)
        local = _rows(batch, batch_specs, layout.sizes, layout.coords)
        metrics, grads = _grads(cfg, full, local, k)
        del full
        grads = _map(lambda g, d: comm.all_reduce_mean(g) if d is None
                           else comm.reduce_scatter_mean(g, d),
                           grads, layout.dims)
        names = sorted(metrics)
        avg = comm.all_reduce_mean(torch.stack([metrics[n] for n in names]))
        metrics = {n: avg[i] for i, n in enumerate(names)}
        new_p, new_s, stats = opt.update(grads, opt_state, params,
                                         sq_sums=sq_sums)
        metrics.update(stats)
        return new_p, new_s, metrics

    return step


# ------------------------------------------------------------- train --------

@dataclass
class BuiltStep:
    fn: Callable                      # the step on each rank's own tensors
    in_specs: tuple                   # abstract inputs (meta tensors)
    ctx: ShardingCtx
    arch: ArchConfig
    kind: str
    layouts: tuple = ()               # (params, optimizer state) layouts
    comm: Collectives | None = None

    def shard(self, tree, which: int = 0):
        """A full tree (0: parameters, 1: optimizer state) -> this rank's
        pieces."""
        return self.layouts[which].shard(tree)

    def gather(self, tree, which: int = 0):
        """This rank's pieces -> the full tree (an all-gather per cut
        leaf)."""
        return _gather(self.comm, self.layouts[which].dims, tree)


def _shape(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _batch_specs(arch, sh, batch_specs):
    if batch_specs is None:
        from repro_torch.launch.specs import input_specs
        batch_specs = input_specs(arch, sh)["batch"]
    return batch_specs


def build_train_step(arch: ArchConfig, mesh, shape: ShapeConfig | str,
                     batch_specs: dict | None = None,
                     group_axes: tuple = ("pod", "data", "model"),
                     ctx: ShardingCtx | None = None,
                     comm_name: str = "train") -> BuiltStep:
    """The train step of ``arch`` on ``mesh``.  ``group_axes``: the axes
    its collectives span (the local-SGD inner step leaves out "pod");
    ``ctx``: the sharding context (default :func:`_effective_ctx`)."""
    sh = _shape(shape)
    fence_ssd_rounding(arch, sh.seq_len)
    ctx = ctx or _effective_ctx(arch, mesh, "train", sh.global_batch)
    refuse_tensor_parallel(ctx)
    tc = arch.train
    opt = make_optimizer(tc)
    params_abs = abstract_params(arch.model)
    pspecs = resolve_shardings(ctx, param_axes(arch.model), params_abs)
    layout = _layout(pspecs, mesh)
    _check_8bit_blocks(tc, params_abs, layout)
    opt_abs = opt.init(params_abs)
    state_layout = _layout(_state_specs(tc, pspecs), mesh)
    batch_specs = _batch_specs(arch, sh, batch_specs)
    bspecs = batch_shardings(ctx, batch_specs)
    comm = Collectives(mesh.group(*group_axes), comm_name)
    core = train_step_fn(arch, layout, state_layout, bspecs, comm)

    def train_step(params, opt_state, batch):
        with use_sharding(ctx):
            return core(params, opt_state, batch)

    return BuiltStep(train_step, (params_abs, opt_abs, batch_specs), ctx,
                     arch, "train", (layout, state_layout), comm)


# ------------------------------------------------------ prefill / serve -----

def build_prefill_step(arch: ArchConfig, mesh, shape: ShapeConfig | str,
                       batch_specs: dict | None = None) -> BuiltStep:
    """fn(params, batch) -> the last position's fp32 logits (b, 1, V) of
    the global batch: each rank's rows, joined over the ranks."""
    sh = _shape(shape)
    ctx = _effective_ctx(arch, mesh, "prefill")
    refuse_tensor_parallel(ctx)
    params_abs = abstract_params(arch.model)
    layout = _layout(resolve_shardings(ctx, param_axes(arch.model),
                                       params_abs), mesh)
    batch_specs = _batch_specs(arch, sh, batch_specs)
    bspecs = batch_shardings(ctx, batch_specs)
    comm = Collectives(mesh.group("pod", "data", "model"), "prefill")
    cut = shard_count(bspecs[next(iter(bspecs))], 0, layout.sizes) > 1

    def prefill_step(params, batch):
        with use_sharding(ctx):
            local = _rows(batch, bspecs, layout.sizes, layout.coords)
            logits, _ = tfm.forward(_gather(comm, layout.dims, params),
                                    local, arch.model,
                                    last_only=True)
        return comm.all_gather(logits, 0) if cut else logits

    return BuiltStep(prefill_step, (params_abs, batch_specs), ctx, arch,
                     "prefill", (layout,), comm)


def build_serve_step(arch: ArchConfig, mesh, shape: ShapeConfig | str
                     ) -> BuiltStep:
    """fn(params, cache, token, pos) -> (fp32 logits of the global batch,
    the cache): the cache holds this rank's rows (the batch dim of its
    leaves cut as the token's), updated in place."""
    sh = _shape(shape)
    ctx = _effective_ctx(arch, mesh, "decode")
    refuse_tensor_parallel(ctx)
    params_abs = abstract_params(arch.model)
    layout = _layout(resolve_shardings(ctx, param_axes(arch.model),
                                       params_abs), mesh)
    tok_spec = ctx.value_pspec((sh.global_batch,), ("batch",))
    comm = Collectives(mesh.group("pod", "data", "model"), "serve")
    n = shard_count(tok_spec, 0, layout.sizes)
    from repro_torch.launch.specs import input_specs
    specs = input_specs(arch, sh)

    def serve_step(params, cache, token, pos):
        with use_sharding(ctx):
            tok = torch.as_tensor(token)
            if n > 1:
                tok = tok.chunk(n)[shard_index(tok_spec, 0, layout.sizes,
                                               layout.coords)]
            logits, cache = tfm.decode_step(_gather(comm, layout.dims,
                                                    params), cache, tok,
                                            int(pos), arch.model)
        return (comm.all_gather(logits, 0) if n > 1 else logits), cache

    return BuiltStep(serve_step, (params_abs, specs["cache"], specs["token"],
                                  specs["pos"]), ctx, arch, "decode",
                     (layout,), comm)


def build_step(arch: ArchConfig, mesh, shape: ShapeConfig | str) -> BuiltStep:
    sh = _shape(shape)
    if sh.kind == "train":
        return build_train_step(arch, mesh, sh)
    if sh.kind == "prefill":
        return build_prefill_step(arch, mesh, sh)
    return build_serve_step(arch, mesh, sh)
