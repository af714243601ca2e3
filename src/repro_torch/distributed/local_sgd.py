"""MA-SGD on pods: local SGD / DiLoCo across the "pod" mesh axis.

The port's counterpart of the JAX package's ``distributed/local_sgd.py``:
the paper's central insight mapped to multi-pod training.  MA-SGD beats
GA-SGD exactly when the communication channel is slow relative to
compute (§4.2): workers train locally and average models every H steps
instead of averaging gradients every step.  Across pods the slow channel
is the inter-pod link, so:

- inner step: each pod's replica takes a normal train step on its slice of
  the global batch (pod i takes rows i*B/P .. (i+1)*B/P, as JAX's
  ``P(("pod", "data"))`` lays them out), with collectives over the ranks of
  its own pod only: it issues none over the pod group;
- outer step (every H inner steps): average the replicas over the pods in
  fp32 (MA-SGD; GA-SGD takes the same averaging outer), or apply DiLoCo's
  Nesterov outer step to ``outer - mean(inner)``, optionally with int8 +
  error feedback on the wire: one fp32 scale per last-axis row of each
  rank's own piece, codes and scales all-gathered over the pod group (a
  quarter of the fp32 bytes plus the scales).

The pods are either stacked (every rank carries all P replicas as the
leading dim of its tensors: one card runs ``--mesh 2x1x1``) or spread over
the ranks (each rank's leading dim is 1, its own pod's).  Both gather
every pod's contribution in pod order and average it the same way, so
they give the same numbers bit for bit.  The quantiser is
:func:`repro_torch.kernels.quant8.ref.quantize8_ef_ref` along the last
axis, the JAX package's ``quantize_int8_ef`` formula; as there, it is plain
tensor code, not a kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.sync import DiLoCoOuter
from repro_torch.distributed.sharding import ShardingCtx
from repro_torch.distributed.step import (
    Collectives, _effective_ctx, _shape, build_train_step,
)
from repro_torch.kernels.quant8.ref import dequantize8_ref, quantize8_ef_ref
from repro_torch.models.common import tree_map
from repro_torch.optim import _flat, _map


def _inner_ctx(arch: ArchConfig, mesh) -> ShardingCtx:
    """The sharding ctx of one pod's step: batch maps to 'data' only and
    nothing references 'pod'."""
    ctx = _effective_ctx(arch, mesh, "train")
    ctx.map["batch"] = ("data",) if "data" in mesh.axis_names else None
    ctx.map["group"] = ctx.map["batch"]
    return ctx


def _flat_leaves(tree) -> list:
    return [x for _path, x in _flat(tree)]


@dataclass
class LocalSGDStep:
    """inner_fn(params_st, opt_st, batch) -> (params_st, opt_st, metrics)
    outer_fn(params_st, outer_state) -> (params_st, outer_state)
    run H inner steps, then one outer step.  Stacked trees carry this
    rank's pods (``pods``) as their leading dim."""
    inner_fn: Callable
    outer_fn: Callable
    init_outer_fn: Callable
    pod_losses: Callable              # metrics -> every pod's loss, (P,)
    inner: object                     # one pod's BuiltStep
    pods: tuple = (0,)
    n_pods: int = 1
    sync_period: int = 1
    pod_group: object = None          # None where the pods are stacked

    def stack(self, tree, which: int = 0):
        """A full tree (0: parameters, 1: optimizer state) -> this rank's
        pieces, one per local pod, stacked."""
        piece = self.inner.shard(tree, which)
        return tree_map(lambda x: torch.stack([x] * len(self.pods)), piece)

    def restack(self, tree_st, which: int = 0):
        """A full stacked tree (P, ...) -> this rank's stacked pieces."""
        return _stack([self.inner.shard(tree_map(lambda x: x[g], tree_st),
                                        which) for g in self.pods])

    def gather(self, tree_st, which: int = 0):
        """This rank's stacked pieces -> the full stacked tree (P, ...)."""
        full = _stack([self.inner.gather(tree_map(lambda x: x[i], tree_st),
                                         which)
                       for i in range(len(self.pods))])
        comm = Collectives(self.pod_group, "checkpoint")
        return tree_map(lambda x: comm.all_gather(x, 0), full)

    def gather_outer(self, state):
        """The outer state's full tree (residuals stacked over all pods)."""
        out = {k: self.inner.gather(v) for k, v in state.items()
               if k != "residual"}
        if "residual" in state:
            out["residual"] = self.gather(state["residual"])
        return out

    def shard_outer(self, state):
        """A full outer state -> this rank's pieces."""
        out = {k: self.inner.shard(v) for k, v in state.items()
               if k != "residual"}
        if "residual" in state:
            out["residual"] = self.restack(state["residual"])
        return out


def build_local_sgd(arch: ArchConfig, mesh, shape: ShapeConfig | str,
                    batch_specs: dict | None = None) -> LocalSGDStep:
    if "pod" not in mesh.axis_names:
        raise ValueError("local SGD needs a mesh with a 'pod' axis")
    sh = _shape(shape)
    n_pods = mesh.shape["pod"]
    stacked = "pod" in mesh.stacked
    pods = tuple(range(n_pods)) if stacked else (mesh.coords["pod"],)
    tc = arch.train
    if sh.global_batch % n_pods:
        raise ValueError(f"batch {sh.global_batch} does not split over "
                         f"{n_pods} pods")
    rows = sh.global_batch // n_pods
    pod_shape = ShapeConfig(sh.name, sh.seq_len, rows, sh.kind)
    if batch_specs is not None:
        batch_specs = {k: torch.empty((rows,) + tuple(v.shape[1:]),
                                      dtype=v.dtype, device="meta")
                       for k, v in batch_specs.items()}
    inner = build_train_step(arch, mesh, pod_shape, batch_specs,
                             group_axes=("data", "model"),
                             ctx=_inner_ctx(arch, mesh), comm_name="inner")
    pod_comm = Collectives(None if stacked else mesh.group("pod"), "pod")

    # ---------------------------------------------------------- inner -------
    def inner_fn(params_st, opt_st, batch):
        outs = []
        for i, g in enumerate(pods):
            part = {k: torch.as_tensor(v)[g * rows:(g + 1) * rows]
                    for k, v in batch.items()}
            outs.append(inner.fn(tree_map(lambda x: x[i], params_st),
                                 tree_map(lambda x: x[i], opt_st), part))
        metrics = {k: torch.stack([o[2][k] for o in outs])
                   for k in outs[0][2]}
        # NO collective over "pod": the metrics come back per local pod
        return _stack([o[0] for o in outs]), _stack([o[1] for o in outs]), \
            metrics

    # ---------------------------------------------------------- outer -------
    algo = tc.algorithm  # ma_sgd | diloco (ga_sgd takes ma_sgd's outer)
    compress = tc.compress_cross_pod

    def init_outer(params_st):
        p0 = tree_map(lambda x: x[0].float(), params_st)
        state = {"outer_params": p0}
        if algo == "diloco":
            state["momentum"] = tree_map(torch.zeros_like, p0)
        if compress:
            state["residual"] = tree_map(
                lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                      device=x.device), params_st)
        return state

    def gather_pods(x):
        """(local pods, ...) -> (P, ...): every pod's, in pod order (the
        identity where the pods are stacked, counted all the same)."""
        return pod_comm.all_gather(x, 0)

    def mean_pods(x, res):
        """x (local pods, ...) fp32 -> (the mean over all P pods, the new
        residual)."""
        if not compress:
            return gather_pods(x).mean(dim=0), None
        q, scale, _deq, new_res = quantize8_ef_ref(x + res, axis=-1)
        deq = dequantize8_ref(gather_pods(q), gather_pods(scale))
        return deq.mean(dim=0), new_res

    def outer_step(params_st, state):
        leaves = _flat_leaves(params_st)
        res = (_flat_leaves(state["residual"]) if compress
               else [None] * len(leaves))
        new_state = dict(state)
        if algo != "diloco":
            outs = [mean_pods(x.float(), r) for x, r in zip(leaves, res)]
            mean = _unflat(params_st, [o[0] for o in outs])
            new_p = _map(lambda x, m: m.to(x.dtype)[None].expand(
                x.shape).clone(), params_st, mean)
            new_state["outer_params"] = mean
        else:
            outer_opt = DiLoCoOuter(tc.outer_lr, tc.outer_momentum)
            o_l = _flat_leaves(state["outer_params"])
            m_l = _flat_leaves(state["momentum"])
            new_o, new_m, outs = [], [], []
            for x, o, m, r in zip(leaves, o_l, m_l, res):
                mean_delta, nr = mean_pods(o[None] - x.float(), r)
                no, nm = outer_opt.step(o, m, mean_delta)
                new_o.append(no)
                new_m.append(nm)
                outs.append((None, nr))
            new_state["outer_params"] = _unflat(params_st, new_o)
            new_state["momentum"] = _unflat(params_st, new_m)
            new_p = _map(lambda x, o: o.to(x.dtype)[None].expand(
                x.shape).clone(), params_st, new_state["outer_params"])
        if compress:
            new_state["residual"] = _unflat(params_st, [o[1] for o in outs])
        return new_p, new_state

    def pod_losses(metrics):
        """Every pod's loss, for the log (outside the steps)."""
        if stacked:
            return metrics["loss"]
        return Collectives(mesh.group("pod"), "log").all_gather(
            metrics["loss"], 0)

    return LocalSGDStep(inner_fn, outer_step, init_outer, pod_losses, inner,
                        pods, n_pods, tc.sync_period,
                        None if stacked else mesh.group("pod"))


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _unflat(like, leaves: list):
    """``leaves`` (in JAX's order) as a tree shaped like ``like``."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)
    return walk(like)
