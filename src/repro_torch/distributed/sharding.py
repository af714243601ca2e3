"""Logical-axis sharding: resolve ('embed','heads',...) -> mesh axes.

The port's counterpart of the JAX package's ``distributed/sharding.py``,
its arithmetic bit for bit.  Models are written against *logical* axis
names; a :class:`ShardingCtx` maps them to mesh axes.  A spec is what JAX
calls a ``PartitionSpec``: a tuple with one entry per tensor dim, each
``None`` (replicated), a mesh-axis name, or a tuple of two or more names.
:func:`placements` maps a spec onto a ``DeviceMesh`` as DTensor placements
(``Shard(dim)`` / ``Replicate()``), and :func:`local_shard` cuts a rank's
piece of a full tensor the same way.

The mesh is anything with ``axis_names`` and a ``shape`` dict (the port's
:class:`repro_torch.launch.mesh.Mesh`, or a plain stand-in that only
names sizes, as the rules need nothing else).  :func:`hint` is the
identity: outside a ctx as in JAX, and inside one because each rank's
activations already are its shard of the batch.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Optional

from repro_torch.configs.base import ShardingRules

_TLS = threading.local()


def _logical_map(rules: ShardingRules, mesh) -> dict:
    axes = set(mesh.axis_names)
    batch_axes = ("pod", "data", "model") if rules.dp_over_model \
        else ("pod", "data")
    batch = tuple(a for a in batch_axes if a in axes)
    m = {
        "batch": batch or None,
        "group": batch or None,          # MoE dispatch groups track data shards
        "seq": rules.seq,
        "embed": rules.embed,
        "heads": rules.heads,
        "kv_heads": rules.heads,         # same axis family as heads
        "head_dim": None,
        "ff": rules.ff,
        "vocab": rules.vocab,
        "experts": rules.experts,
        "kv_seq": rules.kv_seq,
        "img_seq": None,
        "layers": None,
        "lora": None,
        "state": None,
        "conv": None,
        None: None,
    }
    if rules.dp_over_model:
        # pure DP: weight TP mappings would fight the batch sharding
        for k in ("heads", "kv_heads", "ff", "vocab", "experts", "seq",
                  "kv_seq"):
            m[k] = None
    return {k: (v if v in axes or v is None or isinstance(v, tuple) else None)
            for k, v in m.items()}


def _names(m) -> tuple:
    """The mesh-axis names of one spec entry."""
    return (m,) if isinstance(m, str) else tuple(m or ())


def _spec(entries) -> tuple:
    """Entries as a spec, a one-axis tuple written as the axis name (as
    ``PartitionSpec`` writes it)."""
    return tuple(m[0] if isinstance(m, tuple) and len(m) == 1 else m
                 for m in entries)


class ShardingCtx:
    def __init__(self, mesh, rules: ShardingRules):
        self.mesh = mesh
        self.rules = rules
        self.map = _logical_map(rules, mesh)

    def pspec(self, axes: tuple) -> tuple:
        return _spec(self._dedup([self.map.get(a, None) for a in axes]))

    @staticmethod
    def _dedup(mesh_axes: list) -> list:
        """A mesh axis may shard at most one dim -- first occurrence wins
        (e.g. EP keeps "model" on the experts dim; the per-expert ff falls
        back to replication)."""
        seen: set = set()
        out = []
        for m in mesh_axes:
            ms = _names(m)
            if any(a in seen for a in ms):
                out.append(None)
            else:
                seen.update(ms)
                out.append(m)
        return out

    def _axis_size(self, m) -> int:
        if m is None:
            return 1
        return math.prod(self.mesh.shape[a] for a in _names(m))

    def fit_axes(self, dim: int, m):
        """Trim trailing axes of a tuple mapping until it divides `dim`
        (e.g. global_batch=256 with batch axes (pod,data,model)=512 shards
        falls back to (pod,data)=32)."""
        if m is None or isinstance(m, str):
            return m if dim % self._axis_size(m) == 0 else None
        axes = tuple(m)
        while axes and dim % self._axis_size(axes) != 0:
            axes = axes[:-1]
        return axes or None

    # ---- parameter sharding with FSDP fill-in -------------------------------
    def param_pspec(self, shape: tuple, axes: tuple) -> tuple:
        mesh_axes = [self.map.get(a, None) for a in axes]
        # drop mappings that do not divide the dim (tiny smoke shapes, scales)
        mesh_axes = [m if shape[i] % self._axis_size(m) == 0 else None
                     for i, m in enumerate(mesh_axes)]
        mesh_axes = self._dedup(mesh_axes)
        fsdp = self.rules.fsdp_axis
        if isinstance(fsdp, str):
            fsdp = (fsdp,) if fsdp in self.mesh.axis_names else ()
        else:
            fsdp = tuple(a for a in (fsdp or ()) if a in self.mesh.axis_names)
        if fsdp:
            fsdp_size = math.prod(self.mesh.shape[a] for a in fsdp)
            used = set()
            for x in mesh_axes:
                used.update(_names(x))
            if not used & set(fsdp):
                # shard the largest still-replicated, divisible dim over fsdp axis
                cands = [(shape[i], i) for i, m in enumerate(mesh_axes)
                         if m is None and axes[i] != "layers"
                         and shape[i] % fsdp_size == 0 and shape[i] >= fsdp_size]
                if cands:
                    _, i = max(cands)
                    mesh_axes[i] = fsdp if len(fsdp) > 1 else fsdp[0]
        return _spec(mesh_axes)

    def value_pspec(self, shape: tuple, axes: tuple) -> tuple:
        """An activation's or batch's spec: each dim's mapping trimmed until
        it divides the dim (the step builders' ``_value_pspec``)."""
        mesh_axes = [self.fit_axes(shape[i], self.map.get(a, None))
                     for i, a in enumerate(axes)]
        return _spec(self._dedup(mesh_axes))


def current() -> Optional[ShardingCtx]:
    return getattr(_TLS, "ctx", None)


@contextmanager
def use_sharding(ctx: Optional[ShardingCtx]):
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = ctx
    try:
        yield ctx
    finally:
        _TLS.ctx = prev


def hint(x, *axes: Optional[str]):
    """Name an activation's logical axes (no-op w/o ctx).  Each rank holds
    its own rows of the batch, so within a ctx it is the identity too; a
    rank mismatch raises, as in JAX."""
    ctx = current()
    if ctx is not None and x.ndim != len(axes):
        raise ValueError(f"rank mismatch: {tuple(x.shape)} vs {axes}")
    return x


# ------------------------------------------------------------ placement -----

def placements(spec: tuple, mesh_dim_names: tuple) -> tuple:
    """A spec as DTensor placements over a mesh with these dim names: one
    ``Shard(d)`` per mesh dim that shards tensor dim d, ``Replicate()`` for
    the others.  A dim sharded over a tuple of mesh axes is split by them
    in the tuple's order, major first (JAX's and DTensor's convention for
    mesh dims listed in order)."""
    from torch.distributed.tensor import Replicate, Shard
    by_axis = {a: d for d, m in enumerate(spec) for a in _names(m)}
    unknown = set(by_axis) - set(mesh_dim_names)
    if unknown:
        raise ValueError(f"spec {spec} names axes {sorted(unknown)} that the "
                         f"mesh {mesh_dim_names} lacks")
    for m in spec:
        names = _names(m)
        order = [mesh_dim_names.index(a) for a in names]
        if order != sorted(order):
            raise ValueError(f"spec entry {m}: DTensor splits a dim over "
                             f"mesh dims in the mesh's order {mesh_dim_names}")
    return tuple(Shard(by_axis[a]) if a in by_axis else Replicate()
                 for a in mesh_dim_names)


def shard_count(spec: tuple, dim: int, sizes: dict) -> int:
    """How many pieces ``spec`` cuts tensor dim ``dim`` into, over the axes
    of ``sizes`` (axis -> size; axes not listed count as 1)."""
    return math.prod(sizes.get(a, 1) for a in _names(spec[dim]))


def shard_index(spec: tuple, dim: int, sizes: dict, coords: dict) -> int:
    """A rank's piece of tensor dim ``dim``: its coordinates on the dim's
    axes read as one number, the first axis major."""
    idx = 0
    for a in _names(spec[dim]):
        idx = idx * sizes.get(a, 1) + coords.get(a, 0)
    return idx


def local_shard(x, spec: tuple, sizes: dict, coords: dict):
    """The piece of the full tensor ``x`` that a rank at ``coords`` (axis
    -> index) holds under ``spec``, over the axes of ``sizes``."""
    for d in range(len(spec)):
        n = shard_count(spec, d, sizes)
        if n > 1:
            x = x.chunk(n, dim=d)[shard_index(spec, d, sizes, coords)]
    return x
