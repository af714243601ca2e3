"""Meshes: named axes and their sizes, spread over ``torch.distributed``
ranks.

The port's counterpart of the JAX package's ``launch/mesh.py``.  The
single-pod production mesh is 16x16 = 256 devices over ("data","model");
multi-pod prepends a "pod" axis (2x16x16 = 512).  A :class:`Mesh` names
its axes and their sizes.  Where a process group is up, its ranks span the
mesh's axes in row-major order (rank = ((pod * data) + d) * model + m) and
a ``DeviceMesh`` over them carries the DTensor view; the groups of ranks
that differ only along some axes are made once, here (every rank makes
them all, in one order, as ``torch.distributed.new_group`` needs).

**The "pod" axis may instead be stacked**: when the world holds only
data x model ranks, each rank carries every pod's replica as the leading
dim of its tensors (the local-SGD step's ``params_st``, stacked in JAX
too), so one card runs ``--mesh 2x1x1``.

A data or model axis larger than the world raises, and so does a mesh
whose ranks do not fill the world.  Tensor parallelism (a "model" axis
above 1 that the rules put weights on) is refused by the step builders
(ROADMAP.md queue A10).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.device import resolve_device

AXES = ("pod", "data", "model")


@dataclass
class Mesh:
    axis_names: tuple
    shape: dict                      # axis -> size, in axis order
    stacked: tuple = ()              # axes carried by a stacked leading dim
    rank: int = 0
    world: int = 1
    device: Any = None
    device_mesh: Any = None          # a DeviceMesh over the rank axes
    _groups: dict = field(default_factory=dict, repr=False)

    @property
    def rank_axes(self) -> tuple:
        """The axes that the ranks span (the mesh's, less the stacked)."""
        return tuple(a for a in self.axis_names if a not in self.stacked)

    @property
    def rank_sizes(self) -> dict:
        return {a: self.shape[a] for a in self.rank_axes}

    @property
    def coords(self) -> dict:
        """This rank's index along each rank axis."""
        out, r = {}, self.rank
        for a in reversed(self.rank_axes):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return out

    def group(self, *axes: str):
        """The process group of the ranks that differ from this one only
        along ``axes`` (stacked axes ignored); None without a process
        group (the collectives over it are then the identity)."""
        key = tuple(a for a in self.rank_axes if a in axes)
        return self._groups.get(key)


def _groups(rank_axes: tuple, sizes: dict, rank: int) -> dict:
    """For every subset of the rank axes, this rank's group: the ranks that
    share its coordinates on the other axes.  Every rank creates every
    group in the same order."""
    import torch.distributed as dist
    grid = torch.arange(math.prod(sizes[a] for a in rank_axes)).reshape(
        [sizes[a] for a in rank_axes] or [1])
    out = {}
    for n in range(1, len(rank_axes) + 1):
        for subset in itertools.combinations(rank_axes, n):
            keep = [rank_axes.index(a) for a in subset]
            rest = [i for i in range(len(rank_axes)) if i not in keep]
            blocks = grid.permute(rest + keep).reshape(
                -1, math.prod(sizes[a] for a in subset))
            for ranks in blocks.tolist():
                g = dist.new_group(ranks)
                if rank in ranks:
                    out[subset] = g
    return out


def make_mesh(shape, axes, *, device=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` (("data","model") or
    ("pod","data","model")) on ``device`` (None -> the card; raises
    without one).  Without a process group the world is one rank."""
    import torch.distributed as dist
    shape, axes = tuple(int(x) for x in shape), tuple(axes)
    if len(shape) != len(axes) or set(axes) - set(AXES) or \
            list(axes) != [a for a in AXES if a in axes]:
        raise ValueError(f"mesh {shape} over {axes}: want sizes for "
                         f"('data', 'model') or ('pod', 'data', 'model')")
    dev = resolve_device(device)
    sizes = dict(zip(axes, shape))
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    rank = dist.get_rank() if up else 0
    inner = sizes.get("data", 1) * sizes.get("model", 1)
    for a in ("data", "model"):
        if sizes.get(a, 1) > world:
            raise ValueError(
                f"mesh axis {a}={sizes[a]} is larger than the world of "
                f"{world} rank(s): start one process per rank "
                f"(torch.distributed) or use a smaller mesh")
    if math.prod(shape) == world:
        stacked = ()
    elif "pod" in axes and inner == world:
        stacked = ("pod",)
    else:
        raise ValueError(f"mesh {sizes} does not fit a world of {world} "
                         f"rank(s): its ranks must fill the world (the pod "
                         f"axis may be stacked on each rank)")
    mesh = Mesh(axes, sizes, stacked, rank, world, dev)
    if up:
        from torch.distributed.device_mesh import DeviceMesh
        rank_shape = [sizes[a] for a in mesh.rank_axes]
        mesh.device_mesh = DeviceMesh(
            dev.type, torch.arange(world).reshape(rank_shape),
            mesh_dim_names=mesh.rank_axes)
        mesh._groups = _groups(mesh.rank_axes, sizes, rank)
    return mesh


def abstract_mesh(shape, axes) -> Mesh:
    """Sizes and names only (no ranks, no device): what the sharding rules
    read, as JAX's ``AbstractMesh``."""
    return Mesh(tuple(axes), dict(zip(axes, (int(x) for x in shape))))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_local_mesh(device=None) -> Mesh:
    """1x1 mesh on one device (the card unless ``device`` says otherwise)."""
    return make_mesh((1, 1), ("data", "model"), device=device)
