"""The **Collective** axis of the communication design space (DESIGN.md §12).

A collective is *how a fleet's update vectors are reduced to one* over a
transport.  The store-based collectives (paper §3.2.3, Fig 4) implement the
two-phase synchronous protocol of §3.2.4 (merge phase + update phase,
file-name polling) over any transport exposing the metered ``put``/``get``
surface; the network collectives reduce with the paper's closed-form ring /
push-pull models over the transport's Table 6/2 constants.

Each collective takes the workers' flat update vectors (tensors), moves
them through the transport (real payloads), and returns ``(merged_vector,
per_worker_times)`` -- AllReduce's leader bottleneck and ScatterReduce's
balanced reduce show up exactly as in Table 3, and the two-level tree of
:func:`two_level_reduce` shows the multi-level-reduction scaling of
FSD-Inference (PAPERS.md): leaders touch ``g + w/g`` objects instead of
``w``.

The :class:`Collective` protocol also carries the two facts spec-time
validation needs: ``barrier`` (does the reduce rendezvous the fleet?) and
``max_item_bytes`` (the largest single object the reduce stores -- what the
DynamoDB 400 KB limit is checked against, Table 1's "N/A" cells).
"""
from __future__ import annotations

import math
from typing import Protocol, runtime_checkable

import numpy as np
import torch

POLL = 0.01  # s between list() polls (merge-phase waiting)


def _div_(acc: torch.Tensor, w: int) -> torch.Tensor:
    """In-place ``acc /= w`` as a true IEEE division on every device (on
    CUDA, PyTorch turns a division by a Python scalar into a multiply by
    its reciprocal, which can differ in the last bit)."""
    return acc.div_(torch.full((), float(w), dtype=acc.dtype,
                               device=acc.device))


def mean_of(vecs) -> torch.Tensor:
    """THE merge of per-worker vectors: a sequential add over workers in
    worker order, then one divide -- the arithmetic of the JAX package's
    ``+=``-then-``/= w`` and ``np.mean(np.stack(..), 0)`` merges.  Every
    merge site uses it, so FaaS and IaaS merges stay bitwise equal on the
    card (a ``stack(..).mean(0)`` is a tree reduction in another order)."""
    acc = torch.zeros_like(vecs[0])
    for v in vecs:
        acc += v
    return _div_(acc, len(vecs))


def _poll_until(t_now: float, t_ready: float, latency: float) -> float:
    """Poll (list) until t_ready; each poll costs one latency."""
    if t_now >= t_ready:
        return t_now + latency
    n_polls = int((t_ready - t_now) / max(POLL, latency)) + 1
    return t_ready + latency  # arrives at ready + one confirming list


def allreduce(channel, updates: list, tag: str):
    """Fig 4 left: all write; leader (worker 0) merges; all read merged."""
    w = len(updates)
    lat = channel.spec.latency
    t_put = np.zeros(w)
    for i, u in enumerate(updates):
        t_put[i] = channel.put(f"{tag}/part{i}", u)
    # merge phase: leader polls until all parts visible
    t_all_put = float(np.max(t_put))
    t_leader = _poll_until(t_put[0], t_all_put, lat)
    parts = []
    for i in range(w):
        p, dt = channel.get(f"{tag}/part{i}")
        parts.append(p)
        t_leader += dt
    merged = mean_of(parts)
    t_leader += channel.put(f"{tag}/merged", merged)
    # update phase: everyone else polls for the merged file, then reads it
    times = np.zeros(w)
    for i in range(w):
        if i == 0:
            times[i] = t_leader
        else:
            t = _poll_until(t_put[i], t_leader, lat)
            _, dt = channel.get(f"{tag}/merged")
            times[i] = t + dt
    return merged, times


def scatter_reduce(channel, updates: list, tag: str):
    """Fig 4 right: every worker reduces one partition of the update."""
    w = len(updates)
    lat = channel.spec.latency
    n = updates[0].numel()
    bounds = [int(b) for b in np.linspace(0, n, w + 1, dtype=int)]
    # phase 1: each worker writes w partitions
    t_put = np.zeros(w)
    for i, u in enumerate(updates):
        t = 0.0
        for j in range(w):
            t += channel.put(f"{tag}/p{i}_{j}", u[bounds[j]: bounds[j + 1]])
        t_put[i] = t
    t_all_put = float(np.max(t_put))
    # phase 2: worker j reduces partition j
    merged = torch.zeros_like(updates[0])
    t_reduced = np.zeros(w)
    for j in range(w):
        t = _poll_until(t_put[j], t_all_put, lat)
        parts = []
        for i in range(w):
            p, dt = channel.get(f"{tag}/p{i}_{j}")
            parts.append(p)
            t += dt
        acc = mean_of(parts)
        merged[bounds[j]: bounds[j + 1]] = acc
        t += channel.put(f"{tag}/r{j}", acc)
        t_reduced[j] = t
    t_all_reduced = float(np.max(t_reduced))
    # phase 3: everyone reads the other w-1 reduced partitions
    times = np.zeros(w)
    for i in range(w):
        t = _poll_until(t_reduced[i], t_all_reduced, lat)
        for j in range(w):
            if j != i:
                _, dt = channel.get(f"{tag}/r{j}")
                t += dt
        times[i] = t
    return merged, times


def two_level_reduce(channel, updates: list, tag: str,
                     group_size: int | None = None):
    """Hierarchical two-level reduction (FSD-Inference's multi-level
    scaling, PAPERS.md): workers form groups of ``group_size`` (default
    ``ceil(sqrt(w))``); each group leader reduces its group's parts into one
    partial sum, the global leader (worker 0) reduces the partial sums and
    publishes the merged vector.  Leaders read ``g + w/g`` objects instead
    of AllReduce's ``w`` -- the tree flattens the leader bottleneck for
    large fleets while every byte still crosses the metered transport."""
    w = len(updates)
    lat = channel.spec.latency
    g = int(group_size) if group_size else max(int(math.ceil(math.sqrt(w))), 1)
    groups = [list(range(s, min(s + g, w))) for s in range(0, w, g)]
    # phase 1: everyone writes its update
    t_put = np.zeros(w)
    for i, u in enumerate(updates):
        t_put[i] = channel.put(f"{tag}/part{i}", u)
    # phase 2: each group leader polls for its group's parts and writes the
    # group partial sum
    t_group = np.zeros(len(groups))
    for gi, members in enumerate(groups):
        leader = members[0]
        t = _poll_until(t_put[leader],
                        float(max(t_put[m] for m in members)), lat)
        acc = torch.zeros_like(updates[0])
        for m in members:
            p, dt = channel.get(f"{tag}/part{m}")
            acc += p
            t += dt
        t += channel.put(f"{tag}/g{gi}", acc)
        t_group[gi] = t
    # phase 3: the global leader polls for all group sums and merges
    t_all_groups = float(np.max(t_group))
    t_root = _poll_until(float(t_group[0]), t_all_groups, lat)
    merged = torch.zeros_like(updates[0])
    for gi in range(len(groups)):
        p, dt = channel.get(f"{tag}/g{gi}")
        merged += p
        t_root += dt
    _div_(merged, w)
    t_root += channel.put(f"{tag}/merged", merged)
    # phase 4: everyone else polls for the merged file, then reads it
    times = np.zeros(w)
    for gi, members in enumerate(groups):
        for m in members:
            if m == 0:
                times[m] = t_root
                continue
            t_done = float(t_group[gi]) if m == members[0] else float(t_put[m])
            t = _poll_until(t_done, t_root, lat)
            _, dt = channel.get(f"{tag}/merged")
            times[m] = t + dt
    return merged, times


#: legacy name -> free-function map (the seed-era ``patterns.PATTERNS``)
PATTERNS = {"allreduce": allreduce, "scatter_reduce": scatter_reduce,
            "hierarchical": two_level_reduce}


# ----------------------------------------------------------------- protocol --

@runtime_checkable
class Collective(Protocol):
    """How a fleet reduces one round of update vectors (DESIGN.md §12)."""

    name: str
    #: True: the reduce rendezvouses the fleet (clocks resync at the max);
    #: False: each worker pays the round time from its own clock (push/pull)
    barrier: bool

    def run(self, transport, updates: list, tag: str):
        """-> ``(merged_vector, per_worker_times)`` (times may be scalar)."""
        ...

    def max_item_bytes(self, m_bytes: int, workers: int) -> int:
        """Largest single object this reduce stores on the transport for an
        ``m_bytes`` wire payload -- 0 when nothing is stored (ring/PS)."""
        ...


class StoreAllReduce:
    """Two-phase leader merge over a storage transport (Fig 4 left)."""
    name = "allreduce"
    barrier = True

    def run(self, transport, updates, tag):
        return allreduce(transport, updates, tag)

    def max_item_bytes(self, m_bytes, workers):
        return int(m_bytes)


class StoreScatterReduce:
    """Balanced partition reduce over a storage transport (Fig 4 right)."""
    name = "scatter_reduce"
    barrier = True

    def run(self, transport, updates, tag):
        return scatter_reduce(transport, updates, tag)

    def max_item_bytes(self, m_bytes, workers):
        n = -(-int(m_bytes) // 4)                      # fp32 elements
        return -(-n // max(int(workers), 1)) * 4       # largest partition


class TwoLevelReduce:
    """Hierarchical two-level tree reduce (FSD-Inference scaling)."""
    barrier = True

    def __init__(self, group_size: int | None = None):
        if group_size is not None and int(group_size) < 1:
            raise ValueError(f"hierarchical group size must be >= 1, "
                             f"got {group_size}")
        self.group_size = int(group_size) if group_size else None

    @property
    def name(self) -> str:
        return ("hierarchical" if self.group_size is None
                else f"hierarchical:{self.group_size}")

    def run(self, transport, updates, tag):
        return two_level_reduce(transport, updates, tag, self.group_size)

    def max_item_bytes(self, m_bytes, workers):
        return int(m_bytes)                  # full vectors + group sums


class RingAllReduce:
    """IaaS/pod ring AllReduce: the paper's closed-form ``(2w-2) *
    (m/w/Bn + Ln)`` over the transport's constants; the mean is computed
    in place (nothing is stored on the transport)."""
    name = "ring"
    barrier = True

    def run(self, transport, updates, tag):
        merged = mean_of(updates)
        w = len(updates)
        spec = transport.spec
        if w <= 1:
            return merged, 0.0
        t = (2 * w - 2) * (updates[0].nbytes / w / spec.bandwidth
                           + spec.latency)
        return merged, t

    def max_item_bytes(self, m_bytes, workers):
        return 0


class PSPushPull:
    """Hybrid VM-PS round (Table 2): push grads + server update + pull
    model; each worker pays the round from its own clock (no barrier --
    the PS serializes, it does not rendezvous)."""
    name = "pushpull"
    barrier = False

    def run(self, transport, updates, tag):
        merged = mean_of(updates)
        return merged, transport.push_pull_round(updates[0].nbytes,
                                                 len(updates))

    def max_item_bytes(self, m_bytes, workers):
        return 0


#: every selectable collective: name -> factory(arg_str or None)
COLLECTIVES = {
    "allreduce": lambda arg=None: StoreAllReduce(),
    "scatter_reduce": lambda arg=None: StoreScatterReduce(),
    "hierarchical": lambda arg=None: TwoLevelReduce(
        int(arg) if arg else None),
    "ring": lambda arg=None: RingAllReduce(),
    "pushpull": lambda arg=None: PSPushPull(),
}

#: collectives that store objects on the transport (need put/get; their
#: items are what per-item limits apply to)
STORE_COLLECTIVES = ("allreduce", "scatter_reduce", "hierarchical")


def make_collective(spec) -> Collective:
    """``"allreduce"`` | ``"scatter_reduce"`` | ``"hierarchical[:<g>]"`` |
    ``"ring"`` | ``"pushpull"`` | a :class:`Collective` instance."""
    if not isinstance(spec, str):
        return spec
    name, _, arg = spec.partition(":")
    try:
        factory = COLLECTIVES[name]
    except KeyError:
        raise KeyError(f"unknown collective {spec!r}; available: "
                       f"{', '.join(sorted(COLLECTIVES))}") from None
    return factory(arg or None)


def list_collectives() -> list[str]:
    return sorted(COLLECTIVES)
