"""Per-round telemetry snapshots for elastic fleet control (DESIGN.md §13).

A :class:`Telemetry` is everything a scaling policy may observe at a sync
boundary: statistical progress (loss and per-round loss drop), system
progress (round time, the share of wall time spent in metered
communication), and money (the platform's bill so far).  Policies see
ONLY this snapshot -- they never touch the engine context -- which is
what keeps the ``static`` path byte-identical and makes policies trivially
unit-testable with hand-built snapshots.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Telemetry:
    """One sync-boundary observation handed to a scaling policy."""
    round: int                   # fleet rounds completed so far
    workers: int                 # current fleet width
    loss: float | None           # latest evaluated loss (None before any eval)
    loss_delta: float | None     # loss drop per round since the last
                                 # observation (positive = improving; None
                                 # until two evals exist)
    round_time: float            # simulated s per round since last observation
    comm_share: float            # metered comm s / total elapsed s, in [0, 1]
    cost_so_far: float           # the platform bill if the run stopped now ($)
    sim_time: float              # max worker clock (s)
    min_workers: int             # the FleetSpec's elastic floor
    max_workers: int             # the FleetSpec's elastic ceiling

    @property
    def progress_rate(self) -> float | None:
        """Loss drop per simulated second -- SMLT's widen/narrow signal.
        None until a loss delta exists; 0-time rounds report None too."""
        if self.loss_delta is None or self.round_time <= 0.0:
            return None
        return self.loss_delta / self.round_time


@dataclass(frozen=True)
class ServingTelemetry:
    """One autoscaler-window observation of a serving fleet (DESIGN.md §14).

    Field names are chosen so the training policies whose ``observe`` only
    reads scheduling state (``StaticPolicy``, ``SchedulePolicy`` via
    ``round``/``workers``) or money (``CostCapPolicy`` via ``cost_so_far``/
    ``min_workers``) work on serving snapshots unchanged -- the registry
    grammar carries over; only the load-driven policy (smlt) is re-read on
    serving signals (queue depth + utilization instead of loss deltas).
    """
    round: int                   # autoscaler windows completed so far
    workers: int                 # replicas (provisioned) or concurrency cap
    qps: float                   # arrivals/s over the window
    queue_depth: int             # requests waiting at the window boundary
    p50_ms: float | None         # window completion-latency percentiles
    p99_ms: float | None         # (None if nothing completed this window)
    utilization: float           # busy replica-seconds / capacity, in [0, 1]
    cost_so_far: float           # serving bill if traffic stopped now ($)
    sim_time: float              # window boundary on the simulated clock (s)
    min_workers: int             # elastic floor
    max_workers: int             # elastic ceiling
