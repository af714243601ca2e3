"""Discrete-event training simulation engine (DESIGN.md §4).

One per-worker virtual-clock event loop drives every (infrastructure x sync
protocol) combination in the study.  The engine owns everything that used to
be duplicated between the FaaS and IaaS training loops:

- per-worker clocks, the startup/load prologue, and the time/cost meters,
- the checkpoint/restart machinery (Lambda 15-minute lifetime rotation and
  spot-instance preemption share one code path, DESIGN.md §7.1),
- pluggable straggler and failure processes,
- the ``CommBackend`` seam: one metering interface implemented by the
  composable :class:`repro_torch.core.comm.CommStack` (Transport x Collective x
  Codec, DESIGN.md §12) -- storage channels, the hybrid VM parameter
  server, VM NICs and the cross-pod DCN all plug in through it.

Sync protocols (:mod:`repro_torch.core.sync`) are strategy objects over a
:class:`SimContext`; infrastructures (:mod:`repro_torch.core.runtimes`) are
platform adapters queried through the explicit
:class:`~repro_torch.core.platform.Platform` protocol (the engine itself stays
import-free of concrete platforms, so new protocols and new platforms
compose for free).

All payloads are REAL tensors on the run's device (numerics are exact; only
time and money are simulated) -- the paper's statistical/system efficiency
split.  Clocks, meters and every metered quantity stay numpy float64, as in
the JAX package, so they match it exactly.  The scaling axis is static in
this port: elastic fleets (DESIGN.md §13) are ROADMAP.md queue A4.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any

import numpy as np
import torch

if TYPE_CHECKING:                        # platform.py imports engine at runtime
    from repro_torch.core.platform import Platform

from repro_torch.core.ckpt import Checkpointer, CheckpointSpec
from repro_torch.core.comm import (  # noqa: F401  (adapters re-exported)
    ChannelComm, ChannelItemTooLarge, CommStack, MPIComm, PSComm,
    StorageChannel, VMNetwork,
)
from repro_torch.core.mlmodels import device_data, model_bytes
from repro_torch.core.trace import TraceRecorder
from repro_torch.data.synthetic import partition
from repro_torch.device import resolve_device


@dataclass
class RunResult:
    """Outcome of one simulated training run (shared FaaS/IaaS schema)."""
    system: str
    algorithm: str
    workers: int
    history: list = field(default_factory=list)   # [(sim_time_s, loss)]
    rounds: int = 0
    sim_time: float = 0.0
    cost: float = 0.0
    breakdown: dict = field(default_factory=dict)
    converged: bool = False
    error: str = ""
    preemptions: int = 0          # involuntary restarts (spot / crash)
    max_staleness: int = 0        # max observed round lag at a model read
    comm_bytes: float = 0.0       # per-worker update bytes moved on the
                                  # metered (slow) substrate, whole run
                                  # (WIRE bytes: codecs shrink this exactly)
    comm_cost: float = 0.0        # $ billed by the comm substrate itself
    ckpt_bytes: float = 0.0       # checkpoint bytes moved through the
                                  # metered checkpoint transport (save puts
                                  # + restore gets, repro_torch.core.ckpt)
    ckpt_time: float = 0.0        # simulated checkpoint transfer seconds
                                  # (excludes the cold-start part of a
                                  # restart -- that stays in breakdown)
    ckpt_cost: float = 0.0        # $ of checkpoint put/get requests
    scaling_timeline: list = field(default_factory=list)
                                  # elastic fleets only (DESIGN.md §13,
                                  # not ported yet): [] for fixed fleets
    trace: Any = field(default=None, repr=False)
                                  # TraceRecorder when run with trace=True
                                  # (DESIGN.md §18); None otherwise

    @property
    def final_loss(self) -> float:
        return self.history[-1][1] if self.history else float("nan")

    @property
    def comm_time(self) -> float:
        """Simulated seconds spent in metered communication (the
        ``breakdown["comm"]`` meter every backend feeds uniformly)."""
        return self.breakdown.get("comm", 0.0)

    def to_dict(self):
        """Full-precision record payload.  Rounding is presentation-only
        (see :meth:`summary`): the record keeps every metered float exact
        so span-derived breakdown fractions reconcile bitwise with
        ``sim_time`` and ``cost``."""
        d = {"system": self.system, "algorithm": self.algorithm,
             "workers": self.workers, "rounds": self.rounds,
             "sim_time_s": self.sim_time,
             "cost_usd": self.cost,
             "final_loss": self.final_loss,
             "converged": self.converged,
             "preemptions": self.preemptions,
             "max_staleness": self.max_staleness,
             "comm_bytes": self.comm_bytes,
             "comm_time_s": self.comm_time,
             "comm_cost_usd": self.comm_cost,
             "ckpt_bytes": self.ckpt_bytes,
             "ckpt_time_s": self.ckpt_time,
             "ckpt_cost_usd": self.ckpt_cost,
             "scaling_timeline": [[int(r), int(w), float(s), float(c)]
                                  for r, w, s, c in self.scaling_timeline],
             "breakdown": dict(self.breakdown),
             "error": self.error}
        if self.trace is not None and not self.error:
            from repro_torch.core.trace import check_invariants, derive_breakdown
            inv = check_invariants(self)
            bd = derive_breakdown(self.trace)
            d["trace"] = {
                "spans": len(self.trace.spans),
                "marks": len(self.trace.marks),
                "breakdown": bd["phases"],
                "usd": bd["usd"],
                "invariants": {"clock": inv["clock"]["ok"],
                               "cost": inv["cost"]["ok"],
                               "bytes": inv["bytes"]["ok"]},
            }
        return d

    def summary(self):
        """Presentation view of :meth:`to_dict` -- the legacy 2-decimal
        rounding, applied at the edge instead of inside the record."""
        d = self.to_dict()
        d.update(
            sim_time_s=round(self.sim_time, 2),
            cost_usd=round(self.cost, 4),
            comm_time_s=round(self.comm_time, 2),
            comm_cost_usd=round(self.comm_cost, 6),
            ckpt_time_s=round(self.ckpt_time, 2),
            ckpt_cost_usd=round(self.ckpt_cost, 6),
            scaling_timeline=[[int(r), int(w), round(s, 3), round(c, 6)]
                              for r, w, s, c in self.scaling_timeline],
            breakdown={k: round(v, 2) for k, v in self.breakdown.items()})
        return d


# ------------------------------------------------------------ processes -----

@dataclass
class StragglerProcess:
    """Per-worker relative compute slowdown (1.0 = nominal).

    Log-normal jitter plus one deterministic straggler when ``factor > 1``;
    ``cap`` models backup invocations racing the straggler (effective speed =
    min(own, median), DESIGN.md §7.3).
    """
    factor: float = 1.0
    jitter: float = 0.05
    cap_at_median: bool = False

    def speeds(self, w: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        s = np.exp(rng.normal(0.0, self.jitter, w))
        if self.factor > 1.0:
            s[rng.integers(0, w)] *= self.factor
        if self.cap_at_median:
            s = np.minimum(s, np.median(s))
        return s


class FailureProcess:
    """Base failure process: no preemptions ever."""

    def next_preemption(self, worker: int, after_t: float,
                        before_t: float) -> float | None:
        """Pop the next preemption for ``worker`` due before ``before_t``
        (or None).  ``after_t`` is the start of the queried healthy-runtime
        window; stochastic processes count exposure from it, deterministic
        ones may ignore it and let past events fire clamped to the present.
        Per-worker calls must be time-monotone; a returned event is
        consumed."""
        return None


class PoissonPreemptions(FailureProcess):
    """Memoryless spot-market preemptions at ``rate`` per worker-hour.

    Exposure is counted in *healthy instance runtime*: a replacement
    instance brought up after a preemption starts a fresh memoryless lease,
    so restart/checkpoint time itself is never preempted (and a high rate
    degrades throughput instead of deadlocking the simulation).
    """

    def __init__(self, rate_per_hour: float, workers: int, seed: int = 0):
        self.scale = 3600.0 / max(rate_per_hour, 1e-12)
        self._rng = np.random.default_rng(seed ^ 0x5107)
        # keyed by STABLE worker id (elastic fleets retire ids for good and
        # mint fresh ones for joiners, DESIGN.md §13); the initial fleet is
        # drawn eagerly in id order so fixed fleets stay byte-identical to
        # the seed-era list-based draws
        self._togo = {i: float(self._rng.exponential(self.scale))
                      for i in range(workers)}   # healthy s until next kill

    def next_preemption(self, worker, after_t, before_t):
        if worker not in self._togo:             # elastic joiner: fresh lease
            self._togo[worker] = float(self._rng.exponential(self.scale))
        window = max(before_t - after_t, 0.0)
        if self._togo[worker] >= window:
            self._togo[worker] -= window
            return None
        t = after_t + self._togo[worker]
        self._togo[worker] = float(self._rng.exponential(self.scale))
        return t


class InjectedPreemptions(FailureProcess):
    """Deterministic preemptions at explicit ``(worker, sim_time)`` points --
    the reproducible way to script a spot scenario in tests/benchmarks.

    Unlike :class:`PoissonPreemptions`, ``after_t`` is ignored: a scripted
    kill never silently vanishes.  An injected time that is already in the
    worker's past (e.g. before startup finished) fires at the next query and
    is executed clamped to the worker's current clock."""

    def __init__(self, at: tuple[tuple[int, float], ...]):
        self.at = tuple((int(wk), float(t)) for wk, t in at)
        self._pending: dict[int, list[float]] = {}
        for wk, t in self.at:
            self._pending.setdefault(wk, []).append(t)
        for ts in self._pending.values():
            ts.sort(reverse=True)  # pop() from the end = earliest first

    def next_preemption(self, worker, after_t, before_t):
        ts = self._pending.get(worker)
        if ts and ts[-1] < before_t:
            return ts.pop()
        return None


# --------------------------------------------------------- comm backends ----

class CommBackend:
    """How a fleet moves update vectors.  All backends expose:

    - ``bsp_reduce(ctx, updates, tag)``: merge one BSP round, advancing
      ``ctx.clock`` and the comm meter; returns the merged vector.
    - ``kvstore()``: a metered key-value store (``put``/``get`` returning
      simulated seconds) holding the global model for ASP/SSP.
    - ``service_cost(seconds)``: $ for the communication substrate itself.

    The one real implementation is the composable
    :class:`repro_torch.core.comm.CommStack` (Transport x Collective x Codec,
    DESIGN.md §12); ``ChannelComm``/``PSComm``/``MPIComm`` are its thin
    legacy adapters, re-exported here for the seed-era import paths.
    """

    def bsp_reduce(self, ctx: "SimContext", updates: list, tag: str):
        raise NotImplementedError

    def kvstore(self):
        raise NotImplementedError

    def startup(self) -> float:
        """Seconds to provision the substrate (0 = always-on)."""
        return 0.0

    def service_cost(self, seconds: float) -> float:
        return 0.0


# -------------------------------------------------------------- context -----

@dataclass
class SimContext:
    """Mutable state of one simulated run, shared by engine + protocol."""
    platform: Any
    model: Any
    algo: Any
    states: list
    parts: list
    ds_val: Any                # validation rows, on the run's device
    res: RunResult
    comm: CommBackend
    ckpt_store: Any
    failure: FailureProcess
    clock: np.ndarray          # per-worker virtual time (s)
    invoked_at: np.ndarray     # per-worker start of current lease
    speeds: np.ndarray         # straggler multipliers
    c_round: np.ndarray        # per-worker nominal seconds per round
    mbytes: int
    lifetime: float            # s before planned rotation; inf = never
    lifetime_margin: float
    target_loss: float | None
    max_epochs: int
    eval_every: int
    invocations: int = 0
    ckpt: Any = None           # Checkpointer routing save/restore bytes
                               # through the metered transport (§17)
    # ---- fleet identity (fixed fleets; elastic resizing is queue A4) ----
    worker_ids: np.ndarray = None   # stable identity per position
    joined_at: np.ndarray = None    # sim s each worker started billing
                                    # (0.0 for the whole fixed fleet)
    retired_cost: float = 0.0       # $ billed by retired workers (0.0)
    rec: Any = None                 # TraceRecorder (DESIGN.md §18), or None;
                                    # every emission site is guarded so the
                                    # disabled path is byte-identical

    @property
    def w(self) -> int:
        return len(self.clock)

    def meter_add(self, key: str, dt: float):
        self.res.breakdown[key] = self.res.breakdown.get(key, 0.0) + dt
        if self.rec is not None:
            # mirrored accumulation: same value, same order, so
            # rec.meters stays bitwise-equal to res.breakdown
            self.rec.meter(key, dt)

    def meter_bytes(self, n: float):
        """Count per-worker update bytes crossing the metered substrate
        (the storage channel, the PS link, VM NICs, or the cross-pod DCN
        -- never the free intra-pod ICI)."""
        self.res.comm_bytes += n
        if self.rec is not None:
            self.rec.bytes_event("comm", n)

    # ---- compute ----
    def tick_compute(self):
        """Advance every worker by one local round of compute."""
        c = self.c_round * self.speeds
        if self.rec is None:
            self.clock += c
        else:
            before = self.clock.copy()
            self.clock += c
            for i in range(self.w):
                wid = int(self.worker_ids[i])
                t0, t1 = float(before[i]), float(self.clock[i])
                if self.speeds[i] > 1.0:
                    # a straggler's extra seconds beyond the nominal round
                    # are a stall, not useful compute (paper §V straggler
                    # mitigation); the split point is interior, so tiling
                    # stays endpoint-exact
                    mid = t0 + float(self.c_round[i])
                    self.rec.span(wid, "compute", "compute", t0, mid)
                    self.rec.span(wid, "straggler", "stall", mid, t1)
                else:
                    self.rec.span(wid, "compute", "compute", t0, t1)
        self.meter_add("compute", float(np.mean(c)))

    def step_compute(self, i: int) -> float:
        """One worker's seconds for one local round (event-driven loops)."""
        c = float(self.c_round[i] * self.speeds[i])
        self.meter_add("compute", c / self.w)
        return c

    # ---- checkpoint / restart machinery (shared lifetime + spot path) ----
    def _rotate(self, i: int, at_time: float, meter_key: str):
        """Bring a fresh replacement for worker ``i`` up at ``at_time``,
        routing checkpoint bytes through the metered transport
        (repro_torch.core.ckpt).

        Save-at-kill mode (``CheckpointSpec.every == 0``, the seed
        semantics): ckpt save + cold start + ckpt restore, byte-identical
        to the inline seed path for the default spec.  Under a periodic
        cadence an INVOLUNTARY kill instead restores the last fleet
        checkpoint and re-does the work since it (nothing can save at the
        moment of a preemption); planned lifetime rotations still save
        on their way out in both modes."""
        ck = self.ckpt
        rec = self.rec
        if rec is not None:
            wid = int(self.worker_ids[i])
            # work since the last sync point dies with the instance: the
            # interval from the worker's clock to the (possibly later) kill
            # time is lost progress, traced as a stall
            rec.span(wid, "preempt.lost", "stall", float(self.clock[i]),
                     at_time, meta={"cause": meter_key})
        if ck is not None and ck.every > 0 and meter_key == "restart":
            restart = self.platform.restart_time()
            dt_get = ck.restore("ckpt/fleet")
            rework = max(at_time - ck.last_ckpt_t, 0.0)
            self.clock[i] = at_time + restart + dt_get + rework
            self.meter_add(meter_key, restart + dt_get + rework)
            if rec is not None:
                # split points are the engine's own left-associative
                # partial sums, so the sub-spans tile bitwise
                s1 = at_time + restart
                s2 = s1 + dt_get
                rec.span(wid, "coldstart", "startup", at_time, s1)
                rec.span(wid, "ckpt.restore", "ckpt", s1, s2)
                rec.span(wid, "rework", "stall", s2, float(self.clock[i]))
        else:
            dt_put = ck.save(f"ckpt/{i}")
            restart = self.platform.restart_time()
            dt_get = ck.restore(f"ckpt/{i}")
            self.clock[i] = at_time + dt_put + restart + dt_get
            self.meter_add(meter_key, dt_put + restart + dt_get)
            if rec is not None:
                s1 = at_time + dt_put
                s2 = s1 + restart
                rec.span(wid, "ckpt.save", "ckpt", at_time, s1)
                rec.span(wid, "coldstart", "startup", s1, s2)
                rec.span(wid, "ckpt.restore", "ckpt", s2,
                         float(self.clock[i]))
        self.invoked_at[i] = self.clock[i]
        self.invocations += 1

    def ckpt_boundary(self, rnd: int) -> float:
        """Periodic fleet checkpoint at a sync boundary
        (``CheckpointSpec.every = N``): every worker stalls for one metered
        fleet save.  Returns the stall seconds (0.0 when the cadence is off
        or not yet due) so event-driven protocols can shift their queues."""
        ck = self.ckpt
        if ck is None or not ck.due(rnd):
            return 0.0
        dt = ck.save("ckpt/fleet")
        if self.rec is None:
            self.clock += dt
        else:
            before = self.clock.copy()
            self.clock += dt
            self.rec.tile(self.worker_ids, before, self.clock,
                          "ckpt.save", "ckpt")
        self.meter_add("checkpoint", dt)
        ck.mark(rnd, float(np.max(self.clock)))
        return dt

    def ensure_alive(self, i: int, est: float):
        """Guarantee worker ``i`` survives its next ``est`` seconds of work:
        consume any spot/crash preemption in the window, then rotate ahead of
        a planned lifetime expiry (the Lambda 15-minute contract).  The
        failure process is queried by STABLE worker id, not position, so a
        worker retired by an elastic scale-down takes its pending failures
        with it."""
        wid = int(self.worker_ids[i])
        t_pre = self.failure.next_preemption(wid, float(self.clock[i]),
                                             float(self.clock[i]) + est)
        while t_pre is not None:
            if self.rec is not None:
                self.rec.mark("preempt", t_pre, wid)
            self._rotate(i, max(t_pre, float(self.clock[i])), "restart")
            self.res.preemptions += 1
            t_pre = self.failure.next_preemption(wid, float(self.clock[i]),
                                                 float(self.clock[i]) + est)
        if (math.isfinite(self.lifetime)
                and self.clock[i] - self.invoked_at[i] + est
                > self.lifetime - self.lifetime_margin):
            self._rotate(i, float(self.clock[i]), "checkpoint")

    # ---- evaluation ----
    def record_eval(self, rnd: int, total_rounds: int, params) -> bool:
        """Round-boundary eval (BSP); returns True when converged."""
        if rnd % self.eval_every == 0 or rnd == total_rounds - 1:
            loss = self.model.eval_loss(params, self.ds_val)
            self.res.history.append((float(np.max(self.clock)), loss))
            if self.target_loss is not None and loss <= self.target_loss:
                self.res.converged = True
                return True
        return False

    def record_eval_at(self, t: float, params) -> bool:
        """Event-time eval (ASP/SSP); returns True when converged."""
        loss = self.model.eval_loss(params, self.ds_val)
        self.res.history.append((t, loss))
        if self.target_loss is not None and loss <= self.target_loss:
            self.res.converged = True
            return True
        return False


# -------------------------------------------------------------- simulate ----

def simulate(platform: "Platform", sync, model, algo, ds_train, ds_val, *,
             target_loss: float | None = None, max_epochs: int = 10,
             eval_every: int = 1, data_local: bool = False,
             trace: bool = False, device=None) -> RunResult:
    """Run one training scenario: ``platform`` (any
    :class:`~repro_torch.core.platform.Platform` implementation) x ``sync``
    (protocol object) x ``algo`` on real data/numerics, with every tensor on
    ``device`` (``None`` = the card; see :func:`repro_torch.resolve_device`).
    The initial parameters are drawn from a CPU ``torch.Generator`` seeded
    with ``platform.seed`` and then moved to the device, so a card run and a
    CPU run start from identical parameters.  ``trace=True`` attaches a
    :class:`~repro_torch.core.trace.TraceRecorder` (DESIGN.md §18) recording
    every event as a span, without perturbing any metered value."""
    device = resolve_device(device)
    w = platform.workers
    res = RunResult(platform.system_name(), algo.name, w)
    rec = TraceRecorder("train") if trace else None
    res.trace = rec
    parts = partition(ds_train, w)
    gen = torch.Generator().manual_seed(int(platform.seed))
    params0 = model.init(gen).to(device)
    mbytes = model_bytes(params0)
    err = platform.validate(mbytes)
    if err:
        res.error = err
        return res
    states = [algo.init_worker(model, params0, p) for p in parts]
    val = device_data(ds_val, device)

    comm = platform.make_comm()
    ckpt_store = platform.make_ckpt_store(comm)
    ckpt_spec = getattr(platform, "ckpt", None) or CheckpointSpec()
    ckpt = Checkpointer(spec=ckpt_spec, store=ckpt_store, mbytes=int(mbytes),
                        shards=ckpt_spec.shards(w), rec=rec)
    speeds = platform.worker_speeds()
    t_start = platform.startup_time(comm)
    part_bytes = max(p.nbytes for p in parts)
    t_load = platform.load_time(part_bytes, data_local)
    res.breakdown = dict(platform.init_breakdown())
    res.breakdown.update(startup=t_start, load=t_load)
    if rec is not None:
        # seed the meter mirror with the prologue values so the two dicts
        # stay bitwise-equal under the same subsequent accumulations
        rec.meters.update(res.breakdown)

    flops = platform.worker_flops_array(model)
    rows = algo.rows_per_round(parts[0])
    c_round = rows * model.flops_per_row / flops

    ctx = SimContext(
        platform=platform, model=model, algo=algo, states=states, parts=parts,
        ds_val=val, res=res, comm=comm,
        ckpt_store=ckpt_store, ckpt=ckpt,
        failure=platform.failure_process(),
        clock=np.full(w, t_start + t_load),
        invoked_at=np.full(w, t_start + t_load),
        speeds=speeds, c_round=np.asarray(c_round, float), mbytes=mbytes,
        lifetime=platform.lifetime_s(),
        lifetime_margin=platform.lifetime_margin_s(),
        target_loss=target_loss, max_epochs=max_epochs, eval_every=eval_every,
        invocations=w,
        worker_ids=np.arange(w), joined_at=np.zeros(w), rec=rec)
    if rec is not None:
        # every initial worker is born at t=0 and spends the prologue in
        # startup then data loading (clock starts at t_start + t_load)
        for i in range(w):
            rec.birth(i, 0.0)
            rec.span(i, "startup", "startup", 0.0, t_start)
            rec.span(i, "load", "data", t_start, float(ctx.clock[i]))

    try:
        if ckpt.every > 0:
            # periodic-cadence mode: checkpoint the freshly-initialized
            # fleet first, so the earliest involuntary kill always has a
            # checkpoint to restore (rework is bounded by the cadence)
            dt0 = ctx.ckpt.save("ckpt/fleet")
            if rec is None:
                ctx.clock += dt0
            else:
                before = ctx.clock.copy()
                ctx.clock += dt0
                rec.tile(ctx.worker_ids, before, ctx.clock,
                         "ckpt.save", "ckpt")
            ctx.meter_add("checkpoint", dt0)
            ctx.ckpt.mark(0, float(np.max(ctx.clock)))
        sync.run(ctx)
    except ChannelItemTooLarge as e:
        res.error = str(e)
        return res
    finally:
        res.ckpt_bytes = ctx.ckpt.wire_bytes
        res.ckpt_time = ctx.ckpt.time_s
        res.ckpt_cost = ctx.ckpt.op_usd

    res.sim_time = float(np.max(ctx.clock))
    res.comm_cost = ctx.comm.service_cost(res.sim_time)
    res.cost = platform.finalize_cost(ctx)
    if rec is not None:
        rec.finalize_clock(ctx.worker_ids, ctx.clock)
    return res
