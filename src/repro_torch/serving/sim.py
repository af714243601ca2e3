"""Request-driven serving simulator: open-loop traffic against metered fleets.

The port's copy of the JAX package's ``serving/sim.py`` (numpy; its
``+=`` accumulation order kept, so results are bitwise equal).  The
inference-side mirror of :mod:`repro_torch.core.engine` (DESIGN.md §14): a
discrete-event loop on the same clock/metering discipline — simulated
seconds and dollars are derived from the same measured constants the
training engine bills against; nothing here touches a wall clock.

Two money models, selected by the platform's :class:`ServingHooks`:

- ``"request"`` (FaaS): one Lambda per in-flight request.  A request that
  finds no warm sandbox pays the measured invoke curve **plus** pulling the
  weights from S3; finished sandboxes stay warm for ``keep_warm_s``.  The
  bill is Σ per-request ``gb × billed_s × $/GB-s + invocation fee`` — and
  scale-to-zero is structural: zero traffic costs exactly $0.
- ``"provisioned"`` (IaaS / pods): hourly-billed replicas that run a
  continuously-batched decode loop — at every step boundary, waiting
  requests are packed into the batch as long as reserved KV-cache bytes fit
  the replica's memory budget.  The bill is Σ replica (provision→retire)
  spans × hourly; an idle fleet costs exactly its idle floor.

Both loops observe per-window
:class:`~repro_torch.core.elastic.ServingTelemetry`
and hand it to an autoscaler from the ``core.elastic`` policy registry
(``schedule:`` and ``cost_cap:`` work unchanged; ``smlt`` is re-read on
queue depth + utilization via :class:`ServingSMLT`).  Scale-ups pay the same
Table 6 provisioning curves as elastic training; scale-downs drain.

Latency/service times come from one shared :class:`LatencyModel`, which the
parity test pins byte-identically to the real ``Generator`` decode loop.
"""
from __future__ import annotations

import heapq
import math
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core.elastic import (
    MAX_FLEET, SMLTPolicy, StaticPolicy, make_policy,
)
from repro_torch.core.elastic.telemetry import ServingTelemetry
from repro_torch.core.trace import TraceRecorder
from repro_torch.serving.arrivals import ArrivalProcess, make_arrivals
from repro_torch.serving.latency import LatencyModel

__all__ = ["ServingResult", "ServingSMLT", "make_autoscaler", "serve",
           "provision_for"]


# ------------------------------------------------------------ autoscaler ----

class ServingSMLT:
    """The SMLT widen/hold/narrow loop re-read on serving signals.

    Training SMLT sheds workers when the marginal loss drop stops paying for
    them; serving has no loss, so the "is the fleet earning its keep" signal
    becomes load: widen while requests queue or the fleet runs hot, narrow
    once it idles.  Same ×/÷ ``factor`` geometry as the training policy.
    """

    name = "smlt"

    def __init__(self, factor: int = 2, util_hi: float = 0.85,
                 util_lo: float = 0.30, cooldown_s: float = 120.0):
        if int(factor) < 2:
            raise ValueError(f"smlt step factor must be >= 2, got {factor}")
        self.factor = int(factor)
        self.util_hi = float(util_hi)
        self.util_lo = float(util_lo)
        # ordered capacity takes a Table 6 provisioning curve to come online;
        # widening again before then just re-reacts to the same backlog
        self.cooldown_s = float(cooldown_s)
        self._last_widen: float | None = None

    def initial_workers(self, w0: int) -> int:
        return w0

    def observe(self, t: ServingTelemetry) -> int:
        if t.queue_depth > 0 or t.utilization >= self.util_hi:
            if (self._last_widen is not None
                    and t.sim_time - self._last_widen < self.cooldown_s):
                return t.workers
            self._last_widen = t.sim_time
            return min(t.workers * self.factor, t.max_workers)
        if t.utilization <= self.util_lo:
            return max(t.workers // self.factor, t.min_workers)
        return t.workers


def make_autoscaler(spec):
    """Resolve a ``scaling`` spec against the ``core.elastic`` registry.

    ``static`` (or None) means no autoscaler; ``smlt[:<factor>]`` maps to
    :class:`ServingSMLT`; every other grammar entry (``schedule:…``,
    ``cost_cap:…``) is the training policy unchanged — their ``observe``
    only reads fields :class:`ServingTelemetry` provides.
    """
    if spec is None:
        return None
    if isinstance(spec, str):
        head, _, arg = spec.partition(":")
        if head == "static":
            return None
        if head == "smlt":
            return ServingSMLT(int(arg)) if arg else ServingSMLT()
        if head == "plan":
            raise ValueError("scaling='plan' is the training-side planner; "
                             "size a serving fleet with provision_for()")
        return make_policy(spec)
    if isinstance(spec, SMLTPolicy):
        return ServingSMLT(spec.factor)
    if isinstance(spec, StaticPolicy):
        return None
    return spec


def provision_for(arrivals, lat: LatencyModel, hooks, *,
                  prompt_len: int = 32, new_tokens: int = 32,
                  max_batch: int = 32, util_target: float = 0.8) -> int:
    """Analytic fleet sizing: replicas needed to carry the arrival peak at
    ``util_target`` utilization with continuous batching at the best
    feasible batch.  The serving mirror of ``plan_initial_workers``."""
    arrivals = make_arrivals(arrivals)
    kv_req = lat.kv_bytes(prompt_len + new_tokens)
    kv_budget = hooks.memory_bytes - lat.model_bytes
    b = max(1, min(max_batch, int(kv_budget // kv_req) if kv_req else max_batch))
    per_replica_qps = b / (lat.step_s(b) * lat.request_steps(prompt_len,
                                                             new_tokens))
    return max(1, math.ceil(arrivals.peak_qps / (per_replica_qps
                                                 * util_target)))


# --------------------------------------------------------------- result -----

@dataclass
class ServingResult:
    """Everything a serving run produced, with the bill decomposed so every
    dollar is recomputable from the parts (property-tested)."""

    system: str
    arrival: str
    duration_s: float
    workers0: int
    requests: int = 0            # arrivals seen
    completed: int = 0
    rejected: int = 0            # could never fit replica memory
    dropped: int = 0             # shed by a stop/scale-to-zero
    cold_starts: int = 0
    latencies: List[float] = field(default_factory=list)
    per_request_usd: List[float] = field(default_factory=list)   # FaaS
    provisioned: List[tuple] = field(default_factory=list)       # (t0,t1,$/h)
    cost: float = 0.0
    peak_kv_bytes: int = 0
    kv_budget_bytes: float = 0.0
    peak_batch: int = 0
    scaling_timeline: List[tuple] = field(default_factory=list)  # (win,w,t)
    windows: List[dict] = field(default_factory=list)
    sim_time: float = 0.0
    trace: object = field(default=None, repr=False)
                                 # TraceRecorder when serve(trace=True)
                                 # (DESIGN.md §18); None otherwise

    def _pct(self, q: float) -> float:
        if not self.latencies:
            return float("nan")
        return float(np.percentile(np.asarray(self.latencies), q))

    @property
    def p50_s(self) -> float:
        return self._pct(50)

    @property
    def p99_s(self) -> float:
        return self._pct(99)

    @property
    def mean_s(self) -> float:
        return float(np.mean(self.latencies)) if self.latencies else float("nan")

    @property
    def usd_per_1k(self) -> float:
        if not self.completed:
            return float("nan")
        return self.cost / self.completed * 1e3

    def to_dict(self) -> dict:
        return {
            "system": self.system, "arrival": self.arrival,
            "duration_s": self.duration_s, "workers0": self.workers0,
            "requests": self.requests, "completed": self.completed,
            "rejected": self.rejected, "dropped": self.dropped,
            "cold_starts": self.cold_starts,
            "p50_ms": round(self.p50_s * 1e3, 3) if self.latencies else None,
            "p99_ms": round(self.p99_s * 1e3, 3) if self.latencies else None,
            "mean_ms": round(self.mean_s * 1e3, 3) if self.latencies else None,
            "cost_usd": self.cost,
            "usd_per_1k": (round(self.usd_per_1k, 6)
                           if self.completed else None),
            "peak_batch": self.peak_batch,
            "peak_kv_bytes": self.peak_kv_bytes,
            "kv_budget_bytes": self.kv_budget_bytes,
            "scaling_timeline": [list(x) for x in self.scaling_timeline],
            "sim_time": round(self.sim_time, 3),
            "breakdown": self.breakdown(),
        }

    def breakdown(self) -> dict:
        """Span-derived phase seconds (queue wait, cold start, prefill,
        decode) -- {} when the run was not traced."""
        if self.trace is None:
            return {}
        out: dict = {}
        for s in self.trace.spans:
            out[s.kind] = out.get(s.kind, 0.0) + (s.t1 - s.t0)
        return out


# ------------------------------------------------------------- internals ----

@dataclass
class _Req:
    rid: int
    t_arr: float
    steps_left: int
    kv_bytes: int
    t_admit: Optional[float] = None
    cost: float = 0.0


class _Replica:
    __slots__ = ("rid", "t_ready", "t_bill0", "t_bill1", "active",
                 "draining", "scheduled", "kv")

    def __init__(self, rid: int, t_ready: float, t_bill0: float):
        self.rid = rid
        self.t_ready = t_ready
        self.t_bill0 = t_bill0
        self.t_bill1: Optional[float] = None   # None = still billing
        self.active: List[_Req] = []
        self.draining = False
        self.scheduled = False
        self.kv = 0

    @property
    def alive(self) -> bool:
        return self.t_bill1 is None


def _fleet_bounds(platform) -> tuple:
    lo = 1 if platform.fleet.min_workers is None else int(platform.fleet.min_workers)
    hi = (MAX_FLEET if platform.fleet.max_workers is None
          else int(platform.fleet.max_workers))
    return lo, hi


class _WindowMeter:
    """Per-window telemetry, built once for both billing loops (they used
    to duplicate this block).  One source of truth for
    :class:`ServingTelemetry` and the ``res.windows`` record; when tracing,
    each window also lands a ``serve.window`` mark on the recorder."""

    def __init__(self, rec, res, window_s: float, lo: int, hi: int):
        self.rec = rec
        self.res = res
        self.window_s = window_s
        self.lo = lo
        self.hi = hi
        self.arr = 0                # arrivals this window
        self.lat: list = []         # completion latencies this window
        self.prev_busy = 0.0        # busy_integral at the last boundary

    def observe(self, widx: int, t: float, workers: int,
                busy_integral: float, queue_depth: int,
                cost_now: float) -> ServingTelemetry:
        util = (busy_integral - self.prev_busy) / (max(workers, 1)
                                                   * self.window_s)
        tele = ServingTelemetry(
            round=widx, workers=workers, qps=self.arr / self.window_s,
            queue_depth=queue_depth,
            p50_ms=(float(np.percentile(self.lat, 50)) * 1e3
                    if self.lat else None),
            p99_ms=(float(np.percentile(self.lat, 99)) * 1e3
                    if self.lat else None),
            utilization=min(1.0, util), cost_so_far=cost_now,
            sim_time=t, min_workers=self.lo, max_workers=self.hi)
        self.res.windows.append({"t": t, "qps": tele.qps,
                                 "queue": tele.queue_depth,
                                 "p50_ms": tele.p50_ms,
                                 "p99_ms": tele.p99_ms,
                                 "util": round(tele.utilization, 4),
                                 "workers": workers, "cost": cost_now})
        if self.rec is not None:
            self.rec.mark("serve.window", t, workers=workers, qps=tele.qps,
                          queue=queue_depth, util=tele.utilization,
                          cost_usd=cost_now)
        self.prev_busy = busy_integral
        self.arr = 0
        self.lat = []
        return tele


# ------------------------------------------------------------------ serve ---

def serve(platform, lat, arrivals, *, duration_s: float = 300.0,
          prompt_len: int = 32, new_tokens: int = 32,
          window_s: float = 15.0, scaling=None, max_batch: int = 32,
          prewarm: int = 0, reduced: bool = False,
          seed: int = 0, trace: bool = False) -> ServingResult:
    """Serve an open-loop arrival process on ``platform``.

    ``lat`` is a :class:`LatencyModel` or an arch name (resolved against the
    platform's serving hooks); ``arrivals`` is a process or grammar string;
    ``scaling`` is a ``core.elastic`` grammar string / policy instance
    (default: the platform's own ``scaling`` spec, ``static`` = fixed).
    ``prewarm`` seeds the FaaS warm pool (ignored on provisioned platforms,
    whose initial fleet is warm by construction).  ``trace=True`` records
    the request lifecycle (queue wait, cold start, prefill, decode slices)
    on a :class:`~repro_torch.core.trace.TraceRecorder` (DESIGN.md §18) without
    perturbing any metered value.
    """
    hooks = platform.serving_hooks()
    if isinstance(lat, str):
        lat = LatencyModel.from_arch(lat, flops=hooks.flops,
                                     mem_bandwidth=hooks.mem_bandwidth,
                                     reduced=reduced)
    arrivals = make_arrivals(arrivals)
    if prompt_len < 1 or new_tokens < 1:
        raise ValueError("prompt_len and new_tokens must be >= 1")
    if window_s <= 0 or duration_s <= 0:
        raise ValueError("window_s and duration_s must be > 0")
    if lat.model_bytes >= hooks.memory_bytes:
        raise ValueError(
            f"weights ({lat.model_bytes / 1e9:.2f} GB) do not fit a "
            f"{hooks.system} replica ({hooks.memory_bytes / 1e9:.2f} GB)")

    if scaling is None:
        scaling = getattr(platform, "scaling", None)
    policy = make_autoscaler(scaling)
    lo, hi = _fleet_bounds(platform)
    w0 = int(platform.workers)
    if policy is not None:
        w0 = max(lo, min(hi, int(policy.initial_workers(w0))))

    times = arrivals.times(duration_s, seed)
    res = ServingResult(system=hooks.system, arrival=arrivals.name,
                        duration_s=float(duration_s), workers0=w0,
                        kv_budget_bytes=hooks.memory_bytes - lat.model_bytes)
    res.trace = TraceRecorder("serve") if trace else None
    if policy is not None:
        res.scaling_timeline.append((0, w0, 0.0))

    kv_req = lat.kv_bytes(prompt_len + new_tokens)
    args = (platform, hooks, lat, policy, res, times, kv_req, lo, hi, w0,
            duration_s, prompt_len, new_tokens, window_s, max_batch)
    if hooks.billing == "request":
        _serve_request_billed(*args, prewarm=prewarm)
    else:
        _serve_provisioned(*args)
    return res


# ------------------------------------------------------ FaaS (per-request) --

def _serve_request_billed(platform, hooks, lat, policy, res, times, kv_req,
                          lo, hi, w0, duration_s, prompt_len, new_tokens,
                          window_s, max_batch, *, prewarm: int = 0):
    """One Lambda per in-flight request; the autoscaler moves the
    concurrency cap.  Fees accrue when a request starts executing (its
    billed duration is known then), so ``cost_cap`` windows always observe
    every admitted dollar."""
    heap: list = []
    seq = 0
    for i, t in enumerate(times):
        heap.append((float(t), seq, "arr", i))
        seq += 1
    heapq.heapify(heap)
    heapq.heappush(heap, (window_s, seq, "win", 0))
    seq += 1

    rec = res.trace
    win = _WindowMeter(rec, res, window_s, lo, hi)
    service_s = lat.service_s(prompt_len, new_tokens, batch=1)
    cold_extra = hooks.cold_start_total_s(lat.model_bytes)
    warm: list = [hooks.keep_warm_s] * max(0, int(prewarm))
    queue: deque = deque()
    cap = w0
    busy = 0
    stopped = False
    last_t = 0.0
    busy_integral = 0.0
    last_done = 0.0

    def advance(t: float):
        nonlocal busy_integral, last_t
        busy_integral += busy * (t - last_t)
        last_t = t

    def start(req: _Req, t: float):
        nonlocal busy, seq
        warm[:] = [e for e in warm if e > t]
        cold = not warm
        if warm:
            warm.pop()
        delay = cold_extra if cold else 0.0
        res.cold_starts += int(cold)
        billed = delay + service_s
        req.cost = (hooks.gb * billed * hooks.gb_s_usd
                    + hooks.request_fee_usd)
        req.t_admit = t
        res.cost += req.cost
        res.per_request_usd.append(req.cost)
        if rec is not None:
            # invariant 2: one ledger entry per admitted dollar, in the
            # exact order res.cost accumulates them
            rec.cost("request", req.cost)
            rec.span(req.rid, "serve.queue", "stall", req.t_arr, t)
            if cold:
                rec.span(req.rid, "serve.coldstart", "startup", t, t + delay)
            t_exec = t + delay
            t_pf = t_exec + prompt_len * lat.step_s(1)
            rec.span(req.rid, "serve.prefill", "compute", t_exec, t_pf,
                     usd=req.cost)
            rec.span(req.rid, "serve.decode", "compute", t_pf,
                     t_exec + service_s)
        res.peak_kv_bytes = max(res.peak_kv_bytes, req.kv_bytes)
        res.peak_batch = max(res.peak_batch, 1)
        busy += 1
        heapq.heappush(heap, (t + delay + service_s, seq, "done", req))
        seq += 1

    while heap:
        t, _, kind, payload = heapq.heappop(heap)
        advance(t)
        if kind == "arr":
            res.requests += 1
            win.arr += 1
            if stopped or cap == 0:
                res.dropped += 1
                continue
            if lat.model_bytes + kv_req > hooks.memory_bytes:
                res.rejected += 1
                continue
            req = _Req(rid=payload, t_arr=t,
                       steps_left=lat.request_steps(prompt_len, new_tokens),
                       kv_bytes=kv_req)
            if busy < cap:
                start(req, t)
            else:
                queue.append(req)
        elif kind == "done":
            req = payload
            busy -= 1
            res.completed += 1
            delay = t - req.t_arr
            res.latencies.append(delay)
            win.lat.append(delay)
            last_done = max(last_done, t)
            warm.append(t + hooks.keep_warm_s)
            if queue and not stopped and busy < cap:
                start(queue.popleft(), t)
        elif kind == "win":
            widx = payload
            # when tracing, the window's cost snapshot is the recorder's
            # ledger sum -- bitwise-equal to res.cost by construction
            cost_now = res.cost if rec is None else rec.cost_total()
            tele = win.observe(widx, t, cap, busy_integral, len(queue),
                               cost_now)
            if policy is not None:
                target = int(policy.observe(tele))
                if target == 0:
                    stopped = True
                    res.dropped += len(queue)
                    queue.clear()
                    cap = 0
                    res.scaling_timeline.append((widx, 0, t))
                else:
                    target = max(lo, min(hi, target))
                    if target != cap:
                        res.scaling_timeline.append((widx, target, t))
                        if target > cap:  # drain the queue into the new room
                            cap = target
                            while queue and busy < cap:
                                start(queue.popleft(), t)
                        cap = target
            if not stopped and (t < duration_s or queue or busy > 0):
                heapq.heappush(heap, (t + window_s, seq, "win", widx + 1))
                seq += 1

    res.sim_time = max(duration_s, last_done)


# ------------------------------------------- IaaS / pods (provisioned) ------

def _serve_provisioned(platform, hooks, lat, policy, res, times, kv_req,
                       lo, hi, w0, duration_s, prompt_len, new_tokens,
                       window_s, max_batch):
    """Hourly-billed replicas running a continuously-batched decode loop.

    Each replica advances its batch in fast-forwarded chunks: ``n`` decode
    steps at the current batch's step time, where ``n`` is capped by the
    soonest batch-changing event (a member finishing, the next arrival, the
    next autoscaler window) — so wall-clock work is proportional to
    batch-composition changes, not to tokens."""
    heap: list = []
    seq = 0
    for i, t in enumerate(times):
        heap.append((float(t), seq, "arr", i))
        seq += 1
    heapq.heapify(heap)
    heapq.heappush(heap, (window_s, seq, "win", 0))
    seq += 1

    kv_budget = hooks.memory_bytes - lat.model_bytes
    steps_per_req = lat.request_steps(prompt_len, new_tokens)
    # the initial fleet is provisioned and warmed before t=0; it bills
    # from t=0 (that IS the idle-fleet floor the zero-traffic test pins)
    replicas: List[_Replica] = [_Replica(i, 0.0, 0.0) for i in range(w0)]
    queue: deque = deque()
    width = w0
    stopped = False
    arr_idx = 0                 # next unseen arrival (horizon lookahead)
    next_win = window_s
    busy_integral = 0.0
    rec = res.trace
    win = _WindowMeter(rec, res, window_s, lo, hi)
    last_done = 0.0

    def cost_at(t: float) -> float:
        total = 0.0
        for r in replicas:
            end = r.t_bill1 if r.t_bill1 is not None else t
            total += (end - r.t_bill0) * hooks.hourly_usd / 3600.0
        return total

    def schedule(r: _Replica, t: float):
        nonlocal seq
        if not r.scheduled and r.alive:
            r.scheduled = True
            heapq.heappush(heap, (max(t, r.t_ready), seq, "step", r.rid))
            seq += 1

    def admit(r: _Replica, t: float):
        while (queue and len(r.active) < max_batch
               and r.kv + queue[0].kv_bytes <= kv_budget):
            req = queue.popleft()
            req.t_admit = t
            if rec is not None:
                rec.span(req.rid, "serve.queue", "stall", req.t_arr, t,
                         meta={"replica": r.rid})
            r.active.append(req)
            r.kv += req.kv_bytes
            res.peak_kv_bytes = max(res.peak_kv_bytes, r.kv)
        res.peak_batch = max(res.peak_batch, len(r.active))

    def retire(r: _Replica, t: float):
        r.t_bill1 = t
        res.provisioned.append((r.t_bill0, t, hooks.hourly_usd))

    while heap:
        t, _, kind, payload = heapq.heappop(heap)
        if kind == "arr":
            arr_idx = payload + 1
            res.requests += 1
            win.arr += 1
            if stopped:
                res.dropped += 1
                continue
            if kv_req > kv_budget:
                res.rejected += 1
                continue
            queue.append(_Req(rid=payload, t_arr=t, steps_left=steps_per_req,
                              kv_bytes=kv_req))
            for r in replicas:
                if r.alive and not r.draining and not r.active:
                    schedule(r, t)
        elif kind == "step":
            r = replicas[payload]
            if not r.alive:
                continue
            r.scheduled = False
            for req in [q for q in r.active if q.steps_left <= 0]:
                r.active.remove(req)
                r.kv -= req.kv_bytes
                res.completed += 1
                delay = t - req.t_arr
                res.latencies.append(delay)
                win.lat.append(delay)
                last_done = max(last_done, t)
            if r.draining:
                if not r.active:
                    retire(r, t)
                    continue
            else:
                admit(r, t)
            if not r.active:
                continue            # idle; the next arrival wakes it
            b = len(r.active)
            step = lat.step_s(b)
            n = min(q.steps_left for q in r.active)
            horizon = next_win
            if queue or arr_idx < len(times):
                nxt = times[arr_idx] if arr_idx < len(times) else horizon
                horizon = min(horizon, nxt)
            if math.isfinite(horizon) and horizon > t + step:
                n = min(n, max(1, int((horizon - t) / step)))
            for q in r.active:
                q.steps_left -= n
            busy_integral += n * step
            if rec is not None:
                # one continuous-batching decode slice per fast-forwarded
                # chunk, on the replica's timeline
                rec.span(r.rid, "serve.decode", "compute", t, t + n * step,
                         meta={"batch": b, "steps": n})
            r.scheduled = True
            heapq.heappush(heap, (t + n * step, seq, "step", r.rid))
            seq += 1
        elif kind == "win":
            widx = payload
            tele = win.observe(widx, t, width, busy_integral, len(queue),
                               cost_at(t))
            if policy is not None and not stopped:
                target = int(policy.observe(tele))
                if target == 0:
                    stopped = True
                    res.dropped += len(queue)
                    queue.clear()
                    width = 0
                    res.scaling_timeline.append((widx, 0, t))
                    for r in replicas:
                        if r.alive:
                            if r.active:
                                r.draining = True
                            else:
                                retire(r, t)
                else:
                    target = max(lo, min(hi, target))
                    if target != width:
                        res.scaling_timeline.append((widx, target, t))
                    if target > width:
                        need = target - width
                        for r in replicas:   # un-drain before provisioning
                            if need and r.alive and r.draining:
                                r.draining = False
                                need -= 1
                                schedule(r, t)
                        if need:
                            t_ready = (t + hooks.provision_s(need)
                                       + hooks.model_load_s(lat.model_bytes))
                            res.cold_starts += need
                            for _ in range(need):
                                r = _Replica(len(replicas), t_ready, t)
                                replicas.append(r)
                                if rec is not None:
                                    rec.span(r.rid, "serve.coldstart",
                                             "startup", t, t_ready,
                                             meta={"ordered": need})
                                if queue:
                                    schedule(r, t_ready)
                        width = target
                    elif target < width:
                        shed = width - target
                        live = [r for r in replicas
                                if r.alive and not r.draining]
                        live.sort(key=lambda r: len(r.active))
                        for r in live[:shed]:
                            if r.active:
                                r.draining = True
                            else:
                                retire(r, t)
                        width = target
            if not stopped and (t < duration_s or queue
                                or any(r.active for r in replicas if r.alive)):
                next_win = t + window_s
                heapq.heappush(heap, (next_win, seq, "win", widx + 1))
                seq += 1
            else:
                next_win = float("inf")

    sim_end = max(duration_s, last_done,
                  max((r.t_bill1 or 0.0 for r in replicas), default=0.0))
    for r in replicas:
        if r.alive:
            retire(r, sim_end)
    res.sim_time = sim_end
    res.cost = sum((t1 - t0) * hourly / 3600.0
                   for t0, t1, hourly in res.provisioned)
    if rec is not None:
        # invariant 2 for provisioned billing: one ledger entry per replica
        # span, same terms in the same order as the sum above, so the
        # ledger total is bitwise-equal to res.cost
        rec.cost_reset()
        for t0, t1, hourly in res.provisioned:
            rec.cost("replica", (t1 - t0) * hourly / 3600.0)
