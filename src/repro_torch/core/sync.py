"""Synchronization protocols (paper §3.2.4; DESIGN.md §6).

Each protocol is a strategy object driving the discrete-event engine's
:class:`~repro_torch.core.engine.SimContext`; the same protocols run on
every infrastructure (FaaS, IaaS, hybrid, spot, heterogeneous fleets):

- :class:`BSP` -- bulk-synchronous rounds; the merge itself is delegated to
  the platform's :class:`~repro_torch.core.engine.CommBackend`, barrier =
  the max over per-worker completion times.
- :class:`ASP` -- SIREN-style fully-asynchronous global-model overwrite;
  ASP is SSP with an unbounded staleness.
- :class:`SSP` -- stale-synchronous parallel with staleness bound ``s``: a
  worker more than ``s`` rounds ahead of the slowest active worker blocks
  until the laggard catches up.
- :class:`LocalSGD` -- reduced communication (paper §4.2's MA-SGD insight,
  DESIGN.md §11): workers apply their own updates locally for ``H`` rounds,
  then merge the *accumulated* update once, by plain averaging
  (``outer="ma"``) or a DiLoCo Nesterov outer step (``outer="diloco"``),
  optionally with blockwise int8 + error-feedback delta compression
  (``compress=True``, the quant8 kernel).  ``LocalSGD(h=1)`` IS BSP.

Update vectors, merges, residuals and the global model are fp32 tensors on
the run's device; every merge goes through
:func:`repro_torch.core.comm.collectives.mean_of`.  BSP, SSP/ASP and
LocalSGD resize elastic fleets (DESIGN.md §13) at their sync boundaries.

Select a protocol with ``sync="bsp"|"asp"|"ssp"`` (or ``"ssp:<s>"``,
``"local:<H>"``, ``"diloco:<H>"``, with an optional ``":c8"`` compression
suffix -- or pass a protocol instance).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.comm.codecs import int8_encode_decode, int8_wire_floats
from repro_torch.core.comm.collectives import mean_of
from repro_torch.core.engine import SimContext

BSP_NAME = "bsp"
ASP_NAME = "asp"
SSP_NAME = "ssp"
LOCAL_NAME = "local"
DILOCO_NAME = "diloco"
COMPRESS_SUFFIX = "c8"

#: the sync-protocol string grammar, one entry per selectable protocol
#: (``python -m repro_torch list`` prints it); keep in step with
#: :func:`make_sync` / :func:`sync_name`
SYNC_GRAMMARS = (
    f"{BSP_NAME}",
    f"{ASP_NAME}",
    f"{SSP_NAME}[:<staleness>]",
    f"{LOCAL_NAME}[:<H>][:{COMPRESS_SUFFIX}]",
    f"{DILOCO_NAME}[:<H>][:{COMPRESS_SUFFIX}]",
)


def list_syncs() -> list:
    """The selectable sync grammars (``repro_torch list`` prints these)."""
    return list(SYNC_GRAMMARS)


@dataclass(frozen=True)
class DiLoCoOuter:
    """DiLoCo's outer optimizer: Nesterov momentum on the average inner
    delta (delta = outer_params - inner_params, so the step SUBTRACTS)."""
    lr: float = 0.7
    momentum: float = 0.9

    def step(self, outer, mom, mean_delta):
        """-> (new_outer_params, new_momentum)."""
        new_mom = self.momentum * mom + mean_delta
        new_outer = outer - self.lr * (self.momentum * new_mom + mean_delta)
        return new_outer, new_mom


class SyncProtocol:
    """Base class: a protocol runs the whole training loop over a context."""
    name = "base"
    #: protocols that call ``ctx.maybe_resize`` at their sync boundaries
    #: declare True; elastic scaling policies (DESIGN.md §13) refuse to
    #: pair with protocols that do not
    supports_resize = False

    def run(self, ctx: SimContext) -> None:
        raise NotImplementedError


class BSP(SyncProtocol):
    """Bulk-synchronous rounds with per-round lifetime/failure handling.
    Elastic fleets resize at any round boundary (every round IS a sync
    point); the remaining round budget is rescaled to keep the epoch count,
    since a resize re-partitions the data and changes rounds-per-epoch."""
    name = BSP_NAME
    supports_resize = True

    def run(self, ctx: SimContext) -> None:
        algo, model = ctx.algo, ctx.model
        rpe = algo.rounds_per_epoch(ctx.parts[0])
        total_rounds = ctx.max_epochs * rpe
        est = float(np.max(ctx.c_round * ctx.speeds)) + 5.0
        rnd = 0
        while rnd < total_rounds:
            states = ctx.states
            for i in range(ctx.w):
                ctx.ensure_alive(i, est)
            updates = [algo.local_update(model, st, rnd) for st in states]
            ctx.tick_compute()
            merged = ctx.comm.bsp_reduce(ctx, updates, f"r{rnd}")
            for st in states:
                algo.apply_merged(model, st, merged, ctx.w)
            ctx.res.rounds += 1
            if ctx.record_eval(rnd, total_rounds, algo.eval_params(states[0])):
                break
            rnd += 1
            ctx.ckpt_boundary(rnd)      # cadence save (DESIGN.md §17)
            stop, total_rounds, rpe, resized = ctx.elastic_boundary(
                rnd, total_rounds, rpe)
            if stop:
                break
            if resized:
                est = float(np.max(ctx.c_round * ctx.speeds)) + 5.0


class SSP(SyncProtocol):
    """Stale-synchronous event loop over a metered global-model store.

    Every worker repeatedly: reads the global model (possibly ``<= s`` rounds
    stale), computes one local update, and writes ``global -= lr * update``
    with a 1/sqrt(T) learning-rate decay (paper §4.5).  The engine pops
    workers in virtual-time order; a worker whose completed-round count leads
    the slowest *active* worker by more than ``s`` parks in a wait set and is
    released (wait time metered under ``"wait"``) when the laggard's next
    update lands.

    Elastic fleets (DESIGN.md §13) resize at eval boundaries, where the
    global model was just read: the membership change reconciles the
    staleness clocks -- parked workers are released (wait metered to the
    boundary), every survivor's completed-round count restarts at 0 so the
    staleness bound is measured within the new membership, the remaining
    per-worker round quota is rescaled from the epochs already done, and
    the event heap is rebuilt over the new fleet.
    """
    name = SSP_NAME
    supports_resize = True

    def __init__(self, staleness: float = 3):
        self.staleness = staleness

    def _bound(self) -> float:
        return self.staleness if self.staleness is not None else math.inf

    def run(self, ctx: SimContext) -> None:
        algo, states, model = ctx.algo, ctx.states, ctx.model
        w = ctx.w
        store = ctx.comm.kvstore()
        shape = states[0].params.shape
        store.put("global", states[0].flat.to(torch.float32).clone())
        rpe = algo.rounds_per_epoch(ctx.parts[0])
        per_worker = ctx.max_epochs * rpe
        total = per_worker * w
        eval_stride = w * max(rpe // 4, 1)
        bound = self._bound()

        rounds = np.zeros(w, dtype=int)
        heap = [(float(ctx.clock[i]), i) for i in range(w)]
        heapq.heapify(heap)
        waiting: dict[int, float] = {}     # worker -> time it parked
        done = 0
        done_mark = 0          # `done` at the last eval boundary
        fleet_round = 0.0      # monotone fleet rounds across resize eras
        epoch_acc = 0.0        # epochs completed across resize eras
        t = float(np.max(ctx.clock))

        def active_min() -> int:
            live = rounds[rounds < per_worker]
            return int(live.min()) if live.size else int(rounds.min())

        while heap and done < total:
            t, i = heapq.heappop(heap)
            lag = rounds[i] - active_min()
            if lag > bound:
                waiting[i] = t
                continue
            ctx.res.max_staleness = max(ctx.res.max_staleness, int(lag))
            ctx.clock[i] = t
            est = float(ctx.c_round[i] * ctx.speeds[i]) + 5.0
            ctx.ensure_alive(i, est)
            t = float(ctx.clock[i])

            g_flat, dt1 = store.get("global")
            states[i].params = g_flat.reshape(shape)
            upd = algo.local_update(model, states[i], done)
            T = max(done // (rpe * w), 1)
            lr = float(algo.lr / np.sqrt(T))   # 1/sqrt(T) decay (paper §4.5)
            # float64 step then float32, as numpy promotes an np.float64 lr
            new = (g_flat.to(torch.float64)
                   - lr * upd.to(torch.float64)).to(torch.float32)
            dt2 = store.put("global", new)
            c = ctx.step_compute(i)
            if ctx.rec is not None:
                t_round0 = t
            t += dt1 + c + dt2
            ctx.clock[i] = t
            if ctx.rec is not None:
                # interior split points are approximate partials; the round
                # endpoint is the stored clock, so tiling stays exact
                wid = int(ctx.worker_ids[i])
                s1 = t_round0 + dt1
                s2 = s1 + c
                ctx.rec.span(wid, "comm.get", "comm", t_round0, s1)
                if ctx.speeds[i] > 1.0:
                    mid = s1 + float(ctx.c_round[i])
                    ctx.rec.span(wid, "compute", "compute", s1, mid)
                    ctx.rec.span(wid, "straggler", "stall", mid, s2)
                else:
                    ctx.rec.span(wid, "compute", "compute", s1, s2)
                ctx.rec.span(wid, "comm.put", "comm", s2, t)
            ctx.meter_add("comm", dt1 + dt2)
            # same accounting convention as the BSP backends: one update
            # vector per per-worker round (BSP meters nbytes once per fleet
            # round of w worker-rounds)
            ctx.meter_bytes(float(g_flat.nbytes) / ctx.w)
            rounds[i] += 1
            done += 1
            ctx.res.rounds = done
            if rounds[i] < per_worker:
                heapq.heappush(heap, (t, i))

            # this update may have released parked workers
            if waiting:
                amin = active_min()
                for j in [j for j, _ in waiting.items()
                          if rounds[j] - amin <= bound]:
                    t_park = waiting.pop(j)
                    ctx.meter_add("wait", max(0.0, t - t_park))
                    if ctx.rec is None:
                        ctx.clock[j] = max(t, t_park)
                    else:
                        wait0 = float(ctx.clock[j])
                        ctx.clock[j] = max(t, t_park)
                        ctx.rec.span(int(ctx.worker_ids[j]), "ssp.wait",
                                     "stall", wait0, float(ctx.clock[j]))
                    heapq.heappush(heap, (float(ctx.clock[j]), j))

            if done % eval_stride == 0 or done == total:
                # era-wise progress counters: `done` mixes worker-rounds
                # from eras with different fleet widths, so policies get a
                # MONOTONE fleet-round count (a naive done // w regresses
                # after a scale-up and would make a schedule oscillate,
                # re-billing joiner startup every swing) and the epoch
                # estimate accumulates per era
                span = done - done_mark
                fleet_round += span / max(w, 1)
                epoch_acc += span / max(rpe * w, 1)
                done_mark = done
                cur, _ = store.get("global")
                if ctx.record_eval_at(t, cur.reshape(shape)):
                    break
                # cadence save at the eval boundary (the global model was
                # just read); the fleet-wide stall shifts every pending
                # event and park time uniformly, preserving the heap order
                dt_ck = ctx.ckpt_boundary(int(fleet_round))
                if dt_ck > 0.0:
                    t += dt_ck
                    heap = [(tj + dt_ck, j) for tj, j in heap]
                    waiting = {j: tp + dt_ck for j, tp in waiting.items()}
                if ctx.elastic is not None and done < total:
                    w_before = w
                    # resize rebuilds worker state from states[0]: hand it
                    # the freshly-read global model first
                    states[0].params = cur.reshape(shape)
                    if ctx.maybe_resize(int(fleet_round)):
                        break
                    if ctx.w != w_before:
                        # ---- membership change: clock reconciliation ----
                        for j, t_park in waiting.items():
                            ctx.meter_add("wait", max(0.0, t - t_park))
                            if j < ctx.w:
                                if ctx.rec is None:
                                    ctx.clock[j] = max(float(ctx.clock[j]), t)
                                else:
                                    wait0 = float(ctx.clock[j])
                                    ctx.clock[j] = max(wait0, t)
                                    ctx.rec.span(int(ctx.worker_ids[j]),
                                                 "ssp.wait", "stall", wait0,
                                                 float(ctx.clock[j]))
                        waiting.clear()
                        epochs_done = epoch_acc
                        rpe = algo.rounds_per_epoch(ctx.parts[0])
                        per_worker = int(np.ceil(
                            max(ctx.max_epochs - epochs_done, 0.0) * rpe))
                        w = ctx.w
                        states = ctx.states
                        rounds = np.zeros(w, dtype=int)
                        total = done + per_worker * w
                        eval_stride = w * max(rpe // 4, 1)
                        # the comm stack was re-composed: seed the (carried
                        # over or fresh) kvstore with the global model
                        store = ctx.comm.kvstore()
                        ctx.meter_add("resize", store.put("global", cur))
                        heap = [(float(ctx.clock[i]), i) for i in range(w)]
                        heapq.heapify(heap)


class ASP(SSP):
    """Fully-asynchronous (SIREN-style): SSP with no staleness bound."""
    name = ASP_NAME

    def __init__(self):
        super().__init__(staleness=math.inf)


class LocalSGD(SyncProtocol):
    """Local SGD / DiLoCo: sync the fleet every ``h`` rounds, not every
    round (the paper's MA-SGD-beats-GA-SGD regime, §4.2, generalized).

    Between sync rounds every worker applies its OWN update locally
    (``algo.apply_merged(st, own_update, 1)``) while the raw updates
    accumulate; at a sync boundary the workers merge the accumulated
    update vectors through the platform's comm backend and apply the mean
    to the block's base parameters.  For ``h=1`` the code path degenerates
    to exactly one ``bsp_reduce`` + ``apply_merged`` per round (BSP).

    ``outer="diloco"`` instead treats the per-worker parameter displacement
    as a pseudo-gradient and applies :class:`DiLoCoOuter` Nesterov momentum
    to it.  ``compress=True`` ships blockwise int8 + error-feedback
    quantized vectors (:func:`int8_encode_decode`, the fused quant8
    kernel): metered wire bytes drop ~4x on top of the ``h`` x; the
    quantization error is carried per worker into the next sync round.

    Requires an algorithm with additive updates (``ga_sgd``).

    Elastic fleets (DESIGN.md §13) resize at the averaging boundaries
    only -- between boundaries workers hold un-merged local state that a
    membership change would discard -- and the per-worker accumulators
    (and compression residuals) restart at zero for the new fleet.
    """
    name = LOCAL_NAME
    supports_resize = True

    def __init__(self, h: int = 8, outer: str = "ma", compress: bool = False,
                 outer_lr: float = 0.7, outer_momentum: float = 0.9):
        if outer not in ("ma", "diloco"):
            raise ValueError(f"outer must be 'ma' or 'diloco', got {outer!r}")
        if int(h) < 1:
            raise ValueError(f"sync period H must be >= 1, got {h}")
        self.h = int(h)
        self.outer = outer
        self.compress = bool(compress)
        self.outer_opt = DiLoCoOuter(outer_lr, outer_momentum)

    def _merge(self, ctx: SimContext, vecs: list, residual, tag: str):
        """Merge per-worker fp32 vectors through the metered backend;
        with compression the wire payload is the packed int8 form (a
        host stand-in of identical byte count) and the mean is computed
        from the dequantized vectors (error feedback updates ``residual``
        in place)."""
        if not self.compress:
            return ctx.comm.bsp_reduce(ctx, vecs, tag)
        deq = []
        for i, v in enumerate(vecs):
            d, err = int8_encode_decode(v, residual[i])
            residual[i] = err
            deq.append(d)
        wire = [torch.zeros(int8_wire_floats(v.numel()), dtype=torch.float32)
                for v in vecs]
        if ctx.rec is not None:
            ctx.rec.mark("codec", float(np.max(ctx.clock)),
                         codec="int8-ef", raw_bytes=int(vecs[0].nbytes),
                         wire_bytes=int(wire[0].nbytes))
        ctx.comm.bsp_reduce(ctx, wire, tag + ".q8")   # meters time+bytes only
        return mean_of(deq)

    def run(self, ctx: SimContext) -> None:
        algo, model = ctx.algo, ctx.model
        if not getattr(algo, "additive_update", False):
            raise ValueError(
                f"LocalSGD needs an additive-update algorithm (ga_sgd); "
                f"{algo.name!r} ships non-additive updates -- use bsp/asp/ssp")
        rpe = algo.rounds_per_epoch(ctx.parts[0])
        total_rounds = ctx.max_epochs * rpe
        est = float(np.max(ctx.c_round * ctx.speeds)) + 5.0
        diloco = self.outer == "diloco"

        states = ctx.states
        shape = states[0].params.shape
        base = states[0].flat.to(torch.float32).clone()   # params at last sync
        momentum = torch.zeros_like(base) if diloco else None
        residual = ([torch.zeros_like(base) for _ in range(ctx.w)]
                    if self.compress else None)
        accs = [torch.zeros_like(base) for _ in range(ctx.w)]

        rnd = 0
        while rnd < total_rounds:
            states = ctx.states
            for i in range(ctx.w):
                ctx.ensure_alive(i, est)
            updates = [algo.local_update(model, st, rnd) for st in states]
            ctx.tick_compute()
            for i, u in enumerate(updates):
                accs[i] += u
            ctx.res.rounds += 1
            if not ((rnd + 1) % self.h == 0 or rnd == total_rounds - 1):
                for st, u in zip(states, updates):
                    algo.apply_merged(model, st, u, 1)   # local-only round
                rnd += 1
                continue

            # ---- sync boundary: one metered merge for the whole block ----
            if not diloco:
                merged = self._merge(ctx, accs, residual, f"l{rnd}")
                for st in states:
                    st.params = base.reshape(shape)
                    algo.apply_merged(model, st, merged, ctx.w)
                base = states[0].flat
            else:
                deltas = []
                for st, acc in zip(states, accs):
                    st.params = base.reshape(shape)
                    algo.apply_merged(model, st, acc, 1)
                    deltas.append(base - st.flat)   # DiLoCo pseudo-gradient
                mean_delta = self._merge(ctx, deltas, residual, f"l{rnd}")
                base, momentum = self.outer_opt.step(base, momentum,
                                                     mean_delta)
                for st in states:
                    st.params = base.reshape(shape)
            for acc in accs:
                acc.zero_()
            # h == 1 keeps BSP's exact eval cadence (eval_every respected);
            # h > 1 evaluates at EVERY averaging boundary
            params = algo.eval_params(states[0])
            done = (ctx.record_eval(rnd, total_rounds, params) if self.h == 1
                    else ctx.record_eval_at(float(np.max(ctx.clock)), params))
            if done:
                break
            rnd += 1
            # cadence saves ride the averaging boundaries too: between them
            # workers hold un-merged local state no checkpoint could restore
            ctx.ckpt_boundary(rnd)
            # averaging boundary = the only safe membership change: every
            # worker just resynced to the merged model
            stop, total_rounds, rpe, resized = ctx.elastic_boundary(
                rnd, total_rounds, rpe)
            if stop:
                break
            if resized:
                est = float(np.max(ctx.c_round * ctx.speeds)) + 5.0
                accs = [torch.zeros_like(base) for _ in range(ctx.w)]
                if self.compress:
                    residual = [torch.zeros_like(base) for _ in range(ctx.w)]


def sync_name(spec) -> str:
    """Canonical string form of a sync spec (``"bsp"``, ``"asp"``,
    ``"ssp:<s>"``, ``"local:<H>"``, ``"diloco:<H>[:c8]"``) -- the
    serialization used by :class:`repro_torch.experiments.ExperimentSpec`.
    Inverse of :func:`make_sync` up to protocol identity."""
    proto = make_sync(spec)
    if isinstance(proto, ASP):
        return ASP_NAME
    if isinstance(proto, SSP):
        s = proto.staleness
        return SSP_NAME if s is None else f"{SSP_NAME}:{s:g}"
    if isinstance(proto, LocalSGD):
        if proto.outer == "diloco" and proto.outer_opt != DiLoCoOuter():
            raise ValueError(
                "custom DiLoCo outer_lr/outer_momentum are not expressible "
                "as a sync string (specs serialize the defaults only); pass "
                "the LocalSGD instance directly to the platform instead")
        head = DILOCO_NAME if proto.outer == "diloco" else LOCAL_NAME
        return (f"{head}:{proto.h}"
                + (f":{COMPRESS_SUFFIX}" if proto.compress else ""))
    return proto.name


def make_sync(spec) -> SyncProtocol:
    """``"bsp"`` | ``"asp"`` | ``"ssp[:<s>]"`` | ``"local[:<H>][:c8]"`` |
    ``"diloco[:<H>][:c8]"`` | protocol class or instance."""
    if isinstance(spec, SyncProtocol):
        return spec
    if isinstance(spec, type) and issubclass(spec, SyncProtocol):
        return spec()
    name, _, arg = str(spec).partition(":")
    if name == BSP_NAME:
        return BSP()
    if name == ASP_NAME:
        return ASP()
    if name == SSP_NAME:
        s = float(arg) if arg else 3.0
        return SSP(int(s) if s.is_integer() else s)   # "ssp:inf" works too
    if name in (LOCAL_NAME, DILOCO_NAME):
        h_part, _, c_part = arg.partition(":")
        if h_part == COMPRESS_SUFFIX and not c_part:    # "local:c8"
            h_part, c_part = "", COMPRESS_SUFFIX
        if c_part not in ("", COMPRESS_SUFFIX):
            raise KeyError(f"unknown sync protocol suffix {c_part!r} in "
                           f"{spec!r} (only {COMPRESS_SUFFIX!r})")
        return LocalSGD(h=int(h_part) if h_part else 8,
                        outer="diloco" if name == DILOCO_NAME else "ma",
                        compress=c_part == COMPRESS_SUFFIX)
    raise KeyError(f"unknown sync protocol {spec!r}")
