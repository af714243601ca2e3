"""Scaling policies and the elastic fleet controller (DESIGN.md §13).

A :class:`ScalingPolicy` observes one :class:`~repro_torch.core.elastic.telemetry.
Telemetry` snapshot per sync boundary and returns the fleet width it wants
next (0 = stop the run).  Policies are selected by the same string-grammar
convention as sync protocols and comm stacks, via
``ExperimentSpec(scaling=...)`` / ``FaaSRuntime(scaling=...)``:

- ``static``                -- never resize (the default; parity-pinned:
  the engine takes the exact pre-elastic code path),
- ``schedule:<w@round,...>`` -- declarative resize plan
  (``"schedule:2@0,8@5"`` = 2 workers from round 0, 8 from round 5),
- ``smlt``                  -- SMLT-style adaptive scaling (Ali et al.,
  PAPERS.md): widen while the per-round progress rate (loss drop x
  throughput) keeps improving, narrow once statistical efficiency decays,
- ``cost_cap:<dollars>``    -- MLLess-style budget guard (Sarroca &
  Sánchez-Artigas, PAPERS.md): shed workers to stretch the remaining
  budget, stop before overshooting it by more than one round's spend,
- ``plan[:<objective>]``    -- use the analytic planner's pick
  (:mod:`repro_torch.core.elastic.planner`) as the initial fleet, then run
  static.  Resolved at spec level (it needs the workload constants), so
  :func:`make_policy` refuses it with a pointer.

The :class:`ElasticController` is the engine-facing half: it builds the
telemetry from the :class:`~repro_torch.core.engine.SimContext`, clamps the
policy's answer to the FleetSpec's ``min_workers``/``max_workers``, and
performs the resize through ``ctx.resize``.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.elastic.telemetry import Telemetry

#: hard ceiling when FleetSpec.max_workers is unset -- generous beyond the
#: paper's 300-worker measurements, but keeps a runaway policy bounded
MAX_FLEET = 1000


@runtime_checkable
class ScalingPolicy(Protocol):
    """The decision surface of elastic fleet control (DESIGN.md §13)."""

    name: str

    def initial_workers(self, w0: int) -> int:
        """Fleet width to START with (``w0`` = the FleetSpec's); lets a
        schedule's round-0 entry apply before anything is invoked."""
        ...

    def observe(self, t: Telemetry) -> int:
        """Target width for the next rounds; 0 stops the run.  The
        controller clamps the answer to ``[min_workers, max_workers]``."""
        ...


class StaticPolicy:
    """Never resize.  :func:`build_controller` maps this to *no controller
    at all*, so the engine runs the exact fixed-fleet code path -- the
    byte-identity contract the parity tests pin."""
    name = "static"

    def initial_workers(self, w0: int) -> int:
        return w0

    def observe(self, t: Telemetry) -> int:
        return t.workers


class SchedulePolicy:
    """Declarative resize plan: ``schedule:<w@round,...>``.

    Entry ``w@r`` means "run with ``w`` workers from round ``r`` on"; the
    latest entry at or before the current round wins.  A round-0 entry
    also pins the INITIAL fleet (applied before startup, so nothing is
    invoked twice)."""
    name = "schedule"

    def __init__(self, plan):
        entries = sorted((int(r), int(w)) for r, w in plan)
        if not entries:
            raise ValueError("schedule needs at least one w@round entry")
        rounds = [r for r, _ in entries]
        if len(set(rounds)) != len(rounds):
            raise ValueError(f"schedule has duplicate rounds: {rounds}")
        if rounds[0] < 0:
            raise ValueError(f"schedule rounds must be >= 0, got {rounds[0]}")
        if any(w < 1 for _, w in entries):
            raise ValueError("schedule widths must be >= 1")
        self.plan = tuple(entries)

    @classmethod
    def parse(cls, arg: str) -> "SchedulePolicy":
        """``"2@0,8@5"`` -> entries ((0, 2), (5, 8))."""
        plan = []
        for item in arg.split(","):
            w_s, sep, r_s = item.partition("@")
            if not sep:
                raise ValueError(
                    f"schedule entry {item!r} is not <workers>@<round> "
                    f"(example: scaling='schedule:2@0,8@5')")
            plan.append((int(r_s), int(w_s)))
        return cls(plan)

    def _at(self, rnd: int, default: int) -> int:
        w = default
        for r, tw in self.plan:
            if r <= rnd:
                w = tw
        return w

    def initial_workers(self, w0: int) -> int:
        return self._at(0, w0)

    def observe(self, t: Telemetry) -> int:
        return self._at(t.round, t.workers)


class SMLTPolicy:
    """SMLT-style adaptive scaling: widen while the per-round progress
    rate (loss drop x throughput) keeps improving, step back once it
    stops, and narrow when statistical efficiency decays (the late-run
    regime where extra workers buy almost no loss drop -- MLLess's
    scale-down-to-save-money observation)."""
    name = "smlt"

    def __init__(self, factor: int = 2, improve_tol: float = 0.02,
                 decay_frac: float = 0.25):
        if int(factor) < 2:
            raise ValueError(f"smlt step factor must be >= 2, got {factor}")
        self.factor = int(factor)
        self.improve_tol = float(improve_tol)
        self.decay_frac = float(decay_frac)
        self._best_rate: float | None = None
        self._peak_delta: float | None = None
        self._widening = True

    def initial_workers(self, w0: int) -> int:
        return w0

    def observe(self, t: Telemetry) -> int:
        rate = t.progress_rate
        if rate is None:
            return t.workers              # no signal yet
        delta = t.loss_delta
        if delta is not None and delta > 0:
            if self._peak_delta is None or delta > self._peak_delta:
                self._peak_delta = delta
        if delta is None or delta <= 0:
            # loss stalled or regressed: stop exploring, shed a step
            self._widening = False
            return max(t.workers // self.factor, t.min_workers)
        if self._widening:
            if (self._best_rate is None
                    or rate > self._best_rate * (1.0 + self.improve_tol)):
                self._best_rate = rate
                return min(t.workers * self.factor, t.max_workers)
            # widening stopped paying: step back and hold
            self._widening = False
            return max(t.workers // self.factor, t.min_workers)
        if (self._peak_delta is not None
                and delta < self.decay_frac * self._peak_delta):
            return max(t.workers // self.factor, t.min_workers)
        return t.workers


class CostCapPolicy:
    """MLLess-style running budget: keep the fleet only as wide as the
    remaining dollars can carry; stop (width 0) rather than bust the cap.

    Invariant (property-tested): a run under ``cost_cap:<b>`` never costs
    more than ``b`` plus ONE round's spend -- the policy only lets another
    round start while the bill is still under the budget, and sheds
    workers once the projected next-round spend would cross it."""
    name = "cost_cap"

    def __init__(self, budget_usd: float):
        budget = float(budget_usd)
        if not budget > 0.0:
            raise ValueError(f"cost_cap budget must be > 0, got {budget}")
        self.budget = budget
        self._prev_cost: float | None = None
        self.max_round_spend = 0.0       # observed, for the property test

    def initial_workers(self, w0: int) -> int:
        return w0

    def observe(self, t: Telemetry) -> int:
        spend = t.cost_so_far - (self._prev_cost or 0.0)
        self._prev_cost = t.cost_so_far
        self.max_round_spend = max(self.max_round_spend, spend)
        if t.cost_so_far >= self.budget:
            return 0
        remaining = self.budget - t.cost_so_far
        if spend <= 0.0 or spend <= remaining:
            return t.workers
        # the next round at this width busts the budget: shed workers
        # (per-round spend scales ~linearly with width on every platform)
        shrunk = max(t.min_workers,
                     min(t.workers, int(t.workers * remaining / spend)))
        if spend * shrunk / t.workers > remaining:
            return 0                     # even the floor fleet busts it
        return shrunk


# ------------------------------------------------------------- controller ---

class ElasticController:
    """Engine-side controller: telemetry in, (clamped) resize out.

    Built once per run by :func:`build_controller`; the engine calls
    :meth:`step` at every sync boundary the protocol declares safe
    (``supports_resize``).  Keeps the per-run observation state (previous
    loss/clock/rounds) so policies stay pure functions of telemetry."""

    def __init__(self, policy, min_workers: int, max_workers: int):
        self.policy = policy
        self.min_w = int(min_workers)
        self.max_w = int(max_workers)
        self.telemetry_log: list[Telemetry] = []
        self._prev_loss: float | None = None
        self._prev_time: float | None = None
        self._rounds_at_time = 0         # rounds at the last boundary
        self._rounds_at_eval = 0         # rounds at the last NEW eval
        self._prev_evals = 0             # history length last boundary

    def initial_workers(self, w0: int) -> int:
        return max(self.min_w, min(self.max_w,
                                   int(self.policy.initial_workers(w0))))

    def snapshot(self, ctx, rnd: int) -> Telemetry:
        """Build (and log) the boundary telemetry from the engine state."""
        res = ctx.res
        loss = float(res.history[-1][1]) if res.history else None
        now = float(np.max(ctx.clock))
        dr = max(res.rounds - self._rounds_at_time, 1)
        round_time = ((now - self._prev_time) / dr
                      if self._prev_time is not None else now)
        # loss_delta only when the history actually GREW since the last
        # boundary: under eval_every > 1 some boundaries see no new eval,
        # and a stale entry would read as delta == 0.0 ("stalled")
        # instead of "no signal" (None)
        fresh_eval = loss is not None and len(res.history) > self._prev_evals
        loss_delta = None
        if fresh_eval and self._prev_loss is not None:
            loss_delta = (self._prev_loss - loss) / max(
                res.rounds - self._rounds_at_eval, 1)
        # one source of truth (DESIGN.md §18): when tracing, both the comm
        # seconds and the cost snapshot come from the recorder -- its meter
        # mirror and $ ledger are bitwise-equal to the engine values by
        # construction, so policy decisions are identical either way
        from repro_torch.core.trace import comm_seconds
        cost_now = float(ctx.platform.finalize_cost(ctx))
        if ctx.rec is not None:
            cost_now = ctx.rec.cost_total()
        tel = Telemetry(
            round=int(rnd), workers=ctx.w, loss=loss, loss_delta=loss_delta,
            round_time=round_time,
            comm_share=comm_seconds(ctx) / max(now, 1e-12),
            cost_so_far=cost_now,
            sim_time=now, min_workers=self.min_w, max_workers=self.max_w)
        self.telemetry_log.append(tel)
        if fresh_eval:
            self._prev_loss = loss
            self._rounds_at_eval = res.rounds
        self._prev_evals = len(res.history)
        self._rounds_at_time = res.rounds
        self._prev_time = now
        return tel

    def step(self, ctx, rnd: int) -> bool:
        """One boundary decision; True = the policy stopped the run."""
        tel = self.snapshot(ctx, rnd)
        target = int(self.policy.observe(tel))
        if target <= 0:
            ctx.res.scaling_timeline.append((int(rnd), 0, 0.0, 0.0))
            return True
        target = max(self.min_w, min(self.max_w, target))
        if target != ctx.w and self._comm_feasible(ctx, target):
            ctx.resize(target, rnd)
        return False

    @staticmethod
    def _comm_feasible(ctx, target: int) -> bool:
        """Spec-time comm validation, re-run for the CANDIDATE width: a
        scatter-reduce chunk grows as the fleet shrinks, so a scale-down
        can push a per-item transport limit (DynamoDB's 400 KB) that the
        original width satisfied.  An infeasible target skips the resize
        (the fleet keeps its width) instead of aborting the run mid-flight
        with ChannelItemTooLarge."""
        spec = getattr(ctx.platform, "comm", None)
        if spec is None or not hasattr(spec, "validate"):
            return True
        base = ctx.platform.system_name().partition("-")[0]
        update_bytes = ctx.last_update_nbytes or ctx.mbytes
        try:
            spec.validate(platform=base, model_bytes=update_bytes,
                          workers=target)
        except ValueError:
            return False
        return True


# ---------------------------------------------------------------- registry --

#: name -> factory(arg_str_or_None); the grammar mirror of the sync/comm
#: registries
POLICIES = {
    "static": lambda arg=None: StaticPolicy(),
    "schedule": lambda arg=None: SchedulePolicy.parse(arg or ""),
    "smlt": lambda arg=None: SMLTPolicy(int(arg) if arg else 2),
    "cost_cap": lambda arg=None: CostCapPolicy(float(arg) if arg else 0.0),
}


def make_policy(spec) -> "ScalingPolicy":
    """``"static"`` | ``"schedule:<w@round,...>"`` | ``"smlt[:<factor>]"``
    | ``"cost_cap:<dollars>"`` | a :class:`ScalingPolicy` instance."""
    if not isinstance(spec, str):
        if isinstance(spec, type):
            return spec()
        return spec
    name, _, arg = spec.partition(":")
    if name == "plan":
        raise ValueError(
            "scaling='plan' is resolved at spec level (it needs the "
            "workload's analytic constants): use "
            "ExperimentSpec(scaling='plan') or pick the width with "
            "repro_torch.core.elastic.planner.plan() yourself")
    try:
        factory = POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown scaling policy {spec!r}; available: "
                       f"{', '.join(sorted(POLICIES))}, plan") from None
    return factory(arg or None)


def validate_scaling(spec) -> None:
    """Eager grammar check for ``ExperimentSpec.scaling`` (a sweep should
    reject at expansion, not crash mid-run): parses and discards."""
    if isinstance(spec, str):
        head, _, arg = spec.partition(":")
        if head == "plan":
            if arg not in ("", "cheapest", "fastest"):
                raise ValueError(
                    f"plan objective must be 'cheapest' or 'fastest', "
                    f"got {arg!r}")
            return
    make_policy(spec)


def build_controller(scaling, fleet) -> ElasticController | None:
    """Turn a platform's ``scaling`` spec + FleetSpec into a controller.

    Returns ``None`` for static (string or instance): the engine then runs
    the pre-elastic fixed-fleet path untouched.  Heterogeneous per-worker
    fleets (tuple ``lambda_gb``/``instance``) are rejected -- a joiner's
    shape would be ambiguous."""
    policy = make_policy(scaling)
    if isinstance(policy, StaticPolicy):
        return None
    for name in ("lambda_gb", "instance"):
        if isinstance(getattr(fleet, name, None), tuple):
            raise ValueError(
                f"elastic scaling needs a homogeneous fleet; per-worker "
                f"{name}={getattr(fleet, name)!r} cannot be resized")
    min_w = 1 if fleet.min_workers is None else int(fleet.min_workers)
    max_w = MAX_FLEET if fleet.max_workers is None else int(fleet.max_workers)
    return ElasticController(policy, min_w, max_w)


def list_policies() -> list[str]:
    """Human-oriented registry listing for ``repro_torch list``."""
    return ["static", "schedule:<w@round,...>", "smlt[:<factor>]",
            "cost_cap:<dollars>", "plan[:cheapest|fastest]"]
