"""Analytic fleet planner: the §5.3 cost model as a decision subsystem
(DESIGN.md §13).

The paper's headline result is that the profitable degree of parallelism
is workload-dependent: FaaS pays off for fast-converging, comm-light
models (LR/Higgs), IaaS for comm-heavy ones (MobileNet).  The analytical
model (:mod:`repro_torch.core.analytical`) already encodes the whole trade-off;
:func:`plan` turns it into ranked advice by sweeping fleet width x
platform through ``faas_time``/``iaas_time`` and the pricing model.

Objectives:

- ``fastest``  -- minimize wall-clock, budget-feasible options first.
- ``cheapest`` -- minimize dollars among DEADLINE-feasible options.  With
  no explicit ``deadline_s`` the deadline defaults to ``slack`` x the
  fastest option ("no-regret": the paper's profitability question is asked
  at a competitive degree of parallelism, not at w=1-and-wait) -- pass
  ``deadline_s=math.inf`` for the unconstrained minimum, which on this
  pricing model is always a small IaaS fleet.

Entry points: ``python -m repro_torch plan`` (CLI verb), ``ExperimentSpec(
scaling="plan")`` (use the pick as the initial fleet), or call
:func:`plan` directly with a :class:`~repro_torch.core.analytical.CostInputs`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.analytical import (
    TABLE6, CostInputs, faas_cost, faas_time, iaas_cost, iaas_time,
    pod_cost, pod_time,
)
from repro_torch.core.elastic.policies import MAX_FLEET

#: default fleet widths swept by the planner (the paper's Fig 11/14 axis)
DEFAULT_WORKERS = (1, 2, 5, 10, 25, 50, 100, 150, 200, 300)

#: paper-scale ``(s, m, R, C)`` constants for the Fig 11-14 workloads --
#: the crossover fixtures the planner CLI and tests reproduce: LR/Higgs
#: converges fast and ships 16 KB updates (FaaS pays off), MobileNet/
#: ResNet ship MBs for hundreds of epochs (IaaS wins outright)
PAPER_WORKLOADS = {
    "lr_higgs": CostInputs(s_bytes=16e9, m_bytes=16e3, R=10, C=30.0),
    "svm_rcv1": CostInputs(s_bytes=1.2e9, m_bytes=189e3, R=15, C=20.0),
    "kmeans_higgs": CostInputs(s_bytes=16e9, m_bytes=3.4e3, R=15, C=45.0),
    "mobilenet_cifar10": CostInputs(s_bytes=220e6, m_bytes=12e6,
                                    R=500, C=400.0),
    "resnet50_cifar10": CostInputs(s_bytes=220e6, m_bytes=89e6,
                                   R=600, C=900.0),
}

OBJECTIVES = ("cheapest", "fastest")


@dataclass(frozen=True)
class PlanOption:
    """One ranked point of the plan: platform x width -> (time, $)."""
    platform: str
    workers: int
    time_s: float
    cost_usd: float
    feasible: bool = True
    note: str = ""

    def to_dict(self) -> dict:
        return {"platform": self.platform, "workers": self.workers,
                "time_s": round(self.time_s, 1),
                "cost_usd": round(self.cost_usd, 4),
                "feasible": self.feasible, "note": self.note}


def as_cost_inputs(workload, *, R: float | None = None) -> CostInputs:
    """Coerce a plan target into :class:`CostInputs`: pass one through, a
    :data:`PAPER_WORKLOADS` name, or an ``ExperimentSpec`` (the constants
    are derived from its actual workload; ``R`` defaults to the spec's
    epoch budget)."""
    if isinstance(workload, CostInputs):
        return workload
    if isinstance(workload, str):
        try:
            return PAPER_WORKLOADS[workload]
        except KeyError:
            raise KeyError(
                f"unknown planner workload {workload!r}; named workloads: "
                f"{', '.join(sorted(PAPER_WORKLOADS))}") from None
    # duck-typed ExperimentSpec
    wl, _algo, tr, _va = workload.build_workload()
    return CostInputs.from_workload(
        wl, tr, R=workload.max_epochs if R is None else R)


def plan(workload, objective: str = "cheapest", *,
         deadline_s: float | None = None, budget_usd: float | None = None,
         workers=DEFAULT_WORKERS, platforms=("faas", "iaas"),
         channel: str = "s3", codec: str = "fp32", gb: float = 3.0,
         instance: str = "t2.medium", chips_per_pod: int = 4,
         mfu: float | str = 0.4,
         slack: float = 1.25,  # lint: ignore[C001] -- deadline slack, not a price
         R: float | None = None) -> list[PlanOption]:
    """Sweep ``workers`` x ``platforms`` through the analytic model and
    return options ranked best-first: feasible options (deadline + budget)
    before infeasible ones, then by the objective's key.  See the module
    docstring for the ``cheapest`` auto-deadline.  ``platforms`` may
    include ``"pod"`` (accelerator slices, ``pod_time``/``pod_cost``);
    ``mfu="measured"`` derives those rows from the benchmarked roofline
    fraction instead of the asserted default."""
    if objective not in OBJECTIVES:
        raise ValueError(f"objective must be one of {OBJECTIVES}, "
                         f"got {objective!r}")
    ci = as_cost_inputs(workload, R=R)
    if "pod" in platforms:
        from repro_torch.core.calibration import resolve_mfu
        mfu = resolve_mfu(mfu)   # resolve once: one snapshot read per plan
    # the analytic NIC table (Table 6 "B_n"/"L_n") covers two instance
    # rows; for others the TIME constants fall back to t2.medium's NIC
    # (flagged in the option note) while the COST keeps the real instance
    # price -- dollars must never silently change instance type
    time_instance, nic_note = instance, ""
    if instance not in TABLE6["B_n"]:
        time_instance = "t2.medium"
        nic_note = f"NIC constants approximated from {time_instance}"
    raw = []
    for w in workers:
        w = int(w)
        if "faas" in platforms:
            t = faas_time(ci, w, channel=channel, codec=codec)
            raw.append(("faas", w, t, faas_cost(ci, w, t, gb), ""))
        if "iaas" in platforms:
            t = iaas_time(ci, w, instance=time_instance)
            raw.append(("iaas", w, t, iaas_cost(ci, w, t, instance),
                        nic_note))
        if "pod" in platforms:
            t = pod_time(ci, w, chips_per_pod=chips_per_pod, mfu=mfu,
                         codec=codec)
            raw.append(("pod", w, t, pod_cost(ci, w, t, chips_per_pod),
                        f"mfu={mfu:.3f}"))
    if not raw:
        return []
    fastest = min(t for _, _, t, _, _ in raw)
    if deadline_s is None:
        deadline_s = slack * fastest if objective == "cheapest" else math.inf
    options = []
    for plat, w, t, c, extra in raw:
        notes = []
        if t > deadline_s:
            notes.append(f"misses deadline ({t:.0f}s > {deadline_s:.0f}s)")
        if budget_usd is not None and c > budget_usd:
            notes.append(f"over budget (${c:.4f} > ${budget_usd:.4f})")
        feasible = not notes
        if extra:
            notes.append(extra)
        options.append(PlanOption(plat, w, t, c, feasible=feasible,
                                  note="; ".join(notes)))
    key = ((lambda o: o.cost_usd) if objective == "cheapest"
           else (lambda o: o.time_s))
    return sorted(options, key=lambda o: (not o.feasible, key(o)))


def plan_initial_workers(spec, objective: str = "cheapest") -> int:
    """The width ``scaling="plan"`` starts a spec's run with: the best
    feasible option for the SPEC's platform (the platform itself is fixed
    by the spec; cross-platform comparison is ``repro_torch plan``'s job),
    clamped to the fleet's elastic bounds."""
    if spec.platform not in ("faas", "iaas"):
        raise ValueError(
            f"scaling='plan' covers the analytic model's platforms "
            f"(faas/iaas), not {spec.platform!r}; size pod fleets "
            f"explicitly or via scaling='schedule:...'")
    fleet = spec.fleet
    lo = 1 if fleet.min_workers is None else int(fleet.min_workers)
    hi = fleet.max_workers
    candidates = [w for w in DEFAULT_WORKERS
                  if lo <= w and (hi is None or w <= int(hi))]
    kw = {}
    if spec.platform == "faas":
        transport, _c, codec = spec.comm.resolved("faas")
        kw = dict(channel=transport, codec=codec,
                  gb=float(fleet.gb_array()[0]))
    else:
        kw = dict(instance=str(fleet.instances()[0]))
    options = plan(spec, objective, workers=candidates or [fleet.workers],
                   platforms=(spec.platform,), **kw)
    best = next((o for o in options if o.feasible), options[0])
    return max(lo, min(best.workers,
                       int(hi) if hi is not None else MAX_FLEET))
