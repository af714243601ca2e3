"""Named experiment presets: the paper's figures as specs, not scripts.

Each preset is a declarative bundle of :class:`ExperimentSpec` trials (plus
a canonical ``base`` spec), the same eleven bundles as the JAX package's;
``faas_vs_pod`` and ``pod_local_sgd`` train a model-zoo architecture
(smollm-360m) through the engine.  ``python -m repro_torch run <name>``
consumes them.

Every preset takes ``quick`` (small row counts, CI-friendly) vs full
paper-scale sizes -- the same knob the benchmark suite always had.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core.runtimes import _T_IAAS, interp_startup
from repro_torch.experiments.spec import (
    CommSpec, ExperimentSpec, FailureSpec, FleetSpec,
)


@dataclass(frozen=True)
class Preset:
    """A named, parameter-free study: ``build(quick)`` yields its trials."""
    name: str
    description: str
    build: Callable[[bool], list[ExperimentSpec]] = field(repr=False)

    def base(self, quick: bool = True) -> ExperimentSpec:
        """Canonical single spec for sweeping (the first trial)."""
        return self.build(quick)[0]


_GA = {"lr": 0.3, "batch_size": 2048}
_ADMM = {"lr": 0.1, "local_epochs": 5}


def _fig10_breakdown(quick: bool) -> list[ExperimentSpec]:
    base = ExperimentSpec(
        model="lr", dataset="higgs", rows=30_000 if quick else 500_000,
        algorithm="ga_sgd", algo_args=dict(_GA), max_epochs=10,
        fleet=FleetSpec(workers=10))
    return [
        base.with_(name="fig10_faas_s3", platform="faas",
                   comm=CommSpec(channel="s3")),
        base.with_(name="fig10_faas_memcached", platform="faas",
                   comm=CommSpec(channel="memcached")),
        base.with_(name="fig10_hybridps", platform="faas",
                   comm=CommSpec(channel="vmps")),
        base.with_(name="fig10_iaas", platform="iaas"),
    ]


def _fig10_trace(quick: bool) -> list[ExperimentSpec]:
    """The Fig-10 trials with the span recorder on (§18): the breakdown
    table is re-derived from spans alone and gated on the conservation
    invariants (``repro trace fig10_trace``)."""
    return [s.with_(name=s.name.replace("fig10_", "fig10_trace_"),
                    trace=True)
            for s in _fig10_breakdown(quick)]


def _fig11_end2end(quick: bool) -> list[ExperimentSpec]:
    base = ExperimentSpec(
        model="lr", dataset="higgs", rows=30_000 if quick else 400_000,
        algorithm="admm", algo_args=dict(_ADMM), max_epochs=3)
    counts = (1, 5, 10) if quick else (1, 5, 10, 25, 50, 100)
    specs = []
    for w in counts:
        for plat in ("faas", "iaas"):
            specs.append(base.with_(
                name=f"fig11_lr_{plat}_w{w}", platform=plat,
                **{"fleet.workers": w}))
    return specs


def _fig8_sync(quick: bool) -> list[ExperimentSpec]:
    # high lr + strong straggler: the regime where stale SIREN-style
    # overwrites destabilize (paper Fig 8); SSP's bound caps the damage
    base = ExperimentSpec(
        platform="faas", model="lr", algorithm="ga_sgd",
        algo_args={"lr": 1.0, "batch_size": 2048}, max_epochs=4,
        fleet=FleetSpec(workers=16, straggler=6.0))
    datasets = ("higgs",) if quick else ("higgs", "rcv1")
    rows = 30_000 if quick else 200_000
    return [
        base.with_(name=f"fig8_{ds}_{sync.replace(':', '')}", dataset=ds,
                   rows=rows, sync=sync)
        for ds in datasets for sync in ("bsp", "asp", "ssp:2")
    ]


def _spot_vs_ondemand(quick: bool) -> list[ExperimentSpec]:
    w = 8
    t0 = interp_startup(_T_IAAS, w)       # kills land after cluster startup
    base = ExperimentSpec(
        platform="iaas", model="lr", dataset="higgs",
        rows=30_000 if quick else 200_000, algorithm="ga_sgd",
        algo_args=dict(_GA), max_epochs=3, fleet=FleetSpec(workers=w))
    return [
        base.with_(name="spot_ondemand"),
        base.with_(name="spot_preempted",
                   failure=FailureSpec(spot=True,
                                       inject=((1, t0 + 2.0), (5, t0 + 6.0)))),
    ]


def _spot_trace(quick: bool) -> list[ExperimentSpec]:
    # trace-driven spot failures x checkpoint cadence (DESIGN.md §17): the
    # recorded spot_burst reclaim wave replayed against a no-cadence fleet
    # (save-at-kill seed semantics) and three checkpoint policies -- the
    # cadence grid shows the rework-vs-overhead trade the derived restart
    # term prices
    base = ExperimentSpec(
        platform="iaas", model="lr", dataset="higgs",
        rows=30_000 if quick else 200_000, algorithm="ga_sgd",
        algo_args=dict(_GA), max_epochs=3, fleet=FleetSpec(workers=8),
        failure=FailureSpec(spot=True, trace="spot_burst"))
    return [
        base.with_(name="spot_trace_nockpt"),
        base.with_(name="spot_trace_every2", ckpt="s3:every=2"),
        base.with_(name="spot_trace_every8", ckpt="s3:every=8"),
        base.with_(name="spot_trace_sharded", ckpt="s3:every=2:sharded"),
    ]


def _hetero_fleet(quick: bool) -> list[ExperimentSpec]:
    return [
        ExperimentSpec(
            name="hetero_faas_mixed_gb", platform="faas", model="mobilenet",
            dataset="cifar10", rows=4_000 if quick else 50_000,
            algorithm="ga_sgd", algo_args={"lr": 0.05, "batch_size": 512},
            max_epochs=1, comm=CommSpec(channel="memcached"),
            fleet=FleetSpec(workers=6,
                            lambda_gb=(3.0, 3.0, 3.0, 3.0, 1.0, 1.0))),
        ExperimentSpec(
            name="hetero_iaas_mixed_instances", platform="iaas", model="lr",
            dataset="higgs", rows=30_000 if quick else 400_000,
            algorithm="admm", algo_args=dict(_ADMM), max_epochs=3,
            fleet=FleetSpec(workers=4,
                            instance=("c5.large", "c5.large",
                                      "t2.medium", "t2.medium"))),
    ]


def _faas_vs_pod(quick: bool) -> list[ExperimentSpec]:
    # a REAL smollm-360m-config workload running genuine fwd/bwd numerics
    # through the engine on all three infrastructures (the reduced config;
    # --set model_args={"reduced":false} builds the published 360M shapes
    # -- same code path).  LocalSGD(H=8) on the pod platform is the paper's
    # reduced-communication regime: ~8x fewer metered cross-pod comm
    # seconds/bytes at matching statistical efficiency.
    base = ExperimentSpec(
        model="smollm_360m", dataset="tokens",
        rows=256 if quick else 16_384,
        algorithm="ga_sgd", algo_args={"lr": 0.05, "batch_size": 8},
        max_epochs=2, fleet=FleetSpec(workers=4))
    return [
        base.with_(name="pods_faas_bsp", platform="faas",
                   comm=CommSpec(channel="memcached")),
        base.with_(name="pods_iaas_bsp", platform="iaas"),
        base.with_(name="pods_pod_bsp", platform="pod"),
        base.with_(name="pods_pod_local8", platform="pod", sync="local:8"),
    ]


def _comm_axis(quick: bool) -> list[ExperimentSpec]:
    # the Transport x Collective x Codec axis (DESIGN.md §12) on one
    # CNN-sized workload: Table 3's allreduce-vs-scatter-reduce, the
    # FSD-Inference-style hierarchical tree, and the MLLess-style
    # reduced-communication codecs that change the FaaS verdict -- plus
    # the same codecs riding the IaaS NIC ring and the pod DCN.
    base = ExperimentSpec(
        platform="faas", model="mobilenet", dataset="cifar10",
        rows=2_000 if quick else 20_000, algorithm="ga_sgd",
        algo_args={"lr": 0.05, "batch_size": 512}, max_epochs=1,
        fleet=FleetSpec(workers=8))
    stacks = [
        "s3/allreduce/fp32",
        "s3/scatter_reduce/fp32",
        "s3/hierarchical/fp32",
        "s3/scatter_reduce/int8",
        "s3/scatter_reduce/topk:0.01",
        "memcached/allreduce/fp32",
        "vmps/pushpull/fp32",
    ]
    specs = [base.with_(name="comm_" + s.replace("/", "_").replace(":", ""),
                        comm=s)
             for s in stacks]
    specs.append(base.with_(name="comm_iaas_nic_ring_int8", platform="iaas",
                            comm="nic/ring/int8"))
    specs.append(base.with_(name="comm_pod_dcn_ring_int8", platform="pod",
                            comm="dcn/ring/int8"))
    return specs


def _pod_local_sgd(quick: bool) -> list[ExperimentSpec]:
    # communication-interval sweep on the pod platform: BSP GA-SGD vs
    # LocalSGD(H) vs DiLoCo, with and without int8 delta compression (the
    # quant8 kernel on the card)
    base = ExperimentSpec(
        platform="pod", model="smollm_360m", dataset="tokens",
        rows=256 if quick else 16_384,
        algorithm="ga_sgd", algo_args={"lr": 0.05, "batch_size": 8},
        max_epochs=2, fleet=FleetSpec(workers=4))
    return [
        base.with_(name="podsgd_bsp"),
        base.with_(name="podsgd_local1", sync="local:1"),
        base.with_(name="podsgd_local8", sync="local:8"),
        base.with_(name="podsgd_local8_c8", sync="local:8:c8"),
        base.with_(name="podsgd_diloco8", sync="diloco:8"),
    ]


def _elastic_axis(quick: bool) -> list[ExperimentSpec]:
    # the elastic-fleet axis (DESIGN.md §13) on the Fig-11 workload: a
    # fixed fleet vs a declarative resize plan vs SMLT-style adaptive
    # scaling vs an MLLess-style cost cap, all emitting w(t) in
    # RunResult.scaling_timeline
    base = ExperimentSpec(
        platform="faas", model="lr", dataset="higgs",
        rows=30_000 if quick else 400_000, algorithm="ga_sgd",
        algo_args=dict(_GA), max_epochs=6,
        fleet=FleetSpec(workers=4, min_workers=2, max_workers=16))
    return [
        base.with_(name="elastic_static"),
        base.with_(name="elastic_schedule", scaling="schedule:2@0,8@5"),
        base.with_(name="elastic_smlt", scaling="smlt"),
        base.with_(name="elastic_cost_cap",
                   scaling="cost_cap:0.01" if quick else "cost_cap:0.25"),
        base.with_(name="elastic_iaas_schedule", platform="iaas",
                   scaling="schedule:4@0,2@3"),
    ]


PRESETS: dict[str, Preset] = {p.name: p for p in [
    Preset("fig10_breakdown",
           "Fig 10: startup/load/compute/comm breakdown, FaaS channels vs "
           "hybrid VM-PS vs IaaS (LR on Higgs, w=10)", _fig10_breakdown),
    Preset("fig10_trace",
           "Fig 10 re-derived from spans (§18): the same four trials with "
           "trace=True, phase table from the recorder + conservation gates",
           _fig10_trace),
    Preset("fig11_end2end",
           "Fig 11: end-to-end runtime+cost vs worker count, FaaS vs IaaS "
           "(LR+ADMM on Higgs)", _fig11_end2end),
    Preset("fig8_sync",
           "Fig 8: BSP vs ASP vs SSP(s=2) under a 6x straggler "
           "(GA-SGD, w=16)", _fig8_sync),
    Preset("spot_vs_ondemand",
           "Spot IaaS with injected preemptions + restart-from-checkpoint "
           "vs the on-demand fleet", _spot_vs_ondemand),
    Preset("spot_trace",
           "Recorded spot-preemption trace (spot_burst) x checkpoint "
           "cadence grid: no cadence vs s3:every=2/8 vs sharded (§17)",
           _spot_trace),
    Preset("hetero_fleet",
           "Heterogeneous fleets: mixed 1/3 GB Lambdas and mixed instance "
           "types", _hetero_fleet),
    Preset("faas_vs_pod",
           "Real smollm-360m workload (genuine PyTorch fwd/bwd) on all three "
           "infrastructures: FaaS vs IaaS vs accelerator pods, + "
           "LocalSGD(H=8) on pods", _faas_vs_pod),
    Preset("pod_local_sgd",
           "Pod platform comm-interval sweep: BSP vs LocalSGD(H) vs DiLoCo "
           "vs int8-compressed deltas (MA-SGD insight on pod meshes)",
           _pod_local_sgd),
    Preset("comm_axis",
           "Transport x Collective x Codec axis (§12): S3/Memcached/VM-PS, "
           "allreduce vs scatter-reduce vs hierarchical, fp32 vs int8 vs "
           "top-k, + NIC/DCN ring rows", _comm_axis),
    Preset("elastic_axis",
           "Elastic fleets (§13): static vs schedule vs SMLT-adaptive vs "
           "cost-capped scaling on the Fig-11 workload, w(t) in the "
           "scaling timeline", _elastic_axis),
]}


def get_preset(name: str) -> Preset:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: "
                       f"{', '.join(sorted(PRESETS))}") from None
