"""FaaS and IaaS training runtimes (paper §3.3, §5; DESIGN.md §5).

Both runtimes execute the REAL optimization math in PyTorch (identical numerics,
so FaaS and IaaS converge identically for the same algorithm -- the paper's
statistical/system efficiency split) while metering simulated wall-clock and
dollars from the measured constants of Tables 2/6 and the pricing model.

Since the Platform redesign (DESIGN.md §9) the classes here are *thin
builders* over the composable specs of :mod:`repro_torch.core.platform`:
:class:`~repro_torch.core.platform.FleetSpec` (workers, per-worker Lambda memory
or instance types, stragglers), :class:`~repro_torch.core.platform.FailureSpec`
(Poisson rate / injected kills / spot pricing) and
:class:`~repro_torch.core.platform.CommSpec` (channel, reduce pattern).  The
legacy flat keyword constructors (``FaaSRuntime(workers=10, channel="s3")``)
keep working and simply populate the specs; spec objects can also be passed
directly (``FaaSRuntime(fleet=FleetSpec(...), failure=FailureSpec(...))``)
so a hetero/spot/straggler scenario composes with either platform.

Each class implements the platform-specific half of the
:class:`~repro_torch.core.platform.Platform` protocol; the spec-derivable half
(training entry point, fleet speeds, failure processes) lives once in
:class:`~repro_torch.core.platform.BasePlatform`, and the training loops
themselves -- one BSP round loop and one ASP/SSP event loop -- live in
:mod:`repro_torch.core.sync`, shared by every platform.

FaaS specifics (LambdaML):
- starter->worker hierarchical invocation (startup t^F(w)),
- 15-minute worker lifetime: checkpoint to the channel + re-invocation,
- BSP via the two-phase merge/update pattern, ASP/SSP via SIREN-style global
  model on the channel (event-driven, stale reads emerge naturally),
- straggler injection + optional backup-invocation mitigation,
- pure-FaaS channels (S3/Memcached/Redis/DynamoDB) or hybrid VM-PS,
- heterogeneous fleets: per-worker Lambda memory sizes (``lambda_gb`` tuple).

IaaS specifics (distributed-PyTorch-style VM cluster):
- ring AllReduce over VM NICs; worker 0 hosts the ASP/SSP model store,
- spot fleets (``spot=True``): preemption events (Poisson or injected) +
  restart-from-checkpoint via S3, discounted hourly pricing,
- heterogeneous fleets: per-worker instance types (``instance`` tuple);
  the collective runs at the slowest NIC.

Pod specifics (accelerator pods, DESIGN.md §11): one engine worker = one
SIMULATED pod slice; compute from the simulated chip's peak discounted by
an MFU; intra-pod collectives free (inside the MFU), cross-pod DCN as the
metered comm substrate -- see :class:`PodPlatform`.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import cost as pricing
from repro_torch.core.channels import StorageChannel, VMNetwork, VMParameterServer
from repro_torch.core.ckpt import ckpt_transport_constants, make_ckpt_transport
from repro_torch.core.comm.transports import (
    CHANNEL_SPECS, DCN_BANDWIDTH, DCN_LATENCY, NIC_BANDWIDTH, NIC_LATENCY,
)
from repro_torch.core.engine import (  # noqa: F401  (RunResult re-exported)
    ChannelComm, FailureProcess, InjectedPreemptions, MPIComm, PoissonPreemptions,
    PSComm, RunResult, StragglerProcess, simulate,
)
from repro_torch.core.platform import (  # noqa: F401  (specs re-exported)
    BasePlatform, CommSpec, FailureSpec, FleetSpec, Platform, per_worker,
)

# Table 6 startup constants (seconds) -- see interp_startup for how worker
# counts between and beyond the measured points are handled
_T_FAAS = {1: 1.2, 10: 1.2, 50: 11.0, 100: 18.0, 200: 35.0, 300: 50.0}
_T_IAAS = {1: 100.0, 10: 132.0, 50: 160.0, 100: 292.0, 200: 606.0}
# data-plane S3 constants: the same Table 6 row the "s3" comm transport is
# built from (one source of truth in repro_torch.core.comm.transports)
B_S3 = CHANNEL_SPECS["s3"].bandwidth
L_S3 = CHANNEL_SPECS["s3"].latency
# the t2.medium row doubles as the comm package's "nic" transport default
B_NET = {"t2.medium": NIC_BANDWIDTH, "c5.large": 225e6, "c5.xlarge": 600e6,
         # t2.2xlarge's NIC coincides with the t2.medium row's value but is
         # its own Table 6 measurement, not a copy of NIC_BANDWIDTH:
         "t2.2xlarge": 120e6,  # lint: ignore[C001]
         "c5.4xlarge": 1250e6, "m5a.12xlarge": 1250e6,
         "g3s.xlarge": 1250e6, "g4dn.xlarge": 1250e6}
L_NET = {"t2.medium": NIC_LATENCY, "c5.large": 1.5e-4}

LIFETIME = 900.0          # Lambda max duration (s)
LIFETIME_MARGIN = 20.0


def interp_startup(table: dict, w: int) -> float:
    """Startup seconds for a ``w``-worker fleet from a Table 6 column.

    Piecewise-linear interpolation between measured worker counts; below
    the smallest measured count the smallest entry is returned unchanged.
    ABOVE the largest measured count the curve is extrapolated *linearly
    through the origin* from the last point (``t = table[k_max] * w /
    k_max``), i.e. startup is assumed to keep scaling proportionally with
    fleet size at the last measured per-worker rate -- a deliberately
    pessimistic tail for what-if studies beyond the paper's 200-300 worker
    measurements.
    """
    ks = sorted(table)
    if w <= ks[0]:
        return table[ks[0]]
    for a, b in zip(ks, ks[1:]):
        if w <= b:
            f = (w - a) / (b - a)
            return table[a] + f * (table[b] - table[a])
    return table[ks[-1]] * w / ks[-1]


class FaaSRuntime(BasePlatform):
    """LambdaML platform: thin builder over Fleet/Failure/Comm specs.

    Accepts either the legacy flat keywords (``workers=``, ``channel=``,
    ``lambda_gb=``, ``preempt_rate=``, ...) or explicit spec objects
    (``fleet=``, ``failure=``, ``comm=``); a spec object wins over the flat
    keywords it covers.
    """

    def __init__(self, workers: int = 10, channel: str = "s3",
                 pattern: str = "allreduce", sync: object = "bsp",
                 lambda_gb: object = 3.0, straggler: float = 1.0,
                 backup_invocations: bool = False, lifetime: float = LIFETIME,
                 seed: int = 0, preempt_rate: float = 0.0,
                 preempt_at: tuple = (), scaling: object = "static", *,
                 fleet: FleetSpec | None = None,
                 failure: FailureSpec | None = None,
                 comm: CommSpec | None = None,
                 ckpt: object = None):
        super().__init__(
            fleet=fleet if fleet is not None else FleetSpec(
                workers=workers, lambda_gb=lambda_gb, straggler=straggler,
                backup_invocations=backup_invocations),
            failure=failure if failure is not None else FailureSpec(
                rate=preempt_rate, inject=tuple(preempt_at)),
            comm=comm if comm is not None else CommSpec(
                channel=channel, pattern=pattern),
            sync=sync, seed=seed, scaling=scaling, ckpt=ckpt)
        self.lifetime = lifetime

    # ---- legacy flat attributes (read-only views over the specs) ------------
    @property
    def channel(self) -> str:
        return self.comm.channel

    @property
    def pattern(self) -> str:
        return self.comm.pattern

    @property
    def lambda_gb(self):
        return self.fleet.lambda_gb

    @property
    def straggler(self) -> float:
        return self.fleet.straggler

    @property
    def backup_invocations(self) -> bool:
        return self.fleet.backup_invocations

    @property
    def preempt_rate(self) -> float:
        return self.failure.resolved_rate()

    @property
    def preempt_at(self) -> tuple:
        return self.failure.inject

    # ---- fleet shape --------------------------------------------------------
    def worker_flops_array(self, model) -> np.ndarray:
        gb = self.fleet.gb_array()
        return np.where(gb >= 3.0, pricing.LAMBDA_3GB_FLOPS,
                        pricing.LAMBDA_1GB_FLOPS)

    # ---- engine hooks -------------------------------------------------------
    def system_name(self) -> str:
        return "faas"

    def validate(self, mbytes: int) -> str:
        """Memory-headroom check: the model (plus the runtime's working
        copies -- gradients, the merge buffer, serialization) must fit in
        one third of the *smallest* Lambda in the fleet.  GPU fleets are
        rejected outright: AWS Lambda has no GPU offering, so ``gpu=True``
        can only mean a FleetSpec written for IaaS was reused unchanged."""
        if self.fleet.gpu:
            return ("FleetSpec.gpu=True is meaningless on FaaS: AWS Lambda "
                    "has no GPUs (the paper's GPU-FaaS what-if lives in the "
                    "analytical model, core/analytical.py Q2).  Drop gpu "
                    "from the fleet or use platform='iaas'/'pod'")
        gb_min = float(np.min(self.fleet.gb_array()))
        headroom_bytes = gb_min * 1e9 / 3.0
        if mbytes > headroom_bytes:
            return (f"model ({mbytes / 1e6:.1f} MB) exceeds 1/3 of the "
                    f"smallest Lambda's memory ({gb_min:.1f} GB)")
        try:
            # the comm stack's pairing + per-item rules (DynamoDB 400 KB ->
            # Table 1 "N/A") fail here, before any simulated second elapses
            self.comm.validate(platform="faas", model_bytes=mbytes,
                               workers=self.workers)
        except ValueError as e:
            return str(e)
        return ""

    def make_comm(self):
        from repro_torch.core.comm import build_comm_stack
        return build_comm_stack(*self.comm.resolved("faas"))

    def make_ckpt_store(self, comm):
        if self.ckpt.transport is not None:   # dedicated checkpoint channel
            return make_ckpt_transport(self.ckpt.transport)
        return comm.kvstore()     # the storage channel (PSComm: its S3 side)

    def ckpt_channel_spec(self):
        # the default FaaS checkpoint home IS the comm kvstore, so the
        # derived restart reads the resolved comm transport's constants
        if self.ckpt.transport is not None:
            return ckpt_transport_constants(self.ckpt.transport)
        return ckpt_transport_constants(self.comm.resolved("faas")[0])

    def startup_time(self, comm) -> float:
        return max(interp_startup(_T_FAAS, self.workers), comm.startup())

    def load_time(self, part_bytes: int, data_local: bool = False) -> float:
        return L_S3 + part_bytes / B_S3

    def restart_time(self, model_bytes: int = 0) -> float:
        dt = interp_startup(_T_FAAS, 1)
        if model_bytes > 0:       # derived: startup + metered restore
            dt += self.ckpt.restore_seconds(
                model_bytes, self.ckpt_channel_spec(), self.workers)
        return dt

    def lifetime_s(self) -> float:
        return self.lifetime

    def lifetime_margin_s(self) -> float:
        return LIFETIME_MARGIN

    def init_breakdown(self) -> dict:
        return {"startup": 0.0, "load": 0.0, "compute": 0.0, "comm": 0.0,
                "checkpoint": 0.0}

    def finalize_cost(self, ctx) -> float:
        # Lambda bills execution time only: each live worker's clock minus
        # when it was (re-)invoked into the fleet (joined_at == 0 for the
        # whole initial fleet, so fixed fleets bill exactly as before);
        # retired workers' usage was folded into retired_cost on exit
        gb_s = float(np.dot(self.fleet.gb_array(),
                            ctx.clock - ctx.joined_at))
        sim_time = float(np.max(ctx.clock))
        # a DEDICATED checkpoint channel bills its service/op prices on
        # top; the default store is the comm kvstore, already billed above
        ckpt_usd = (ctx.ckpt_store.service_cost(sim_time)
                    if self.ckpt.transport is not None else 0.0)
        usd_gb_s = gb_s * pricing.LAMBDA_GB_S
        usd_req = ctx.invocations * pricing.LAMBDA_REQUEST
        usd_comm = ctx.comm.service_cost(sim_time)
        if ctx.rec is not None:
            # invariant 2 ledger (DESIGN.md §18): each additive term, in
            # the summation order, so the sequential ledger sum is bitwise
            # the return value; reset because mid-run telemetry snapshots
            # call finalize_cost too and only the last call's ledger counts
            ctx.rec.cost_reset()
            ctx.rec.cost("lambda_gb_s", usd_gb_s)
            ctx.rec.cost("requests", usd_req)
            ctx.rec.cost("comm_service", usd_comm)
            ctx.rec.cost("retired", ctx.retired_cost)
            ctx.rec.cost("ckpt_service", ckpt_usd)
        return usd_gb_s + usd_req + usd_comm + ctx.retired_cost + ckpt_usd


class IaaSRuntime(BasePlatform):
    """Distributed-PyTorch-style VM cluster: thin builder over the specs.

    Accepts the legacy flat keywords (``workers=``, ``instance=``,
    ``spot=``, ``preempt_rate=``, ...) or explicit spec objects; a spec
    object wins over the flat keywords it covers.  The Poisson preemption
    rate (default 2/worker-hour) only arms on spot fleets; injected kills
    always apply.
    """

    def __init__(self, workers: int = 10, instance: object = "t2.medium",
                 gpu: bool = False, straggler: float = 1.0, seed: int = 0,
                 sync: object = "bsp", spot: bool = False,
                 preempt_rate: float = 2.0, preempt_at: tuple = (),
                 ckpt_channel: str = "s3", scaling: object = "static", *,
                 fleet: FleetSpec | None = None,
                 failure: FailureSpec | None = None,
                 comm: CommSpec | None = None,
                 ckpt: object = None):
        super().__init__(
            fleet=fleet if fleet is not None else FleetSpec(
                workers=workers, instance=instance, gpu=gpu,
                straggler=straggler),
            failure=failure if failure is not None else FailureSpec(
                rate=preempt_rate, inject=tuple(preempt_at), spot=spot),
            comm=comm if comm is not None else CommSpec(
                ckpt_channel=ckpt_channel),
            sync=sync, seed=seed, scaling=scaling, ckpt=ckpt)

    # ---- legacy flat attributes (read-only views over the specs) ------------
    @property
    def instance(self):
        return self.fleet.instance

    @property
    def gpu(self) -> bool:
        return self.fleet.gpu

    @property
    def straggler(self) -> float:
        return self.fleet.straggler

    @property
    def spot(self) -> bool:
        return self.failure.spot

    @property
    def preempt_rate(self) -> float:
        return self.failure.resolved_rate(self.SPOT_DEFAULT_RATE)

    @property
    def preempt_at(self) -> tuple:
        return self.failure.inject

    @property
    def ckpt_channel(self) -> str:
        return self.comm.ckpt_channel

    # ---- fleet shape --------------------------------------------------------
    def worker_flops_array(self, model) -> np.ndarray:
        # With no model to inspect, a GPU fleet reports GPU FLOP/s (the
        # capability estimate); with a model, convex workloads fall back to
        # CPU speed -- the paper's NN-only GPU rule.
        if self.fleet.gpu and (model is None or not model.convex):
            return np.asarray([pricing.VM_GPU_FLOPS.get(
                                   i, pricing.VM_GPU_FLOPS_DEFAULT)
                               for i in self.fleet.instances()])
        return np.full(self.workers, pricing.VM_CPU_FLOPS)

    # ---- engine hooks -------------------------------------------------------
    def system_name(self) -> str:
        return ("iaas" + ("-gpu" if self.fleet.gpu else "")
                + ("-spot" if self.failure.spot else ""))

    def _net(self) -> VMNetwork:
        insts = self.fleet.instances()
        bn = min(B_NET.get(i, NIC_BANDWIDTH) for i in insts)  # slowest NIC
        ln = max(L_NET.get(i, 5e-4) for i in insts)
        return VMNetwork(bn, ln)

    def make_comm(self):
        from repro_torch.core.comm import build_comm_stack
        return build_comm_stack(*self.comm.resolved("iaas"), nic=self._net())

    def make_ckpt_store(self, comm):
        if self.ckpt.transport is not None:   # dedicated checkpoint channel
            return make_ckpt_transport(self.ckpt.transport)
        return StorageChannel(self.comm.ckpt_channel)

    def startup_time(self, comm) -> float:
        # NICs add nothing; a pinned storage/PS stack waits for its service
        # to provision, exactly as on FaaS
        return max(interp_startup(_T_IAAS, self.workers), comm.startup())

    def load_time(self, part_bytes: int, data_local: bool = False) -> float:
        if data_local:
            return part_bytes / min(B_NET.get(i, NIC_BANDWIDTH)
                                    for i in self.fleet.instances())
        return part_bytes / B_S3

    def restart_time(self, model_bytes: int = 0) -> float:
        dt = interp_startup(_T_IAAS, 1)
        if model_bytes > 0:       # derived: startup + metered restore
            dt += self.ckpt.restore_seconds(
                model_bytes, self.ckpt_channel_spec(), self.workers)
        return dt

    #: default spot-market preemption rate (per worker-hour) when the
    #: FailureSpec leaves ``rate=None``
    SPOT_DEFAULT_RATE = 2.0

    def failure_process(self) -> FailureProcess:
        # injected kills always apply; the Poisson rate (spot-market
        # default when unset) only arms on spot fleets
        return self.failure.process(self.workers, self.seed,
                                    armed=self.failure.spot,
                                    default_rate=self.SPOT_DEFAULT_RATE)

    def _hourly_total(self) -> float:
        """The fleet's (spot-discounted) $/hour -- the ONE derivation the
        bill uses; kept as sum-then-discount so fixed-fleet costs stay
        byte-identical to the pre-elastic expression."""
        hourly = sum(pricing.EC2_HOURLY[i] for i in self.fleet.instances())
        if self.failure.spot:
            hourly *= self.failure.spot_discount
        return hourly

    def _hourly_array(self) -> np.ndarray:
        """Per-worker split of :meth:`_hourly_total` (elastic rebates and
        retirements only -- both are no-ops on fixed fleets)."""
        rates = np.asarray([pricing.EC2_HOURLY[i]
                            for i in self.fleet.instances()])
        if self.failure.spot:
            rates = rates * self.failure.spot_discount
        return rates

    def finalize_cost(self, ctx) -> float:
        sim_time = float(np.max(ctx.clock))
        hourly = self._hourly_total()
        # elastic joiners are only billed from when they were provisioned:
        # subtract the pre-join span (0.0 for fixed fleets, keeping the
        # seed-era expression byte-identical); retired VMs were billed into
        # retired_cost when they left the fleet
        joined_rebate = float(np.dot(self._hourly_array(),
                                     ctx.joined_at)) / 3600.0
        # comm substrate dollars: $0 for the default NIC ring, but a pinned
        # storage/PS stack bills its hourly + per-op prices like on FaaS
        usd_vm = hourly / 3600.0 * sim_time
        usd_ckpt = ctx.ckpt_store.service_cost(sim_time)
        usd_comm = ctx.comm.service_cost(sim_time)
        if ctx.rec is not None:
            # invariant 2 ledger (DESIGN.md §18): the rebate enters as a
            # negative entry -- IEEE a - b == a + (-b), so the sequential
            # ledger sum is bitwise the return value
            ctx.rec.cost_reset()
            ctx.rec.cost("vm_hours", usd_vm)
            ctx.rec.cost("joined_rebate", -joined_rebate)
            ctx.rec.cost("retired", ctx.retired_cost)
            ctx.rec.cost("ckpt_service", usd_ckpt)
            ctx.rec.cost("comm_service", usd_comm)
        return (usd_vm - joined_rebate
                + ctx.retired_cost + usd_ckpt + usd_comm)


# --------------------------------------------------------------- pods -------

#: pod-slice provisioning seconds by slice count (queue + topology bring-up;
#: same interp_startup convention as the Table 6 columns)
_T_POD = {1: 45.0, 4: 75.0, 16: 120.0, 64: 240.0}

#: cross-pod data-center network: per-pod egress bandwidth and latency
#: (the shared repro_torch.core.comm "dcn" transport constants).  Intra-pod ICI
#: is NOT metered here -- collectives inside a pod ride the compute term
#: (they are part of the MFU discount), which is exactly the
#: slow-channel/fast-compute split the paper studies on FaaS.
POD_DCN_BANDWIDTH = DCN_BANDWIDTH  # bytes/s per pod
POD_DCN_LATENCY = DCN_LATENCY      # s per collective phase


class PodPlatform(BasePlatform):
    """Accelerator pods: the third infrastructure (DESIGN.md §11).

    Each engine "worker" is one SIMULATED pod slice of ``chips_per_pod``
    chips.  The engine divides ``rows x workload.flops_per_row`` by this
    platform's FLOP/s hook, ``chips_per_pod * PEAK_FLOPS * mfu``, where
    ``PEAK_FLOPS`` is the simulated chip's constant
    (:data:`repro_torch.core.cost.PEAK_FLOPS`).  ``mfu`` defaults to 0.4;
    ``mfu="measured"`` reads the committed ``BENCH_kernels.json``
    (:mod:`repro_torch.core.calibration`).  These are inputs of the
    simulated fleet, not the speed of the card the port runs on.

    Intra-pod collectives are free (folded into ``mfu``); CROSS-pod traffic
    is the metered substrate: a ring all-reduce over the DCN, reusing the
    IaaS :class:`~repro_torch.core.engine.MPIComm`/``VMNetwork`` machinery with
    DCN constants.  This is the regime where ``sync="local:<H>"`` /
    ``"diloco:<H>"`` pays off -- the pod-mesh mirror of the paper's MA-SGD
    result.

    The composable specs are reused unchanged: ``FleetSpec.workers`` is the
    pod count (stragglers model slow hosts/interference), ``FailureSpec``
    with ``spot=True`` models preemptible capacity at the spot discount,
    ``CommSpec.ckpt_channel`` is where checkpoints live.
    """

    #: constructor knobs an ExperimentSpec may pass via ``platform_args``
    #: (everything else is spec-derived and would collide or be ignored)
    SPEC_TUNABLES = frozenset({"chips_per_pod", "mfu", "dcn_bandwidth",
                               "dcn_latency", "chip_hourly"})

    def __init__(self, pods: int = 4, chips_per_pod: int = 4,
                 mfu: float | str = 0.4, sync: object = "bsp", seed: int = 0,
                 dcn_bandwidth: float = POD_DCN_BANDWIDTH,
                 dcn_latency: float = POD_DCN_LATENCY,
                 chip_hourly: float = pricing.TPU_CHIP_HOURLY,
                 straggler: float = 1.0, preempt_at: tuple = (),
                 scaling: object = "static", *,
                 fleet: FleetSpec | None = None,
                 failure: FailureSpec | None = None,
                 comm: CommSpec | None = None,
                 ckpt: object = None):
        super().__init__(
            fleet=fleet if fleet is not None else FleetSpec(
                workers=pods, straggler=straggler),
            failure=failure if failure is not None else FailureSpec(
                inject=tuple(preempt_at)),
            comm=comm if comm is not None else CommSpec(),
            sync=sync, seed=seed, scaling=scaling, ckpt=ckpt)
        if chips_per_pod < 1:
            raise ValueError(f"chips_per_pod must be >= 1, got {chips_per_pod}")
        from repro_torch.core.calibration import resolve_mfu
        mfu = resolve_mfu(mfu)     # "measured" -> benchmarked fraction
        if not 0.0 < mfu <= 1.0:
            raise ValueError(f"mfu must be in (0, 1], got {mfu}")
        self.chips_per_pod = int(chips_per_pod)
        self.mfu = float(mfu)
        self.dcn_bandwidth = float(dcn_bandwidth)
        self.dcn_latency = float(dcn_latency)
        self.chip_hourly = float(chip_hourly)

    @property
    def pods(self) -> int:
        return self.workers

    # ---- fleet shape --------------------------------------------------------
    def worker_flops_array(self, model) -> np.ndarray:
        return np.full(self.workers,
                       self.chips_per_pod * pricing.PEAK_FLOPS * self.mfu)

    # ---- engine hooks -------------------------------------------------------
    def system_name(self) -> str:
        return "pod" + ("-spot" if self.failure.spot else "")

    def validate(self, mbytes: int) -> str:
        """Pods are accelerator slices already: a ``gpu=True`` fleet can
        only mean an IaaS FleetSpec was reused unchanged, so reject it
        (same policy as FaaS) rather than silently billing TPU hours for a
        requested GPU.  (``instance``/``lambda_gb`` carry non-None defaults
        and cannot be distinguished from intent; they are documented as
        not consulted here.)"""
        if self.fleet.gpu:
            return ("FleetSpec.gpu=True is meaningless on the pod platform "
                    "(a pod IS the accelerator -- size it with "
                    "chips_per_pod/mfu).  GPU fleets are "
                    "platform='iaas' with gpu instance types")
        return ""

    def make_comm(self):
        from repro_torch.core.comm import build_comm_stack
        return build_comm_stack(
            *self.comm.resolved("pod"),
            dcn=VMNetwork(self.dcn_bandwidth, self.dcn_latency, "dcn"))

    def make_ckpt_store(self, comm):
        if self.ckpt.transport is not None:   # dedicated checkpoint channel
            return make_ckpt_transport(self.ckpt.transport)
        return StorageChannel(self.comm.ckpt_channel)

    def startup_time(self, comm) -> float:
        return max(interp_startup(_T_POD, self.workers), comm.startup())

    def load_time(self, part_bytes: int, data_local: bool = False) -> float:
        if data_local:
            return self.dcn_latency + part_bytes / self.dcn_bandwidth
        return L_S3 + part_bytes / B_S3

    def restart_time(self, model_bytes: int = 0) -> float:
        dt = interp_startup(_T_POD, 1)
        if model_bytes > 0:       # derived: startup + metered restore
            dt += self.ckpt.restore_seconds(
                model_bytes, self.ckpt_channel_spec(), self.workers)
        return dt

    SPOT_DEFAULT_RATE = IaaSRuntime.SPOT_DEFAULT_RATE

    def failure_process(self) -> FailureProcess:
        # preemptible (spot) pod capacity behaves like spot VMs: the rate
        # only arms on spot fleets, scripted kills always fire
        return self.failure.process(self.workers, self.seed,
                                    armed=self.failure.spot,
                                    default_rate=self.SPOT_DEFAULT_RATE)

    def _fleet_hourly(self) -> float:
        """The whole mesh's (spot-discounted) $/hour -- the ONE derivation
        the bill uses; kept multiply-then-discount so fixed-fleet costs
        stay byte-identical to the pre-elastic expression."""
        hourly = self.workers * self.chips_per_pod * self.chip_hourly
        if self.failure.spot:
            hourly *= self.failure.spot_discount
        return hourly

    def _pod_hourly(self) -> float:
        """Per-pod share of :meth:`_fleet_hourly` (elastic rebates,
        retirements and joiner provisioning only)."""
        hourly = self.chips_per_pod * self.chip_hourly
        if self.failure.spot:
            hourly *= self.failure.spot_discount
        return hourly

    def finalize_cost(self, ctx) -> float:
        sim_time = float(np.max(ctx.clock))
        hourly = self._fleet_hourly()
        # elastic pod slices bill from when the reshape granted them
        # (joined_at == 0 for fixed fleets -- expression unchanged);
        # released slices were billed into retired_cost at the reshape
        joined_rebate = self._pod_hourly() * float(np.sum(ctx.joined_at)) \
            / 3600.0
        # DCN rings bill $0; pinned storage/PS stacks bill their service
        usd_pod = hourly / 3600.0 * sim_time
        usd_ckpt = ctx.ckpt_store.service_cost(sim_time)
        usd_comm = ctx.comm.service_cost(sim_time)
        if ctx.rec is not None:
            # invariant 2 ledger (DESIGN.md §18), rebate as a negative entry
            ctx.rec.cost_reset()
            ctx.rec.cost("pod_hours", usd_pod)
            ctx.rec.cost("joined_rebate", -joined_rebate)
            ctx.rec.cost("retired", ctx.retired_cost)
            ctx.rec.cost("ckpt_service", usd_ckpt)
            ctx.rec.cost("comm_service", usd_comm)
        return (usd_pod - joined_rebate
                + ctx.retired_cost + usd_ckpt + usd_comm)

