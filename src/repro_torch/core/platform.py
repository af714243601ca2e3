"""The ``Platform`` protocol and its composable configuration specs.

This module formalizes the engine-hook interface that
:mod:`repro_torch.core.runtimes` used to implement purely by convention, and
splits the monolithic runtime dataclasses into three orthogonal, reusable
pieces (DESIGN.md §9):

- :class:`FleetSpec`   -- how many workers and what each one is (per-worker
  Lambda memory OR per-worker instance type, straggler factor, backup
  invocations).  The SAME FleetSpec composes with any platform: only the
  fields the platform understands are consulted.
- :class:`FailureSpec` -- the failure scenario (Poisson preemption rate,
  deterministically injected kills, spot pricing + discount).
- :class:`CommSpec`    -- how updates move (storage channel, reduce pattern,
  checkpoint channel).

:class:`BasePlatform` implements every spec-derivable engine hook once;
concrete platforms (``FaaSRuntime``, ``IaaSRuntime``) add only the genuinely
platform-specific ones (startup/load timings, comm backend construction,
pricing).  :class:`Platform` is the runtime-checkable protocol the engine
programs against -- any object satisfying it simulates through
:func:`repro_torch.core.engine.simulate`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Protocol, runtime_checkable

import numpy as np

from repro_torch.core import cost as pricing
from repro_torch.core.ckpt import CheckpointSpec, ckpt_transport_constants
from repro_torch.core.engine import (
    CommBackend, FailureProcess, InjectedPreemptions, PoissonPreemptions,
    RunResult, StragglerProcess, simulate,
)


def per_worker(value, w: int) -> np.ndarray:
    """Broadcast a scalar or validate a per-worker sequence of length w."""
    if np.isscalar(value) or isinstance(value, str):
        return np.asarray([value] * w)
    arr = np.asarray(value)
    if len(arr) != w:
        raise ValueError(f"per-worker config has {len(arr)} entries, "
                         f"expected {w}")
    return arr


def _freeze(obj, name: str, value):
    object.__setattr__(obj, name, value)


# ------------------------------------------------------------------ specs ----

@dataclass(frozen=True)
class FleetSpec:
    """Worker fleet shape, independent of the platform that runs it.

    ``lambda_gb`` is consulted by FaaS platforms (scalar or per-worker GB,
    paper §5 heterogeneity), ``instance``/``gpu`` by IaaS platforms; the
    straggler knobs apply everywhere.  Per-worker sequences must have
    exactly ``workers`` entries (validated lazily, when the fleet is used).

    ``min_workers``/``max_workers`` bound what an elastic scaling policy
    (DESIGN.md §13) may resize the fleet to; they are validated and kept
    (a spec hashes the same in both packages) but inert here, where the
    only scaling is ``"static"``.
    """
    workers: int = 10
    lambda_gb: Any = 3.0                 # FaaS: scalar GB or per-worker tuple
    instance: Any = "t2.medium"          # IaaS: scalar type or per-worker tuple
    gpu: bool = False                    # IaaS: GPU instances (NN models only)
    straggler: float = 1.0               # slowdown of one injected straggler
    backup_invocations: bool = False     # straggler mitigation (FaaS)
    min_workers: int | None = None       # elastic floor (None = 1)
    max_workers: int | None = None       # elastic ceiling (None = MAX_FLEET)

    def __post_init__(self):
        if isinstance(self.lambda_gb, list):
            _freeze(self, "lambda_gb", tuple(self.lambda_gb))
        if isinstance(self.instance, list):
            _freeze(self, "instance", tuple(self.instance))
        lo = 1 if self.min_workers is None else int(self.min_workers)
        hi = self.max_workers
        if lo < 1:
            raise ValueError(f"min_workers must be >= 1, got {lo}")
        if hi is not None and int(hi) < lo:
            raise ValueError(f"max_workers ({hi}) < min_workers ({lo})")
        if not (lo <= self.workers <= (int(hi) if hi is not None
                                       else self.workers)):
            raise ValueError(
                f"workers={self.workers} outside the elastic bounds "
                f"[{lo}, {hi}]")

    def gb_array(self) -> np.ndarray:
        return per_worker(self.lambda_gb, self.workers).astype(float)

    def instances(self) -> list[str]:
        return [str(i) for i in per_worker(self.instance, self.workers)]

    def speeds(self, seed: int) -> np.ndarray:
        return StragglerProcess(
            factor=self.straggler,
            cap_at_median=self.backup_invocations).speeds(self.workers, seed)


@dataclass(frozen=True)
class FailureSpec:
    """Failure scenario: stochastic rate, scripted kills, spot pricing.

    ``process()`` builds the engine's :class:`FailureProcess`: injected
    kills always win (they are the reproducible way to script a scenario);
    the Poisson rate applies only when ``armed`` (FaaS arms it whenever
    the rate is positive; IaaS arms it only for spot fleets, matching the
    legacy ``preempt_rate``-only-if-``spot`` semantics).

    ``rate=None`` means "the platform's default": 0 for on-demand/FaaS
    fleets, 2 preemptions per worker-hour for spot IaaS fleets -- so a
    bare ``FailureSpec(spot=True)`` buys the discount WITH the
    preemption risk, exactly like the legacy ``IaaSRuntime(spot=True)``.

    ``trace`` replays a RECORDED preemption trace instead (a bundled
    fixture name or a file path, :mod:`repro_torch.core.failures`) -- failure
    timing from data, not Poisson only.  Precedence: ``inject`` (an
    explicit script always wins) > ``trace`` > Poisson rate.
    """
    rate: float | None = None            # preemptions per worker-hour
    inject: tuple = ()                   # ((worker, sim_time), ...) kills
    spot: bool = False                   # preemptible fleet, discounted $
    spot_discount: float = pricing.SPOT_DISCOUNT   # spot $ / on-demand $
    trace: str = ""                      # recorded trace: fixture name|path

    def __post_init__(self):
        _freeze(self, "inject",
                tuple((int(w), float(t)) for w, t in self.inject))

    def resolved_rate(self, default: float = 0.0) -> float:
        return default if self.rate is None else self.rate

    def process(self, workers: int, seed: int, armed: bool = True,
                default_rate: float = 0.0) -> FailureProcess:
        if self.inject:
            return InjectedPreemptions(self.inject)
        if self.trace:
            from repro_torch.core.failures import TracePreemptions
            return TracePreemptions.from_spec(self.trace, workers)
        rate = self.resolved_rate(default_rate)
        if armed and rate > 0.0:
            return PoissonPreemptions(rate, workers, seed)
        return FailureProcess()


@dataclass(frozen=True)
class CommSpec:
    """How the fleet communicates: one point of the Transport x Collective
    x Codec space (:mod:`repro_torch.core.comm`, DESIGN.md §12).

    The seed-era fields keep their platform-interpreted meaning --
    ``channel``/``pattern`` are what FaaS runs (Tables 1-3), IaaS/pod
    fleets default to ring over their NIC/DCN, ``ckpt_channel`` is where
    spot/lifetime checkpoints live.  The explicit ``transport`` /
    ``collective`` overrides (``None`` = platform default) and the
    ``codec`` pin the full stack on ANY platform; the
    ``"transport/collective/codec"`` string grammar
    (:meth:`CommSpec.parse`, accepted anywhere a CommSpec is --
    ``ExperimentSpec(comm="s3/scatter_reduce/int8")``) fills them in one
    shot.
    """
    channel: str = "s3"                  # s3|memcached[_large]|redis|
                                         #   dynamodb|vmps (FaaS transport)
    pattern: str = "allreduce"           # allreduce|scatter_reduce|
                                         #   hierarchical[:<g>] (store reduce)
    ckpt_channel: str = "s3"
    codec: str = "fp32"                  # fp32|int8|topk[:<fraction>]
    transport: str | None = None         # explicit transport (wins over
                                         #   channel; nic/dcn allowed)
    collective: str | None = None        # explicit collective (wins over
                                         #   pattern; ring/pushpull allowed)

    def __post_init__(self):
        from repro_torch.core import comm as C
        # structural name validation, eagerly (a sweep should reject at
        # expansion, not crash mid-batch inside make_comm)
        for name in (self.channel, self.ckpt_channel):
            C.transport_constants(name)          # raises on unknown
        C.make_collective(self.pattern)
        C.make_codec(self.codec)
        if self.transport is not None:
            C.transport_constants(self.transport)
        if self.collective is not None:
            C.make_collective(self.collective)

    # ---- the string grammar -------------------------------------------------
    @classmethod
    def parse(cls, text: str, *, ckpt_channel: str = "s3") -> "CommSpec":
        """``"<transport>[/<collective>[/<codec>]]"`` -> CommSpec (see
        :mod:`repro_torch.core.comm.grammar` for defaults and examples).  The
        legacy ``channel``/``pattern`` views mirror the parsed parts where
        they are expressible."""
        from repro_torch.core import comm as C
        transport, collective, codec = C.parse_stack(text)
        kw: dict = dict(transport=transport, collective=collective,
                        codec=codec, ckpt_channel=ckpt_channel)
        if transport not in C.NETWORK_TRANSPORTS:
            kw["channel"] = transport
        if collective is not None and (
                collective.partition(":")[0] in C.STORE_COLLECTIVES):
            kw["pattern"] = collective
        return cls(**kw)

    def resolved(self, platform: str = "faas") -> tuple[str, str, str]:
        """The concrete ``(transport, collective, codec)`` this spec means
        on ``platform`` -- explicit overrides win; otherwise FaaS reduces
        ``pattern`` over ``channel``, IaaS rings over NICs, pods over the
        DCN, and the VM-PS transport implies push/pull."""
        from repro_torch.core import comm as C
        t = self.transport
        if t is None:
            t = {"iaas": "nic", "pod": "dcn"}.get(platform, self.channel)
        c = self.collective
        if c is None:
            c = (self.pattern if t not in ("vmps", "nic", "dcn")
                 else C.default_collective(t))
        return t, c, self.codec

    def stack_name(self, platform: str = "faas") -> str:
        """Canonical ``transport/collective/codec`` string on ``platform``."""
        from repro_torch.core.comm import stack_name
        return stack_name(*self.resolved(platform))

    def validate(self, platform: str | None = None, model_bytes=None,
                 workers: int | None = None) -> None:
        """Raise on stacks that cannot run (pairing/platform rules) or
        cannot fit (transport per-item limits vs the codec'd update size:
        DynamoDB's 400 KB limit becomes an eager
        :class:`~repro_torch.core.comm.ChannelItemTooLarge`, reproducing Table
        1's "N/A" cells at spec time).  ``model_bytes`` is the fp32
        update-vector size; pass a callable for lazy estimation."""
        from repro_torch.core.comm import validate_stack
        validate_stack(*self.resolved(platform or "faas"),
                       platform=platform, model_bytes=model_bytes,
                       workers=workers)


def check_static_scaling(scaling) -> None:
    """The port runs fixed fleets only: elastic scaling policies
    (DESIGN.md §13, ``core/elastic/``) are ROADMAP.md queue A4."""
    if scaling != "static":
        raise NotImplementedError(
            f"scaling={scaling!r}: the PyTorch port runs scaling='static' "
            f"only; elastic fleets are ROADMAP.md queue A4")


def check_sync_codec(proto, codec: str) -> None:
    """Codecs encode the *update vectors of collective reduces* (BSP and
    the LocalSGD/DiLoCo sync boundaries); the ASP/SSP event loop exchanges
    the raw fp32 global model through the kvstore instead, so a lossy
    codec there would be a silent no-op -- reject it rather than return
    fp32 results labeled int8/topk."""
    from repro_torch.core.comm import make_codec
    from repro_torch.core.sync import SSP
    if isinstance(proto, SSP) and not make_codec(codec).is_identity:
        raise ValueError(
            f"comm codec {codec!r} has no effect under sync="
            f"{proto.name!r}: codecs apply to collective reduces "
            f"(bsp / local:<H> / diloco:<H>); the ASP/SSP global-model "
            f"store moves raw fp32 -- drop the codec or switch sync")


# --------------------------------------------------------------- protocol ----

@runtime_checkable
class Platform(Protocol):
    """The engine-hook interface (DESIGN.md §5).  Anything implementing it
    can be simulated: the engine never imports a concrete platform.

    Implementations must also expose ``workers: int`` and ``seed: int``.
    """

    def system_name(self) -> str: ...

    def validate(self, mbytes: int) -> str:
        """Empty string if a model of ``mbytes`` fits; else the error."""
        ...

    def make_comm(self) -> CommBackend: ...

    def make_ckpt_store(self, comm: CommBackend) -> Any:
        """Metered store holding lifetime/preemption checkpoints."""
        ...

    def startup_time(self, comm: CommBackend) -> float: ...

    def load_time(self, part_bytes: int, data_local: bool = False) -> float: ...

    def restart_time(self, model_bytes: int = 0) -> float:
        """Cold-start seconds for one replacement worker.  With
        ``model_bytes > 0`` the platform DERIVES the full restart:
        startup plus the metered restore of the model's actual byte
        size through the checkpoint transport (DESIGN.md §17) -- no
        platform asserts a checkpoint-free restart."""
        ...

    def lifetime_s(self) -> float:
        """Planned worker lease (900 s on Lambda, inf on VMs)."""
        ...

    def lifetime_margin_s(self) -> float: ...

    def failure_process(self) -> FailureProcess: ...

    def worker_flops(self, model=None) -> float:
        """Slowest worker's FLOP/s; ``model`` optional (used by GPU fleets
        to decide whether the model can use the accelerator)."""
        ...

    def worker_flops_array(self, model) -> np.ndarray: ...

    def worker_speeds(self) -> np.ndarray: ...

    def init_breakdown(self) -> dict: ...

    def finalize_cost(self, ctx) -> float: ...


# ------------------------------------------------------------ base class ----

@dataclass
class BasePlatform:
    """Shared, spec-driven half of a :class:`Platform` implementation.

    Concrete platforms are thin: they add startup/load timing tables, the
    comm-backend factory, and pricing.  Everything derivable from the specs
    (fleet speeds, failure processes, the training entry point) lives here
    exactly once.
    """
    fleet: FleetSpec = field(default_factory=FleetSpec)
    failure: FailureSpec = field(default_factory=FailureSpec)
    comm: CommSpec = field(default_factory=CommSpec)
    sync: object = "bsp"                 # bsp|asp|ssp|ssp:<s>|SyncProtocol
    seed: int = 0
    scaling: object = "static"           # only "static" (elastic: queue A4)
    ckpt: object = field(default_factory=CheckpointSpec)
                                         # CheckpointSpec | "s3:every=5:sharded"

    def __post_init__(self):
        if isinstance(self.comm, str):   # "s3/scatter_reduce/int8" grammar
            self.comm = CommSpec.parse(self.comm)
        if self.ckpt is None:
            self.ckpt = CheckpointSpec()
        elif isinstance(self.ckpt, str):  # "s3:every=5:sharded" grammar
            self.ckpt = CheckpointSpec.parse(self.ckpt)

    # ---- user entry point ---------------------------------------------------
    def train(self, model, algo, ds_train, ds_val, *,
              target_loss: float | None = None, max_epochs: int = 10,
              eval_every: int = 1, data_local: bool = False,
              trace: bool = False, device=None) -> RunResult:
        """Simulate one training run with every tensor on ``device``
        (``None`` = the card; raises without CUDA unless ``"cpu"``)."""
        from repro_torch.core.sync import make_sync
        check_static_scaling(self.scaling)
        proto = make_sync(self.sync)
        check_sync_codec(proto, self.comm.codec)
        return simulate(self, proto, model, algo, ds_train, ds_val,
                        target_loss=target_loss, max_epochs=max_epochs,
                        eval_every=eval_every, data_local=data_local,
                        trace=trace, device=device)

    # ---- spec-derived hooks -------------------------------------------------
    @property
    def workers(self) -> int:
        return self.fleet.workers

    def worker_speeds(self) -> np.ndarray:
        return self.fleet.speeds(self.seed)

    def worker_flops(self, model=None) -> float:
        """Slowest worker's FLOP/s (scalar convenience over the array)."""
        return float(np.min(self.worker_flops_array(model)))

    def failure_process(self) -> FailureProcess:
        return self.failure.process(self.workers, self.seed)

    def ckpt_channel_spec(self):
        """The :class:`~repro_torch.core.comm.ChannelSpec` checkpoint bytes move
        over: an explicit ``CheckpointSpec.transport`` wins; otherwise the
        platform's default checkpoint channel (``comm.ckpt_channel`` here;
        FaaS overrides to its resolved comm transport, whose kvstore holds
        the checkpoints by default)."""
        if self.ckpt.transport is not None:
            return ckpt_transport_constants(self.ckpt.transport)
        return ckpt_transport_constants(self.comm.ckpt_channel)

    def validate(self, mbytes: int) -> str:
        return ""

    def lifetime_s(self) -> float:
        return math.inf

    def lifetime_margin_s(self) -> float:
        return 0.0

    def init_breakdown(self) -> dict:
        return {"startup": 0.0, "load": 0.0, "compute": 0.0, "comm": 0.0}

