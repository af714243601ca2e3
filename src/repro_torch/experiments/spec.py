"""Declarative experiment specifications (DESIGN.md §10).

An :class:`ExperimentSpec` is a frozen, JSON-round-trippable description of
one point in the paper's design space: platform x fleet x failure scenario x
communication x sync protocol x algorithm x model x dataset x stopping rule.
It is the unit the sweep runner expands, hashes (for the on-disk result
cache), and records next to every result, so any row in any table can be
re-run from its JSON alone:

    spec = ExperimentSpec(platform="faas", sync="ssp:2",
                          fleet=FleetSpec(workers=16, straggler=6.0))
    assert ExperimentSpec.from_json(spec.to_json()) == spec

``build_runtime()`` / ``build_workload()`` turn a spec into the exact same
objects a hand-written ``FaaSRuntime(...).train(...)`` call would construct,
which is what makes ``run_experiment(spec)`` identical to the hand-written
entry points for the same seed.

The spec is the JAX package's, field for field and default for default,
with the same :data:`HASH_SCHEMA`, so one spec hashes the same in both
packages.  The device a spec runs on is NOT a spec field: it is an
argument of :func:`repro_torch.experiments.run_experiment`.  This port
runs the study models with ``scaling="static"``; architecture workloads
(queue A6) and elastic scaling (queue A4) raise ``NotImplementedError``.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field, fields, replace

from repro_torch.core.ckpt import CheckpointSpec
from repro_torch.core.platform import (
    CommSpec, FailureSpec, FleetSpec, check_static_scaling,
)
from repro_torch.core.runtimes import (
    LIFETIME, FaaSRuntime, IaaSRuntime, PodPlatform,
)
from repro_torch.core.sync import sync_name

PLATFORMS = ("faas", "iaas", "pod")

#: salt for :meth:`ExperimentSpec.spec_hash` -- the JAX package's current
#: value, kept equal so both packages key the same spec identically (the
#: salt history lives in the JAX package's ``experiments/spec.py``)
HASH_SCHEMA = "h6"


@dataclass(frozen=True)
class ExperimentSpec:
    """One fully-determined experiment.  Every field is JSON-serializable;
    ``name`` is a human label and does NOT enter the spec hash."""
    name: str = ""
    platform: str = "faas"                 # faas | iaas | pod
    fleet: FleetSpec = field(default_factory=FleetSpec)
    failure: FailureSpec = field(default_factory=FailureSpec)
    comm: CommSpec = field(default_factory=CommSpec)
                                           # also accepts the string grammar
                                           # "transport/collective/codec",
                                           # e.g. "s3/scatter_reduce/int8"
    ckpt: CheckpointSpec = field(default_factory=CheckpointSpec)
                                           # also accepts the string grammar
                                           # "<transport>[:every=<N>][:sharded]",
                                           # e.g. "s3:every=5:sharded" (§17)
    sync: str = "bsp"                      # bsp | asp | ssp:<s>
                                           #   | local:<H>[:c8] | diloco:<H>[:c8]
    scaling: str = "static"                # elastic fleet policy (§13):
                                           # only "static" here (queue A4)
    model: str = "lr"                      # a study stand-in: lr | svm |
                                           # kmeans | mobilenet | resnet50
    model_args: dict = field(default_factory=dict)
    algorithm: str = "ga_sgd"              # make_algorithm name
    algo_args: dict = field(default_factory=dict)
    dataset: str = "higgs"                 # make_dataset name
    rows: int = 30_000
    data_seed: int = 0
    val_frac: float = 0.1
    seed: int = 0                          # params init + stragglers + failures
    max_epochs: int = 3
    eval_every: int = 1
    target_loss: float | None = None
    data_local: bool = False               # IaaS/pod: peer-to-peer data load
    trace: bool = False                    # record per-event spans (§18);
                                           # metered results are byte-equal
                                           # either way (property-tested)
    lifetime: float | None = None          # FaaS: worker lease override (s)
    platform_args: dict = field(default_factory=dict)
                                           # pod: chips_per_pod, mfu,
                                           # dcn_bandwidth, chip_hourly, ...

    def __post_init__(self):
        if self.platform not in PLATFORMS:
            raise ValueError(f"platform must be one of {PLATFORMS}, "
                             f"got {self.platform!r}")
        if self.platform_args and self.platform != "pod":
            raise ValueError(
                f"platform_args only apply to platform='pod' "
                f"(got {sorted(self.platform_args)} on {self.platform!r}); "
                f"faas/iaas knobs live in fleet/failure/comm/lifetime")
        bad = set(self.platform_args) - PodPlatform.SPEC_TUNABLES
        if bad:
            raise KeyError(
                f"unknown platform_args {sorted(bad)}; tunable via spec: "
                f"{sorted(PodPlatform.SPEC_TUNABLES)} (worker/pod count and "
                f"failure scenario come from fleet/failure)")
        # fail the workload/dataset pairing eagerly (a sweep should reject
        # at expansion, not crash mid-batch inside build_workload)
        from repro_torch.core.workloads import (
            TOKEN_DATASET, check_study_workload,
        )
        check_study_workload(self.model)
        if self.dataset == TOKEN_DATASET:
            raise ValueError(
                f"dataset={TOKEN_DATASET!r} is the architecture workloads' "
                f"corpus; model {self.model!r} is a study stand-in -- pick "
                f"one of the feature datasets (higgs, rcv1, ...)")
        object.__setattr__(self, "sync", sync_name(self.sync))
        if isinstance(self.comm, str):     # "transport/collective/codec"
            object.__setattr__(self, "comm", CommSpec.parse(self.comm))
        if isinstance(self.ckpt, str) or self.ckpt is None:
            object.__setattr__(self, "ckpt", CheckpointSpec.parse(self.ckpt))
        for f in ("fleet", "failure", "comm", "ckpt"):
            v = getattr(self, f)
            if isinstance(v, dict):
                cls = {"fleet": FleetSpec, "failure": FailureSpec,
                       "comm": CommSpec, "ckpt": CheckpointSpec}[f]
                object.__setattr__(self, f, cls(**v))
        # the comm stack fails HERE, not mid-simulation: pairing/platform
        # rules and per-item limits (DynamoDB 400 KB x the estimated model
        # update size -> ChannelItemTooLarge, Table 1's "N/A" cells).  The
        # size estimate is lazy -- only transports with item limits pay it.
        from repro_torch.core.workloads import estimate_update_bytes
        self.comm.validate(
            platform=self.platform,
            model_bytes=lambda: estimate_update_bytes(
                self.model, self.dataset, self.model_args),
            workers=self.fleet.workers)
        # checkpoint feasibility fails here too: every shard must fit the
        # ckpt transport's per-item limit (DynamoDB 400 KB), same lazy
        # size estimate as the comm check (§17)
        self.ckpt.validate(
            model_bytes=lambda: estimate_update_bytes(
                self.model, self.dataset, self.model_args),
            workers=self.fleet.workers)
        # a preemption trace must exist and parse before a sweep starts
        if self.failure.trace:
            from repro_torch.core.failures import load_trace, resolve_trace
            load_trace(resolve_trace(self.failure.trace))
        # lossy codecs only act on collective reduces; reject the ASP/SSP
        # pairing eagerly (it would silently run fp32)
        from repro_torch.core.platform import check_sync_codec
        from repro_torch.core.sync import make_sync
        check_sync_codec(make_sync(self.sync), self.comm.codec)
        if not isinstance(self.scaling, str):
            raise ValueError(
                f"ExperimentSpec.scaling must be a policy string (specs are "
                f"JSON-round-trippable), got {type(self.scaling)}")
        check_static_scaling(self.scaling)

    # ---- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return asdict(self)

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        d = dict(d)
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise KeyError(f"unknown ExperimentSpec fields {sorted(unknown)}; "
                           f"valid fields: {sorted(known)}")
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    def spec_hash(self) -> str:
        """Stable content hash (cache key).  ``name`` is excluded (renaming
        a trial must still hit the cache), and so is every field still at
        its default value -- so ADDING a spec field in a future schema
        revision does not orphan the whole on-disk record cache (only specs
        that actually use the new field hash differently).  The flip side:
        because defaults are elided, CHANGING a field's default changes
        what an elided field means -- whoever changes a default MUST bump
        ``HASH_SCHEMA`` (and may re-key ``experiments/runs/``), otherwise
        old records alias the new semantics."""
        d = self.to_dict()
        d.pop("name")
        defaults = _spec_defaults()
        canon = {k: v for k, v in d.items() if v != defaults[k]}
        payload = HASH_SCHEMA + json.dumps(canon, sort_keys=True,
                                           separators=(",", ":"))
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def with_(self, **overrides) -> "ExperimentSpec":
        """`replace` that also reaches into nested specs via dotted keys:
        ``spec.with_(**{"fleet.workers": 8, "sync": "asp"})``."""
        out = self
        for key, value in overrides.items():
            out = _apply_override(out, key, value)
        return out

    # ---- builders -----------------------------------------------------------
    def build_runtime(self):
        """The platform object a hand-written call would construct."""
        if self.platform == "faas":
            return FaaSRuntime(
                fleet=self.fleet, failure=self.failure, comm=self.comm,
                sync=self.sync, seed=self.seed, scaling=self.scaling,
                ckpt=self.ckpt,
                lifetime=LIFETIME if self.lifetime is None else self.lifetime)
        if self.platform == "pod":
            return PodPlatform(fleet=self.fleet, failure=self.failure,
                               comm=self.comm, sync=self.sync,
                               seed=self.seed, scaling=self.scaling,
                               ckpt=self.ckpt, **self.platform_args)
        return IaaSRuntime(fleet=self.fleet, failure=self.failure,
                           comm=self.comm, sync=self.sync, seed=self.seed,
                           scaling=self.scaling, ckpt=self.ckpt)

    def build_workload(self):
        """(workload, algo, ds_train, ds_val) via
        :func:`repro_torch.core.workloads.make_workload` (the JAX package's
        construction order, byte-identical datasets).  Deterministic in
        (dataset, rows, data_seed, val_frac, model, algorithm)."""
        from repro_torch.core.algorithms import make_algorithm
        from repro_torch.core.workloads import make_workload
        wl, tr, va = make_workload(
            self.model, dataset=self.dataset, rows=self.rows,
            data_seed=self.data_seed, val_frac=self.val_frac,
            **self.model_args)
        algo = make_algorithm(self.algorithm, **self.algo_args)
        return wl, algo, tr, va


_DEFAULTS: dict | None = None


def _spec_defaults() -> dict:
    """asdict of a default ExperimentSpec (computed once) -- the reference
    ``spec_hash`` diffs against."""
    global _DEFAULTS
    if _DEFAULTS is None:
        _DEFAULTS = ExperimentSpec().to_dict()
    return _DEFAULTS


def _apply_override(spec, path: str, value):
    head, _, rest = path.partition(".")
    valid = {f.name for f in fields(spec)}
    if head not in valid:
        raise KeyError(f"unknown spec field {head!r} in override {path!r}; "
                       f"valid fields: {sorted(valid)}")
    if rest:
        return replace(spec, **{head: _apply_override(getattr(spec, head),
                                                      rest, value)})
    return replace(spec, **{head: value})
