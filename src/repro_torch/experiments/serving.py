"""Declarative serving trials (DESIGN.md §14): spec, cache, frontier.

The serving mirror of :mod:`repro_torch.experiments.spec`/``runner``: a
:class:`ServingSpec` is a frozen, JSON-round-trippable description of one
serving trial (platform x fleet x arrival process x request shape x
autoscaler), hashed with the same default-elision scheme as
``ExperimentSpec`` and cached on disk as schema ``repro.serving/v1``
records (``experiments/runs_torch/serve_<hash>.json``).  The port's copy of
the JAX package's ``experiments/serving.py``: a spec hashes the same in
both packages, and the simulator is numpy, so the records are equal.

:func:`frontier` is the deliverable grid: FaaS vs IaaS vs pod across
arrival shapes, with provisioned fleets sized analytically for each shape's
peak (``provision_for``) — the inference-side Table 6.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field, fields
from pathlib import Path

from repro_torch.core.platform import FleetSpec
from repro_torch.core.runtimes import FaaSRuntime, IaaSRuntime, PodPlatform
from repro_torch.experiments.spec import PLATFORMS, _apply_override
from repro_torch.serving.arrivals import make_arrivals
from repro_torch.serving.latency import LatencyModel
from repro_torch.serving.sim import make_autoscaler, provision_for, serve

SERVE_SCHEMA = "repro.serving/v1"

#: hash salt, same contract as ``spec.HASH_SCHEMA``: defaults are elided
#: from the hash, so bump this whenever a ServingSpec default changes.
SERVE_HASH_SCHEMA = "s1"

DEFAULT_CACHE = (Path(__file__).resolve().parents[3] / "experiments"
                 / "runs_torch")

#: the frontier's arrival shapes: trickle, sustained, flash crowd.  The
#: trickle sits below the FaaS/IaaS break-even (~0.01 qps: one always-on
#: t2.medium costs what ~36 cold-started Lambda requests/hour cost); the
#: flash is sharp, so a provisioned fleet sized for its peak idles >90% of
#: the run and even one always-on pod costs more than cold-starting every
#: spike request — the two regimes where scale-to-zero wins.
FRONTIER_ARRIVALS = ("poisson:0.005", "poisson:5", "flash:0.05,10,60,30")


@dataclass(frozen=True)
class ServingSpec:
    """One fully-determined serving trial.  ``name`` is a human label and
    does not enter the spec hash (same rule as ExperimentSpec)."""

    name: str = ""
    platform: str = "faas"                # faas | iaas | pod
    fleet: FleetSpec = field(default_factory=FleetSpec)
    arrival: str = "poisson:1"            # arrivals registry grammar
    model: str = "smollm_360m"            # a decode-capable zoo arch
    reduced: bool = False                 # serve the CPU-sized variant
    duration_s: float = 300.0
    prompt_len: int = 32
    new_tokens: int = 32
    window_s: float = 15.0
    scaling: str = "static"               # core.elastic grammar (smlt re-read
                                          # on serving signals)
    max_batch: int = 32
    prewarm: int = 0                      # FaaS warm-pool seed
    seed: int = 0
    platform_args: dict = field(default_factory=dict)   # pod tunables

    def __post_init__(self):
        if self.platform not in PLATFORMS:
            raise ValueError(f"platform must be one of {PLATFORMS}, "
                             f"got {self.platform!r}")
        if self.platform_args and self.platform != "pod":
            raise ValueError("platform_args only apply to platform='pod'")
        from repro_torch.core.workloads import is_arch_workload
        if not is_arch_workload(self.model):
            raise ValueError(f"model {self.model!r} is not a zoo arch; "
                             f"serving needs a decode-capable architecture")
        if isinstance(self.fleet, dict):
            object.__setattr__(self, "fleet", FleetSpec(**self.fleet))
        if not isinstance(self.scaling, str):
            raise ValueError("ServingSpec.scaling must be a policy string "
                             "(specs are JSON-round-trippable)")
        make_autoscaler(self.scaling)     # reject bad grammar eagerly
        head = str(self.arrival).partition(":")[0]
        from repro_torch.serving.arrivals import ARRIVALS
        if head not in ARRIVALS:
            raise ValueError(f"unknown arrival process {head!r}; known: "
                             f"{', '.join(sorted(ARRIVALS))}")

    # ---- serialization (same contract as ExperimentSpec) --------------------
    def to_dict(self) -> dict:
        return asdict(self)

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "ServingSpec":
        d = dict(d)
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise KeyError(f"unknown ServingSpec fields {sorted(unknown)}; "
                           f"valid fields: {sorted(known)}")
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "ServingSpec":
        return cls.from_dict(json.loads(s))

    def spec_hash(self) -> str:
        """Content hash with name excluded and defaults elided -- see
        ``ExperimentSpec.spec_hash`` for the schema-evolution contract."""
        d = self.to_dict()
        d.pop("name")
        defaults = _serving_defaults()
        canon = {k: v for k, v in d.items() if v != defaults[k]}
        payload = SERVE_HASH_SCHEMA + json.dumps(canon, sort_keys=True,
                                                 separators=(",", ":"))
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def with_(self, **overrides) -> "ServingSpec":
        out = self
        for key, value in overrides.items():
            out = _apply_override(out, key, value)
        return out

    # ---- builders -----------------------------------------------------------
    def build_platform(self):
        if self.platform == "faas":
            return FaaSRuntime(fleet=self.fleet, seed=self.seed)
        if self.platform == "pod":
            return PodPlatform(fleet=self.fleet, seed=self.seed,
                               **self.platform_args)
        return IaaSRuntime(fleet=self.fleet, seed=self.seed)

    def run(self):
        return serve(self.build_platform(), self.model, self.arrival,
                     duration_s=self.duration_s, prompt_len=self.prompt_len,
                     new_tokens=self.new_tokens, window_s=self.window_s,
                     scaling=self.scaling, max_batch=self.max_batch,
                     prewarm=self.prewarm, reduced=self.reduced,
                     seed=self.seed)


_SERVING_DEFAULTS: dict | None = None


def _serving_defaults() -> dict:
    global _SERVING_DEFAULTS
    if _SERVING_DEFAULTS is None:
        _SERVING_DEFAULTS = ServingSpec().to_dict()
    return _SERVING_DEFAULTS


# ------------------------------------------------------------------ runner --

@dataclass
class ServeRecord:
    """One executed (or cache-recalled) serving trial, spec included."""

    spec: ServingSpec
    result: dict
    spec_hash: str = ""
    schema: str = SERVE_SCHEMA
    cached: bool = False
    path: str = ""

    def __post_init__(self):
        if not self.spec_hash:
            self.spec_hash = self.spec.spec_hash()

    def to_dict(self) -> dict:
        return {"schema": self.schema, "name": self.spec.name,
                "spec_hash": self.spec_hash, "spec": self.spec.to_dict(),
                "result": self.result}

    @classmethod
    def from_dict(cls, d: dict, **kw) -> "ServeRecord":
        return cls(spec=ServingSpec.from_dict(d["spec"]), result=d["result"],
                   spec_hash=d["spec_hash"],
                   schema=d.get("schema", SERVE_SCHEMA), **kw)


def run_serving(spec: ServingSpec, cache_dir: str | Path | None = None,
                force: bool = False) -> ServeRecord:
    """Execute one serving spec (or recall it from ``cache_dir``); cache
    files are ``serve_<hash>.json`` so they sit next to training records
    without colliding."""
    cache_file = None
    if cache_dir is not None:
        cache_file = Path(cache_dir) / f"serve_{spec.spec_hash()}.json"
        if cache_file.exists() and not force:
            rec = ServeRecord.from_dict(json.loads(cache_file.read_text()),
                                        cached=True, path=str(cache_file))
            rec.spec = spec          # caller's label wins (hash ignores it)
            return rec

    rec = ServeRecord(spec=spec, result=spec.run().to_dict())
    if cache_file is not None:
        cache_file.parent.mkdir(parents=True, exist_ok=True)
        cache_file.write_text(json.dumps(rec.to_dict(), indent=1))
        rec.path = str(cache_file)
    return rec


# ---------------------------------------------------------------- frontier --

def _sized_spec(platform: str, arrival: str, model: str, duration_s: float,
                reduced: bool, seed: int) -> ServingSpec:
    """Provisioned platforms get an analytically-sized static fleet for the
    arrival's peak; FaaS gets a generous concurrency cap (it scales per
    request anyway — the cap only guards runaway fan-out)."""
    if platform == "faas":
        return ServingSpec(name=f"faas/{arrival}", platform="faas",
                           fleet=FleetSpec(workers=256, lambda_gb=3.0),
                           arrival=arrival, model=model, reduced=reduced,
                           duration_s=duration_s, seed=seed)
    probe = (IaaSRuntime(workers=1) if platform == "iaas"
             else PodPlatform(pods=1))
    hooks = probe.serving_hooks()
    lat = LatencyModel.from_arch(model, flops=hooks.flops,
                                 mem_bandwidth=hooks.mem_bandwidth,
                                 reduced=reduced)
    w = provision_for(arrival, lat, hooks)
    return ServingSpec(name=f"{platform}/{arrival}", platform=platform,
                       fleet=FleetSpec(workers=w), arrival=arrival,
                       model=model, reduced=reduced, duration_s=duration_s,
                       seed=seed)


def frontier(arrivals=FRONTIER_ARRIVALS, model: str = "smollm_360m",
             duration_s: float = 300.0, reduced: bool = False, seed: int = 0,
             cache_dir: str | Path | None = None,
             force: bool = False) -> list:
    """The cost-vs-p99 frontier: every platform against every arrival shape.
    FaaS wins the trickle/bursty cells on $ (scale-to-zero); provisioned
    fleets win sustained throughput on both $ and p99 — the paper's training
    verdict, inverted per request shape."""
    recs = []
    for arrival in arrivals:
        for platform in ("faas", "iaas", "pod"):
            spec = _sized_spec(platform, arrival, model, duration_s,
                               reduced, seed)
            recs.append(run_serving(spec, cache_dir=cache_dir, force=force))
    return recs
