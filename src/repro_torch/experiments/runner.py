"""Experiment runner and sweeps (DESIGN.md §10).

``run_experiment(spec, device=None)`` executes one :class:`ExperimentSpec`
through the discrete-event engine on ``device`` (the card unless the
caller asks for ``"cpu"``) and returns a :class:`RunRecord` in the JAX
package's record schema (``repro.experiment/v2``), plus the ``device``
the run used:

    {
      "schema":    "repro.experiment/v2",
      "name":      "<human label>",
      "spec_hash": "<16-hex content hash of the spec, name excluded>",
      "device":    "cuda" | "cpu",
      "spec":      { ...ExperimentSpec.to_dict()... },
      "result": {
        ...RunResult.to_dict()...,      # sim_time_s, cost_usd, breakdown, ...
        "history": [[sim_time_s, loss], ...]
      }
    }

Records are cached on disk keyed by ``spec_hash`` (pass ``cache_dir``).
The default cache is ``experiments/runs_torch/``, apart from the JAX
package's ``experiments/runs/``: a spec hashes the same in both packages,
so a shared directory would mix their records.  A cached record is reused
only for the device it was run on.  ``sweep()`` expands a cartesian grid of
dotted-path overrides over a base spec, dedupes identical expansions, and
optionally fans trials out over a thread pool whose threads share one
device.
"""
from __future__ import annotations

import itertools
import json
from dataclasses import dataclass
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch.device import resolve_device
from repro_torch.experiments.spec import ExperimentSpec

SCHEMA = "repro.experiment/v2"
DEFAULT_CACHE = (Path(__file__).resolve().parents[3] / "experiments"
                 / "runs_torch")


@dataclass
class RunRecord:
    """One executed (or cache-recalled) experiment, spec included."""
    spec: ExperimentSpec
    result: dict
    spec_hash: str = ""
    device: str = ""
    schema: str = SCHEMA
    cached: bool = False          # served from the on-disk cache?
    path: str = ""                # cache file, when one was used

    def __post_init__(self):
        if not self.spec_hash:
            self.spec_hash = self.spec.spec_hash()

    def to_dict(self) -> dict:
        return {"schema": self.schema, "name": self.spec.name,
                "spec_hash": self.spec_hash, "device": self.device,
                "spec": self.spec.to_dict(), "result": self.result}

    @classmethod
    def from_dict(cls, d: dict, **kw) -> "RunRecord":
        return cls(spec=ExperimentSpec.from_dict(d["spec"]),
                   result=d["result"], spec_hash=d["spec_hash"],
                   device=d.get("device", ""),
                   schema=d.get("schema", SCHEMA), **kw)

    @property
    def history(self) -> list:
        return self.result.get("history", [])

    @property
    def final_loss(self) -> float:
        return self.result.get("final_loss", float("nan"))


def _result_dict(res) -> dict:
    d = res.to_dict()
    d["history"] = [[float(t), float(l)] for t, l in res.history]
    return d


def run_experiment(spec: ExperimentSpec, cache_dir: str | Path | None = None,
                   force: bool = False, device=None) -> RunRecord:
    """Execute one spec on ``device`` (or recall it from ``cache_dir``).

    The workload and runtime are built exactly as a hand-written
    ``FaaSRuntime(...).train(...)`` call builds them.  ``device=None``
    means the card and raises ``RuntimeError`` without CUDA.
    """
    dev = resolve_device(device)
    cache_file = None
    if cache_dir is not None:
        cache_file = Path(cache_dir) / f"{spec.spec_hash()}.json"
        if cache_file.exists() and not force:
            rec = RunRecord.from_dict(json.loads(cache_file.read_text()),
                                      cached=True, path=str(cache_file))
            if rec.device == dev.type:
                rec.spec = spec      # keep the caller's label
                return rec

    model, algo, tr, va = spec.build_workload()
    res = spec.build_runtime().train(
        model, algo, tr, va, target_loss=spec.target_loss,
        max_epochs=spec.max_epochs, eval_every=spec.eval_every,
        data_local=spec.data_local, trace=spec.trace, device=dev)
    rec = RunRecord(spec=spec, result=_result_dict(res), device=dev.type)

    if cache_file is not None:
        cache_file.parent.mkdir(parents=True, exist_ok=True)
        cache_file.write_text(json.dumps(rec.to_dict(), indent=1))
        rec.path = str(cache_file)
    return rec


def expand_grid(base: ExperimentSpec, grid: dict) -> list[ExperimentSpec]:
    """Cartesian expansion of ``{dotted.field: [values...]}`` over ``base``.
    Each expansion is named ``base.name[k=v,...]`` for traceability."""
    if not grid:
        return [base]
    keys = sorted(grid)
    specs = []
    for combo in itertools.product(*(grid[k] for k in keys)):
        over = dict(zip(keys, combo))
        label = ",".join(f"{k.split('.')[-1]}={v}" for k, v in over.items())
        s = base.with_(**over)
        specs.append(s.with_(name=f"{base.name or 'sweep'}[{label}]"))
    return specs


def sweep(base: ExperimentSpec, grid: dict | None = None,
          cache_dir: str | Path | None = None, max_workers: int = 0,
          force: bool = False, device=None) -> list[RunRecord]:
    """Run every point of ``grid`` over ``base`` (see :func:`expand_grid`)
    on ``device`` (``None`` = the card).

    Trials whose specs hash identically are executed once and the record is
    shared; ``max_workers > 1`` fans independent trials out over a thread
    pool.  The threads share the one device (each run's tensors are its
    own, and every run is deterministic), so records and cache files are
    the same whatever ``max_workers`` is.  Results come back in grid order
    regardless of execution order.
    """
    dev = resolve_device(device)
    specs = expand_grid(base, grid or {})
    unique: dict[str, ExperimentSpec] = {}
    for s in specs:
        unique.setdefault(s.spec_hash(), s)

    def _run(s: ExperimentSpec) -> RunRecord:
        return run_experiment(s, cache_dir=cache_dir, force=force,
                              device=dev)

    if max_workers and max_workers > 1 and len(unique) > 1:
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            done = dict(zip(unique, pool.map(_run, unique.values())))
    else:
        done = {h: _run(s) for h, s in unique.items()}

    out = []
    for s in specs:
        rec = done[s.spec_hash()]
        if rec.spec.name != s.name:      # shared record, caller's label wins
            rec = RunRecord(spec=s, result=rec.result,
                            spec_hash=rec.spec_hash, cached=rec.cached,
                            path=rec.path, device=rec.device)
        out.append(rec)
    return out
