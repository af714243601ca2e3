"""Experiment runner (DESIGN.md §10).

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
only for the device it was run on.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
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
