"""``python -m repro_torch run`` -- run a study on the PyTorch port.

    python -m repro_torch run comm_axis                 # a preset, on the card
    python -m repro_torch run spec.json --set max_epochs=5
    python -m repro_torch run fig10_breakdown --device cpu

``run`` executes a preset (or a JSON file holding a spec, a record, or a
list of either), writes ``repro.experiment/v2`` records into the spec-hash
cache (default ``experiments/runs_torch/``), and prints a summary table.
Runs go to the card unless ``--device cpu`` is given; without CUDA and
without ``--device cpu`` the command fails.  The JAX package's other
commands (sweep, list, plan, trace, serve, lint) are ROADMAP.md queue A4.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.experiments import (
    PRESETS, ExperimentSpec, RunRecord, get_preset, run_experiment,
)
from repro_torch.experiments.runner import DEFAULT_CACHE


def _parse_value(text: str):
    """JSON if it parses, bare string otherwise (so ``sync=asp`` works)."""
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def _parse_set(items: list[str]) -> dict:
    over = {}
    for item in items:
        key, eq, value = item.partition("=")
        if not eq:
            raise SystemExit(f"--set expects field=value, got {item!r}")
        over[key] = _parse_value(value)
    return over


def _unwrap(d: dict) -> dict:
    """Accept a bare spec dict OR a full run-record envelope."""
    return d["spec"] if isinstance(d.get("spec"), dict) else d


def _load_specs(target: str, quick: bool) -> list[ExperimentSpec]:
    """A preset name, or a JSON file holding a spec / record / list of
    either."""
    if target in PRESETS:
        return get_preset(target).build(quick)
    path = Path(target)
    if path.suffix == ".json" or path.exists():
        if not path.exists():
            raise SystemExit(f"spec file not found: {target}")
        data = json.loads(path.read_text())
        items = data if isinstance(data, list) else [data]
        if not items:
            raise SystemExit(f"no specs in {target}")
        return [ExperimentSpec.from_dict(_unwrap(d)) for d in items]
    raise SystemExit(f"unknown preset or spec file {target!r}; "
                     f"presets: {', '.join(sorted(PRESETS))}")


def _print_records(records: list[RunRecord]) -> None:
    if not records:
        print("no records")
        return
    wname = max(len(r.spec.name) for r in records)
    print(f"{'name':<{wname}s} {'time_s':>9s} {'cost_$':>9s} {'loss':>9s} "
          f"{'rounds':>6s} {'device':>6s}  note")
    for r in records:
        res = r.result
        note = "cached" if r.cached else ""
        if res.get("error"):
            note = f"ERROR: {res['error']}"
        print(f"{r.spec.name:<{wname}s} {res.get('sim_time_s', 0):9.1f} "
              f"{res.get('cost_usd', 0):9.4f} {res.get('final_loss', 0):9.4f} "
              f"{res.get('rounds', 0):6d} {r.device:>6s}  {note}")


def cmd_run(args) -> int:
    specs = _load_specs(args.target, quick=not args.full)
    overrides = _parse_set(args.set or [])
    if overrides:
        specs = [s.with_(**overrides) for s in specs]
    cache = None if args.no_cache else args.cache
    records = [run_experiment(s, cache_dir=cache, force=args.force,
                              device=args.device)
               for s in specs]
    _print_records(records)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(
            json.dumps([r.to_dict() for r in records], indent=1))
        print(f"# {len(records)} record(s) -> {args.out}", file=sys.stderr)
    return 1 if any(r.result.get("error") for r in records) else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="Run LambdaML-reproduction studies on the PyTorch port.")
    sub = ap.add_subparsers(dest="command", required=True)
    run_p = sub.add_parser("run", help="run a preset or spec file")
    run_p.add_argument("target",
                       help="preset name or spec JSON file")
    size = run_p.add_mutually_exclusive_group()
    size.add_argument("--quick", action="store_true",
                      help="small CI-friendly sizes (the default)")
    size.add_argument("--full", action="store_true",
                      help="paper-scale sizes")
    run_p.add_argument("--set", action="append", metavar="FIELD=VALUE",
                       help="override a spec field on every trial "
                            "(dotted paths reach nested specs)")
    run_p.add_argument("--device", default=None,
                       help="torch device (default: cuda; 'cpu' to run on "
                            "the CPU)")
    run_p.add_argument("--cache", default=str(DEFAULT_CACHE),
                       help="record cache dir (default experiments/runs_torch/)")
    run_p.add_argument("--no-cache", action="store_true",
                       help="do not read or write the record cache")
    run_p.add_argument("--force", action="store_true",
                       help="re-run even on a cache hit")
    run_p.add_argument("--out", default=None,
                       help="also write all records to this JSON file")
    run_p.set_defaults(fn=cmd_run)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
