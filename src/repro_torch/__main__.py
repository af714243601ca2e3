"""``python -m repro_torch`` -- run studies on the PyTorch port.

    python -m repro_torch list                      # presets and registries
    python -m repro_torch run comm_axis             # a preset, on the card
    python -m repro_torch run spec.json --set max_epochs=5
    python -m repro_torch run fig10_breakdown --device cpu
    python -m repro_torch sweep fig8_sync --grid fleet.workers=4,8 --grid sync=bsp,asp
    python -m repro_torch plan lr_higgs --objective cheapest
    python -m repro_torch trace fig10_trace --export chrome
    python -m repro_torch serve --grid              # serving frontier

``run`` executes a preset (or a JSON file holding a spec, a record, or a
list of either) and ``sweep`` expands a cartesian ``--grid`` over the
preset's base spec; both write ``repro.experiment/v2`` records into the
spec-hash cache (default ``experiments/runs_torch/``) and print a summary
table.  ``plan`` ranks platform x fleet width by the §5.3 analytic model
(DESIGN.md §13), and ``trace`` runs a preset with the span recorder on
(DESIGN.md §18).  ``serve`` runs the request-driven serving simulator
(DESIGN.md §14; numpy, ``repro.serving/v1`` records in the same cache).
Every command works on the card unless ``--device cpu`` is given; without
CUDA and without ``--device cpu`` it fails.  The JAX package's ``lint``
(ROADMAP.md queue A9) is not ported.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.device import resolve_device
from repro_torch.experiments import (
    PRESETS, ExperimentSpec, RunRecord, get_preset, run_experiment, sweep,
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


def _parse_grid(items: list[str]) -> dict:
    grid = {}
    for item in items:
        key, eq, values = item.partition("=")
        if not eq:
            raise SystemExit(f"--grid expects field=v1,v2,..., got {item!r}")
        grid[key] = [_parse_value(v) for v in values.split(",")]
    return grid


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


def _finish(records: list[RunRecord], out: str | None) -> None:
    _print_records(records)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(
            json.dumps([r.to_dict() for r in records], indent=1))
        print(f"# {len(records)} record(s) -> {out}", file=sys.stderr)


def cmd_list(args) -> int:
    """The presets and every registry's grammar, as the JAX package's
    ``list`` prints them, without the lint checkers (queue A9), which the
    port does not have."""
    resolve_device(args.device)
    for name in sorted(PRESETS):
        p = PRESETS[name]
        n = len(p.build(True))
        print(f"{name:<18s} {n:2d} trial(s)  {p.description}")
    from repro_torch.core.comm import (
        list_codecs, list_collectives, list_transports)
    from repro_torch.core.elastic import list_policies
    from repro_torch.core.workloads import list_workloads
    from repro_torch.experiments.spec import PLATFORMS
    print(f"\nplatforms: {', '.join(PLATFORMS)}")
    print(f"models:    {', '.join(list_workloads())}")
    from repro_torch.core.sync import list_syncs
    print(f"\nsync protocols (--set sync=..., DESIGN.md §3):")
    print(f"  {', '.join(list_syncs())}")
    print(f"\ncomm stacks (--set comm=transport/collective/codec, "
          f"DESIGN.md §12):")
    print(f"  transports:  {', '.join(list_transports())}")
    print(f"  collectives: {', '.join(list_collectives())}")
    print(f"  codecs:      {', '.join(list_codecs())}")
    print(f"\nscaling policies (--set scaling=..., DESIGN.md §13):")
    print(f"  {', '.join(list_policies())}")
    from repro_torch.core.ckpt import list_ckpts
    print(f"\ncheckpoint transports (--set ckpt=..., DESIGN.md §17):")
    print(f"  {', '.join(list_ckpts().values())}")
    from repro_torch.core.failures import list_failures
    print(f"\nfailure processes (--set failure.trace=... / failure.rate=..., "
          f"DESIGN.md §17):")
    for line in list_failures().values():
        print(f"  {line}")
    from repro_torch.serving.arrivals import list_arrivals
    print(f"\narrival processes (repro_torch serve --arrival ..., "
          f"DESIGN.md §14):")
    for line in list_arrivals().values():
        print(f"  {line}")
    from repro_torch.core.trace import list_exporters
    print(f"\ntrace exporters (repro_torch trace --export ..., "
          f"DESIGN.md §18):")
    print(f"  {', '.join(list_exporters())}")
    return 0


def cmd_plan(args) -> int:
    """Analytic fleet planner (DESIGN.md §13): rank platform x width for a
    workload by the §5.3 cost model."""
    from repro_torch.core.elastic import PAPER_WORKLOADS, plan
    resolve_device(args.device)
    if args.target in PAPER_WORKLOADS:
        target, label = PAPER_WORKLOADS[args.target], args.target
    else:
        spec = _load_specs(args.target, quick=not args.full)[0]
        overrides = _parse_set(args.set or [])
        if overrides:
            spec = spec.with_(**overrides)
        target, label = spec, spec.name or args.target
    workers = ([int(w) for w in args.workers.split(",")]
               if args.workers else None)
    kw = {} if workers is None else {"workers": workers}
    platforms = tuple(p.strip() for p in args.platforms.split(",")
                      if p.strip())
    mfu = args.mfu if args.mfu == "measured" else float(args.mfu)
    options = plan(target, args.objective, deadline_s=args.deadline_s,
                   budget_usd=args.budget_usd, platforms=platforms,
                   mfu=mfu, **kw)
    print(f"# plan for {label} (objective={args.objective})")
    print(f"{'rank':>4s} {'platform':<8s} {'w':>4s} {'time_s':>10s} "
          f"{'cost_$':>9s}  note")
    for i, o in enumerate(options, 1):
        note = o.note if o.note else ("" if i > 1 else "<- pick")
        print(f"{i:4d} {o.platform:<8s} {o.workers:4d} {o.time_s:10.1f} "
              f"{o.cost_usd:9.4f}  {note}")
    # the restart term behind the ranking: startup + metered restore of
    # the model's actual bytes through the checkpoint transport (§17)
    from repro_torch.core.analytical import restart_seconds
    from repro_torch.core.elastic.planner import as_cost_inputs
    ci = as_cost_inputs(target)
    per = ", ".join(f"{p}={restart_seconds(p, ci.m_bytes):.1f}s"
                    for p in platforms)
    print(f"# derived restart ({ci.m_bytes / 1e6:.3f} MB model): {per}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(
            json.dumps([o.to_dict() for o in options], indent=1))
    if not options or not options[0].feasible:
        print("# no feasible option under the given constraints",
              file=sys.stderr)
        return 1
    return 0


def cmd_trace(args) -> int:
    """Span-level observability (DESIGN.md §18): run a preset with the
    recorder on, print the Figure-10 phase breakdown and the three
    conservation gates, optionally export a Chrome/Perfetto trace."""
    from repro_torch.core.trace import (
        check_invariants, make_exporter, render_breakdown, render_invariants)
    device = resolve_device(args.device)
    exporter = make_exporter(args.export) if args.export else None
    specs = _load_specs(args.target, quick=not args.full)
    overrides = _parse_set(args.set or [])
    if overrides:
        specs = [s.with_(**overrides) for s in specs]
    rc = 0
    for k, spec in enumerate(specs):
        spec = spec.with_(trace=True)
        model, algo, tr, va = spec.build_workload()
        res = spec.build_runtime().train(
            model, algo, tr, va, target_loss=spec.target_loss,
            max_epochs=spec.max_epochs, eval_every=spec.eval_every,
            data_local=spec.data_local, trace=True, device=device)
        if res.error:
            print(f"# {spec.name or args.target}: ERROR {res.error}",
                  file=sys.stderr)
            rc = 1
            continue
        print(render_breakdown(res.trace, title=spec.name or args.target))
        inv = check_invariants(res)
        print(render_invariants(inv))
        print()
        if not inv["ok"]:
            rc = 1
        if exporter is not None:
            path = Path(args.out or f"{spec.name or 'trace'}"
                                    f".{args.export}.json")
            if len(specs) > 1 and args.out:
                path = path.with_name(f"{path.stem}.{k}{path.suffix}")
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(exporter(res.trace)))
            print(f"# {args.export} trace -> {path}", file=sys.stderr)
    return rc


def cmd_run(args) -> int:
    specs = _load_specs(args.target, quick=not args.full)
    overrides = _parse_set(args.set or [])
    if overrides:
        specs = [s.with_(**overrides) for s in specs]
    cache = None if args.no_cache else args.cache
    records = [run_experiment(s, cache_dir=cache, force=args.force,
                              device=args.device)
               for s in specs]
    _finish(records, args.out)
    return 1 if any(r.result.get("error") for r in records) else 0


def cmd_sweep(args) -> int:
    quick = not args.full
    base = (get_preset(args.target).base(quick) if args.target in PRESETS
            else _load_specs(args.target, quick)[0])
    base = base.with_(**_parse_set(args.set or []))
    grid = _parse_grid(args.grid or [])
    if not grid:
        raise SystemExit("sweep needs at least one --grid field=v1,v2,...")
    cache = None if args.no_cache else args.cache
    records = sweep(base, grid, cache_dir=cache, max_workers=args.workers,
                    force=args.force, device=args.device)
    _finish(records, args.out)
    return 1 if any(r.result.get("error") for r in records) else 0


def _print_serve_records(records) -> None:
    wname = max(len(r.spec.name or r.spec.platform) for r in records)
    print(f"{'name':<{wname}s} {'w':>5s} {'req':>6s} {'done':>6s} "
          f"{'cold':>5s} {'p50_ms':>10s} {'p99_ms':>10s} {'cost_$':>10s} "
          f"{'$/1k':>9s}  note")
    for r in records:
        d = r.result
        name = r.spec.name or r.spec.platform
        p50 = d.get("p50_ms")
        p99 = d.get("p99_ms")
        perk = d.get("usd_per_1k")
        print(f"{name:<{wname}s} {d.get('workers0', 0):5d} "
              f"{d.get('requests', 0):6d} {d.get('completed', 0):6d} "
              f"{d.get('cold_starts', 0):5d} "
              f"{p50 if p50 is not None else float('nan'):10.1f} "
              f"{p99 if p99 is not None else float('nan'):10.1f} "
              f"{d.get('cost_usd', 0):10.5f} "
              f"{perk if perk is not None else float('nan'):9.4f}  "
              f"{'cached' if r.cached else ''}")


def cmd_serve(args) -> int:
    """Request-driven serving simulator (DESIGN.md §14; numpy: the device
    is resolved like every command's, and nothing runs on it)."""
    from repro_torch.experiments.serving import (
        ServingSpec, frontier, run_serving)
    resolve_device(args.device)
    cache = None if args.no_cache else args.cache
    overrides = _parse_set(args.set or [])
    if args.grid:
        records = frontier(duration_s=args.duration_s, reduced=args.reduced,
                           cache_dir=cache, force=args.force)
        print("# cost-vs-p99 frontier: FaaS vs IaaS vs pod x arrival shape")
    else:
        if args.target:
            path = Path(args.target)
            if not path.exists():
                raise SystemExit(f"spec file not found: {args.target}")
            data = json.loads(path.read_text())
            items = data if isinstance(data, list) else [data]
            specs = [ServingSpec.from_dict(_unwrap(d)) for d in items]
        else:
            specs = [ServingSpec(name="serve", arrival=args.arrival,
                                 duration_s=args.duration_s,
                                 reduced=args.reduced)]
        if overrides:
            specs = [s.with_(**overrides) for s in specs]
        records = [run_serving(s, cache_dir=cache, force=args.force)
                   for s in specs]
    _print_serve_records(records)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(
            json.dumps([r.to_dict() for r in records], indent=1))
        print(f"# {len(records)} record(s) -> {args.out}", file=sys.stderr)
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="Run LambdaML-reproduction studies on the PyTorch port.")
    sub = ap.add_subparsers(dest="command", required=True)

    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' to run on "
                             "the CPU)")

    sub.add_parser("list", parents=[device],
                   help="list presets and registries").set_defaults(
        fn=cmd_list)

    sized = argparse.ArgumentParser(add_help=False, parents=[device])
    sized.add_argument("target",
                       help="preset name (see `list`) or spec JSON file")
    size = sized.add_mutually_exclusive_group()
    size.add_argument("--quick", action="store_true",
                      help="small CI-friendly sizes (the default)")
    size.add_argument("--full", action="store_true",
                      help="paper-scale sizes")
    sized.add_argument("--set", action="append", metavar="FIELD=VALUE",
                       help="override a spec field on every trial "
                            "(dotted paths reach nested specs)")

    common = argparse.ArgumentParser(add_help=False, parents=[sized])
    common.add_argument("--cache", default=str(DEFAULT_CACHE),
                        help="record cache dir (default "
                             "experiments/runs_torch/)")
    common.add_argument("--no-cache", action="store_true",
                        help="do not read or write the record cache")
    common.add_argument("--force", action="store_true",
                        help="re-run even on a cache hit")
    common.add_argument("--out", default=None,
                        help="also write all records to this JSON file")

    run_p = sub.add_parser("run", parents=[common],
                           help="run a preset or spec file")
    run_p.set_defaults(fn=cmd_run)

    sweep_p = sub.add_parser(
        "sweep", parents=[common],
        help="cartesian sweep over a preset's base spec")
    sweep_p.add_argument("--grid", action="append", metavar="FIELD=V1,V2",
                         help="one sweep axis (repeatable)")
    sweep_p.add_argument("--workers", type=int, default=0,
                         help="thread-pool size for independent trials "
                              "(the threads share the device)")
    sweep_p.set_defaults(fn=cmd_sweep)

    plan_p = sub.add_parser(
        "plan", parents=[common],
        help="rank platform x fleet width for a workload via the §5.3 "
             "analytic model (DESIGN.md §13); target is a preset, a spec "
             "JSON, or a named paper workload (lr_higgs, "
             "mobilenet_cifar10, ...)")
    plan_p.add_argument("--objective", default="cheapest",
                        choices=("cheapest", "fastest"))
    plan_p.add_argument("--deadline-s", type=float, default=None,
                        help="only options finishing within this many "
                             "simulated seconds are feasible (default for "
                             "'cheapest': 1.25x the fastest option)")
    plan_p.add_argument("--budget-usd", type=float, default=None,
                        help="only options under this $ are feasible")
    plan_p.add_argument("--workers", default=None, metavar="W1,W2,...",
                        help="fleet widths to sweep (default: the Fig-11 "
                             "axis 1..300)")
    plan_p.add_argument("--platforms", default="faas,iaas",
                        metavar="P1,P2,...",
                        help="platforms to sweep (faas, iaas, pod; "
                             "default: faas,iaas)")
    plan_p.add_argument("--mfu", default="0.4",
                        help="pod MFU: a fraction in (0, 1], or 'measured' "
                             "to read the committed roofline fraction "
                             "from BENCH_kernels.json")
    plan_p.set_defaults(fn=cmd_plan)

    trace_p = sub.add_parser(
        "trace", parents=[sized],
        help="run a preset with the span recorder on (DESIGN.md §18): "
             "Figure-10 phase breakdown, conservation gates, Chrome export")
    trace_p.add_argument("--export", default=None,
                         choices=("chrome", "perfetto"),
                         help="also write a trace-event JSON file")
    trace_p.add_argument("--out", default=None,
                         help="export file name (default <name>.chrome.json)")
    trace_p.set_defaults(fn=cmd_trace)

    serve_p = sub.add_parser(
        "serve", parents=[device],
        help="request-driven serving simulator (DESIGN.md §14): open-loop "
             "traffic, cold starts, continuous batching")
    serve_p.add_argument("target", nargs="?", default=None,
                         help="ServingSpec JSON file (default: a single "
                              "built-in spec shaped by --arrival)")
    serve_p.add_argument("--grid", action="store_true",
                         help="run the cost-vs-p99 frontier: faas/iaas/pod "
                              "x trickle/sustained/flash")
    serve_p.add_argument("--arrival", default="poisson:1",
                         metavar="PROCESS",
                         help="arrival grammar for the default spec "
                              "(poisson:<qps> | diurnal:... | flash:... | "
                              "trace:<file>)")
    serve_p.add_argument("--duration-s", type=float, default=300.0,
                         help="simulated traffic window (default 300)")
    serve_p.add_argument("--reduced", action="store_true",
                         help="serve the CPU-sized reduced arch variant")
    serve_p.add_argument("--set", action="append", metavar="FIELD=VALUE",
                         help="override a ServingSpec field (dotted paths "
                              "reach the fleet)")
    serve_p.add_argument("--cache", default=str(DEFAULT_CACHE),
                         help="record cache dir (default "
                              "experiments/runs_torch/)")
    serve_p.add_argument("--no-cache", action="store_true",
                         help="do not read or write the record cache")
    serve_p.add_argument("--force", action="store_true",
                         help="re-run even on a cache hit")
    serve_p.add_argument("--out", default=None,
                         help="also write all records to this JSON file")
    serve_p.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
