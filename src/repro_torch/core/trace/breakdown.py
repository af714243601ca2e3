"""Figure-10 phase breakdown derived from spans alone (DESIGN.md §18).

The paper's Figure 10 decomposes end-to-end training into startup, data
loading, computation, and communication.  The recorder's span taxonomy
extends that with the phases the simulator actually exhibits: ``stall``
(stragglers, SSP waits, preemption rework/lost work), ``ckpt`` (save /
restore shards), and ``idle`` (barrier waits).  Everything here is
*derived* -- no meter is consulted, so the aggregation doubles as an
independent check on ``RunResult.breakdown``.
"""
from __future__ import annotations

from .record import TraceRecorder

__all__ = ["PHASES", "derive_breakdown", "render_breakdown"]

# Figure-10 bucket order (presentation + aggregation key order).
PHASES = ("startup", "data", "compute", "comm", "stall", "ckpt", "idle")


def derive_breakdown(rec: TraceRecorder) -> dict:
    """Aggregate spans into the Figure-10 breakdown, per worker and per $.

    Returns::

        {"phases":     {phase: total seconds across workers},
         "per_worker": {wid: {phase: seconds}},
         "wall":       {wid: final clock - birth clock},
         "usd":        {label: attributed dollars, summed per label},
         "bytes":      {"comm": traced comm bytes, "ckpt": traced ckpt bytes}}
    """
    per_worker: dict[int, dict[str, float]] = {w: {} for w in rec.born}
    for s in rec.spans:
        d = per_worker.setdefault(s.worker, {})
        d[s.phase] = d.get(s.phase, 0.0) + (s.t1 - s.t0)
    phases = {p: 0.0 for p in PHASES}
    for d in per_worker.values():
        for p, v in d.items():
            phases[p] = phases.get(p, 0.0) + v
    wall = {w: rec.final.get(w, rec.born[w]) - rec.born[w] for w in rec.born}
    usd: dict[str, float] = {}
    for label, v in rec.cost_ledger():
        usd[label] = usd.get(label, 0.0) + v
    return {
        "phases": phases,
        "per_worker": {w: per_worker[w] for w in sorted(per_worker)},
        "wall": wall,
        "usd": usd,
        "bytes": {"comm": rec.bytes_total("comm"),
                  "ckpt": rec.bytes_total("ckpt")},
    }


def render_breakdown(rec: TraceRecorder, title: str = "") -> str:
    """Text rendering of the Figure-10 table for ``repro trace``."""
    bd = derive_breakdown(rec)
    total_wall = sum(bd["wall"].values())
    lines = []
    if title:
        lines.append(title)
    lines.append(f"{'phase':<10s} {'seconds':>12s} {'share':>8s}")
    for p in PHASES:
        v = bd["phases"].get(p, 0.0)
        share = v / total_wall if total_wall > 0 else 0.0
        lines.append(f"{p:<10s} {v:12.3f} {share:7.1%}")
    other = sum(v for p, v in bd["phases"].items() if p not in PHASES)
    if other:
        lines.append(f"{'other':<10s} {other:12.3f}"
                     f" {other / max(total_wall, 1e-300):7.1%}")
    lines.append(f"{'wall':<10s} {total_wall:12.3f}"
                 f"  ({len(bd['wall'])} workers)")
    if bd["usd"]:
        lines.append("")
        lines.append(f"{'$ term':<16s} {'usd':>14s}")
        for label, v in bd["usd"].items():
            lines.append(f"{label:<16s} {v:14.6f}")
        lines.append(f"{'total':<16s} {rec.cost_total():14.6f}")
    lines.append("")
    lines.append(f"bytes: comm={bd['bytes']['comm']:.0f}"
                 f" ckpt={bd['bytes']['ckpt']:.0f}"
                 f"  events: {len(rec.spans)} spans + {len(rec.marks)} marks")
    return "\n".join(lines)
