"""Trace-driven spot preemptions (DESIGN.md §17).

:class:`TracePreemptions` replays a RECORDED spot-preemption trace --
SMLT's (arXiv 2205.01853) point that real spot markets are bursty and
correlated, not a single Poisson rate.  A trace file is either whitespace
lines ``<sim_seconds> [<worker>]`` (``#`` comments allowed) or a JSON list
of times / ``[t, worker]`` pairs; events without a worker are assigned
round-robin over the fleet (deterministic -- no RNG is ever consumed, so
an EMPTY trace is byte-identical to a no-failure run).  Three recorded
fixtures ship under ``repro_torch/core/traces/`` and resolve by bare name.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.core.engine import InjectedPreemptions

#: bundled recorded traces, resolvable as ``trace:<name>``
TRACE_DIR = Path(__file__).parent / "traces"


def resolve_trace(name_or_path: str) -> Path:
    """A bare fixture name resolves to the bundled trace; anything else is
    treated as a filesystem path."""
    bundled = TRACE_DIR / f"{name_or_path}.txt"
    if "/" not in name_or_path and bundled.exists():
        return bundled
    return Path(name_or_path)


def load_trace(path: str | Path) -> tuple:
    """-> ``((sim_seconds, worker_or_None), ...)`` sorted by time.

    Accepts the whitespace line format (``t [worker]``, ``#`` comments) or
    a JSON list of times / ``[t, worker]`` pairs.
    """
    text = Path(path).read_text().strip()
    events = []
    if text.startswith("["):
        for item in json.loads(text):
            if isinstance(item, (list, tuple)):
                t, w = item[0], (int(item[1]) if len(item) > 1 else None)
            else:
                t, w = item, None
            events.append((float(t), w))
    else:
        for line in text.splitlines():
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            events.append((float(parts[0]),
                           int(parts[1]) if len(parts) > 1 else None))
    return tuple(sorted(events, key=lambda e: e[0]))


class TracePreemptions(InjectedPreemptions):
    """Replay a recorded preemption trace against a ``workers``-wide fleet.

    Events that name a worker kill that stable worker id; events without
    one round-robin over the initial fleet in time order (event ``k`` ->
    worker ``k % workers``), so the same trace spreads proportionally over
    any fleet width.  Replay semantics are exactly
    :class:`InjectedPreemptions`: a kill recorded before a worker's current
    clock fires clamped to the present -- a scripted event never silently
    vanishes."""

    def __init__(self, events, workers: int):
        w = max(int(workers), 1)
        inject = tuple(
            ((wid if wid is not None else k % w), t)
            for k, (t, wid) in enumerate(events))
        super().__init__(inject)

    @classmethod
    def from_spec(cls, spec: str, workers: int) -> "TracePreemptions":
        """``"<fixture|path>"`` (an optional ``trace:`` head is stripped)."""
        head, _, arg = str(spec).partition(":")
        name = arg if head == "trace" and arg else str(spec)
        return cls(load_trace(resolve_trace(name)), workers)
