"""Structured trace subsystem: spans, Figure-10 breakdowns, exporters and
conservation gates (DESIGN.md §18)."""
from .breakdown import PHASES, derive_breakdown, render_breakdown
from .export import EXPORTERS, export_chrome, list_exporters, make_exporter
from .invariants import (assert_invariants, check_clock_tiling,
                         check_invariants, render_invariants)
from .record import Span, TraceRecorder

__all__ = [
    "Span", "TraceRecorder",
    "PHASES", "derive_breakdown", "render_breakdown",
    "EXPORTERS", "export_chrome", "make_exporter", "list_exporters",
    "check_clock_tiling", "check_invariants", "assert_invariants",
    "render_invariants",
]


def comm_seconds(ctx) -> float:
    """One source of truth for elastic telemetry: the recorder's meter
    mirror when tracing (bitwise-equal to the engine meter by
    construction), the engine meter otherwise."""
    if ctx.rec is not None:
        return ctx.rec.meters.get("comm", 0.0)
    return ctx.res.breakdown.get("comm", 0.0)
