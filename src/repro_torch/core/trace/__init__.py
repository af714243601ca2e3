"""Structured trace subsystem: spans, Figure-10 breakdowns and
conservation gates (DESIGN.md §18).  The Chrome exporter (``export.py``)
is not ported yet (ROADMAP.md queue A4)."""
from .breakdown import PHASES, derive_breakdown, render_breakdown
from .invariants import (assert_invariants, check_clock_tiling,
                         check_invariants, render_invariants)
from .record import Span, TraceRecorder

__all__ = [
    "Span", "TraceRecorder",
    "PHASES", "derive_breakdown", "render_breakdown",
    "check_clock_tiling", "check_invariants", "assert_invariants",
    "render_invariants",
]

