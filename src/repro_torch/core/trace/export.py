"""Trace exporters on the registry convention (DESIGN.md §18).

``EXPORTERS`` maps an exporter name to a function ``recorder -> dict``
whose output serializes straight to JSON.  Both built-ins emit the Chrome
trace-event format (the JSON schema Perfetto's legacy importer and
``chrome://tracing`` both load): spans become complete (``"ph": "X"``)
events with microsecond timestamps, instantaneous marks become ``"i"``
events, and worker timelines map to ``tid`` rows under one ``pid``.

Registered under two names -- ``chrome`` and ``perfetto`` -- so either
spelling works in ``repro_torch trace --export``; ``repro_torch list`` prints both.
"""
from __future__ import annotations

from .record import TraceRecorder

__all__ = ["EXPORTERS", "make_exporter", "list_exporters", "export_chrome"]


def export_chrome(rec: TraceRecorder) -> dict:
    """Chrome trace-event JSON object format.

    ``ts``/``dur`` are microseconds of *simulated* time; ``tid`` is the
    stable worker id (request/replica id for serving traces)."""
    events: list[dict] = []
    for wid in rec.workers():
        events.append({"name": "thread_name", "ph": "M", "pid": 0,
                       "tid": wid, "args": {"name": f"worker {wid}"}})
    for s in rec.spans:
        ev = {"name": s.kind, "cat": s.phase, "ph": "X",
              "ts": s.t0 * 1e6, "dur": (s.t1 - s.t0) * 1e6,
              "pid": 0, "tid": s.worker, "args": {}}
        if s.nbytes:
            ev["args"]["nbytes"] = s.nbytes
        if s.usd:
            ev["args"]["usd"] = s.usd
        if s.meta:
            ev["args"].update(s.meta)
        events.append(ev)
    for m in rec.marks:
        args = {k: v for k, v in m.items()
                if k not in ("kind", "t", "worker")}
        events.append({"name": m["kind"], "cat": "mark", "ph": "i",
                       "ts": m["t"] * 1e6, "pid": 0, "tid": m["worker"],
                       "s": "t", "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"recorder": rec.kind,
                          "workers": len(rec.born),
                          "spans": len(rec.spans),
                          "marks": len(rec.marks)}}


# name -> exporter(recorder) -> JSON-serializable dict.  "perfetto" is the
# same trace-event emitter: Perfetto ingests Chrome JSON natively.
EXPORTERS = {
    "chrome": export_chrome,
    "perfetto": export_chrome,
}


def make_exporter(name: str):
    """Resolve an exporter by registry name (raises on unknown names with
    the list of valid ones, like every other registry factory)."""
    try:
        return EXPORTERS[name]
    except KeyError:
        raise ValueError(f"unknown exporter {name!r}; "
                         f"choose from {sorted(EXPORTERS)}") from None


def list_exporters() -> list[str]:
    return sorted(EXPORTERS)
