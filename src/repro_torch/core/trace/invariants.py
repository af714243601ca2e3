"""Conservation invariants: the tracer as a cross-check on every meter
(DESIGN.md §18).

Three gates, all EXACT (``==`` on floats, no tolerance):

1. **Clock tiling** -- per worker, spans are contiguous (each span starts
   bitwise where the previous ended) from the birth clock to the final /
   retirement clock.  Checked on endpoints, never by re-summing durations.
2. **Cost attribution** -- the ordered $ ledger written by the last
   ``finalize_cost`` call sums (left-associatively) to ``RunResult.cost``.
3. **Byte conservation** -- the comm/ckpt byte ledgers sum to
   ``RunResult.comm_bytes`` / ``RunResult.ckpt_bytes``.

Exactness is by construction, not luck: span endpoints are read back from
the mutated clock array, and the ledgers mirror the engine's accumulation
values *and order* (see ``record.py``).
"""
from __future__ import annotations

from .record import TraceRecorder

__all__ = ["check_clock_tiling", "check_invariants", "assert_invariants",
           "render_invariants"]


def check_clock_tiling(rec: TraceRecorder) -> dict:
    """Invariant 1: spans tile each worker's timeline birth -> final."""
    by_worker: dict[int, list] = {w: [] for w in rec.born}
    for s in rec.spans:
        by_worker.setdefault(s.worker, []).append(s)
    errors: list[str] = []
    for wid in sorted(by_worker):
        spans = sorted(by_worker[wid], key=lambda s: (s.t0, s.t1))
        if wid not in rec.born:
            errors.append(f"worker {wid}: spans but no recorded birth")
            continue
        t = rec.born[wid]
        for s in spans:
            if s.t0 != t:
                errors.append(f"worker {wid}: gap/overlap at {s.kind}: "
                              f"span starts {s.t0!r}, timeline at {t!r}")
            t = s.t1
        end = rec.final.get(wid)
        if end is None:
            errors.append(f"worker {wid}: no final clock recorded")
        elif t != end:
            errors.append(f"worker {wid}: timeline ends at {t!r}, "
                          f"final clock {end!r}")
    return {"ok": not errors, "workers": len(by_worker),
            "spans": len(rec.spans), "errors": errors[:8]}


def check_invariants(res) -> dict:
    """All three gates against a traced ``RunResult``.

    ``res`` must expose ``trace`` (the recorder), ``cost``, ``comm_bytes``
    and ``ckpt_bytes``.
    """
    rec = res.trace
    if rec is None:
        raise ValueError("run was not traced (trace=False)")
    clock = check_clock_tiling(rec)
    traced_usd = rec.cost_total()
    cost = {"ok": traced_usd == res.cost,
            "traced_usd": traced_usd, "metered_usd": res.cost}
    t_comm = rec.bytes_total("comm")
    t_ckpt = rec.bytes_total("ckpt")
    m_ckpt = getattr(res, "ckpt_bytes", 0)
    nbytes = {"ok": t_comm == res.comm_bytes and t_ckpt == m_ckpt,
              "traced_comm": t_comm, "metered_comm": res.comm_bytes,
              "traced_ckpt": t_ckpt, "metered_ckpt": m_ckpt}
    return {"ok": clock["ok"] and cost["ok"] and nbytes["ok"],
            "clock": clock, "cost": cost, "bytes": nbytes}


def assert_invariants(res) -> dict:
    """Raise ``AssertionError`` (with the offending numbers) unless every
    gate passes; return the check results otherwise."""
    inv = check_invariants(res)
    if not inv["clock"]["ok"]:
        raise AssertionError("clock tiling violated: "
                             + "; ".join(inv["clock"]["errors"]))
    if not inv["cost"]["ok"]:
        raise AssertionError(
            f"cost attribution violated: traced "
            f"{inv['cost']['traced_usd']!r} != metered "
            f"{inv['cost']['metered_usd']!r}")
    if not inv["bytes"]["ok"]:
        b = inv["bytes"]
        raise AssertionError(
            f"byte conservation violated: comm {b['traced_comm']!r} vs "
            f"{b['metered_comm']!r}, ckpt {b['traced_ckpt']!r} vs "
            f"{b['metered_ckpt']!r}")
    return inv


def render_invariants(inv: dict) -> str:
    """Three OK/FAIL lines for ``repro trace``."""
    c, u, b = inv["clock"], inv["cost"], inv["bytes"]
    mark = lambda ok: "OK  " if ok else "FAIL"  # noqa: E731
    lines = [
        f"[{mark(c['ok'])}] clock tiling      "
        f"{c['spans']} spans tile {c['workers']} worker timelines",
        f"[{mark(u['ok'])}] cost attribution  "
        f"traced ${u['traced_usd']:.6f} == metered ${u['metered_usd']:.6f}",
        f"[{mark(b['ok'])}] byte conservation "
        f"comm {b['traced_comm']:.0f}B == {b['metered_comm']:.0f}B, "
        f"ckpt {b['traced_ckpt']:.0f}B == {b['metered_ckpt']:.0f}B",
    ]
    for err in c.get("errors", []):
        lines.append(f"       {err}")
    return "\n".join(lines)
