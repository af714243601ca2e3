"""The :class:`TraceRecorder`: per-event spans on worker timelines
(DESIGN.md §18).

One recorder observes one simulated run.  Every clock mutation in the
engine/sync/comm/ckpt layers emits a typed :class:`Span` on the mutated
worker's timeline; every metered dollar and wire byte lands in an ordered
ledger.  Three design rules make the recorder a *conservation cross-check*
on the meters rather than a second bookkeeping path:

- **Tiling, not re-summation.**  A span's endpoints are the clock values
  around the mutation (``t0`` captured before, ``t1`` read back from the
  mutated array), so per-worker spans tile the timeline contiguously from
  birth to the final clock and the invariant check compares *endpoints
  bitwise* -- no float re-summation that could drift by ULPs.
- **Mirrored accumulation order.**  The meter mirror (:meth:`meter`), the
  cost ledger (:meth:`cost`) and the byte ledgers (:meth:`bytes_event`)
  append the exact values the engine accumulates, in the exact order, so
  sequential sums are bit-identical to ``RunResult.breakdown`` /
  ``finalize_cost`` / ``comm_bytes`` / ``ckpt_bytes``.
- **Nothing when disabled.**  Every instrumentation site is guarded by
  ``if ctx.rec is not None``; with tracing off no copy, no float op and no
  allocation happens, so ``trace=False`` runs are byte-identical to the
  untraced engine (pinned in ``tests/test_trace.py``).
"""
from __future__ import annotations

__all__ = ["Span", "TraceRecorder"]


class Span:
    """One typed interval on a worker timeline.

    ``worker`` is the STABLE worker id (elastic joiners mint fresh ids;
    serving uses request/replica ids), ``kind`` the event type
    (``"compute"``, ``"comm.reduce"``, ``"ckpt.save"``, ...), ``phase``
    the Figure-10 bucket it aggregates into (``startup``/``data``/
    ``compute``/``comm``/``stall``/``ckpt``/``idle``)."""

    __slots__ = ("worker", "kind", "phase", "t0", "t1", "nbytes", "usd",
                 "meta")

    def __init__(self, worker: int, kind: str, phase: str, t0: float,
                 t1: float, nbytes: float = 0.0, usd: float = 0.0,
                 meta: dict | None = None):
        self.worker = worker
        self.kind = kind
        self.phase = phase
        self.t0 = t0
        self.t1 = t1
        self.nbytes = nbytes
        self.usd = usd
        self.meta = meta

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        d = {"worker": self.worker, "kind": self.kind, "phase": self.phase,
             "t0": self.t0, "t1": self.t1}
        if self.nbytes:
            d["nbytes"] = self.nbytes
        if self.usd:
            d["usd"] = self.usd
        if self.meta:
            d["meta"] = self.meta
        return d

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.worker}, {self.kind!r}, {self.phase!r}, "
                f"[{self.t0:.6g}, {self.t1:.6g}])")


class TraceRecorder:
    """Ordered event record of one simulated run (training or serving).

    Attached to :class:`~repro_torch.core.engine.SimContext` as ``ctx.rec`` (and
    to ``serve()``'s loop state) when ``trace=True``; ``None`` otherwise.
    """

    def __init__(self, kind: str = "train"):
        self.kind = kind                  # "train" | "serve"
        self.spans: list[Span] = []
        self.marks: list[dict] = []       # instant events (codec, shard ops,
                                          # kills, resize decisions, windows)
        self.born: dict[int, float] = {}      # stable id -> birth clock
        self.retired: dict[int, float] = {}   # stable id -> retirement clock
        self.final: dict[int, float] = {}     # stable id -> final clock
        self.meters: dict[str, float] = {}    # breakdown mirror (bitwise)
        self._cost: list[tuple[str, float]] = []    # ordered $ ledger
        self._bytes: dict[str, list[tuple[float, dict | None]]] = {
            "comm": [], "ckpt": []}

    # ---- spans --------------------------------------------------------------
    def span(self, worker: int, kind: str, phase: str, t0: float, t1: float,
             nbytes: float = 0.0, usd: float = 0.0,
             meta: dict | None = None) -> None:
        """Append one span; zero-length spans are dropped (a no-op mutation
        leaves no gap for the tiling check to explain)."""
        if t1 != t0:
            self.spans.append(Span(int(worker), kind, phase, float(t0),
                                   float(t1), nbytes, usd, meta))

    def tile(self, worker_ids, before, after, kind: str, phase: str,
             meta: dict | None = None) -> None:
        """Spans for one vectorized clock mutation: position ``i`` moved
        from ``before[i]`` to ``after[i]``."""
        for i in range(len(worker_ids)):
            self.span(int(worker_ids[i]), kind, phase, float(before[i]),
                      float(after[i]), meta=meta)

    # ---- worker lifecycle ---------------------------------------------------
    def birth(self, worker: int, t: float) -> None:
        self.born[int(worker)] = float(t)

    def retire_worker(self, worker: int, t: float) -> None:
        self.retired[int(worker)] = float(t)
        self.final[int(worker)] = float(t)

    def finalize_clock(self, worker_ids, clock) -> None:
        """Record the end-of-run clock of every LIVE worker (retired ones
        already pinned theirs at retirement)."""
        for i in range(len(worker_ids)):
            self.final[int(worker_ids[i])] = float(clock[i])

    # ---- meter mirror -------------------------------------------------------
    def meter(self, key: str, dt: float) -> None:
        """Mirror of ``SimContext.meter_add`` -- same values, same order,
        so ``rec.meters`` is bitwise-equal to ``RunResult.breakdown``."""
        self.meters[key] = self.meters.get(key, 0.0) + dt

    # ---- $ ledger -----------------------------------------------------------
    def cost_reset(self) -> None:
        """Start a fresh attribution ledger.  ``finalize_cost`` is also
        called mid-run (elastic telemetry snapshots); only the LAST call's
        ledger describes ``RunResult.cost``, so every call resets first."""
        self._cost = []

    def cost(self, label: str, usd: float) -> None:
        self._cost.append((label, float(usd)))

    def cost_total(self) -> float:
        """Left-associative sum in ledger order -- bitwise equal to the
        ``finalize_cost`` return by construction (IEEE ``a - b`` is
        ``a + (-b)``, so rebates enter as negative entries)."""
        total = 0.0
        for _, usd in self._cost:
            total = total + usd
        return total

    def cost_ledger(self) -> list[tuple[str, float]]:
        return list(self._cost)

    # ---- byte ledgers -------------------------------------------------------
    def bytes_event(self, stream: str, nbytes: float,
                    meta: dict | None = None) -> None:
        """One metered byte movement on ``stream`` (``"comm"`` |
        ``"ckpt"``), appended exactly where the engine meter accumulates
        the same value."""
        self._bytes[stream].append((nbytes, meta))

    def bytes_total(self, stream: str) -> float:
        total = 0.0
        for n, _ in self._bytes[stream]:
            total = total + n
        return total

    def bytes_ledger(self, stream: str) -> list:
        return list(self._bytes[stream])

    # ---- instant events -----------------------------------------------------
    def mark(self, kind: str, t: float, worker: int = -1, **meta) -> None:
        self.marks.append({"kind": kind, "t": float(t),
                           "worker": int(worker), **meta})

    # ---- summary ------------------------------------------------------------
    @property
    def n_events(self) -> int:
        return len(self.spans) + len(self.marks)

    def workers(self) -> list[int]:
        """Every stable worker id that was ever born."""
        return sorted(self.born)
