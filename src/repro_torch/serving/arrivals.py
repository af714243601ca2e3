"""Open-loop arrival processes behind the string-grammar registry.

Serving load is *open-loop*: requests arrive on the process's clock whether
or not the fleet keeps up, which is what makes queueing (and therefore p99)
an output of the simulator instead of an input.  Four shapes cover the
paper-style design space:

  ``poisson:<qps>``            homogeneous Poisson at a nominal rate
  ``diurnal:<qps@hour,...>``   piecewise-linear daily rate curve, sampled by
                               thinning; optional ``day=<s>`` rescales the
                               24 h period onto ``<s>`` simulated seconds
  ``flash:<base,spike,at[,dur]>``  flash crowd: base rate with a ``spike``
                               qps plateau starting at ``at`` seconds
                               (default duration: rest of the run)
  ``trace:<file>``             replay recorded arrival timestamps (seconds,
                               one per line, or a JSON list)

Every process exposes ``times(duration_s, seed)`` (sorted arrival instants),
``rate(t)`` (instantaneous qps, used by the analytic sizing helper) and
``peak_qps`` (used to provision IaaS/pod fleets for the frontier grid).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Sequence

import numpy as np

__all__ = ["ArrivalProcess", "PoissonArrivals", "DiurnalArrivals",
           "FlashArrivals", "TraceArrivals", "ARRIVALS", "make_arrivals",
           "list_arrivals"]


class ArrivalProcess:
    """Protocol: open-loop request arrival instants on the simulated clock."""

    name: str = "?"

    def times(self, duration_s: float, seed: int = 0) -> np.ndarray:
        raise NotImplementedError

    def rate(self, t: float) -> float:
        raise NotImplementedError

    @property
    def peak_qps(self) -> float:
        raise NotImplementedError


def _thin(rate: Callable[[float], float], rate_max: float,
          duration_s: float, seed: int) -> np.ndarray:
    """Sample an inhomogeneous Poisson process by thinning at ``rate_max``."""
    if rate_max <= 0 or duration_s <= 0:
        return np.zeros(0)
    rng = np.random.default_rng(seed)
    # Candidate count ~ Poisson(rate_max * T); draw with headroom, extend if
    # the tail is unlucky.
    t, out = 0.0, []
    while True:
        gaps = rng.exponential(1.0 / rate_max, size=max(16, int(rate_max * duration_s)))
        for g in gaps:
            t += g
            if t >= duration_s:
                return np.asarray(out)
            if rng.random() * rate_max < rate(t):
                out.append(t)


@dataclass(frozen=True)
class PoissonArrivals(ArrivalProcess):
    qps: float

    def __post_init__(self):
        if self.qps < 0:
            raise ValueError(f"poisson qps must be >= 0, got {self.qps}")

    @property
    def name(self) -> str:
        return f"poisson:{self.qps:g}"

    def times(self, duration_s: float, seed: int = 0) -> np.ndarray:
        if self.qps == 0 or duration_s <= 0:
            return np.zeros(0)
        rng = np.random.default_rng(seed)
        n = int(np.ceil(self.qps * duration_s + 6 * np.sqrt(self.qps * duration_s) + 16))
        t = np.cumsum(rng.exponential(1.0 / self.qps, size=n))
        while t.size and t[-1] < duration_s:      # pragma: no cover - headroom
            t = np.concatenate([t, t[-1] + np.cumsum(
                rng.exponential(1.0 / self.qps, size=n))])
        return t[t < duration_s]

    def rate(self, t: float) -> float:
        return self.qps

    @property
    def peak_qps(self) -> float:
        return self.qps


@dataclass(frozen=True)
class DiurnalArrivals(ArrivalProcess):
    """Piecewise-linear rate over a wrapped 24 h cycle, mapped onto ``day_s``
    simulated seconds (so a 300 s run can sweep a full synthetic day)."""

    points: tuple  # ((hour, qps), ...) sorted by hour in [0, 24)
    day_s: float = 86400.0

    def __post_init__(self):
        if not self.points:
            raise ValueError("diurnal needs at least one qps@hour point")
        if any(q < 0 for _, q in self.points):
            raise ValueError("diurnal qps must be >= 0")

    @property
    def name(self) -> str:
        pts = ",".join(f"{q:g}@{h:g}" for h, q in self.points)
        return f"diurnal:{pts}" + ("" if self.day_s == 86400.0 else f",day={self.day_s:g}")

    def rate(self, t: float) -> float:
        hour = (t / self.day_s * 24.0) % 24.0
        pts = list(self.points) + [(self.points[0][0] + 24.0, self.points[0][1])]
        if hour < pts[0][0]:
            hour += 24.0
        for (h0, q0), (h1, q1) in zip(pts, pts[1:]):
            if h0 <= hour <= h1:
                f = 0.0 if h1 == h0 else (hour - h0) / (h1 - h0)
                return q0 + f * (q1 - q0)
        return pts[0][1]

    def times(self, duration_s: float, seed: int = 0) -> np.ndarray:
        return _thin(self.rate, self.peak_qps, duration_s, seed)

    @property
    def peak_qps(self) -> float:
        return max(q for _, q in self.points)


@dataclass(frozen=True)
class FlashArrivals(ArrivalProcess):
    base: float
    spike: float
    at: float
    dur: float = float("inf")

    def __post_init__(self):
        if self.base < 0 or self.spike < 0 or self.at < 0:
            raise ValueError("flash parameters must be >= 0")

    @property
    def name(self) -> str:
        tail = "" if self.dur == float("inf") else f",{self.dur:g}"
        return f"flash:{self.base:g},{self.spike:g},{self.at:g}{tail}"

    def rate(self, t: float) -> float:
        return self.spike if self.at <= t < self.at + self.dur else self.base

    def times(self, duration_s: float, seed: int = 0) -> np.ndarray:
        return _thin(self.rate, self.peak_qps, duration_s, seed)

    @property
    def peak_qps(self) -> float:
        return max(self.base, self.spike)


@dataclass(frozen=True)
class TraceArrivals(ArrivalProcess):
    """Replay a recorded trace: arrival seconds, one float per line (or a
    JSON list).  ``times`` clips to the run duration; the seed is ignored."""

    path: str = ""
    _times: tuple = ()

    @classmethod
    def from_file(cls, path: str) -> "TraceArrivals":
        text = Path(path).read_text().strip()
        if text.startswith("["):
            vals = json.loads(text)
        else:
            vals = [float(x) for x in text.split()]
        return cls(path=path, _times=tuple(sorted(float(v) for v in vals)))

    @classmethod
    def from_times(cls, times: Sequence[float]) -> "TraceArrivals":
        return cls(path="<inline>", _times=tuple(sorted(float(v) for v in times)))

    @property
    def name(self) -> str:
        return f"trace:{self.path}"

    def times(self, duration_s: float, seed: int = 0) -> np.ndarray:
        t = np.asarray(self._times)
        return t[t < duration_s]

    def rate(self, t: float) -> float:
        if not self._times:
            return 0.0
        span = max(self._times[-1], 1e-9)
        return len(self._times) / span

    @property
    def peak_qps(self) -> float:
        t = np.asarray(self._times)
        if t.size < 2:
            return float(t.size)
        # max arrivals in any sliding 1 s window
        best = 1
        j = 0
        for i in range(t.size):
            while t[i] - t[j] > 1.0:
                j += 1
            best = max(best, i - j + 1)
        return float(best)


def _parse_poisson(arg: str) -> PoissonArrivals:
    return PoissonArrivals(qps=float(arg))


def _parse_diurnal(arg: str) -> DiurnalArrivals:
    pts, day_s = [], 86400.0
    for part in arg.split(","):
        part = part.strip()
        if not part:
            continue
        if part.startswith("day="):
            day_s = float(part[4:])
        else:
            q, _, h = part.partition("@")
            pts.append((float(h), float(q)))
    return DiurnalArrivals(points=tuple(sorted(pts)), day_s=day_s)


def _parse_flash(arg: str) -> FlashArrivals:
    parts = [float(x) for x in arg.split(",")]
    if len(parts) not in (3, 4):
        raise ValueError("flash:<base,spike,at[,dur]>")
    return FlashArrivals(*parts)


def _parse_trace(arg: str) -> TraceArrivals:
    return TraceArrivals.from_file(arg)


ARRIVALS: Dict[str, Callable[[str], ArrivalProcess]] = {
    "poisson": _parse_poisson,
    "diurnal": _parse_diurnal,
    "flash": _parse_flash,
    "trace": _parse_trace,
}


def make_arrivals(spec) -> ArrivalProcess:
    """``'poisson:5'`` / ``'flash:0.2,8,60'`` / an ArrivalProcess passthrough."""
    if isinstance(spec, ArrivalProcess):
        return spec
    head, _, arg = str(spec).partition(":")
    if head not in ARRIVALS:
        raise ValueError(f"unknown arrival process {head!r}; known: "
                         f"{', '.join(sorted(ARRIVALS))}")
    if not arg:
        raise ValueError(f"arrival process {head!r} needs an argument, e.g. "
                         "'poisson:5'")
    return ARRIVALS[head](arg)


def list_arrivals() -> Dict[str, str]:
    """name -> grammar line, for ``repro_torch list``."""
    return {
        "poisson": "poisson:<qps> - homogeneous Poisson arrivals",
        "diurnal": "diurnal:<qps@hour,...>[,day=<s>] - daily rate curve (thinning)",
        "flash": "flash:<base,spike,at[,dur]> - flash crowd plateau",
        "trace": "trace:<file> - replay recorded arrival seconds",
    }
