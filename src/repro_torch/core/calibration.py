"""Measured-MFU calibration of the SIMULATED pod platform.

:class:`repro_torch.core.runtimes.PodPlatform` discounts the simulated pod
chip's peak by an MFU factor (``worker_flops = chips_per_pod * PEAK_FLOPS *
mfu``).  ``mfu="measured"`` reads ``roofline_fraction`` from the committed
``BENCH_kernels.json`` at the repository root -- the JAX package's
measurement for its simulated pod fleet, read as a file so both packages
meter identical pod runs.  It describes the simulated fleet, not the card
this port runs on.  :data:`MEASURED_MFU` is the same number, used when the
file is absent.
"""
from __future__ import annotations

import json
from pathlib import Path

#: fallback snapshot of BENCH_kernels.json's ``roofline_fraction``
MEASURED_MFU = 0.520

_BENCH_KERNELS = Path(__file__).resolve().parents[3] / "BENCH_kernels.json"


def measured_mfu(path: Path | None = None) -> float:
    """``roofline_fraction`` from the committed ``BENCH_kernels.json``
    (:data:`MEASURED_MFU` when the file is absent or predates it)."""
    p = _BENCH_KERNELS if path is None else Path(path)
    try:
        payload = json.loads(p.read_text())
    except (OSError, ValueError):
        return MEASURED_MFU
    frac = payload.get("roofline_fraction")
    if not isinstance(frac, (int, float)) or not 0.0 < frac <= 1.0:
        return MEASURED_MFU
    return float(frac)


def resolve_mfu(mfu) -> float:
    """``"measured"`` -> :func:`measured_mfu`; numbers pass through."""
    if isinstance(mfu, str):
        if mfu != "measured":
            raise ValueError(
                f"mfu must be a number in (0, 1] or 'measured', got {mfu!r}")
        return measured_mfu()
    return float(mfu)
