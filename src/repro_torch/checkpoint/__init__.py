"""Fault tolerance: atomic checkpoints + deadline-aware preemption guard.

The port's counterpart of the JAX package's ``checkpoint``.  The
tree-flatten / bf16-encode / atomic-commit machinery lives in
:mod:`repro_torch.core.ckpt.localfs` (the ``local`` backend of the metered
checkpoint subsystem, DESIGN.md §17), whose files are byte-compatible with
the JAX package's; this module re-exports it unchanged, so
``from repro_torch import checkpoint`` reads and writes the same files.

:class:`PreemptionGuard` reads the real wall clock (``time.monotonic``),
which the simulated core never touches.  It is the real-hardware
realization of LambdaML's hierarchical invocation (§3.3.1): checkpoint
while there is still (margin + one step) of the lease left, resume after
re-invocation.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.core.ckpt.localfs import (  # noqa: F401
    _BF16_TAG, _SEP, _decode, _encode, _flatten, _unflatten, list_steps,
    load, load_latest, retain, save,
)


@dataclass
class PreemptionGuard:
    """Deadline-aware checkpoint trigger (the 15-minute-Lambda analogue)."""
    lifetime_s: float = 900.0
    margin_s: float = 30.0
    _t0: float = field(default_factory=time.monotonic)
    _ema: float = 0.0

    def record_step(self, dt: float):
        self._ema = dt if self._ema == 0 else 0.9 * self._ema + 0.1 * dt

    @property
    def elapsed(self) -> float:
        return time.monotonic() - self._t0

    def should_checkpoint(self) -> bool:
        budget = self.lifetime_s - self.margin_s - self.elapsed
        return budget < 2 * max(self._ema, 1e-3)

    def renew(self):
        """Call after re-invocation (new lifetime lease)."""
        self._t0 = time.monotonic()
