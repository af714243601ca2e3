"""Declarative experiment layer (DESIGN.md §10), the run half.

- :class:`ExperimentSpec` -- the JAX package's frozen, JSON-round-trippable
  trial description, field for field (a spec hashes the same in both).
- :func:`run_experiment` -- execute a spec on a device into a
  :class:`RunRecord`, with an on-disk cache keyed by spec hash.
- :data:`PRESETS` -- the paper's figures as named spec bundles.

Sweeps and the ``list``/``plan``/``trace``/``serve`` commands are
ROADMAP.md queue A4.
"""
from repro_torch.core.platform import CommSpec, FailureSpec, FleetSpec  # noqa: F401
from repro_torch.experiments.presets import PRESETS, Preset, get_preset  # noqa: F401
from repro_torch.experiments.runner import (  # noqa: F401
    SCHEMA, RunRecord, run_experiment,
)
from repro_torch.experiments.spec import ExperimentSpec  # noqa: F401
