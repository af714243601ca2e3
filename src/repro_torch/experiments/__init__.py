"""Declarative experiment layer (DESIGN.md §10).

- :class:`ExperimentSpec` -- the JAX package's frozen, JSON-round-trippable
  trial description, field for field (a spec hashes the same in both).
- :func:`run_experiment` / :func:`sweep` -- execute a spec (or a cartesian
  grid of overrides over one) on a device into :class:`RunRecord` JSON,
  with an on-disk cache keyed by spec hash.
- :data:`PRESETS` -- the paper's figures as named spec bundles.
- :class:`ServingSpec` / :func:`run_serving` / :func:`frontier` -- the
  serving trials (DESIGN.md §14), the JAX package's records.
"""
from repro_torch.core.platform import CommSpec, FailureSpec, FleetSpec  # noqa: F401
from repro_torch.experiments.presets import PRESETS, Preset, get_preset  # noqa: F401
from repro_torch.experiments.runner import (  # noqa: F401
    SCHEMA, RunRecord, expand_grid, run_experiment, sweep,
)
from repro_torch.experiments.serving import (  # noqa: F401
    SERVE_SCHEMA, ServeRecord, ServingSpec, frontier, run_serving,
)
from repro_torch.experiments.spec import ExperimentSpec  # noqa: F401
