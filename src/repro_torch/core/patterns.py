"""Communication patterns over a storage channel -- COMPAT SHIM.

The implementations moved to :mod:`repro_torch.core.comm.collectives` when the
communication subsystem became the composable Transport x Collective x
Codec API (DESIGN.md §12): the seed-era free functions are unchanged
(`allreduce`/`scatter_reduce` drive the byte-identical legacy paths), and
the new hierarchical two-level reduce lives alongside them.  New code
should import from :mod:`repro_torch.core.comm`.
"""
from repro_torch.core.comm.collectives import (  # noqa: F401
    PATTERNS, POLL, allreduce, scatter_reduce, two_level_reduce,
)

__all__ = ["PATTERNS", "POLL", "allreduce", "scatter_reduce",
           "two_level_reduce"]
