"""FaaS runtime (LambdaML) -- named entry point per DESIGN.md §5.

The platform adapter lives in :mod:`repro_torch.core.runtimes` (FaaS and
IaaS share the algorithm/partition/metering machinery; keeping them in one
module keeps the "same algorithm both sides" guarantee structural), and the
shared training loops live in the discrete-event engine
(:mod:`repro_torch.core.engine`, DESIGN.md §4) driven by the sync protocols
of :mod:`repro_torch.core.sync`.  This module is the documented import
surface:

    from repro_torch.core.faas import FaaSRuntime, LIFETIME

The serving half of the JAX package's surface (``KEEP_WARM_S``,
``ServingHooks``) is ROADMAP.md queue A5.
"""
from repro_torch.core.runtimes import (  # noqa: F401
    FaaSRuntime, LIFETIME, LIFETIME_MARGIN, RunResult, interp_startup,
)
