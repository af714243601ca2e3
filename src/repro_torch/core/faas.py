"""FaaS runtime (LambdaML) -- named entry point per DESIGN.md §5.

The platform adapter lives in :mod:`repro_torch.core.runtimes` (FaaS and
IaaS share the algorithm/partition/metering machinery; keeping them in one
module keeps the "same algorithm both sides" guarantee structural), and the
shared training loops live in the discrete-event engine
(:mod:`repro_torch.core.engine`, DESIGN.md §4) driven by the sync protocols
of :mod:`repro_torch.core.sync`.  This module is the documented import
surface:

    from repro_torch.core.faas import FaaSRuntime, LIFETIME

Serving reuses the same measured constants: ``KEEP_WARM_S`` (sandbox
warm-pool retention) and ``ServingHooks`` (the per-platform serving
contract, DESIGN.md §14) are re-exported here because the serving simulator
documents its FaaS cold starts as "drawn from core/faas.py".
"""
from repro_torch.core.runtimes import (  # noqa: F401
    FaaSRuntime, KEEP_WARM_S, LIFETIME, LIFETIME_MARGIN, RunResult,
    ServingHooks, interp_startup,
)
