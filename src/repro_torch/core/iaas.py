"""IaaS runtime (distributed-PyTorch-style VM cluster) -- named entry point
per DESIGN.md §5; platform adapter in :mod:`repro_torch.core.runtimes`,
shared training loops in the discrete-event engine (DESIGN.md §4).

Spot fleets (``IaaSRuntime(spot=True, ...)``) and heterogeneous fleets
(``instance=("c5.large", "t2.medium", ...)``) are configured here too --
see DESIGN.md §7.
"""
from repro_torch.core.runtimes import IaaSRuntime, RunResult  # noqa: F401
