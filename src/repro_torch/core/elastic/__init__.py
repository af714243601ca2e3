"""Elastic fleet control (DESIGN.md §13): scaling policies, mid-run
resizing, and the analytic planner.

Every run in the repo used to pin ``FleetSpec.workers`` for its whole
lifetime; this package lets the width change at sync boundaries under a
runtime-checkable :class:`ScalingPolicy` -- the SMLT/MLLess adaptive-
serverless-training axis (PAPERS.md) on top of the paper's design space:

- :mod:`repro_torch.core.elastic.telemetry`  -- the per-boundary observation
  (:class:`Telemetry`) policies decide from,
- :mod:`repro_torch.core.elastic.policies`   -- the policy registry
  (``static`` / ``schedule:<w@round,...>`` / ``smlt`` /
  ``cost_cap:<dollars>``) and the engine-facing
  :class:`ElasticController`,
- :mod:`repro_torch.core.elastic.planner`    -- the §5.3 analytical model as a
  decision subsystem (:func:`plan`), behind ``python -m repro_torch plan`` and
  ``ExperimentSpec(scaling="plan")``.

Select a policy anywhere a platform is built:
``ExperimentSpec(scaling="schedule:2@0,8@5")``,
``FaaSRuntime(scaling="smlt")``, or pass a policy instance.  The default
``scaling="static"`` maps to NO controller: the engine takes the exact
pre-elastic code path (parity-pinned in ``tests/test_torch_elastic.py``).
"""
from repro_torch.core.elastic.planner import (  # noqa: F401
    DEFAULT_WORKERS, PAPER_WORKLOADS, PlanOption, as_cost_inputs, plan,
    plan_initial_workers,
)
from repro_torch.core.elastic.policies import (  # noqa: F401
    MAX_FLEET, POLICIES, CostCapPolicy, ElasticController, SchedulePolicy,
    ScalingPolicy, SMLTPolicy, StaticPolicy, build_controller, list_policies,
    make_policy, validate_scaling,
)
from repro_torch.core.elastic.telemetry import (  # noqa: F401
    ServingTelemetry, Telemetry,
)
