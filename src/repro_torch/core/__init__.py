"""LambdaML core in PyTorch: the paper's design space as composable pieces.

- algorithms: GA-SGD / MA-SGD / ADMM / EM-kmeans (shared by every platform)
- comm:       Transport x Collective x Codec, composed by CommStack and
              selected with the "transport/collective/codec" grammar; the
              int8 and top-k codecs run the CUDA kernels of
              repro_torch.kernels on the card
- engine:     the discrete-event simulation core (clocks, failures, metering)
- sync:       BSP / ASP / SSP / LocalSGD-DiLoCo protocol objects
- platform:   the Platform protocol + FleetSpec / FailureSpec / CommSpec
- runtimes:   FaaSRuntime, IaaSRuntime and PodPlatform

The declarative layer (ExperimentSpec / run_experiment / presets / the
``python -m repro_torch run`` CLI) lives in :mod:`repro_torch.experiments`.
"""
from repro_torch.core.algorithms import (  # noqa: F401
    ADMM, Algorithm, EMKMeans, GASGD, MASGD, make_algorithm,
)
from repro_torch.core.comm import (  # noqa: F401
    Codec, Collective, CommStack, Transport, build_comm_stack, make_codec,
    make_collective, make_transport,
)
from repro_torch.core.engine import (  # noqa: F401
    FailureProcess, InjectedPreemptions, PoissonPreemptions, RunResult,
    SimContext, StragglerProcess, simulate,
)
from repro_torch.core.mlmodels import (  # noqa: F401
    StudyModel, make_study_model, model_bytes, params_from_numpy,
)
from repro_torch.core.platform import (  # noqa: F401
    BasePlatform, CommSpec, FailureSpec, FleetSpec, Platform,
)
from repro_torch.core.runtimes import FaaSRuntime, IaaSRuntime, PodPlatform  # noqa: F401
from repro_torch.core.sync import (  # noqa: F401
    ASP, BSP, SSP, LocalSGD, SyncProtocol, make_sync, sync_name,
)
