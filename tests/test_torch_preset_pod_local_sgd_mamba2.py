"""The ``pod_local_sgd`` preset (quick) through the port on the CPU against
the JAX package, trial by trial, with mamba2-370m (reduced, bf16) as the
trials' model in both packages (the tests live in
``_torch_arch_preset.py``)."""
from _torch_arch_preset import *  # noqa: F401,F403 -- its tests and fixtures

PRESET = "pod_local_sgd"
MODEL = "mamba2_370m"
