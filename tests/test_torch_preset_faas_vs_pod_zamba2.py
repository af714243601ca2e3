"""The ``faas_vs_pod`` preset (quick) through the port on the CPU against
the JAX package, trial by trial, with zamba2-2.7b (reduced) as the trials'
model in both packages, in fp32 (the config's dtype replaced in both; the
tests live in ``_torch_arch_preset.py``, which says why not bf16)."""
from _torch_arch_preset import *  # noqa: F401,F403 -- its tests and fixtures

PRESET = "faas_vs_pod"
MODEL = "zamba2_2_7b"
DTYPE = "float32"
