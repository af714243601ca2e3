"""The ``faas_vs_pod`` preset (quick) through the port on the CPU against
the JAX package, trial by trial, with deepseek-v2-lite-16b (reduced) as the trials'
model in both packages, in fp32 (the config's dtype replaced in both; the
tests live in ``_torch_arch_preset.py``, which says why not bf16)."""
from _torch_arch_preset import *  # noqa: F401,F403 -- its tests and fixtures

PRESET = "faas_vs_pod"
MODEL = "deepseek_v2_lite_16b"
DTYPE = "float32"
