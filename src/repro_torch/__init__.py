"""``repro_torch``: the PyTorch port of the LambdaML reproduction.

The JAX package ``repro`` is the reference; this package runs the same
simulator training path (study models, GA-SGD/MA-SGD/ADMM/EM, BSP/SSP/
LocalSGD, FaaS/IaaS/pod platforms, comm stack, checkpoints, tracing) and
the dense half of the model zoo with its serving path (``models``,
``serving.Generator``, ``perplexity``) in PyTorch, with the wire codecs'
and the attention kernels written by hand in CUDA for Hopper.  It imports
neither ``jax`` nor anything of ``repro``.

Entry points run on the card unless the caller passes ``device="cpu"``:
``repro_torch.experiments.run_experiment(spec, device=None)``, the
platforms' ``.train(..., device=None)``,
``python -m repro_torch run <preset|spec.json> [--device cpu]``,
``models.build_model(arch, device=None)``,
``serving.Generator(arch, model=None, device=None)`` and
``python -m repro_torch.launch.serve [--device cpu]``.
"""
from repro_torch.device import resolve_device  # noqa: F401
