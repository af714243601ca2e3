"""Architecture registry: ``get_arch(name)`` / ``list_archs()``.

The port's own copy of the JAX package's ``configs`` (which it does not
import): each assigned architecture lives in its own module with two entry
points, ``CONFIG`` (the published configuration) and ``reduced()`` (a tiny
same-family variant for CPU tests).  The dataclasses and the config values
are copied verbatim; the ``ShardingRules`` and ``TrainConfig`` fields are
carried as data (the port's zoo runs on one card and does not train yet).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    ModelConfig,
    ShapeConfig,
    ShardingRules,
    SHAPES,
    TrainConfig,
)

ARCH_IDS = [
    "grok-1-314b",
    "deepseek-v2-lite-16b",
    "hubert-xlarge",
    "phi3-medium-14b",
    "llama3-405b",
    "stablelm-3b",
    "smollm-360m",
    "zamba2-2.7b",
    "mamba2-370m",
    "llama-3.2-vision-90b",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def spec_name(arch_id: str) -> str:
    """The spec-friendly model name of an arch id (``smollm-360m`` ->
    ``smollm_360m``)."""
    return arch_id.replace("-", "_").replace(".", "_")


def arch_key(name: str) -> str | None:
    """The arch id of a spec-friendly name or of an arch id itself; None if
    ``name`` is neither."""
    if name in _MODULES:
        return name
    return {spec_name(a): a for a in ARCH_IDS}.get(name)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name])


def get_arch(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ArchConfig:
    return _module(name).reduced()


def list_archs() -> list[str]:
    return list(ARCH_IDS)
