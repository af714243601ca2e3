"""Model zoo public API: ``Model`` (an ``nn.Module`` holding the parameter
tree), ``build_model`` (seeded init on a device) and ``params_from_numpy``
(the JAX package's parameters carried across, for parity checks)."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (
    DTYPES, init_params, is_spec, param_count,
)


class _ParamTree(nn.Module):
    """A nested dict of tensors as a module tree (dicts become submodules,
    tensors frozen parameters), so ``.to()``, ``state_dict()`` and
    ``parameters()`` see every leaf under its JAX path."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, _ParamTree(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def tree(self) -> dict:
        out = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class Model(nn.Module):
    """One zoo architecture and its parameters.  The methods are the JAX
    ``Model``'s, with the parameters held instead of passed."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.weights = _ParamTree(params)

    @property
    def params(self) -> dict:
        return self.weights.tree()

    @property
    def device(self) -> torch.device:
        return self.weights.final_norm.device      # every family has one

    @property
    def spec(self):
        return tfm.model_spec(self.cfg)

    def param_count(self) -> int:
        return param_count(self.spec)

    def forward(self, batch, *, last_only=False):
        return tfm.forward(self.params, batch, self.cfg, last_only=last_only)

    def loss(self, batch):
        return tfm.loss_fn(self.params, batch, self.cfg)

    def init_cache(self, batch: int, max_seq: int):
        return tfm.init_cache(self.cfg, batch, max_seq, device=self.device)

    def decode_step(self, cache, token, pos: int):
        return tfm.decode_step(self.params, cache, token, pos, self.cfg)

    def prefill(self, batch, max_seq=None):
        return tfm.prefill(self.params, batch, self.cfg, max_seq=max_seq)

    def prime_cross_cache(self, cache, image_embeds):
        return tfm.prime_cross_cache(self.params, cache, image_embeds,
                                     self.cfg)


def _cfg(arch: ArchConfig | ModelConfig) -> ModelConfig:
    return arch.model if isinstance(arch, ArchConfig) else arch


def build_model(arch: ArchConfig | ModelConfig, *, device=None,
                seed: int = 0) -> Model:
    """The model with parameters drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (None -> the card; raises without one)."""
    cfg = _cfg(arch)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        params = init_params(gen, tfm.model_spec(cfg), cfg.dtype, device=dev)
    return Model(cfg, params)


def params_from_numpy(tree: dict, arch: ArchConfig | ModelConfig,
                      device=None) -> Model:
    """The JAX package's parameter tree (nested dicts of numpy arrays, its
    keys, stacked ``(L, ...)`` leaves) as the port's ``Model`` with exactly
    those values.  Every leaf's shape is checked against the spec; a
    missing or left-over leaf raises."""
    cfg = _cfg(arch)
    dev = resolve_device(device)
    dt = DTYPES[cfg.dtype]

    def walk(spec, got, path):
        if is_spec(spec):
            arr = np.asarray(got)
            if tuple(arr.shape) != spec[0]:
                raise ValueError(f"{path}: shape {arr.shape}, the spec "
                                 f"wants {spec[0]}")
            return torch.from_numpy(arr.astype(np.float32)).to(dt).to(dev)
        if not isinstance(got, dict):
            raise ValueError(f"{path}: want a dict of leaves, got "
                             f"{type(got).__name__}")
        missing, extra = spec.keys() - got.keys(), got.keys() - spec.keys()
        if missing or extra:
            raise ValueError(f"{path or 'params'}: missing {sorted(missing)}, "
                             f"left over {sorted(extra)}")
        return {k: walk(spec[k], got[k], f"{path}/{k}".lstrip("/"))
                for k in spec}

    return Model(cfg, walk(tfm.model_spec(cfg), tree, ""))
