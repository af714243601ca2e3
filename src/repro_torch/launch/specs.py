"""Input stand-ins for every (arch x shape) cell, and small concrete
batches.

``input_specs`` gives the inputs of the step a shape runs as tensors on
the ``meta`` device (shape and dtype, no storage), where the JAX package
gives ``ShapeDtypeStruct``: a train or prefill shape -> the batch; a decode
shape -> one token, its position and the decode cache (``init_cache`` on
``meta``).  ``make_batch`` draws a concrete batch from numpy exactly as the
JAX package's does, value for value: frames, then labels, then mask for
an encoder; tokens, then labels, then (vlm) image embeddings otherwise.
Frames and image embeddings are bf16, rounded from numpy's float64 normals
through fp32, as ``jnp.asarray(x, jnp.bfloat16)`` rounds them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm

META = torch.device("meta")


def _train_like_specs(arch: ArchConfig, batch: int, seq: int) -> dict:
    m = arch.model

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)

    if m.is_encoder:
        return {"frames": meta((batch, seq, m.d_model), torch.bfloat16),
                "labels": meta((batch, seq), torch.int32),
                "mask": meta((batch, seq), torch.bool)}
    out = {"tokens": meta((batch, seq), torch.int32),
           "labels": meta((batch, seq), torch.int32)}
    if m.family == "vlm":
        out["image_embeds"] = meta((batch, m.num_image_tokens, m.d_model),
                                   torch.bfloat16)
    return out


def input_specs(arch: ArchConfig, shape: ShapeConfig | str) -> dict:
    """Inputs for the step that this shape runs (train/prefill -> batch;
    decode -> token + pos + cache), on the ``meta`` device."""
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    if sh.kind in ("train", "prefill"):
        return {"batch": _train_like_specs(arch, sh.global_batch, sh.seq_len)}
    # decode: one new token against a cache of seq_len
    return {
        "cache": tfm.init_cache(arch.model, sh.global_batch, sh.seq_len,
                                device=META),
        "token": torch.empty((sh.global_batch,), dtype=torch.int32,
                             device=META),
        "pos": torch.empty((), dtype=torch.int32, device=META),
    }


def _bf16(x: np.ndarray) -> torch.Tensor:
    """float64 normals -> bf16 through fp32 (two roundings, as JAX's)."""
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def make_batch(arch: ArchConfig, batch: int, seq: int, seed: int = 0,
               device=None) -> dict:
    """Concrete random batch (smoke tests) on ``device`` (None -> the card;
    raises without one)."""
    dev = resolve_device(device)
    m = arch.model
    rng = np.random.default_rng(seed)

    def i32(x):
        return torch.from_numpy(x.astype(np.int32))

    if m.is_encoder:
        out = {"frames": _bf16(rng.standard_normal((batch, seq, m.d_model))),
               "labels": i32(rng.integers(0, m.vocab_size, (batch, seq))),
               "mask": torch.from_numpy(rng.random((batch, seq)) < 0.5)}
    else:
        out = {"tokens": i32(rng.integers(0, m.vocab_size, (batch, seq))),
               "labels": i32(rng.integers(0, m.vocab_size, (batch, seq)))}
        if m.family == "vlm":
            out["image_embeds"] = _bf16(rng.standard_normal(
                (batch, m.num_image_tokens, m.d_model)))
    return {k: v.to(dev) for k, v in out.items()}
