"""Batched serving: a prompt fed token by token, then greedy or temperature
sampling, through the model zoo's ``decode_step`` and its KV cache.

``Generator`` counts its ``decode_step`` calls (``decode_steps``) exactly as
the JAX package's does, and prices them under a :class:`LatencyModel`
(``simulated_latency_s``).  Temperature sampling draws from
``softmax(logits / T)`` with a ``torch.Generator`` seeded by ``seed``: it is
deterministic per seed but does not reproduce ``jax.random.categorical``'s
draws bit for bit.

Traffic-scale serving lives next door (DESIGN.md §14), numpy copies of
the JAX package's modules: open-loop arrival processes in
:mod:`repro_torch.serving.arrivals`, the analytic per-step
:class:`~repro_torch.serving.latency.LatencyModel`, and the request-driven
discrete-event simulator in :mod:`repro_torch.serving.sim`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import Model, build_model
from repro_torch.serving.arrivals import (  # noqa: F401
    ARRIVALS, ArrivalProcess, list_arrivals, make_arrivals,
)
from repro_torch.serving.latency import LatencyModel  # noqa: F401
from repro_torch.serving.sim import (  # noqa: F401
    ServingResult, ServingSMLT, make_autoscaler, provision_for, serve,
)


@dataclass
class Generator:
    """Serves ``arch`` with ``model`` (the port's :class:`Model`; None ->
    built from seed 0) on ``device`` (None -> the card; raises without
    one).  A model on another device is moved there."""
    arch: ArchConfig
    model: Model | None = None
    max_seq: int = 512
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if not self.arch.model.supports_decode:
            raise ValueError(f"{self.arch.name} is encoder-only: it cannot "
                             f"decode")
        if self.model is None:
            self.model = build_model(self.arch, device=self.device)
        self.model.to(self.device)
        self.decode_steps = 0     # calls to decode_step (parity with sim)

    def _decode(self, cache, token, pos: int):
        self.decode_steps += 1
        return self.model.decode_step(cache, token, pos)

    def simulated_latency_s(self, lat: LatencyModel) -> float:
        """Simulated seconds for the decode steps this Generator actually
        executed, under ``lat``'s per-step roofline."""
        return self.decode_steps * lat.step_s(1)

    def _prefill_loop(self, tokens: torch.Tensor):
        """Generic prefill: feed prompt tokens through decode_step.  The
        cache is made anew for every call, so one call never sees another's
        (it is updated in place).  As in the JAX package, a vlm's image
        K/V are not primed: it decodes against a zero image cache."""
        b, s = tokens.shape
        cache = self.model.init_cache(b, self.max_seq)
        logits = None
        for pos in range(s):
            logits, cache = self._decode(cache, tokens[:, pos], pos)
        return logits, cache, s

    @torch.no_grad()
    def generate(self, prompts, max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """prompts (b, s) int -> (b, s + max_new_tokens) int32 numpy."""
        prompts = torch.as_tensor(np.asarray(prompts, np.int32),
                                  device=self.device).long()
        b, s = prompts.shape
        if s + max_new_tokens > self.max_seq:
            raise ValueError(f"{s} prompt + {max_new_tokens} new tokens do "
                             f"not fit max_seq={self.max_seq}")
        logits, cache, pos = self._prefill_loop(prompts)
        out = [prompts]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for i in range(max_new_tokens):
            if temperature > 0:
                probs = torch.softmax(logits / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                tok = torch.argmax(logits, dim=-1)
            out.append(tok[:, None])
            logits, cache = self._decode(cache, tok, pos + i)
        return torch.cat(out, dim=1).to(torch.int32).cpu().numpy()


@torch.no_grad()
def perplexity(model: Model, tokens) -> float:
    """Teacher-forced ppl via the training forward (consistency checks).
    Tokens only, as in the JAX package: a vlm's forward wants
    ``image_embeds`` and raises ``KeyError``."""
    tokens = torch.as_tensor(np.asarray(tokens), device=model.device).long()
    loss, _ = model.loss({"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
    return float(torch.exp(loss))
