"""LM token pipeline: deterministic synthetic corpus + sharded batch iterator.

The port's copy of the JAX package's ``data/tokens.py`` (numpy only): the
same Zipf-distributed token stream with short-range bigram structure, so
the tokens and labels are byte-identical to the reference's for the same
``(vocab_size, seed, worker, num_workers, position)``.  The loader is
elastic: ``TokenStream(worker, num_workers)`` re-shards deterministically
when the worker count changes (a resume carries only ``position``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TokenStream:
    vocab_size: int
    seed: int = 0
    worker: int = 0
    num_workers: int = 1
    position: int = 0  # global sample counter (for elastic resume)

    def _sample_doc(self, rng: np.random.Generator, length: int) -> np.ndarray:
        v = self.vocab_size
        base = rng.zipf(1.3, size=length).astype(np.int64) % v
        # bigram structure: with p=0.5 the next token is a fixed hash of prev
        follow = (base * 2654435761 + 12345) % v
        coin = rng.random(length) < 0.5
        out = np.where(coin, np.roll(follow, 1), base)
        return out.astype(np.int32)

    def batch(self, batch_size: int, seq_len: int) -> dict:
        """Deterministic batch for (position, worker); advances position."""
        tokens = np.empty((batch_size, seq_len + 1), np.int32)
        for i in range(batch_size):
            gidx = self.position + i * self.num_workers + self.worker
            rng = np.random.default_rng((self.seed, gidx))
            tokens[i] = self._sample_doc(rng, seq_len + 1)
        self.position += batch_size * self.num_workers
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def state(self) -> dict:
        return {"position": self.position, "seed": self.seed}

    def restore(self, state: dict, worker: int, num_workers: int):
        self.position = int(state["position"])
        self.seed = int(state["seed"])
        self.worker = worker
        self.num_workers = num_workers


def lm_batches(vocab_size: int, batch_size: int, seq_len: int, steps: int,
               seed: int = 0):
    ts = TokenStream(vocab_size, seed)
    for _ in range(steps):
        yield ts.batch(batch_size, seq_len)
