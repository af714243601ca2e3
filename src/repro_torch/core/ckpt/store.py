"""The :class:`Checkpointer`: metered, sharded checkpoint save/restore.

One object per simulated run, wrapping the platform's checkpoint store
(the comm channel itself on FaaS, a dedicated :class:`StorageChannel` on
IaaS/pods or whenever ``CheckpointSpec.transport`` pins one).  Every save
and restore ships REAL shard payloads through the store's metered
``put``/``get`` -- so checkpoint seconds land on the worker clocks, wire
bytes and request $ accumulate here for :class:`RunResult`, and per-item
limits fire exactly like comm traffic does.

Default-spec parity contract: with ``CheckpointSpec()`` and one shard the
op sequence (keys, payload sizes, put/get order) is byte-identical to the
engine's inline rotate path, so no-failure fixed-seed runs reproduce the
runs that predate checkpoint specs exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from repro_torch.core.ckpt.spec import CheckpointSpec, shard_sizes


@dataclass
class Checkpointer:
    """Routes checkpoint bytes through a metered transport and accounts
    for them (wire bytes, transfer seconds, request $) separately from the
    comm meters -- the FaaS default store is SHARED with comm traffic, so
    the split has to happen at this layer."""
    spec: CheckpointSpec
    store: Any                # metered put/get with a .spec ChannelSpec
    mbytes: int               # model checkpoint payload (fp32 bytes)
    shards: int = 1           # fixed at run start (initial fleet width)
    wire_bytes: float = 0.0   # checkpoint bytes moved (puts + gets)
    time_s: float = 0.0       # simulated transfer seconds (puts + gets)
    op_usd: float = 0.0       # request $ (puts + gets)
    puts: int = 0
    gets: int = 0
    last_ckpt_t: float = 0.0  # sim time of the last fleet checkpoint
    _last_save_rnd: int = 0
    rec: Any = None           # TraceRecorder (DESIGN.md §18): every shard
                              # put/get lands one "ckpt" byte event, in the
                              # exact order wire_bytes accumulates

    @property
    def every(self) -> int:
        return self.spec.every

    def _op_price(self, kind: str) -> float:
        ch = getattr(self.store, "spec", None)
        return float(getattr(ch, f"{kind}_cost", 0.0)) if ch else 0.0

    def _blobs(self, key: str) -> list:
        sizes = shard_sizes(self.mbytes, self.shards)
        if len(sizes) == 1:
            return [(key, np.zeros(sizes[0] // 4, np.float32))]
        return [(f"{key}/s{j}", np.zeros(n // 4, np.float32))
                for j, n in enumerate(sizes)]

    def save(self, key: str) -> float:
        """Put every shard under ``key``; returns the (sequential-stream)
        simulated seconds the saving worker stalls."""
        dt = 0.0
        for k, blob in self._blobs(key):
            dt += self.store.put(k, blob)
            self.wire_bytes += blob.nbytes
            self.op_usd += self._op_price("put")
            self.puts += 1
            if self.rec is not None:
                self.rec.bytes_event("ckpt", blob.nbytes,
                                     meta={"op": "put", "key": k})
        self.time_s += dt
        return dt

    def restore(self, key: str) -> float:
        """Get every shard back; returns the simulated restore seconds."""
        dt = 0.0
        for k, blob in self._blobs(key):
            _, d = self.store.get(k)
            dt += d
            self.wire_bytes += blob.nbytes
            self.op_usd += self._op_price("get")
            self.gets += 1
            if self.rec is not None:
                self.rec.bytes_event("ckpt", blob.nbytes,
                                     meta={"op": "get", "key": k})
        self.time_s += dt
        return dt

    # ---- cadence (CheckpointSpec.every) -------------------------------------
    def due(self, rnd: int) -> bool:
        """True when a periodic fleet save is owed at sync round ``rnd``
        (rounds-since-last-save accounting, so LocalSGD's sparse boundaries
        still checkpoint at roughly the requested cadence)."""
        return self.every > 0 and (rnd - self._last_save_rnd) >= self.every

    def mark(self, rnd: int, t: float) -> None:
        """Record that a fleet checkpoint landed at round ``rnd``, sim
        time ``t`` (what preemption rework is measured against)."""
        self._last_save_rnd = int(rnd)
        self.last_ckpt_t = float(t)
