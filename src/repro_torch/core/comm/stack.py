"""Transport x Collective x Codec composed into one engine comm backend
(DESIGN.md §12).

:class:`CommStack` is the single implementation of the engine's
``CommBackend`` surface: it runs the collective over the transport on the
codec's wire form, advances the per-worker clocks (barrier or skew,
according to the collective), and meters time (``breakdown["comm"]``),
bytes (``RunResult.comm_bytes``: the WIRE payload, so codec compression
shows up exactly) and substrate dollars (``service_cost``) uniformly --
the three hardwired seed-era backends each re-implemented this.

``ChannelComm`` / ``PSComm`` / ``MPIComm`` remain as thin legacy adapters
over the composition (constructors unchanged, byte-identical results);
:func:`build_comm_stack` is what the platforms call to turn a resolved
``(transport, collective, codec)`` triple into a backend.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.comm.codecs import Codec, make_codec
from repro_torch.core.comm.collectives import Collective, make_collective, mean_of
from repro_torch.core.comm.transports import (
    DCN_BANDWIDTH, DCN_LATENCY, NETWORK_TRANSPORTS, StorageChannel, Transport,
    VMNetwork, VMParameterServer, make_transport,
)


class CommStack:
    """One composed communication stack; the engine's comm backend.

    - ``bsp_reduce(ctx, updates, tag)``: merge one BSP round, advancing
      ``ctx.clock`` and the comm meters; returns the merged vector.
    - ``kvstore()``: a metered key-value store (``put``/``get`` returning
      simulated seconds) holding the global model for ASP/SSP and the
      checkpoint blobs -- the transport itself, unless a side ``store``
      was given (the hybrid VM-PS keeps its global model on S3).
    - ``service_cost(seconds)``: $ for the communication substrate(s).
    """

    def __init__(self, transport: Transport, collective: Collective | str,
                 codec: Codec | str = "fp32", store=None):
        self.transport = transport
        self.collective = make_collective(collective)
        self.codec = make_codec(codec)
        self._store = store if store is not None else transport

    @property
    def name(self) -> str:
        """Canonical ``transport/collective/codec`` label."""
        return (f"{self.transport.spec.name}/{self.collective.name}"
                f"/{self.codec.name}")

    def bsp_reduce(self, ctx, updates, tag):
        codec = self.codec
        # pre-codec update size, for elastic resize feasibility checks
        # (validate_stack re-applies the codec's wire ratio itself)
        ctx.last_update_nbytes = int(updates[0].nbytes)
        if codec.is_identity:
            payloads, merged_lossy = updates, None
        else:
            # exact numerics from the dequantized/densified vectors (on the
            # engine's device); the collective runs on wire-sized host
            # stand-ins, whose size is all that is metered
            deq = [codec.encode_decode(i, u) for i, u in enumerate(updates)]
            merged_lossy = mean_of(deq)
            nw = codec.wire_floats(updates[0].numel())
            payloads = [torch.zeros(nw, dtype=torch.float32) for _ in updates]
        merged, times = self.collective.run(self.transport, payloads, tag)
        times = np.asarray(times, float)
        ctx.meter_add("comm", float(np.mean(times)))
        ctx.meter_bytes(float(payloads[0].nbytes))
        rec = ctx.rec
        if rec is not None and not codec.is_identity:
            rec.mark("codec", float(np.max(ctx.clock)), codec=self.codec.name,
                     raw_bytes=int(updates[0].nbytes),
                     wire_bytes=int(payloads[0].nbytes))
        if self.collective.barrier:
            base = float(np.max(ctx.clock))
            if rec is None:
                ctx.clock[:] = base + times
            else:
                # barrier semantics: wait to the fleet max (idle), then the
                # collective's per-worker comm seconds
                before = ctx.clock.copy()
                ctx.clock[:] = base + times
                meta = {"stack": self.name}
                for i in range(len(ctx.worker_ids)):  # times may be 0-d
                    wid = int(ctx.worker_ids[i])
                    rec.span(wid, "barrier", "idle", float(before[i]), base)
                    rec.span(wid, "comm.reduce", "comm", base,
                             float(ctx.clock[i]), meta=meta)
        else:
            if rec is None:
                ctx.clock += times
            else:
                before = ctx.clock.copy()
                ctx.clock += times
                rec.tile(ctx.worker_ids, before, ctx.clock, "comm.reduce",
                         "comm", meta={"stack": self.name})
        return merged if merged_lossy is None else merged_lossy

    def kvstore(self):
        return self._store

    def startup(self) -> float:
        """Seconds to provision the comm substrate (Table 6 ``startup``
        column: 0 for always-on S3/DynamoDB and NICs, ~2 min for an
        ElastiCache cluster, the VM boot for the hybrid PS).  Platforms
        fold this into their fleet startup via ``max``."""
        return self.transport.spec.startup

    def service_cost(self, seconds: float) -> float:
        c = float(self.transport.service_cost(seconds))
        if self._store is not self.transport:
            c += float(self._store.service_cost(seconds))
        return c

    def rebuilt(self) -> "CommStack":
        """Re-compose this stack for a resized fleet (DESIGN.md §13): the
        collective and codec are rebuilt fresh (error-feedback residuals
        are keyed by worker position, which a resize invalidates; the new
        codec allocates its residuals on the device of the first vector it
        encodes, the run's) while the TRANSPORT objects -- and with them
        the accumulated op counters, per-op dollars, and the ASP/SSP
        kvstore contents -- carry over, so ``service_cost`` keeps billing
        the whole run."""
        return CommStack(
            self.transport, self.collective.name, self.codec.name,
            store=None if self._store is self.transport else self._store)


# -------------------------------------------------------- legacy adapters ---

class ChannelComm(CommStack):
    """Pure-FaaS: a store-based collective's files on a storage channel
    (seed-era constructor preserved; now a :class:`CommStack`)."""

    def __init__(self, chan, pattern, codec="fp32"):
        super().__init__(chan, pattern, codec)
        self.chan = chan
        self.pattern = pattern if isinstance(pattern, str) else pattern.name


class PSComm(CommStack):
    """Hybrid (Cirrus): VM-hosted parameter server; S3 keeps checkpoints and
    the ASP/SSP global model (Table 2 costs bound the PS itself)."""

    def __init__(self, ps: VMParameterServer, chan: StorageChannel,
                 codec="fp32"):
        super().__init__(ps, "pushpull", codec, store=chan)
        self.ps = ps
        self.chan = chan


class MPIComm(CommStack):
    """IaaS/pod: ring AllReduce over NICs/DCN; worker 0 doubles as the
    in-memory key-value host for ASP/SSP (reached through the same metered
    network)."""

    def __init__(self, net: VMNetwork, codec="fp32"):
        super().__init__(net, "ring", codec)
        self.net = net


# ---------------------------------------------------------------- factory ---

def build_comm_stack(transport: str, collective: str, codec: str = "fp32", *,
                     nic: VMNetwork | None = None,
                     dcn: VMNetwork | None = None) -> CommStack:
    """Turn a resolved ``(transport, collective, codec)`` name triple into
    a backend.  Platforms pass their calibrated ``nic``/``dcn`` networks
    (per-fleet NIC speeds, per-pod DCN constants); everything else is
    instantiated from the registry.  The legacy adapter classes are used so
    ``isinstance``-based platform hooks (startup, checkpoint store) keep
    working unchanged."""
    if transport == "vmps":
        return PSComm(VMParameterServer(), StorageChannel("s3"), codec=codec)
    if transport in NETWORK_TRANSPORTS:
        if collective != "ring":
            net = (nic if transport == "nic" else dcn)
            net = net if net is not None else make_transport(transport)
            return ChannelComm(net, collective, codec=codec)
        if transport == "nic":
            return MPIComm(nic if nic is not None else make_transport("nic"),
                           codec=codec)
        return MPIComm(dcn if dcn is not None
                       else VMNetwork(DCN_BANDWIDTH, DCN_LATENCY, "dcn"),
                       codec=codec)
    return ChannelComm(StorageChannel(transport), collective, codec=codec)
