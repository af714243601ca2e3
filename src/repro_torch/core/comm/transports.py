"""The **Transport** axis of the communication design space (DESIGN.md §12).

A transport is *where update bytes physically move*: a storage service
(S3, ElastiCache-Memcached/Redis, DynamoDB -- the FaaS channels of §3.2.2),
a VM NIC mesh, the cross-pod data-center network, or the hybrid VM-hosted
parameter server of Table 2.  Every transport moves REAL payloads -- fp32
tensors on the engine's device, or wire-sized stand-ins -- so convergence
is exact, while charging *simulated* time/cost from the paper's
measured constants (Table 6) -- the same methodology as the paper's
analytical model, applied per operation.

The uniform surface (runtime-checkable :class:`Transport`):

- ``put(key, payload) -> sim_seconds`` / ``get(key) -> (payload, seconds)``
  -- a metered key-value store (collectives build reductions out of these),
- ``service_cost(seconds) -> $`` -- what the substrate itself bills,
- ``spec`` -- the :class:`ChannelSpec` constants (bandwidth, latency,
  startup, item limit, prices) that the analytical model (§5.3) reads from
  the SAME source the simulator meters with.

Transports compose with any :mod:`repro_torch.core.comm.collectives` collective
and any :mod:`repro_torch.core.comm.codecs` codec through
:class:`repro_torch.core.comm.stack.CommStack`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Protocol, runtime_checkable

from repro_torch.core import cost as pricing

#: VM NIC defaults (t2.medium, Table 6 "B_n"/"L_n" row) -- per-instance
#: overrides live in repro_torch.core.runtimes.B_NET/L_NET
NIC_BANDWIDTH = 120e6
NIC_LATENCY = 5e-4

#: cross-pod data-center network: per-pod egress bandwidth and latency
#: (intra-pod ICI is never metered -- it rides the MFU discount, §11)
DCN_BANDWIDTH = 25e9
DCN_LATENCY = 1e-3

#: instance-attached EBS (gp2) volume: sequential bandwidth and access
#: latency (Table 6 methodology) -- the measured source for BOTH the
#: analytical model's local-disk terms (B_EBS/L_EBS) and the checkpoint
#: subsystem's ``local`` backend (repro_torch.core.ckpt)
EBS_BANDWIDTH = 1950e6
EBS_LATENCY = 3e-5


class ChannelItemTooLarge(ValueError):
    """A payload exceeds the transport's per-item limit (DynamoDB's 400 KB
    -> the "N/A" cells of Table 1).  Raised eagerly by
    :meth:`repro_torch.core.platform.CommSpec.validate` at spec time and, as a
    backstop, by :meth:`StorageChannel.put` mid-simulation."""


@dataclass(frozen=True)
class ChannelSpec:
    """Measured constants for one communication substrate (Table 6
    methodology, DESIGN.md §3): per-op time = ``latency + size / bandwidth``.

    ``large_item_slowdown`` models a single-threaded value server: for items
    over 10 MB the effective bandwidth is divided by this factor.  The paper
    observes this for Redis (§4.3) -- one event-loop thread serializes big
    GET/SET payloads, so Redis falls behind the otherwise identically-priced
    Memcached once update vectors reach CNN sizes, while staying on par for
    the small linear models of Table 1.
    """
    name: str
    bandwidth: float                 # bytes/s per worker stream
    latency: float                   # s per op
    startup: float                   # s to provision the service
    max_item: Optional[int] = None   # bytes; None = unlimited
    hourly_cost: float = 0.0
    put_cost: float = 0.0            # $ per op
    get_cost: float = 0.0
    large_item_slowdown: float = 1.0  # >1: single-threaded server (Redis)


# Table 6 (+ §4.3 observations), row by row:
CHANNEL_SPECS = {
    # Table 6 "S3" row: B_S3 = 65 MB/s per stream, L_S3 = 80 ms per request;
    # no provisioning (always-on service), request-priced (no hourly $).
    "s3": ChannelSpec("s3", 65e6, 8e-2, 0.0, None, 0.0,
                      pricing.S3_PUT, pricing.S3_GET),
    # Table 6 "ElastiCache" row, cache.t3.medium: B_EC = 630 MB/s,
    # L_EC = 10 ms; ~2-minute cluster provisioning; hourly-priced.
    "memcached": ChannelSpec("memcached", 630e6, 1e-2, 130.0, None,
                             pricing.ELASTICACHE_HOURLY["cache.t3.medium"]),
    # Table 6 "ElastiCache" row, cache.m5.large: 2x the t3.medium bandwidth
    # (1260 MB/s) at ~2.3x the hourly price.
    "memcached_large": ChannelSpec("memcached_large", 1260e6, 1e-2, 130.0,
                                   None,
                                   pricing.ELASTICACHE_HOURLY["cache.m5.large"]),
    # Same ElastiCache constants as memcached (same service class), plus the
    # §4.3 single-threaded-server penalty on > 10 MB items (see ChannelSpec).
    "redis": ChannelSpec("redis", 630e6, 1e-2, 130.0, None,
                         pricing.ELASTICACHE_HOURLY["cache.t3.medium"],
                         large_item_slowdown=2.0),
    # Table 1 + §4.3: bandwidth/latency calibrated so small-model rounds run
    # ~20% faster than S3 (Table 1 slowdown 0.81-0.93 vs S3); the 400 KB
    # item limit makes models > 400 KB infeasible exactly as the paper
    # reports ("N/A" cells of Table 1); on-demand request pricing.
    "dynamodb": ChannelSpec("dynamodb", 81e6, 6.2e-2, 0.0, 400_000, 0.0,
                            put_cost=pricing.DYNAMODB_PER_MREQ / 1e6,
                            get_cost=pricing.DYNAMODB_PER_MREQ / 4e6),
}

def nbytes(payload) -> int:
    """Metered size of a payload (a tensor, an array, or a sequence of
    them): transports meter by size only."""
    if hasattr(payload, "nbytes"):
        return int(payload.nbytes)
    return sum(int(p.nbytes) for p in payload)


def xfer_seconds(spec: ChannelSpec, size: int) -> float:
    """Per-op transfer seconds for ``size`` bytes over ``spec`` -- the ONE
    formula both the metered :class:`StorageChannel` and the closed-form
    consumers (derived restarts in :mod:`repro_torch.core.ckpt`, the analytical
    model) evaluate, so they can never disagree."""
    bw = spec.bandwidth
    if size > 10e6 and spec.large_item_slowdown > 1:
        bw /= spec.large_item_slowdown
    return spec.latency + size / bw


@runtime_checkable
class Transport(Protocol):
    """The metering surface every substrate exposes (DESIGN.md §12)."""

    @property
    def spec(self) -> ChannelSpec: ...

    def put(self, key: str, payload) -> float:
        """Store ``payload``; return simulated seconds for the operation."""
        ...

    def get(self, key: str):
        """-> ``(payload, simulated_seconds)``."""
        ...

    def service_cost(self, seconds: float) -> float:
        """$ billed by the substrate itself over ``seconds`` of wall time."""
        ...


class StorageChannel:
    """In-memory store with a simulated (time, $) meter."""

    def __init__(self, spec: ChannelSpec | str):
        self.spec = CHANNEL_SPECS[spec] if isinstance(spec, str) else spec
        self.store: dict[str, Any] = {}
        self.op_cost = 0.0            # accumulated $ for requests
        self.ops = {"put": 0, "get": 0, "list": 0}

    # each op returns simulated seconds
    def _xfer(self, size: int) -> float:
        return xfer_seconds(self.spec, size)

    def put(self, key: str, payload: Any) -> float:
        size = nbytes(payload)
        if self.spec.max_item and size > self.spec.max_item:
            raise ChannelItemTooLarge(
                f"{self.spec.name}: item {size}B > limit {self.spec.max_item}B")
        self.store[key] = payload
        self.ops["put"] += 1
        self.op_cost += self.spec.put_cost
        return self._xfer(size)

    def get(self, key: str) -> tuple[Any, float]:
        payload = self.store[key]
        self.ops["get"] += 1
        self.op_cost += self.spec.get_cost
        return payload, self._xfer(nbytes(payload))

    def list(self, prefix: str) -> tuple[list[str], float]:
        self.ops["list"] += 1
        self.op_cost += self.spec.get_cost
        return [k for k in self.store if k.startswith(prefix)], self.spec.latency

    def delete(self, key: str) -> float:
        self.store.pop(key, None)
        return 0.0

    def service_cost(self, seconds: float) -> float:
        return self.spec.hourly_cost / 3600.0 * seconds + self.op_cost


class VMNetwork:
    """Metered point-to-point VM network + in-memory key-value host.

    Implements the same metering interface as :class:`StorageChannel`
    (``put``/``get`` return simulated seconds, op counters accumulate) so the
    discrete-event engine can treat "files on S3" and "tensors over a NIC"
    uniformly (DESIGN.md §4.3).  ``put``/``get`` model a worker exchanging a
    payload with the key-value host (worker 0) over one NIC stream;
    ``allreduce_time`` is the paper's ring model for the BSP collective.
    The network itself bills nothing -- NICs come with the instances.
    """

    def __init__(self, bandwidth: float, latency: float, name: str = "nic"):
        self.bandwidth = bandwidth
        self.latency = latency
        self.name = name
        self.store: dict[str, Any] = {}
        self.ops = {"put": 0, "get": 0}

    @property
    def spec(self) -> ChannelSpec:
        """Constants view in the shared :class:`ChannelSpec` shape."""
        return ChannelSpec(self.name, self.bandwidth, self.latency, 0.0)

    def _xfer(self, size: int) -> float:
        return self.latency + size / self.bandwidth

    def put(self, key: str, payload: Any) -> float:
        self.store[key] = payload
        self.ops["put"] += 1
        return self._xfer(nbytes(payload))

    def get(self, key: str) -> tuple[Any, float]:
        payload = self.store[key]
        self.ops["get"] += 1
        return payload, self._xfer(nbytes(payload))

    def allreduce_time(self, size: int, workers: int) -> float:
        """MPI ring AllReduce (paper model): ``(2w-2) * (m/w/Bn + Ln)``."""
        if workers <= 1:
            return 0.0
        return (2 * workers - 2) * (size / workers / self.bandwidth
                                    + self.latency)

    def service_cost(self, seconds: float) -> float:
        return 0.0


@dataclass
class VMParameterServer:
    """Hybrid design (Cirrus): a VM-hosted PS reached from Lambda via gRPC.

    Table 2 model: a 3GB Lambda moves 75 MB in ~1.85 s to c5.4xlarge (~40.5
    MB/s effective incl. serialization), with ~2x contention at 10 workers;
    the server-side model update costs ~2.7 s per worker per 75 MB (lock +
    apply), which is what bounds the hybrid design (§4.3).
    """
    instance: str = "c5.4xlarge"
    n_servers: int = 1
    startup: float = 40.0              # VM boot (no job dispatch needed)
    base_bw: float = 40.5e6
    update_unit: float = 2.7 / 75e6    # s per byte per worker

    store: dict = field(default_factory=dict)

    @property
    def spec(self) -> ChannelSpec:
        return ChannelSpec("vmps", self.base_bw, 0.0, self.startup)

    # metered single-stream kv ops (the Transport surface; the push/pull
    # round below is what the BSP collective actually uses)
    def put(self, key: str, payload: Any) -> float:
        self.store[key] = payload
        return self.transfer_time(nbytes(payload), 1)

    def get(self, key: str) -> tuple[Any, float]:
        payload = self.store[key]
        return payload, self.transfer_time(nbytes(payload), 1)

    def transfer_time(self, size: int, workers: int) -> float:
        contention = 1.0 + (workers - 1) / 9.0
        return size / self.base_bw * contention / self.n_servers

    def update_time(self, size: int, workers: int) -> float:
        # serialization/locking on the PS, scales with workers (Table 2)
        return self.update_unit * size * workers / self.n_servers

    def push_pull_round(self, size: int, workers: int) -> float:
        """push grads + server update + pull model (per worker wall time)."""
        return (2 * self.transfer_time(size, workers)
                + self.update_time(size, workers))

    def hourly_cost(self) -> float:
        return pricing.EC2_HOURLY[self.instance] * self.n_servers

    def service_cost(self, seconds: float) -> float:
        return pricing.ec2_cost(self.instance, seconds, self.n_servers)


# ----------------------------------------------------------------- registry --

#: non-storage transport constants, same ChannelSpec shape so the analytical
#: model and spec-time validation read every substrate uniformly -- derived
#: from the implementations' own defaults (no second copy of Table 2)
NETWORK_SPECS = {
    "nic": ChannelSpec("nic", NIC_BANDWIDTH, NIC_LATENCY, 0.0),
    "dcn": ChannelSpec("dcn", DCN_BANDWIDTH, DCN_LATENCY, 0.0),
    "vmps": VMParameterServer().spec,
}


def _make_nic(bandwidth: float = NIC_BANDWIDTH,
              latency: float = NIC_LATENCY) -> VMNetwork:
    return VMNetwork(bandwidth, latency, "nic")


def _make_dcn(bandwidth: float = DCN_BANDWIDTH,
              latency: float = DCN_LATENCY) -> VMNetwork:
    return VMNetwork(bandwidth, latency, "dcn")


#: every selectable transport: name -> zero-config factory
TRANSPORTS = {
    **{name: (lambda n: (lambda: StorageChannel(n)))(name)
       for name in CHANNEL_SPECS},
    "vmps": VMParameterServer,
    "nic": _make_nic,
    "dcn": _make_dcn,
}

#: transports that are storage services (FaaS channels, Tables 1/6)
STORAGE_TRANSPORTS = tuple(CHANNEL_SPECS)

#: transports that are point-to-point networks (ring collectives)
NETWORK_TRANSPORTS = ("nic", "dcn")


def make_transport(name: str, **kw) -> Transport:
    """Instantiate a transport by registry name (``s3``, ``memcached``,
    ``memcached_large``, ``redis``, ``dynamodb``, ``vmps``, ``nic``,
    ``dcn``).  ``nic``/``dcn``/``vmps`` accept constructor overrides."""
    try:
        factory = TRANSPORTS[name]
    except KeyError:
        raise KeyError(f"unknown transport {name!r}; available: "
                       f"{', '.join(sorted(TRANSPORTS))}") from None
    return factory(**kw) if kw else factory()


def transport_constants(name: str) -> ChannelSpec:
    """The Table 6 constants for any transport, WITHOUT instantiating it --
    the single source the analytical model (§5.3) and spec-time validation
    (:meth:`repro_torch.core.platform.CommSpec.validate`) both read."""
    if name in CHANNEL_SPECS:
        return CHANNEL_SPECS[name]
    try:
        return NETWORK_SPECS[name]
    except KeyError:
        raise KeyError(f"unknown transport {name!r}; available: "
                       f"{', '.join(sorted(TRANSPORTS))}") from None


def list_transports() -> list[str]:
    return sorted(TRANSPORTS)
