"""The checkpoint axis: :class:`CheckpointSpec` + its transport registry.

A checkpoint spec picks *where* checkpoints live (a metered transport from
the comm registry's storage channels, or the instance-local EBS disk), *how
often* the fleet saves (``every=N`` sync rounds; 0 keeps the save-at-kill
semantics of the seed engine), and *how* the model is laid out (``sharded``
splits it one shard per worker -- which is also what makes models larger
than a transport's per-item limit feasible, e.g. DynamoDB's 400 KB).

String grammar (same registry conventions as comm/sync/scaling/arrivals,
``repro list`` prints it, parse/name round-trip under R002)::

    <transport>[:every=<N>][:sharded]      e.g. "s3:every=5:sharded"
    every=<N>[:sharded]                    platform-default store + cadence

Everything downstream -- the engine's metered save/restore
(:class:`repro_torch.core.ckpt.store.Checkpointer`), the platforms' derived
``restart_time(model_bytes)``, the planner's restart term, serving's
scale-up weight pulls -- reads the SAME :class:`ChannelSpec` constants, so
a checkpoint second is traceable to the same Table 6 sources as a comm
second.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.comm.transports import (
    CHANNEL_SPECS, EBS_BANDWIDTH, EBS_LATENCY, ChannelItemTooLarge,
    ChannelSpec, StorageChannel, xfer_seconds,
)

#: the "local" backend: instance-attached EBS disk (the B_EBS/L_EBS row the
#: analytical model always used).  Registered ONLY here -- a local disk is
#: not a fleet-wide comm substrate, so ``CommSpec(channel="local")`` stays
#: invalid while ``ckpt="local:every=5"`` works on every platform.
LOCAL_SPEC = ChannelSpec("local", EBS_BANDWIDTH, EBS_LATENCY, 0.0)

#: every selectable checkpoint transport: the comm registry's storage
#: channels plus the local-disk backend (one source of truth -- no second
#: copy of the Table 6 constants)
CKPT_TRANSPORTS: dict[str, ChannelSpec] = {**CHANNEL_SPECS,
                                           "local": LOCAL_SPEC}

_GRAMMAR = "[:every=<N>][:sharded]"


def shard_sizes(model_bytes: int, shards: int) -> list[int]:
    """Byte size of each checkpoint shard.  This is the SAME split the
    metered save/restore ships (fp32 words, last shard takes the
    remainder), so closed-form restart times equal metered ones exactly."""
    words = max(int(model_bytes) // 4, 1)
    if shards <= 1:
        return [4 * words]
    per = -(-words // shards)          # ceil-divide
    out = []
    for j in range(shards):
        n = min(per, words - j * per)
        if n <= 0:
            break
        out.append(4 * n)
    return out


@dataclass(frozen=True)
class CheckpointSpec:
    """One point of the checkpoint design space (frozen, hashable,
    JSON-round-trippable through :meth:`parse`/:attr:`name`).

    The default spec (``CheckpointSpec()``) reproduces the seed engine
    byte-for-byte: checkpoints ride the platform's default store (FaaS: the
    comm channel itself; IaaS/pod: ``CommSpec.ckpt_channel``) and a worker
    saves exactly when it is killed or rotates out of its lease.
    """
    transport: str | None = None   # None = the platform's default store
    every: int = 0                 # fleet checkpoint every N sync rounds;
                                   #   0 = save-at-kill (seed semantics)
    sharded: bool = False          # one shard per worker (fixed at start)

    def __post_init__(self):
        if (self.transport is not None
                and self.transport not in CKPT_TRANSPORTS):
            raise KeyError(
                f"unknown checkpoint transport {self.transport!r}; "
                f"available: {', '.join(sorted(CKPT_TRANSPORTS))}")
        if int(self.every) < 0:
            raise ValueError(f"every must be >= 0, got {self.every}")
        object.__setattr__(self, "every", int(self.every))
        object.__setattr__(self, "sharded", bool(self.sharded))

    # ---- the string grammar -------------------------------------------------
    @classmethod
    def parse(cls, text) -> "CheckpointSpec":
        """``"<transport>[:every=<N>][:sharded]"`` -> CheckpointSpec; the
        empty string (or None) is the default spec."""
        if isinstance(text, cls):
            return text
        if not text:
            return cls()
        transport, every, sharded = None, 0, False
        for idx, part in enumerate(str(text).split(":")):
            if part.startswith("every="):
                every = int(part[len("every="):])
            elif part == "sharded":
                sharded = True
            elif idx == 0:
                transport = part
            else:
                raise ValueError(
                    f"bad checkpoint spec segment {part!r} in {text!r} "
                    f"(grammar: <transport>{_GRAMMAR})")
        return cls(transport=transport, every=every, sharded=sharded)

    @property
    def name(self) -> str:
        """Canonical grammar string; ``parse(name)`` round-trips (R002) and
        the default spec serializes to ``""``."""
        parts = []
        if self.transport is not None:
            parts.append(self.transport)
        if self.every:
            parts.append(f"every={self.every}")
        if self.sharded:
            parts.append("sharded")
        return ":".join(parts)

    # ---- layout + feasibility -----------------------------------------------
    def shards(self, workers: int) -> int:
        return max(int(workers), 1) if self.sharded else 1

    def validate(self, *, model_bytes=None, workers: int | None = None) -> None:
        """Spec-time feasibility: every shard must fit the transport's
        per-item limit (DynamoDB's 400 KB -> an eager
        :class:`ChannelItemTooLarge`, the checkpoint mirror of Table 1's
        "N/A" cells).  ``model_bytes`` may be a callable for lazy
        estimation, mirroring :meth:`CommSpec.validate`."""
        if self.transport is None or model_bytes is None:
            return
        ch = CKPT_TRANSPORTS[self.transport]
        if ch.max_item is None:
            return
        mb = model_bytes() if callable(model_bytes) else model_bytes
        biggest = max(shard_sizes(int(mb), self.shards(workers or 1)))
        if biggest > ch.max_item:
            hint = ("" if self.sharded
                    else " -- shard it (ckpt='...:sharded') or pick a "
                         "transport without a per-item limit")
            raise ChannelItemTooLarge(
                f"checkpoint shard ({biggest} B) exceeds {ch.name}'s "
                f"per-item limit ({ch.max_item} B){hint}")

    # ---- derived restart ----------------------------------------------------
    def restore_seconds(self, model_bytes: int, channel: ChannelSpec,
                        workers: int = 1) -> float:
        """Closed-form seconds to pull a ``model_bytes`` checkpoint through
        ``channel``: the SAME per-shard transfer arithmetic the metered
        store charges (:func:`xfer_seconds` over :func:`shard_sizes`), so
        the planner's derived restart equals the engine's metered one to
        the last bit."""
        return sum(xfer_seconds(channel, s)
                   for s in shard_sizes(model_bytes, self.shards(workers)))


def make_ckpt(spec) -> CheckpointSpec:
    """Registry-style constructor: string grammar, dict, CheckpointSpec or
    None -> CheckpointSpec."""
    if isinstance(spec, CheckpointSpec):
        return spec
    if isinstance(spec, dict):
        return CheckpointSpec(**spec)
    return CheckpointSpec.parse(spec)


def ckpt_transport_constants(name: str) -> ChannelSpec:
    """Constants for any name a checkpoint may ride -- the registry's own
    transports first, then the comm registry (platform defaults like vmps
    resolve here)."""
    try:
        return CKPT_TRANSPORTS[name]
    except KeyError:
        from repro_torch.core.comm.transports import transport_constants
        return transport_constants(name)


def make_ckpt_transport(name: str) -> StorageChannel:
    """A metered store for a checkpoint-transport registry name (the
    storage services, or the EBS-constant ``local`` channel)."""
    try:
        return StorageChannel(CKPT_TRANSPORTS[name])
    except KeyError:
        raise KeyError(
            f"unknown checkpoint transport {name!r}; available: "
            f"{', '.join(sorted(CKPT_TRANSPORTS))}") from None


def list_ckpts() -> dict[str, str]:
    """name -> grammar line, printed by ``repro list`` (R001)."""
    return {name: f"{name}{_GRAMMAR}" for name in CKPT_TRANSPORTS}
