"""The comm-stack string grammar and its spec-time validation
(DESIGN.md §12).

A stack is written ``"<transport>/<collective>/<codec>"``, each part
optionally parameterized with ``:``-arguments::

    s3/allreduce/fp32            # the seed-era FaaS default, byte-identical
    s3/scatter_reduce/int8       # balanced reduce, int8+error-feedback wire
    s3/hierarchical:4/topk:0.01  # two-level tree, groups of 4, top-1% sparse
    nic/ring/fp32                # the IaaS default (ring over VM NICs)
    dcn/ring/int8                # cross-pod DCN ring, compressed deltas
    vmps/pushpull/fp32           # the hybrid VM parameter server

The collective and codec may be omitted (``"s3"``, ``"s3/scatter_reduce"``)
and default per transport: store transports reduce with ``allreduce``,
``nic``/``dcn`` with ``ring``, ``vmps`` with ``pushpull``; the codec
defaults to ``fp32``.

:func:`validate_stack` is the eager half of the paper's Table 1: pairing
rules (a ring needs a network, the PS needs push/pull, FaaS workers have no
p2p NICs) are structural errors, and a transport per-item limit versus the
codec'd wire size of the model update raises
:class:`~repro_torch.core.comm.transports.ChannelItemTooLarge` AT SPEC TIME --
reproducing the "N/A" cells (DynamoDB x models > 400 KB) before a single
simulated second elapses.  A sparsifying codec can flip a cell back to
feasible, which is exactly MLLess's point.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.comm.codecs import make_codec
from repro_torch.core.comm.collectives import STORE_COLLECTIVES, make_collective
from repro_torch.core.comm.transports import (
    ChannelItemTooLarge, NETWORK_TRANSPORTS, TRANSPORTS, transport_constants,
)

#: default collective per transport kind (when the string omits it)
_DEFAULT_COLLECTIVE = {"vmps": "pushpull", "nic": "ring", "dcn": "ring"}


def default_collective(transport: str) -> str:
    return _DEFAULT_COLLECTIVE.get(transport, "allreduce")


def parse_stack(text: str) -> tuple[str, str | None, str]:
    """``"t[/c[/d]]"`` -> ``(transport, collective_or_None, codec)`` with
    every named part checked against its registry."""
    parts = str(text).strip().split("/")
    if not 1 <= len(parts) <= 3 or not all(parts):
        raise ValueError(
            f"bad comm stack {text!r}: expected "
            f"'<transport>[/<collective>[/<codec>]]', e.g. "
            f"'s3/scatter_reduce/int8'")
    transport = parts[0]
    collective = parts[1] if len(parts) > 1 else None
    codec = parts[2] if len(parts) > 2 else "fp32"
    if transport.partition(":")[0] not in TRANSPORTS:
        raise KeyError(f"unknown transport {transport!r} in comm stack "
                       f"{text!r}; available: {', '.join(sorted(TRANSPORTS))}")
    if transport.partition(":")[2]:
        raise ValueError(f"transport {transport!r} takes no ':' arguments")
    if collective is not None:
        make_collective(collective)          # raises on unknown/bad args
    make_codec(codec)                        # raises on unknown/bad args
    return transport, collective, codec


def stack_name(transport: str, collective: str, codec: str) -> str:
    return f"{transport}/{collective}/{codec}"


def validate_stack(transport: str, collective: str, codec: str, *,
                   platform: str | None = None,
                   model_bytes: int | Callable[[], int | None] | None = None,
                   workers: int | None = None) -> None:
    """Raise on any stack that cannot run (structure) or cannot fit
    (per-item limits).  ``model_bytes`` is the fp32 update-vector size and
    may be a lazy callable -- it is only evaluated when the transport
    actually enforces an item limit."""
    spec = transport_constants(transport)          # raises on unknown name
    coll = make_collective(collective)             # raises on unknown name
    cdc = make_codec(codec)                        # raises on unknown name
    c_base = collective.partition(":")[0]
    if (transport == "vmps") != (c_base == "pushpull"):
        raise ValueError(
            f"comm stack '{stack_name(transport, collective, codec)}': "
            f"the push/pull collective and the 'vmps' transport require "
            f"each other (Table 2's hybrid PS protocol); store transports "
            f"use {'/'.join(STORE_COLLECTIVES)}, networks use 'ring'")
    if c_base == "ring" and transport not in NETWORK_TRANSPORTS:
        raise ValueError(
            f"comm stack '{stack_name(transport, collective, codec)}': "
            f"'ring' reduces over point-to-point network constants "
            f"({'/'.join(NETWORK_TRANSPORTS)}); storage services reduce "
            f"with {'/'.join(STORE_COLLECTIVES)} (paper Fig 4/Table 3)")
    if platform == "faas" and transport in NETWORK_TRANSPORTS:
        raise ValueError(
            f"comm stack '{stack_name(transport, collective, codec)}': "
            f"FaaS workers cannot talk to each other directly "
            f"(no p2p network, paper §3.2.2) -- pick a storage transport "
            f"({', '.join(n for n in sorted(TRANSPORTS) if n not in NETWORK_TRANSPORTS)})")
    if spec.max_item is None:
        return
    m = model_bytes() if callable(model_bytes) else model_bytes
    if m is None:
        return
    n = max(int(m) // 4, 1)                       # fp32 elements
    wire_bytes = cdc.wire_floats(n) * 4
    item = coll.max_item_bytes(wire_bytes, workers or 1)
    if item > spec.max_item:
        raise ChannelItemTooLarge(
            f"comm stack '{stack_name(transport, collective, codec)}': the "
            f"model update is {m / 1e6:.2f} MB ({wire_bytes / 1e6:.2f} MB "
            f"on the wire after the {cdc.name} codec), whose largest "
            f"{coll.name} item ({item / 1e3:.1f} KB) exceeds the "
            f"{spec.name} per-item limit of {spec.max_item / 1e3:.0f} KB "
            f"(paper Table 1 'N/A'); shrink the model, switch transports, "
            f"or sparsify (e.g. codec 'topk:0.01')")
