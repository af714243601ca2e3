"""``repro_torch.core.ckpt``: the metered checkpoint subsystem (DESIGN.md §17).

Three pieces, one set of constants:

- :class:`CheckpointSpec` -- frozen spec + string grammar
  (``"s3:every=5:sharded"``) selecting a transport from the comm registry's
  storage channels (plus the EBS-backed ``local`` disk), a save cadence,
  and a sharding layout.  Printed by ``repro list``; parse/name round-trip
  under R002.
- :class:`Checkpointer` -- routes real shard bytes through the metered
  store so checkpoint seconds, wire bytes and request $ land in
  :class:`~repro_torch.core.engine.RunResult` alongside the comm meters.
- the ``local`` backend's on-disk format (``localfs``) is not ported yet
  (ROADMAP.md queue A7); ``local`` here is the metered EBS-constant store.

``Platform.restart_time(model_bytes)`` derives from the same
:class:`ChannelSpec` constants via :meth:`CheckpointSpec.restore_seconds`,
so the engine's metered restarts, the planner's crossover and serving's
cold-start weight pulls can never disagree.
"""
from repro_torch.core.ckpt.spec import (  # noqa: F401
    CKPT_TRANSPORTS, LOCAL_SPEC, CheckpointSpec, ckpt_transport_constants,
    list_ckpts, make_ckpt, make_ckpt_transport, shard_sizes,
)
from repro_torch.core.ckpt.store import Checkpointer  # noqa: F401
