"""``repro_torch.core.comm``: the communication design space as three orthogonal,
runtime-checkable protocols (DESIGN.md §12).

- :class:`Transport`  -- WHERE bytes move: S3 / Memcached / Redis /
  DynamoDB / hybrid VM-PS / VM NIC / cross-pod DCN (Table 6 constants).
- :class:`Collective` -- HOW vectors reduce: two-phase allreduce /
  scatter-reduce (Fig 4), hierarchical two-level tree (FSD-Inference),
  ring (IaaS/pods), PS push-pull (Table 2).
- :class:`Codec`      -- WHAT goes on the wire: fp32 identity, int8 +
  error feedback, top-k sparsification (MLLess).

Any triple composes through :class:`CommStack`; a stack is selected
declaratively with the ``"transport/collective/codec"`` grammar
(:func:`parse_stack`) on :class:`repro_torch.core.platform.CommSpec` /
:class:`repro_torch.experiments.ExperimentSpec`, validated eagerly at spec time
(:func:`validate_stack` -- the DynamoDB 400 KB limit reproduces Table 1's
"N/A" cells as a spec error), and metered uniformly into
``RunResult.comm_bytes`` / ``breakdown["comm"]`` / ``comm_cost`` on every
platform.  Codecs act on collective reduces (BSP and the LocalSGD/DiLoCo
sync boundaries); the ASP/SSP event loop exchanges the raw fp32 global
model, so a lossy codec there is rejected at spec time rather than
silently ignored.
"""
from repro_torch.core.comm.codecs import (  # noqa: F401
    CODECS, Codec, Fp32Codec, Int8EFCodec, TopKCodec, int8_encode_decode,
    int8_wire_floats, list_codecs, make_codec,
)
from repro_torch.core.comm.collectives import (  # noqa: F401
    COLLECTIVES, PATTERNS, Collective, PSPushPull, RingAllReduce,
    STORE_COLLECTIVES, StoreAllReduce, StoreScatterReduce, TwoLevelReduce,
    allreduce, list_collectives, make_collective, mean_of, scatter_reduce,
    two_level_reduce,
)
from repro_torch.core.comm.grammar import (  # noqa: F401
    default_collective, parse_stack, stack_name, validate_stack,
)
from repro_torch.core.comm.stack import (  # noqa: F401
    ChannelComm, CommStack, MPIComm, PSComm, build_comm_stack,
)
from repro_torch.core.comm.transports import (  # noqa: F401
    CHANNEL_SPECS, ChannelItemTooLarge, ChannelSpec, NETWORK_TRANSPORTS,
    STORAGE_TRANSPORTS, StorageChannel, TRANSPORTS, Transport, VMNetwork,
    VMParameterServer, list_transports, make_transport, nbytes,
    transport_constants,
)
