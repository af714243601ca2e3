"""Storage-mediated communication channels -- COMPAT SHIM.

The implementations moved to :mod:`repro_torch.core.comm.transports` when the
communication subsystem became the composable Transport x Collective x
Codec API (DESIGN.md §12).  This module re-exports the seed-era surface so
existing imports keep working; new code should import from
:mod:`repro_torch.core.comm`.
"""
from repro_torch.core.comm.transports import (  # noqa: F401
    CHANNEL_SPECS, ChannelItemTooLarge, ChannelSpec, StorageChannel,
    VMNetwork, VMParameterServer, nbytes,
)

__all__ = ["CHANNEL_SPECS", "ChannelItemTooLarge", "ChannelSpec",
           "StorageChannel", "VMNetwork", "VMParameterServer", "nbytes"]
