"""The **Codec** axis of the communication design space (DESIGN.md §12, §16).

A codec is *what an update vector looks like on the wire*.  The paper's
core finding -- FaaS pays off only for models with *reduced* communication
-- makes payload encoding a first-class axis: MLLess (PAPERS.md) shows
significance-filtered/sparsified updates change the FaaS verdict, and
int8 + error-feedback deltas are what make DiLoCo-style outer steps cheap
across slow links.

Codecs follow the *simulate-time, exact-numerics* contract of the whole
engine: the *merged value* is computed from the dequantized/densified
vectors (so convergence reflects the real lossy math, error feedback
included), while the *metered wire payload* is the packed form --
``wire_floats(n)`` f32 slots for an ``n``-element vector.  Metered
``comm_bytes`` therefore shrink by exactly ``wire_floats(n) / n``.

The codec math itself is NOT implemented here: :class:`Int8EFCodec` and
:class:`TopKCodec` run :mod:`repro_torch.kernels.quant8` and
:mod:`repro_torch.kernels.topk_ef` -- the CUDA kernels for tensors on the
card, their plain versions for tensors on the CPU.  Update vectors and
the error-feedback residuals stay tensors on the engine's device: a host
round trip per worker per round would cost far more than the kernel.
Quantization is **blockwise**: one fp32 scale per 256-element block (=
``kernels.quant8.kernel.BLOCK``), which is what :func:`int8_wire_floats`
meters.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch

#: elements per quantization block == one fp32 wire scale; must equal
#: ``repro_torch.kernels.quant8.kernel.BLOCK`` (asserted in tests)
QUANT_BLOCK = 256


def int8_wire_floats(n: int) -> int:
    """f32 slots occupied by an int8-compressed n-element vector on the
    wire: packed codes (4 per float) + one fp32 scale per 256-element
    block -- the blockwise form the quant8 kernel actually ships."""
    return -(-n // 4) + -(-n // QUANT_BLOCK)


def int8_encode_decode(x: torch.Tensor, residual=None):
    """One blockwise-int8 EF wire round trip for an any-shape vector.

    -> ``(deq, new_residual)`` both shaped like ``x``, on x's device.  On
    the card this is one fused kernel pass
    (:func:`repro_torch.kernels.quant8.ops.int8_roundtrip`) emitting codes,
    scales, dequantized values and the carried error together.
    """
    from repro_torch.kernels.quant8.ops import int8_roundtrip

    x = x.to(torch.float32)
    if residual is not None:
        x = x + residual
    _q, _s, deq, err = int8_roundtrip(x)
    return deq, err


# ----------------------------------------------------------------- protocol --

@runtime_checkable
class Codec(Protocol):
    """Payload encoding for one fleet's update vectors (DESIGN.md §12).

    Codecs are STATEFUL per run (error-feedback residuals are carried per
    worker across rounds), so factories hand out fresh instances.
    """

    name: str
    #: identity codecs skip the encode/decode round trip entirely
    is_identity: bool

    def wire_floats(self, n: int) -> int:
        """f32 slots the encoded form of an n-element vector occupies."""
        ...

    def encode_decode(self, worker: int, vec: torch.Tensor) -> torch.Tensor:
        """One worker's lossy wire round trip (residual carried inside)."""
        ...

    def ratio(self, n: int) -> float:
        """Wire bytes / fp32 bytes for an n-element vector."""
        ...


class _CodecBase:
    is_identity = False

    def ratio(self, n: int) -> float:
        return self.wire_floats(n) / n


class Fp32Codec(_CodecBase):
    """Identity: fp32 vectors go on the wire untouched."""
    name = "fp32"
    is_identity = True

    def wire_floats(self, n: int) -> int:
        return n

    def encode_decode(self, worker: int, vec: torch.Tensor) -> torch.Tensor:
        return vec


class Int8EFCodec(_CodecBase):
    """Blockwise int8 + error feedback: ~4x fewer wire bytes; the
    quantization error is carried per worker into the next round.  Runs
    the fused quant8 EF kernel (:func:`int8_encode_decode`)."""
    name = "int8"

    def __init__(self):
        self._residual: dict[int, torch.Tensor] = {}

    def wire_floats(self, n: int) -> int:
        return int8_wire_floats(n)

    def encode_decode(self, worker: int, vec: torch.Tensor) -> torch.Tensor:
        deq, err = int8_encode_decode(vec, self._residual.get(worker))
        self._residual[worker] = err
        return deq


class TopKCodec(_CodecBase):
    """Top-k sparsification with error feedback (MLLess-style significance
    filtering): only the ``k = max(1, round(fraction * n))`` largest-|.|
    coordinates ship each round as (value, index) pairs -- ``2k`` f32 slots
    on the wire; everything filtered is carried as residual into the next
    round, so no signal is lost, only deferred.  Runs the fused
    magnitude-threshold + residual-carry kernel
    (:func:`repro_torch.kernels.topk_ef.topk_ef`); ties at the k-th
    magnitude are all kept."""

    def __init__(self, fraction: float = 0.01):
        fraction = float(fraction)
        if not 0.0 < fraction <= 1.0:
            raise ValueError(
                f"topk fraction must be in (0, 1], got {fraction}")
        self.fraction = fraction
        self._residual: dict[int, torch.Tensor] = {}

    @property
    def name(self) -> str:
        return f"topk:{self.fraction:g}"

    def _k(self, n: int) -> int:
        return max(1, int(round(self.fraction * n)))

    def wire_floats(self, n: int) -> int:
        return 2 * self._k(n)            # values + int32 indices

    def encode_decode(self, worker: int, vec: torch.Tensor) -> torch.Tensor:
        from repro_torch.kernels.topk_ef import topk_ef

        x = vec.to(torch.float32)
        res = self._residual.get(worker)
        if res is not None:
            x = x + res
        out, new_res = topk_ef(x, self._k(x.numel()))
        self._residual[worker] = new_res
        return out


#: every selectable codec: name -> factory(arg_str or None)
CODECS = {
    "fp32": lambda arg=None: Fp32Codec(),
    "int8": lambda arg=None: Int8EFCodec(),
    "topk": lambda arg=None: TopKCodec(float(arg) if arg else 0.01),
}


def make_codec(spec) -> Codec:
    """``"fp32"`` | ``"int8"`` | ``"topk[:<fraction>]"`` | a
    :class:`Codec` instance.  Returns a FRESH instance (codecs carry
    per-run error-feedback state)."""
    if not isinstance(spec, str):
        return spec
    name, _, arg = spec.partition(":")
    try:
        factory = CODECS[name]
    except KeyError:
        raise KeyError(f"unknown codec {spec!r}; available: "
                       f"{', '.join(sorted(CODECS))}") from None
    return factory(arg or None)


def list_codecs() -> list[str]:
    return sorted(CODECS)
