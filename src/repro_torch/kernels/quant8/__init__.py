from repro_torch.kernels.quant8.ops import (  # noqa: F401
    dequantize8, int8_roundtrip, quantize8,
)
