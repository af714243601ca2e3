"""Hand-written Hopper (sm_90a) CUDA kernels for the port's hot spots.

Each kernel subpackage has three layers, mirroring the JAX package:

  kernel.py -- the wrapper of the CUDA kernel in ``src/repro_torch/csrc/``
               (device/dtype/shape checks, output allocation, launch on the
               current stream, error check, launch counter)
  ops.py    -- the public any-shape function; the tensor's device picks the
               CUDA kernel or, for a CPU tensor, the plain version
  ref.py    -- the plain PyTorch version of the same function

Kernels (both on the simulator's training path, in the wire codecs):
  quant8   -- blockwise int8 quantize / dequantize / fused error feedback
  topk_ef  -- top-k magnitude threshold with residual carry

The CUDA sources are compiled with nvcc at first use (:mod:`.build`);
importing this package needs neither a card nor a compiler.
"""
