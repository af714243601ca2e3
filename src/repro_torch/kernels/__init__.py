"""Hand-written Hopper (sm_90a) CUDA kernels for the port's hot spots.

Each kernel subpackage has three layers, mirroring the JAX package:

  kernel.py -- the wrapper of the CUDA kernel in ``src/repro_torch/csrc/``
               (device/dtype/shape checks, output allocation, launch on the
               current stream, error check, launch counter)
  ops.py    -- the public any-shape function; the tensor's device picks the
               CUDA kernel or, for a CPU tensor, the plain version
  ref.py    -- the plain PyTorch version of the same function

Kernels on the simulator's training path, in the wire codecs:
  quant8           -- blockwise int8 quantize / dequantize / fused error
                      feedback
  topk_ef          -- top-k magnitude threshold with residual carry
Kernels on the model zoo's serving path (``models/attention.py``):
  flash_attention  -- causal or full GQA attention forward with an online
                      softmax (the forward and ``Model.prefill``)
  decode_attention -- flash decoding of one query step per GQA group
                      against the KV cache, split over the prefix
                      (every ``decode_step``)
Kernel on the ssm and hybrid families' path (``models/ssm.py``):
  ssd_scan         -- the Mamba-2 SSD scan, chunks in parallel on the
                      tensor cores (3xTF32) with the fp32 state passed
                      from chunk to chunk (every forward)

The CUDA sources are compiled with nvcc at first use (:mod:`.build`);
importing this package needs neither a card nor a compiler.
"""
