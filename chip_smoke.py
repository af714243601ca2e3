"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. device -- the card's name and power limit (nvidia-smi), and a build of
   the CUDA kernels from ``src/repro_torch/csrc/`` (one nvcc per source,
   started together);
2. kernels -- each codec kernel against its plain PyTorch version on the
   card, bitwise, at n = 1000, 33*70, 3,000,007 (the MobileNet stand-in's
   update vector) and 22,253,615 (the ResNet50 stand-in's); each attention
   kernel against its plain version within ATTN_TOL (relative to the
   largest output in bf16), over head_dim 20, 64, 80, 128, heads (h, m) =
   (3, 3), (3, 1), (15, 5), causal and full, ragged lengths 47, 577, 2048
   and length < S, the decode kernel's split edges (one tile, each side of
   a split boundary, more splits wanted than tiles), and then at every
   shape phases 3d and 3e give them (smollm's heads and zamba2's shared
   block: h 32, m 32, d 80); then CUDA-event times (median of 20
   back-to-back launches after warm-up) of the kernel, its plain version
   and the one library call that computes the same function, where there
   is one, at the main path's shapes (flash attention at every shape
   phases 3d and 3e give it, FLASH_TIMED; decode attention at b 8, S 577
   and at b 4, S 2048), each kernel output held against the plain version
   there too and two calls of each kernel compared bitwise; flash
   attention against attention in float64 at b 4, s 2048 (within twice
   the error of the kernel it replaced, FLASH_FP64_PARENT);
   the SSD scan kernel against the exact recurrence and the chunked plain
   version within SSD_TOL over tests/test_kernels.py's shapes and the
   zoo's heads (mamba2-370m: h 32, p 64, n 128; zamba2-2.7b: h 80, p 64,
   n 64) at every (b, s) phase 3e gives it (b 4 s 47, b 8 s 512, b 2 s
   575) and at b 2 s 2048, with and without an initial state, its
   continuation property and bf16 inputs (where the chunked version's own
   fp32 rounding misses SSD_TOL, the kernel must be within it of the
   float64 recurrence and nearer to it: a reference caveat), then against
   the float64 recurrence at s = 512 and 575 (within twice the error of
   the kernel it replaced, SSD_FP64_PARENT), and timed at every (b, s) of
   3e with a 3xTF32 (the kernels line's), an fp32 and a bytes bound (no
   PyTorch call computes the SSD: no library time);
3. path -- the simulator's training path on ``device="cuda"`` through the
   platforms' ``train()``: the ``comm_axis`` preset's int8 and top-k specs
   at full size (MobileNet stand-in on cifar10, 20,000 rows, 8 workers,
   GA-SGD, 5 sync rounds) and the pinned ``parity_pod`` case.  Launch
   counters are zeroed right before each run and read right after; every
   merged vector and parameter tensor must live on the card; FaaS and IaaS
   int8 losses must be bitwise equal; ``parity_pod``'s metered fields must
   equal the pinned fixture; each card loss history must match the same
   run on the CPU within a stated tolerance;
3a. control -- the int8 spec once more with TF32 matrix products left on:
   its losses must fall outside that tolerance, which shows the tolerance
   catches a card-side precision fault;
3b. profile -- torch.profiler over one more run of the int8 and top-k
   specs: device busy seconds, idle share, device time by kernel class;
3c. presets -- every trial of every ported preset (quick sizes) through
   ``run_experiment`` on the card and on the CPU, records compared;
3d. serve -- full-width smollm-360m (fp32, random weights from a seeded
   ``torch.Generator``) through ``Generator`` and ``perplexity`` on
   ``device="cuda"``: (a) the launcher's defaults (2 requests of batch 4,
   prompt 16, 32 new tokens at temperature 0.8), (b) batch 8, prompt 512,
   64 new greedy tokens, (c) ``Model.prefill`` at batch 4, s 2048 against
   the token-by-token decode loop.  Launch counters are zeroed before each
   run and read after: decode launches must equal layers x decode steps,
   flash launches layers x forwards.  The card's per-step logits (the same
   decode steps replayed on a fresh cache with the card's tokens) and
   perplexity must match the same model's on the CPU, teacher-forced with
   those tokens, within SERVE_TOL; greedy tokens must be the card logits'
   argmax, and the CPU's wherever its top-two margin exceeds twice
   SERVE_TOL; then a profile of 16 decode steps;
3e. serve -- full-width mamba2-370m and zamba2-2.7b (fp32, seeded random
   weights): mamba2 (a) the launcher's defaults, (b) batch 8, prompt 449,
   64 greedy tokens (perplexity's forward over 512 positions, two of the
   model's 256-position chunks), then a teacher-forced forward at batch 2
   over 575 positions (one chunk of 575 on the CPU) and a profile of 16
   decode steps; zamba2 (a) one request.  Each run as in 3d, and the
   card's forward logits held against its own replayed decode steps too;
   launches exact: SSD = Mamba2 layers x forwards (none in a decode step),
   flash = shared-block uses x forwards, decode = uses x steps;
4. summary -- one JSON line listing every ported kernel.

The last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the repository around it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM dense TF32 on the tensor cores
MOBILENET_N = 3_000_007        # (3072, 777, 777, 10) MLP parameters
RESNET50_N = 22_253_615        # (3072, 3421, 3421, 10) MLP parameters
SHAPES = (1000, 33 * 70, MOBILENET_N, RESNET50_N)
PATH_SPECS = ("comm_s3_scatter_reduce_int8",
              "comm_s3_scatter_reduce_topk0.01",
              "comm_iaas_nic_ring_int8")
#: kernel vs plain version on the card: tests/test_kernels.py's tolerances
ATTN_TOL = {"flash_attention": {"float32": 2e-5, "bfloat16": 2e-2},
            "decode_attention": {"float32": 2e-5, "bfloat16": 3e-2}}
#: full smollm-360m (h 15 over m 5, head_dim 64): the path's attention shapes
SMOLLM_HEADS, SMOLLM_KV_HEADS, SMOLLM_HEAD_DIM = 15, 5, 64
FLASH_PATH = dict(b=4, s=2048)          # Model.prefill in phase 3d (c)
DECODE_PATH = dict(b=8, S=577)          # the last step of phase 3d (b)
#: decode attention timed (b, S, length) at smollm's heads: the last step
#: of phase 3d (b), and the last of 3d (c)'s 2048-step loop at batch 4
DECODE_TIMED = ((DECODE_PATH["b"], DECODE_PATH["S"], DECODE_PATH["S"]),
                (FLASH_PATH["b"], FLASH_PATH["s"], FLASH_PATH["s"]))
#: zamba2-2.7b's shared attention block (h 32 over m 32, head_dim 80)
ZAMBA2_HEADS, ZAMBA2_KV_HEADS, ZAMBA2_HEAD_DIM = 32, 32, 80
#: flash attention timed (b, s, h, m, d), causal fp32 as the serving path
#: gives it: 3d (c)'s prefill (the main shape), 3d (b)'s perplexity over
#: 512 + 64 - 1 positions, 3d (a)'s over 16 + 32 - 1, zamba2's shared block
#: in 3e (a)
_SMOLLM_ATTN = (SMOLLM_HEADS, SMOLLM_KV_HEADS, SMOLLM_HEAD_DIM)
FLASH_TIMED = ((FLASH_PATH["b"], FLASH_PATH["s"], *_SMOLLM_ATTN),
               (8, 512 + 64 - 1, *_SMOLLM_ATTN),
               (4, 16 + 32 - 1, *_SMOLLM_ATTN),
               (4, 16 + 32 - 1, ZAMBA2_HEADS, ZAMBA2_KV_HEADS,
                ZAMBA2_HEAD_DIM))
#: flash attention against attention in float64 (the main shape, inputs
#: from FLASH_FP64_SEED): the CUDA-core kernel that the tensor-core one
#: replaced read this max |o - exact| on these inputs
#: (``flash_vs_float64`` run in its checkout, NVIDIA H100 80GB HBM3 at
#: 700 W); the tensor-core kernel may err by at most twice as much
FLASH_FP64_SEED = 3
FLASH_FP64_PARENT = 1.1232379750758525e-06
#: card vs CPU fp32 logits of full-width smollm-360m, relative to the
#: largest |logit| (and perplexity, relative): the card's fp32 GEMMs and
#: the attention kernels sum in other orders than the CPU over 32 layers
#: (an H100 gave 1.3e-6 of the largest logit, and 9e-7 on perplexity); a
#: wrong kernel or layout moves logits by O(1)
SERVE_TOL = 1e-4
#: SSD kernel vs its plain versions on the card: tests/test_kernels.py's
#: 1e-3 (atol = rtol); the kernel sums in 64-position chunks, the chunked
#: plain version in the model's (256, or one chunk of s where 256 does not
#: divide s), the recurrence position by position
SSD_TOL = 1e-3
SSD_MODEL_CHUNK = 256                   # cfg.ssm_chunk of both models
#: (heads, head_dim, state) of full mamba2-370m and zamba2-2.7b
MAMBA2_SSD, ZAMBA2_SSD = (32, 64, 128), (80, 64, 64)
SSD_PATH = dict(b=8, s=512)             # perplexity's forward in 3e (b)
#: every (b, s) that phase 3e gives the SSD kernel: the (a) runs' forwards
#: over 16 + 32 - 1 positions, mamba2 (b)'s over 449 + 64 - 1, and the
#: ragged forward's
SSD_PATH_SHAPES = ((4, 16 + 32 - 1), (SSD_PATH["b"], SSD_PATH["s"]), (2, 575))
#: the SSD kernel is timed at every one of them, the main one first
SSD_TIMED = (SSD_PATH_SHAPES[1], SSD_PATH_SHAPES[2], SSD_PATH_SHAPES[0])
#: the SSD kernel against the float64 recurrence (mamba2 heads, b 2, inputs
#: from SSD_FP64_SEED): the one-block-per-(batch, head) kernel that the
#: chunk-parallel one replaced read these max |y - exact| on these inputs
#: (``ssd_vs_float64`` run in its checkout, NVIDIA H100 80GB HBM3 at
#: 700 W); the chunk-parallel kernel may err by at most twice as much
SSD_FP64_SEED = 2
SSD_FP64_PARENT = {512: 1.1245186668702445e-3, 575: 9.388894636970235e-4}
#: card vs CPU loss tolerance: the card's fp32 matrix products sum in
#: another order than the CPU's, and one ulp of gradient difference can
#: move an int8 code by a step or swap a top-k survivor.  It lies between
#: the sound readings (at most 1.7e-6 relative on an H100) and the TF32
#: control of phase 3a, which must exceed it.
CARD_VS_CPU_RTOL = 1e-5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ------------------------------------------------------------ 1. device ----

def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch/ beside {Path(__file__).name}: run it "
             f"from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    from repro_torch.kernels import build
    t0 = time.time()
    libs = build.build(["quant8", "topk_ef", "flash_attention",
                        "decode_attention", "ssd_scan"])
    print(f"build: {time.time() - t0:.2f} s, "
          + ", ".join(str(p.relative_to(ROOT)) for p in libs.values()))
    return card


# ----------------------------------------------------------- 2. kernels ----

def _bits_equal(a, b) -> bool:
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _max_err(outs, refs) -> float:
    import torch
    err = 0.0
    for a, b in zip(outs, refs):
        if a.dtype == torch.float32 and a.numel():
            err = max(err, float((a - b).abs().max()))
    return err


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call: events around each of ``reps``
    back-to-back calls, queued behind a spin kernel so that host overhead
    does not leave gaps between them."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(200_000_000)
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1])
                             for i in range(reps))


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def tf32x3_bound_ms(nbytes: float, flop: float) -> tuple[float, str]:
    """The bound of fp32 products done as 3xTF32 on the tensor cores, as
    the flash and SSD kernels do them: three TF32 products per fp32 one."""
    return bound_ms(nbytes, 3 * flop, TF32_OPS_PER_S)


def decode_timed_row(gen, b: int, S: int, length: int) -> dict:
    """Decode attention at smollm's heads in fp32 over a (b, S) cache with
    ``length`` valid positions: the kernel against its plain version, two
    kernel calls compared bitwise, then CUDA-event times of the kernel, the
    plain version and ``F.scaled_dot_product_attention`` over the same
    prefix.  Bound: the prefix's K/V read once, q read, o written."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_kernel)
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_plain as decode_plain)
    h, m, d = SMOLLM_HEADS, SMOLLM_KV_HEADS, SMOLLM_HEAD_DIM
    q, k, v = _attn_inputs(gen, torch.float32, (b, h, d), (b, S, m, d),
                           (b, S, m, d))

    def kernel_fn():
        return decode_attention_kernel(q, k, v, length)

    def plain_fn():
        return decode_plain(q, k, v, length)

    def library_fn():
        return F.scaled_dot_product_attention(
            q[:, :, None], k[:, :length].transpose(1, 2),
            v[:, :length].transpose(1, 2), enable_gqa=True)[:, :, 0]

    out, again, ref, lib = kernel_fn(), kernel_fn(), plain_fn(), library_fn()
    torch.cuda.synchronize()
    nbytes = 4 * (2 * b * length * m * d + 2 * b * h * d)
    b_ms, by = bound_ms(nbytes, 4 * b * h * length * d)
    row = {"shape": f"b{b} S{S} length{length} h{h} m{m} d{d} fp32",
           "max_abs_err": float((out - ref).abs().max()),
           "repeat_bitwise": _bits_equal(out, again),
           "library_max_abs_err": float((lib - ref).abs().max()),
           "ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn),
           "library_ms": time_ms(library_fn),
           "library": "F.scaled_dot_product_attention(..., enable_gqa=True)",
           "bound_ms": b_ms, "bound_by": by, "bound_bytes": nbytes}
    print(f"  decode_attention {row['shape']} ms={row['ms']:.5f} "
          f"bound_ms={b_ms:.5f} ({by}) plain_ms={row['plain_ms']:.5f} "
          f"library_ms={row['library_ms']:.5f} max|err|="
          f"{row['max_abs_err']:.3e} repeat_bitwise={row['repeat_bitwise']}")
    return row


def _launch_profile(fn, reps: int = 10) -> dict:
    """Device microseconds per call of each kernel ``fn`` launches
    (torch.profiler over ``reps`` warmed-up calls), by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").replace(
                "void ", "").split("(")[0]
            out[name] = out.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / reps
    return out


def ssd_timed_row(gen, b: int, s: int, recurrence: bool = False):
    """The SSD kernel at mamba2-370m's heads in fp32 with the model's
    ranges: two kernel calls compared bitwise, the error against the fp32
    recurrence, then CUDA-event times of the kernel, the chunked plain
    version and (``recurrence``) the recurrence.  Three bounds: the
    operations as 3xTF32 on the tensor cores (three TF32 products each, as
    the kernel does them; the kernels line's), the same operations in fp32
    on CUDA cores, and the bytes.
    Returns (row, inputs, kernel output) for the caller's checks."""
    import torch
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
    from repro_torch.kernels.ssd_scan.ops import (
        decay_rates, ssd_scan_recurrence)
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked
    h, p, n = MAMBA2_SSD
    inputs = _ssd_inputs(gen, b, s, h, p, n, torch.float32, True)
    x, dt, a_log, B, C = inputs
    A = decay_rates(a_log)
    out, again = ssd_scan_kernel(x, dt, A, B, C), ssd_scan_kernel(x, dt, A, B,
                                                                   C)
    rec = ssd_scan_recurrence(x, dt, a_log, B, C)
    torch.cuda.synchronize()
    err = max(float((o - r).abs().max()) for o, r in zip(out, rec))
    del rec
    flop = 4 * p * n * b * s * h
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n
                  + b * h * p * n)
    b_ms, by = tf32x3_bound_ms(nbytes, flop)
    row = {"shape": f"b{b} s{s} h{h} p{p} n{n} fp32",
           "max_abs_err": err,
           "repeat_bitwise": all(map(_bits_equal, out, again)),
           "ms": time_ms(lambda: ssd_scan_kernel(x, dt, A, B, C)),
           "plain_ms": time_ms(lambda: ssd_scan_chunked(
               x, dt, a_log, B, C, SSD_MODEL_CHUNK)),
           "bound_ms": b_ms, "bound_by": by,
           "bound_fp32_ms": bound_ms(nbytes, flop)[0],
           "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_bytes": nbytes, "bound_flop": flop, "library_ms": None,
           "library": "none (no PyTorch call computes the SSD scan)"}
    if recurrence:
        row["recurrence_ms"] = time_ms(
            lambda: ssd_scan_recurrence(x, dt, a_log, B, C), reps=5)
        row["launch_us"] = _launch_profile(
            lambda: ssd_scan_kernel(x, dt, A, B, C))
    print(f"  ssd_scan         {row['shape']} ms={row['ms']:.5f} "
          f"bound_ms={b_ms:.5f} (3xTF32 {by}; fp32 "
          f"{row['bound_fp32_ms']:.5f}, bytes {row['bytes_bound_ms']:.5f}) "
          f"plain_ms={row['plain_ms']:.5f}"
          + (f" recurrence_ms={row['recurrence_ms']:.5f}" if recurrence
             else "")
          + f" max|err| vs recurrence={err:.3e} "
          f"repeat_bitwise={row['repeat_bitwise']}"
          + (" launches_us=" + json.dumps(row["launch_us"]) if recurrence
             else ""))
    return row, inputs, out


def ssd_vs_float64() -> dict:
    """Rounding at the serving path's lengths: the kernel (its own chunks)
    and the chunked plain version (256-position chunks at 512, one chunk
    of 575 at 575) against the recurrence in float64, mamba2 heads, b 2,
    on inputs from their own seed (the same in every checkout)."""
    import torch
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
    from repro_torch.kernels.ssd_scan.ops import (
        decay_rates, ssd_scan_recurrence)
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked
    gen = torch.Generator(device="cuda").manual_seed(SSD_FP64_SEED)
    vs_fp64 = {}
    for s in (512, 575):
        x, dt, a_log, B, C = _ssd_inputs(gen, 2, s, *MAMBA2_SSD,
                                         torch.float32, True)
        exact = ssd_scan_recurrence(x.double(), dt.double(), a_log.double(),
                                    B.double(), C.double())[0]
        got = {"kernel": ssd_scan_kernel(x, dt, decay_rates(a_log), B, C)[0],
               "chunked": ssd_scan_chunked(x, dt, a_log, B, C,
                                           SSD_MODEL_CHUNK)[0]}
        vs_fp64[s] = {k: float((v.double() - exact).abs().max())
                      for k, v in got.items()}
        vs_fp64[s]["max_abs_y"] = float(exact.abs().max())
    print("  ssd_scan vs the float64 recurrence (mamba2 heads, b 2): "
          + json.dumps(vs_fp64))
    return vs_fp64


def _causal_pairs(sq: int, sk: int) -> int:
    """(query, key) pairs a top-left causal mask keeps."""
    return sum(min(sk, i + 1) for i in range(sq))


def flash_timed_row(gen, b: int, s: int, h: int, m: int, d: int) -> dict:
    """Flash attention, causal fp32, q (b, s, h, d) and k/v (b, s, m, d):
    the kernel against its plain version, two kernel calls compared
    bitwise, then CUDA-event times of the kernel, the plain version and
    ``F.scaled_dot_product_attention``, and the kernel's device time by
    launch (torch.profiler).  Three bounds: the operations of QK^T and P V
    over the causal pairs as 3xTF32 on the tensor cores (three TF32
    products each, as the kernel does them; the kernels line's), the same
    operations in fp32 on CUDA cores, and the bytes (q, k, v read once, o
    written once)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    q, k, v = _attn_inputs(gen, torch.float32, (b, s, h, d), (b, s, m, d),
                           (b, s, m, d))

    def kernel_fn():
        return flash_attention_kernel(q, k, v, causal=True)

    def plain_fn():
        return flash_attention_plain(q, k, v, causal=True)

    def library_fn():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    out, again, ref, lib = kernel_fn(), kernel_fn(), plain_fn(), library_fn()
    torch.cuda.synchronize()
    flop = 4 * b * h * _causal_pairs(s, s) * d
    nbytes = 4 * (2 * b * s * h * d + 2 * b * s * m * d)
    b_ms, by = tf32x3_bound_ms(nbytes, flop)
    row = {"shape": f"b{b} s{s} h{h} m{m} d{d} causal fp32",
           "max_abs_err": float((out - ref).abs().max()),
           "repeat_bitwise": _bits_equal(out, again),
           "library_max_abs_err": float((lib - ref).abs().max()),
           "ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn),
           "library_ms": time_ms(library_fn),
           "library": "F.scaled_dot_product_attention(..., is_causal=True, "
                      "enable_gqa=True)",
           "bound_ms": b_ms, "bound_by": by,
           "bound_fp32_ms": bound_ms(nbytes, flop)[0],
           "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_bytes": nbytes, "bound_flop": flop,
           "launch_us": _launch_profile(kernel_fn)}
    del q, k, v, out, again, ref, lib
    print(f"  flash_attention  {row['shape']} ms={row['ms']:.5f} "
          f"bound_ms={b_ms:.5f} (3xTF32 {by}; fp32 {row['bound_fp32_ms']:.5f}, "
          f"bytes {row['bytes_bound_ms']:.5f}) plain_ms={row['plain_ms']:.5f} "
          f"library_ms={row['library_ms']:.5f} max|err|="
          f"{row['max_abs_err']:.3e} repeat_bitwise={row['repeat_bitwise']} "
          f"launch_us=" + json.dumps(row["launch_us"]))
    return row


def flash_vs_float64() -> dict:
    """Rounding at the main shape: the kernel and the plain version against
    attention in float64 (the plain version's arithmetic), causal, smollm's
    heads, on inputs from their own seed (the same in every checkout)."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_plain, fold_gqa)
    from repro_torch.kernels.flash_attention.ref import NEG_INF
    b, s = FLASH_PATH["b"], FLASH_PATH["s"]
    h, m, d = SMOLLM_HEADS, SMOLLM_KV_HEADS, SMOLLM_HEAD_DIM
    gen = torch.Generator(device="cuda").manual_seed(FLASH_FP64_SEED)
    q, k, v = _attn_inputs(gen, torch.float32, (b, s, h, d), (b, s, m, d),
                           (b, s, m, d))
    qf, kf, vf = (x.double() for x in fold_gqa(q, k, v))
    sc = torch.einsum("bqd,bkd->bqk", qf, kf) * d ** -0.5
    keep = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    sc = sc.masked_fill(~keep, NEG_INF).softmax(dim=-1)
    exact = torch.einsum("bqk,bkd->bqd", sc, vf).reshape(
        b, h, s, d).transpose(1, 2)
    del sc, qf, kf, vf
    got = {"kernel": flash_attention_kernel(q, k, v, causal=True),
           "plain": flash_attention_plain(q, k, v, causal=True)}
    out = {key: float((val.double() - exact).abs().max())
           for key, val in got.items()}
    out["max_abs_o"] = float(exact.abs().max())
    print(f"  flash_attention vs float64 (b{b} s{s} h{h} m{m} d{d} causal): "
          + json.dumps(out))
    return out


def prefill_timed(reps: int = 5) -> dict:
    """End to end for flash attention: full-width smollm-360m (fp32, seed
    0) ``Model.prefill`` at phase 3d (c)'s b 4, s 2048 -- 32 flash
    launches among the model's GEMMs and elementwise kernels -- timed by
    CUDA events (median of ``reps`` after a warm-up), and the flash
    kernel's share of it by torch.profiler."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    arch = get_arch("smollm-360m")
    arch = arch.replace(model=arch.model.replace(dtype="float32"))
    model = build_model(arch, device="cuda", seed=0)
    b, s = FLASH_PATH["b"], FLASH_PATH["s"]
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, arch.model.vocab_size, (b, s))).cuda()

    def run():
        with torch.no_grad():
            return model.prefill({"tokens": toks}, max_seq=s)

    ms = time_ms(run, reps=reps, warmup=1)
    flash_us = sum(v for k, v in _launch_profile(run, reps=2).items()
                   if "flash_attention" in k)
    out = {"shape": f"b{b} s{s}", "ms": ms, "flash_ms": flash_us / 1e3}
    print(f"  smollm-360m prefill b{b} s{s}: {ms:.3f} ms, flash "
          f"{flash_us / 1e3:.3f} ms of it")
    del model
    torch.cuda.empty_cache()
    return out


def redesign_baseline() -> dict:
    """The redesigned kernels' readings alone, for a checkout of any commit
    with this file copied to its root: decode attention, the SSD scan and
    flash attention at their timed shapes, the SSD and flash kernels
    against float64, and smollm-360m's prefill end to end.  ``python3 -c 'import chip_smoke as c;
    c.phase_device(); c.redesign_baseline()'``."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"decode_attention": [decode_timed_row(gen, *shape)
                                for shape in DECODE_TIMED],
           "ssd_scan": [ssd_timed_row(gen, b, s)[0] for b, s in SSD_TIMED],
           "ssd_vs_float64": ssd_vs_float64(),
           "flash_attention": [flash_timed_row(gen, *shape)
                               for shape in FLASH_TIMED],
           "flash_vs_float64": flash_vs_float64(),
           "prefill": prefill_timed()}
    print(json.dumps({"redesign_baseline": out}))
    return out


def phase_kernels() -> dict:
    import torch
    from repro_torch.kernels.quant8 import kernel as qk
    from repro_torch.kernels.quant8 import ops as qo
    from repro_torch.kernels.topk_ef import kernel as tk
    from repro_torch.kernels.topk_ef.ref import topk_ef_ref, topk_tau_ref

    gen = torch.Generator().manual_seed(0)
    rows = {}

    def record(name, n, kernel_fn, plain_fn, nbytes, ops, extra=None,
               library_fn=None):
        b, by = bound_ms(nbytes, ops)
        row = {"n": n, "ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn),
               "bound_ms": b, "bound_by": by,
               "library_ms": time_ms(library_fn) if library_fn else None}
        row.update(extra or {})
        rows.setdefault(name, {})[n] = row
        shown = {**(extra or {}), **({"library_ms": row["library_ms"]}
                                     if library_fn else {})}
        print(f"  {name:13s} n={n:>10d} ms={row['ms']:.5f} "
              f"bound_ms={b:.5f} ({by}) plain_ms={row['plain_ms']:.5f}"
              + "".join(f" {k}={v:.5f}" for k, v in shown.items()))

    errs = {k: 0.0 for k in ("quantize8_ef", "quantize8", "dequantize8",
                             "topk_ef")}
    for n in SHAPES:
        x = (torch.randn(n, generator=gen) * 3.0).cuda()
        x[: min(n, 5)] = 0.0
        blocks = -(-n // 256)
        # 1: fused EF quantize
        out, ref = qk.quantize8_ef_kernel(x), qo.quantize8_ef_plain(x)
        torch.cuda.synchronize()
        check(all(map(_bits_equal, out, ref)), f"quantize8_ef n={n} differs")
        errs["quantize8_ef"] = max(errs["quantize8_ef"], _max_err(out, ref))
        # 3: quantize
        out3, ref3 = qk.quantize8_kernel(x), qo.quantize8_plain(x)
        torch.cuda.synchronize()
        check(all(map(_bits_equal, out3, ref3)), f"quantize8 n={n} differs")
        errs["quantize8"] = max(errs["quantize8"], _max_err(out3, ref3))
        # 4: dequantize
        q, s = out[0], out[1]
        out4, ref4 = qk.dequantize8_kernel(q, s, n), qo.dequantize8_plain(q, s, n)
        torch.cuda.synchronize()
        check(_bits_equal(out4, ref4), f"dequantize8 n={n} differs")
        errs["dequantize8"] = max(errs["dequantize8"], _max_err([out4], [ref4]))
        # the one library call that computes dequantize8: int8 * fp32 promotes
        # the codes exactly and rounds one product, so it is bitwise equal too
        lib4 = torch.mul(q, s)
        check(_bits_equal(lib4.reshape(-1)[:n], ref4),
              f"torch.mul dequantize n={n} differs from the plain version")
        # 2: top-k EF at the codec's 1% fraction
        k = max(1, round(0.01 * n))
        tau = topk_tau_ref(x, k)
        out2, ref2 = tk.topk_ef_kernel(x, tau), topk_ef_ref(x, tau)
        torch.cuda.synchronize()
        check(all(map(_bits_equal, out2, ref2)), f"topk_ef n={n} differs")
        check(_bits_equal(out2[0] + out2[1], x), f"topk_ef n={n}: kept+res!=x")
        errs["topk_ef"] = max(errs["topk_ef"], _max_err(out2, ref2))
        print(f"  n={n}: quantize8_ef, quantize8, dequantize8, topk_ef "
              f"bitwise equal to their plain versions")
        if n < MOBILENET_N:
            continue
        record("quantize8_ef", n, lambda: qk.quantize8_ef_kernel(x),
               lambda: qo.quantize8_ef_plain(x),
               4 * n + 256 * blocks + 4 * blocks + 8 * n, 6 * n)
        record("quantize8", n, lambda: qk.quantize8_kernel(x),
               lambda: qo.quantize8_plain(x),
               4 * n + 256 * blocks + 4 * blocks, 4 * n)
        record("dequantize8", n, lambda: qk.dequantize8_kernel(q, s, n),
               lambda: qo.dequantize8_plain(q, s, n),
               256 * blocks + 4 * blocks + 4 * n, n,
               library_fn=lambda: torch.mul(q, s))
        record("topk_ef", n, lambda: tk.topk_ef_kernel(x, tau),
               lambda: topk_ef_ref(x, tau), 4 * n + 4 + 8 * n, 2 * n,
               {"topk_tau_ms": time_ms(lambda: topk_tau_ref(x, k))})
        del x, out, ref, out2, ref2, out3, ref3, out4, ref4, lib4, q, s, tau
        torch.cuda.empty_cache()
    return {"rows": rows, "errs": errs}


def _attn_inputs(gen, dtype, *shapes):
    import torch
    return [torch.randn(*sh, generator=gen, device="cuda").to(dtype)
            for sh in shapes]


def phase_attention_kernels() -> dict:
    """Flash attention and flash decoding against their plain versions on
    the card (within ATTN_TOL), then timed at the main path's shapes (flash
    at every FLASH_TIMED shape, decode at both DECODE_TIMED shapes, two
    calls of each bitwise equal), and flash against float64 within twice
    the replaced kernel's error (FLASH_FP64_PARENT)."""
    import torch
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_kernel)
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_plain as decode_plain)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    #: max |kernel - plain| by kernel and dtype, over the sweep ("sweep")
    #: and over the serving path's own shapes ("path")
    errs = {name: {"sweep": {}, "path": {}} for name in ATTN_TOL}
    n = {"flash_attention": 0, "decode_attention": 0}

    def hold(name, out, ref, dtype, what, group="sweep"):
        """Fails unless the kernel's output is within ATTN_TOL of the plain
        version's; in bf16 the tolerance is relative to the largest plain
        output where that is below 1 (long full-attention rows average to
        a few hundredths)."""
        torch.cuda.synchronize()
        ref = ref.float()
        err = float((out.float() - ref).abs().max())
        key = str(dtype).replace("torch.", "")
        tol = ATTN_TOL[name][key]
        if dtype == torch.bfloat16:
            tol *= min(1.0, float(ref.abs().max()))
        check(err <= tol, f"{name} {what} {key}: max |kernel - plain| "
                          f"{err:.3e} > {tol:.3e}")
        errs[name][group][key] = max(errs[name][group].get(key, 0.0), err)
        n[name] += 1
        return err

    def hold_flash(b, sq, sk, h, m, d, causal, dtype, group="sweep"):
        q, k, v = _attn_inputs(gen, dtype, (b, sq, h, d), (b, sk, m, d),
                               (b, sk, m, d))
        hold("flash_attention", flash_attention_kernel(q, k, v, causal=causal),
             flash_attention_plain(q, k, v, causal=causal), dtype,
             f"b{b} sq{sq} sk{sk} h{h} m{m} d{d} causal={causal}", group)

    def hold_decode(b, S, lengths, h, m, d, dtype, group="sweep"):
        q, k, v = _attn_inputs(gen, dtype, (b, h, d), (b, S, m, d),
                               (b, S, m, d))
        for length in lengths:
            hold("decode_attention", decode_attention_kernel(q, k, v, length),
                 decode_plain(q, k, v, length), dtype,
                 f"b{b} S{S} length{length} h{h} m{m} d{d}", group)

    from repro_torch.kernels.decode_attention.kernel import (
        TILE, plan_splits, units)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        for d in (20, 64, 80, 128):
            for h, m in ((3, 3), (3, 1), (SMOLLM_HEADS, SMOLLM_KV_HEADS)):
                for s in (47, 577, 2048):
                    b = 2 if s < 2048 else 1
                    for causal in (True, False):
                        hold_flash(b, s, s, h, m, d, causal, dtype)
                    hold_flash(b, 47, s, h, m, d, False, dtype)
                    hold_decode(3, s, (1, s // 2 + 3, s), h, m, d, dtype)
        # the split edges of the timed decode shapes: one tile, each side
        # of the first split boundary, the last position before the last
        # split; and a batch of one kv head, where the planner would ask
        # for more splits than the prefix has tiles
        h, m, d = SMOLLM_HEADS, SMOLLM_KV_HEADS, SMOLLM_HEAD_DIM
        for b, S, length in DECODE_TIMED:
            n_splits, per = plan_splits(units(b, h, m), length, sms)
            check(n_splits > 1, f"decode b{b} length{length}: one split")
            edge = per * TILE
            last = (n_splits - 1) * per * TILE
            hold_decode(b, S, sorted({TILE, edge - 1, edge, edge + 1, last,
                                      last + 1, length}), h, m, d, dtype)
        tiles = -(-577 // TILE)
        check(plan_splits(units(1, 3, 1), 577, sms) == (tiles, 1),
              "decode: the planner does not cap the splits at the tiles")
        hold_decode(1, 577, (2 * TILE + 1, 577), 3, 1, SMOLLM_HEAD_DIM, dtype)
        # the serving path's own shapes (full smollm-360m heads): perplexity
        # of phase 3d (a) and (b), Model.prefill of (c); the caches of (a),
        # (b) and (c) at their first, a middle and their last length
        h, m, d = SMOLLM_HEADS, SMOLLM_KV_HEADS, SMOLLM_HEAD_DIM
        for b, s in ((4, 16 + 32 - 1), (8, 512 + 64 - 1),
                     (FLASH_PATH["b"], FLASH_PATH["s"])):
            hold_flash(b, s, s, h, m, d, True, dtype, "path")
        for b, S, lengths in ((4, 16 + 32 + 1, (1, 16, 48)),
                              (8, 512 + 64 + 1, (1, 512, 576, 577)),
                              (FLASH_PATH["b"], FLASH_PATH["s"],
                               (1, 1025, 2048))):
            hold_decode(b, S, lengths, h, m, d, dtype, "path")
        # zamba2-2.7b's shared attention block: the forwards of phase 3e
        # (a) and its cache at the first, a middle and the last length
        h, m, d = ZAMBA2_HEADS, ZAMBA2_KV_HEADS, ZAMBA2_HEAD_DIM
        hold_flash(4, 16 + 32 - 1, 16 + 32 - 1, h, m, d, True, dtype, "path")
        hold_decode(4, 16 + 32 + 1, (1, 16, 48), h, m, d, dtype, "path")
    for name, by_group in errs.items():
        print(f"  {name}: {n[name]} shapes within {ATTN_TOL[name]} of the "
              f"plain version; max |err| " + "; ".join(
                  f"{group} " + ", ".join(f"{k} {v:.3e}" for k, v in e.items())
                  for group, e in by_group.items()))
    rows = {}
    shapes = []
    for shape in FLASH_TIMED:
        row = flash_timed_row(gen, *shape)
        check(row["repeat_bitwise"], f"flash_attention {row['shape']}: two "
                                     f"calls differ")
        check(row["library_max_abs_err"] <= 1e-4,
              "flash_attention: the library call is not the same function")
        check(row["max_abs_err"] <= ATTN_TOL["flash_attention"]["float32"],
              f"flash_attention timed {row['shape']}: max |kernel - plain| "
              f"{row['max_abs_err']:.3e}")
        errs["flash_attention"]["path"]["float32"] = max(
            errs["flash_attention"]["path"]["float32"], row["max_abs_err"])
        shapes.append(row)
    vs_fp64 = flash_vs_float64()
    check(vs_fp64["kernel"] <= 2 * FLASH_FP64_PARENT,
          f"flash_attention: {vs_fp64['kernel']:.3e} from float64, over "
          f"twice the replaced kernel's {FLASH_FP64_PARENT:.3e}")
    main = shapes[0]
    rows["flash_attention"] = {
        **{k: main[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                "bound_by", "bound_fp32_ms",
                                "bytes_bound_ms", "library_ms", "library",
                                "launch_us")},
        "timed_max_abs_err": main["max_abs_err"],
        "max_abs_err": errs["flash_attention"]["path"]["float32"],
        "max_abs_err_bf16": errs["flash_attention"]["path"]["bfloat16"],
        "sweep_max_abs_err": errs["flash_attention"]["sweep"],
        "vs_float64": vs_fp64, "shapes": shapes}
    shapes = []
    for b, S, length in DECODE_TIMED:
        row = decode_timed_row(gen, b, S, length)
        check(row["repeat_bitwise"], f"decode_attention {row['shape']}: two "
                                     f"calls differ")
        check(row["library_max_abs_err"] <= 1e-4,
              "decode_attention: the library call is not the same function")
        check(row["max_abs_err"] <= ATTN_TOL["decode_attention"]["float32"],
              f"decode_attention timed {row['shape']}: max |kernel - plain| "
              f"{row['max_abs_err']:.3e}")
        errs["decode_attention"]["path"]["float32"] = max(
            errs["decode_attention"]["path"]["float32"], row["max_abs_err"])
        shapes.append(row)
    main = shapes[0]
    rows["decode_attention"] = {
        **{k: main[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "library")},
        "timed_max_abs_err": main["max_abs_err"],
        "max_abs_err": errs["decode_attention"]["path"]["float32"],
        "max_abs_err_bf16": errs["decode_attention"]["path"]["bfloat16"],
        "sweep_max_abs_err": errs["decode_attention"]["sweep"],
        "shapes": shapes}
    torch.cuda.empty_cache()
    return rows


def _ssd_inputs(gen, b, s, h, p, n, dtype, model_like: bool):
    """x, dt, a_log, B, C on the card.  ``model_like``: the Mamba2 block's
    ranges at init (a_log = 1, so A = -e; dt a softplus of a normal);
    otherwise tests/test_kernels.py's (|0.2 N|, a_log 0.3 N)."""
    import torch
    import torch.nn.functional as F

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    x, B, C = rnd(b, s, h, p), rnd(b, s, n), rnd(b, s, n)
    if model_like:
        dt, a_log = F.softplus(rnd(b, s, h)), torch.ones(h, device="cuda")
    else:
        dt, a_log = (rnd(b, s, h) * 0.2).abs(), rnd(h) * 0.3
    return x.to(dtype), dt, a_log, B.to(dtype), C.to(dtype)


def phase_ssd_kernel() -> dict:
    """The SSD scan kernel against the exact recurrence (``ref.py`` behind
    the JAX wrapper's plumbing) and the chunked plain version on the card,
    within SSD_TOL, over a sweep that includes every (b, s) of phase 3e
    (SSD_PATH_SHAPES) for both models' heads; the continuation property
    of ``init_state``; the float64 recurrence within twice the replaced
    kernel's error; then timed at every path shape, two calls compared
    bitwise.  The largest |kernel - recurrence| over the path's shapes is
    the kernels line's ``max_abs_err``.

    Where the chunked plain version itself misses SSD_TOL -- its one-chunk
    fallback at a long ragged length sums exp(cum_i - cum_j) from cumsums
    near -1000, where one fp32 ulp is ~1e-4 -- the kernel must instead be
    within SSD_TOL of the float64 recurrence and nearer to it than the
    chunked version is; such readings are reported as reference caveats."""
    import torch
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
    from repro_torch.kernels.ssd_scan.ops import (
        decay_rates, ssd_scan_recurrence)
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked

    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {"recurrence": 0.0, "chunked": 0.0, "init_state": 0.0,
            "continuation": 0.0, "bfloat16": 0.0, "float64": 0.0}
    #: max |kernel - plain| over the shapes phase 3e gives the kernel
    path_errs = {"recurrence": 0.0, "chunked": 0.0, "float64": 0.0}
    caveats = {}
    n_checks = 0

    def misses(out, ref):
        return any(bool(((o.double() - r.double()).abs()
                         > SSD_TOL * (1.0 + r.double().abs())).any())
                   for o, r in zip(out, ref))

    def gap(out, ref):
        return max(float((o.double() - r.double()).abs().max())
                   for o, r in zip(out, ref))

    def hold(what, out, ref, group):
        nonlocal n_checks
        torch.cuda.synchronize()
        for o, r in zip(out, ref):
            check(bool(o.isfinite().all()), f"ssd_scan {what}: not finite")
            gap = (o - r.float()).abs()
            bad = gap > SSD_TOL * (1.0 + r.float().abs())
            check(not bool(bad.any()), f"ssd_scan {what} vs {group}: max "
                                       f"|kernel - plain| {float(gap.max()):.3e}")
            errs[group] = max(errs[group], float(gap.max()))
        n_checks += 1

    def hold_chunked(what, out, x, dt, a_log, B, C):
        """Returns the group the reading went to and the reading."""
        nonlocal n_checks
        plain = ssd_scan_chunked(x, dt, a_log, B, C, SSD_MODEL_CHUNK)
        torch.cuda.synchronize()
        if not misses(out, plain):
            err = gap(out, plain)
            errs["chunked"] = max(errs["chunked"], err)
            n_checks += 1
            return "chunked", err
        exact = ssd_scan_recurrence(x.double(), dt.double(), a_log.double(),
                                    B.double(), C.double())
        kernel_err, plain_err = gap(out, exact), gap(plain, exact)
        caveats[what] = {"kernel_vs_chunked": gap(out, plain),
                         "kernel_vs_float64": kernel_err,
                         "chunked_vs_float64": plain_err}
        print(f"  ssd_scan {what}: the chunked plain version misses "
              f"{SSD_TOL} -- reference caveat " + json.dumps(caveats[what]))
        check(not misses(out, exact) and kernel_err < plain_err,
              f"ssd_scan {what}: the kernel is not nearer the float64 "
              f"recurrence than the chunked plain version")
        errs["float64"] = max(errs["float64"], kernel_err)
        n_checks += 1
        return "float64", kernel_err

    def hold_path(out, rec, chunked):
        path_errs["recurrence"] = max(path_errs["recurrence"], gap(out, rec))
        group, err = chunked
        path_errs[group] = max(path_errs[group], err)

    def sweep(b, s, h, p, n, model_like, path=False):
        what = f"b{b} s{s} h{h} p{p} n{n}"
        x, dt, a_log, B, C = _ssd_inputs(gen, b, s, h, p, n, torch.float32,
                                         model_like)
        A = decay_rates(a_log)
        out = ssd_scan_kernel(x, dt, A, B, C)
        rec = ssd_scan_recurrence(x, dt, a_log, B, C)
        hold(what, out, rec, "recurrence")
        chunked = hold_chunked(what, out, x, dt, a_log, B, C)
        if path:
            hold_path(out, rec, chunked)
        del rec
        init = torch.randn(b, h, p, n, generator=gen, device="cuda")
        hold(what + " init_state",
             ssd_scan_kernel(x, dt, A, B, C, init),
             ssd_scan_recurrence(x, dt, a_log, B, C, init), "init_state")
        m = s // 2 + 3                # a split off the kernel's 64-chunks
        y1, st1 = ssd_scan_kernel(x[:, :m], dt[:, :m], A, B[:, :m], C[:, :m])
        y2, st2 = ssd_scan_kernel(x[:, m:], dt[:, m:], A, B[:, m:], C[:, m:],
                                  st1)
        hold(what + " continuation", (torch.cat([y1, y2], 1), st2), out,
             "continuation")
        xb, Bb, Cb = x.bfloat16(), B.bfloat16(), C.bfloat16()
        hold(what + " bf16", ssd_scan_kernel(xb, dt, A, Bb, Cb),
             ssd_scan_recurrence(xb.float(), dt, a_log, Bb.float(),
                                 Cb.float()), "bfloat16")

    # tests/test_kernels.py's four (bh, s, p, n) shapes, bh split as b x h
    for b, s, h, p, n in ((2, 256, 2, 64, 32), (2, 128, 1, 32, 16),
                          (3, 96, 1, 16, 8), (1, 64, 1, 128, 64)):
        sweep(b, s, h, p, n, False)
    # the zoo's heads at every (b, s) of the serving path, and longer
    for h, p, n in (MAMBA2_SSD, ZAMBA2_SSD):
        for b, s in SSD_PATH_SHAPES:
            sweep(b, s, h, p, n, True, path=True)
        sweep(2, 2048, h, p, n, True)
    print(f"  ssd_scan: {n_checks} checks within {SSD_TOL} (x (1 + |ref|)) "
          f"of the plain versions; max |err| " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items())
          + "; at the path's shapes " + ", ".join(
              f"{k} {v:.3e}" for k, v in path_errs.items()))
    vs_fp64 = ssd_vs_float64()
    for s, got in vs_fp64.items():
        check(got["kernel"] <= 2 * SSD_FP64_PARENT[s],
              f"ssd_scan s{s}: {got['kernel']:.3e} from the float64 "
              f"recurrence, over twice the replaced kernel's "
              f"{SSD_FP64_PARENT[s]:.3e}")

    shapes = []
    for i, (b, s) in enumerate(SSD_TIMED):
        row, (x, dt, a_log, B, C), out = ssd_timed_row(gen, b, s,
                                                      recurrence=i == 0)
        check(row["repeat_bitwise"], f"ssd_scan {row['shape']}: two calls "
                                     f"differ")
        chunked = hold_chunked(f"timed {row['shape']}", out, x, dt, a_log, B,
                               C)
        rec = ssd_scan_recurrence(x, dt, a_log, B, C)
        hold(f"timed {row['shape']}", out, rec, "recurrence")
        hold_path(out, rec, chunked)
        shapes.append(row)
        del x, dt, a_log, B, C, out, rec
    torch.cuda.empty_cache()
    main = shapes[0]
    return {**{k: main[k] for k in (
                "shape", "ms", "plain_ms", "recurrence_ms", "bound_ms",
                "bound_by", "bound_fp32_ms", "bytes_bound_ms",
                "library_ms", "library", "bound_bytes", "bound_flop",
                "launch_us")},
            "timed_max_abs_err": main["max_abs_err"],
            "max_abs_err": path_errs["recurrence"],
            "path_max_abs_err": path_errs,
            "sweep_max_abs_err": dict(errs), "checks": n_checks,
            "vs_float64": vs_fp64, "reference_caveats": caveats,
            "shapes": shapes}


# -------------------------------------------------------------- 3. path ----

def _history_losses(res):
    return [loss for _, loss in res.history]


def _drive(spec, device: str):
    """One run through the platform's train() on ``device``; returns the
    result, the launch counts of the run, the devices seen at every merge,
    and the wall seconds."""
    import torch
    from repro_torch.kernels.quant8 import kernel as qk
    from repro_torch.kernels.topk_ef import kernel as tk
    model, algo, tr, va = spec.build_workload()
    seen = set()
    apply_merged = algo.apply_merged

    def checked(model_, st, merged, w):
        seen.add(("merged", merged.device.type))
        apply_merged(model_, st, merged, w)
        seen.add(("params", st.params.device.type))

    algo.apply_merged = checked
    qk.reset_launches()
    tk.reset_launches()
    t0 = time.time()
    res = spec.build_runtime().train(
        model, algo, tr, va, target_loss=spec.target_loss,
        max_epochs=spec.max_epochs, eval_every=spec.eval_every,
        data_local=spec.data_local, trace=spec.trace, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {**qk.launches, **tk.launches}
    return res, launches, seen, wall


def phase_path() -> dict:
    from repro_torch.experiments import ExperimentSpec, get_preset
    preset = {s.name: s for s in get_preset("comm_axis").build(False)}
    fixture = json.loads((ROOT / "tests" / "fixtures"
                          / "trace_parity_pr9.json").read_text())
    pod_case = next(c for c in fixture["cases"]
                    if c["spec"]["name"] == "parity_pod")
    specs = [preset[name] for name in PATH_SPECS]
    specs.append(ExperimentSpec.from_dict(pod_case["spec"]))
    totals = {}
    losses = {}
    cpu_losses = {}
    for spec in specs:
        res, launches, seen, wall = _drive(spec, "cuda")
        check(not res.error, f"{spec.name}: {res.error}")
        check(seen == {("merged", "cuda"), ("params", "cuda")},
              f"{spec.name}: merges/params not all on the card: {seen}")
        w = spec.fleet.workers
        if spec.name == "parity_pod":
            syncs = -(-res.rounds // 2)            # local:2 boundaries
            check(launches["quantize8_ef"] == w * syncs,
                  f"parity_pod: quantize8_ef launches {launches}")
        elif "int8" in spec.name:
            check(launches["quantize8_ef"] == w * res.rounds,
                  f"{spec.name}: quantize8_ef launches {launches}, "
                  f"want {w} per round x {res.rounds}")
        else:
            check(launches["topk_ef"] == w * res.rounds,
                  f"{spec.name}: topk_ef launches {launches}, "
                  f"want {w} per round x {res.rounds}")
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        ref, _, _, cpu_wall = _drive(spec, "cpu")
        card_l, cpu_l = _history_losses(res), _history_losses(ref)
        rel = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
        check(len(card_l) == len(cpu_l) and rel <= CARD_VS_CPU_RTOL,
              f"{spec.name}: card losses {card_l} vs cpu {cpu_l}")
        check([t for t, _ in res.history] == [t for t, _ in ref.history],
              f"{spec.name}: card and cpu timestamps differ")
        losses[spec.name] = card_l
        cpu_losses[spec.name] = cpu_l
        print(f"  {spec.name}: rounds={res.rounds} sim_time={res.sim_time!r} "
              f"final_loss={res.final_loss!r} wall_s={wall:.3f} "
              f"launches={launches} cpu_wall_s={cpu_wall:.3f} "
              f"max_rel_loss_vs_cpu={rel:.3e}")
        if spec.name == "parity_pod":
            exp = pod_case["result"]
            got = {"system": res.system, "rounds": res.rounds,
                   "sim_time": res.sim_time, "cost": res.cost,
                   "comm_bytes": res.comm_bytes, "comm_cost": res.comm_cost,
                   "ckpt_bytes": res.ckpt_bytes, "ckpt_time": res.ckpt_time,
                   "ckpt_cost": res.ckpt_cost,
                   "preemptions": res.preemptions,
                   "max_staleness": res.max_staleness,
                   "breakdown": res.breakdown}
            for key, val in got.items():
                check(val == exp[key], f"parity_pod {key}: {val!r} != "
                                       f"{exp[key]!r}")
            check([t for t, _ in res.history]
                  == [t for t, _ in exp["history"]],
                  "parity_pod: history timestamps differ from the fixture")
            print("  parity_pod: metered fields equal the pinned fixture")
    check(losses["comm_s3_scatter_reduce_int8"]
          == losses["comm_iaas_nic_ring_int8"],
          "FaaS (s3 scatter-reduce) and IaaS (NIC ring) int8 losses differ")
    print("  FaaS == IaaS: int8 loss columns bitwise equal on the card")
    return totals, preset, cpu_losses


# ------------------------------------------------------------ 3a. control ---

def phase_control(preset, cpu_losses) -> float:
    """The int8 comm spec on the card with TF32 matrix products left on (the
    fault :func:`repro_torch.resolve_device` exists to prevent): its losses
    must differ from the CPU's by more than CARD_VS_CPU_RTOL, else that
    tolerance would not catch such a fault."""
    import torch
    from repro_torch.core import engine
    name = PATH_SPECS[0]
    resolve = engine.resolve_device

    def with_tf32(device=None):
        dev = resolve(device)
        torch.backends.cuda.matmul.allow_tf32 = True
        return dev

    engine.resolve_device = with_tf32
    try:
        res, _launches, _seen, _wall = _drive(preset[name], "cuda")
    finally:
        engine.resolve_device = resolve
        torch.backends.cuda.matmul.allow_tf32 = False
    card_l, cpu_l = _history_losses(res), cpu_losses[name]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
    print(f"  {name} with TF32 on: max_rel_loss_vs_cpu={rel:.3e} "
          f"(tolerance {CARD_VS_CPU_RTOL:g})")
    check(rel > CARD_VS_CPU_RTOL,
          f"TF32 control within {CARD_VS_CPU_RTOL:g} of the CPU: the "
          f"card-vs-CPU tolerance does not catch a precision fault")
    return rel


# ------------------------------------------------------------ 3b. profile ---

def _kernel_class(name: str) -> str:
    low = name.lower()
    for key, cls in (("quantize8_ef", "quantize8_ef"), ("topk_ef", "topk_ef"),
                     ("memcpy", "memcpy"), ("memset", "memset"),
                     ("gemm", "matmul"), ("sort", "topk_select"),
                     ("radix", "topk_select"), ("topk", "topk_select")):
        if key in low:
            return cls
    return "other"


def phase_profile(preset) -> dict:
    """Where the device time goes on the path: torch.profiler (CUPTI) over
    one more run of each lossy-codec spec, already warmed up.  Device busy
    time is the union of kernel and copy intervals; the idle share is
    measured against the profiled run's own wall time (profiling slows the
    host, so it is an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name in PATH_SPECS[:2]:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _res, _launches, _seen, wall = _drive(preset[name], "cuda")
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if not spans:
            out[name] = {"wall_s": wall, "device_busy_s": "not measured"}
            print(f"  {name}: profiler saw no device events (not measured)")
            continue
        busy, cur_lo, cur_hi = 0.0, spans[0][0], spans[0][1]
        by_class: dict[str, float] = {}
        for lo, hi, kname in spans:
            by_class[_kernel_class(kname)] = \
                by_class.get(_kernel_class(kname), 0.0) + (hi - lo) / 1e6
            if lo > cur_hi:
                busy += (cur_hi - cur_lo) / 1e6
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        busy += (cur_hi - cur_lo) / 1e6
        out[name] = {"wall_s": wall, "device_busy_s": busy,
                     "device_idle_share": 1.0 - busy / wall,
                     "device_s_by_class": dict(sorted(
                         by_class.items(), key=lambda kv: -kv[1]))}
        print(f"  {name}: wall_s={wall:.4f} device_busy_s={busy:.6f} "
              f"idle_share={1.0 - busy / wall:.4f} by_class="
              + json.dumps({k: round(v, 6) for k, v in
                            out[name]["device_s_by_class"].items()}))
    return out


# ----------------------------------------------------------- 3c. presets ---

def phase_presets() -> int:
    """Every trial of every ported preset (quick sizes) through
    ``run_experiment`` on the card and on the CPU: the records must agree
    on every metered field and on the losses to CARD_VS_CPU_RTOL.  This
    reaches the paths the comm specs above do not: MA-SGD, ADMM, SSP/ASP,
    the hybrid PS, spot kills, checkpoint cadences and traces."""
    from repro_torch.experiments import PRESETS, run_experiment
    n, worst = 0, 0.0
    for preset in PRESETS.values():
        for spec in preset.build(True):
            card = run_experiment(spec, device="cuda").result
            cpu = run_experiment(spec, device="cpu").result
            for key, val in cpu.items():
                if key not in ("history", "final_loss"):
                    check(card[key] == val, f"{spec.name}: {key} differs "
                                            f"on the card: {card[key]!r}")
            check([t for t, _ in card["history"]]
                  == [t for t, _ in cpu["history"]],
                  f"{spec.name}: history timestamps differ on the card")
            for (_, a), (_, b) in zip(card["history"], cpu["history"]):
                check(abs(a - b) <= CARD_VS_CPU_RTOL * abs(b),
                      f"{spec.name}: card loss {a!r} vs cpu {b!r}")
                worst = max(worst, abs(a - b) / abs(b))
            n += 1
    print(f"  {n} preset trials: card records equal the CPU's (losses "
          f"within {CARD_VS_CPU_RTOL:g}; largest gap {worst:.3e})")
    return n


# ------------------------------------------------------------- 3d. serve ---

def _path_launches() -> dict:
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    return {**fk.launches, **dk.launches, **sk.launches}


def _reset_path_launches() -> None:
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    fk.reset_launches()
    dk.reset_launches()
    sk.reset_launches()


def _want_launches(cfg, steps: int, forwards: int) -> dict:
    """Exact launch counts of ``steps`` decode steps and ``forwards``
    forwards: flash per attention layer per forward, decode attention per
    attention layer per step, the SSD scan per Mamba2 layer per forward
    (never in a decode step: that is the single-step recurrence)."""
    layers = cfg.num_layers
    attn = {"dense": layers, "ssm": 0,
            "hybrid": layers // max(cfg.attn_every, 1)}[cfg.family]
    mamba = 0 if cfg.family == "dense" else layers
    return {"flash_attention": attn * forwards,
            "decode_attention": attn * steps, "ssd_scan": mamba * forwards}


def _card_step_logits(model, out, max_seq: int):
    """The card's logits of every decode step of a run that gave the tokens
    ``out`` (b, s): the same decode_step calls on a fresh cache, teacher-
    forced with those tokens.  Step t's logits predict token t + 1."""
    import torch
    b, s = out.shape
    toks = out.to(model.device)
    steps = []
    with torch.no_grad():
        cache = model.init_cache(b, max_seq)
        for pos in range(s - 1):
            logits, cache = model.decode_step(cache, toks[:, pos], pos)
            steps.append(logits)
    return torch.stack(steps, dim=1).cpu()                      # (b, s-1, V)


def _vs_cpu(cpu_model, out, card, what: str) -> dict:
    """The card's per-step logits ``card`` against the same model on the
    CPU, teacher-forced with the card's tokens ``out`` (b, s), within
    SERVE_TOL of the largest; the CPU's perplexity from the same logits
    (``perplexity``'s arithmetic)."""
    import torch
    from repro_torch.models.common import cross_entropy
    with torch.no_grad():
        cpu, _ = cpu_model.forward({"tokens": out[:, :-1]})
    err = float((card - cpu).abs().max())
    scale = float(cpu.abs().max())
    check(err <= SERVE_TOL * max(1.0, scale),
          f"{what}: card vs CPU teacher-forced logits differ by {err:.3e}")
    return {"logits_max_abs_err": err, "logits_max_abs": scale,
            "cpu_ppl": float(torch.exp(cross_entropy(cpu, out[:, 1:]))),
            "cpu_logits": cpu}


def _serve_run(gen, model, cpu_model, prompts, new_tokens, temperature,
               seed, what: str) -> dict:
    """One generate() + perplexity on the card, launches counted; then the
    card's teacher-forced forward against its replayed decode steps, and
    the CPU comparison."""
    import torch
    from repro_torch.serving import perplexity
    gen.decode_steps = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_path_launches()
    t0 = time.perf_counter()
    out = gen.generate(prompts, max_new_tokens=new_tokens,
                       temperature=temperature, seed=seed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ppl = perplexity(model, out)
    launches = _path_launches()
    peak = torch.cuda.max_memory_allocated()
    b, s = prompts.shape
    check(gen.decode_steps == s + new_tokens,
          f"{what}: {gen.decode_steps} decode steps, want {s + new_tokens}")
    want = _want_launches(model.cfg, gen.decode_steps, 1)
    check(launches == want, f"{what}: launches {launches}, want {want} "
                            f"({gen.decode_steps} decode steps, one forward)")
    check(out.shape == (b, s + new_tokens)
          and bool(((out >= 0) & (out < model.cfg.vocab_size)).all()),
          f"{what}: tokens out of range or of shape {out.shape}")
    out_t = torch.from_numpy(out).long()
    card = _card_step_logits(model, out_t, gen.max_seq)
    with torch.no_grad():
        card_fwd = model.forward({"tokens": out_t[:, :-1].cuda()})[0].cpu()
    fwd_err = float((card_fwd - card).abs().max())
    check(fwd_err <= SERVE_TOL * max(1.0, float(card.abs().max())),
          f"{what}: the card's forward vs its decode steps differ by "
          f"{fwd_err:.3e}")
    del card_fwd
    cmp = _vs_cpu(cpu_model, out_t, card, what)
    cpu = cmp.pop("cpu_logits")
    rel = abs(ppl - cmp["cpu_ppl"]) / cmp["cpu_ppl"]
    check(rel <= SERVE_TOL, f"{what}: ppl {ppl!r} on the card vs "
                            f"{cmp['cpu_ppl']!r} on the CPU")
    row = {"batch": b, "prompt": s, "new_tokens": new_tokens,
           "temperature": temperature, "wall_s": wall,
           "tok_per_s": b * new_tokens / wall,
           "ms_per_decode_step": wall / gen.decode_steps * 1e3,
           "peak_mem_bytes": peak, "ppl": ppl, "ppl_rel_vs_cpu": rel,
           "forward_vs_decode_max_abs_err": fwd_err,
           "launches": launches, **cmp}
    if temperature == 0:                 # greedy: tokens where margins allow
        top2 = cpu[:, s - 1:].topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        want = cpu[:, s - 1:].argmax(-1)
        got = torch.from_numpy(out[:, s:]).long()
        sure = margin > 2 * SERVE_TOL * max(1.0, row["logits_max_abs"])
        check(bool((got[sure] == want[sure]).all()),
              f"{what}: greedy tokens differ from the CPU's where the "
              f"top-two margin exceeds 2 x SERVE_TOL")
        check(bool((card[:, s - 1:].argmax(-1) == got).all()),
              f"{what}: generated tokens are not the card logits' argmax")
        row["tokens_checked"] = int(sure.sum())
        row["tokens_total"] = int(sure.numel())
    print(f"  {what}: {b}x{new_tokens} tokens in {wall:.3f} s "
          f"({row['tok_per_s']:.1f} tok/s, {row['ms_per_decode_step']:.3f} "
          f"ms/decode step, peak {peak / 2**30:.3f} GiB) ppl={ppl:.4f} "
          f"(cpu {cmp['cpu_ppl']:.4f}) logits vs cpu "
          f"{cmp['logits_max_abs_err']:.3e}, forward vs decode "
          f"{fwd_err:.3e} launches={launches}"
          + (f" tokens checked {row['tokens_checked']}/{row['tokens_total']}"
             if "tokens_checked" in row else ""))
    return row


def _decode_class(name: str) -> str:
    low = name.lower()
    for key, cls in (("decode_attention", "decode_attention"),
                     ("flash_attention", "flash_attention"),
                     ("ssd_scan", "ssd_scan"),
                     ("memcpy", "memcpy"), ("memset", "memset"),
                     ("gemm", "gemm"), ("gemv", "gemm"), ("cutlass", "gemm"),
                     ("xmma", "gemm"), ("reduce", "reduce"),
                     ("elementwise", "elementwise"), ("index", "index")):
        if key in low:
            return cls
    return "other"


def _profile_decode(model, prompt, steps: int = 16) -> dict:
    """torch.profiler over ``steps`` decode steps after ``prompt``, fed by
    a prefill (dense) or by decode steps (ssm, hybrid: they have no
    prefill): device time by kernel class and the device idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    b, s = prompt.shape
    with torch.no_grad():
        if model.cfg.family == "dense":
            logits, cache = model.prefill({"tokens": prompt},
                                          max_seq=s + steps)
        else:
            cache = model.init_cache(b, s + steps)
            for pos in range(s):
                logits, cache = model.decode_step(cache, prompt[:, pos], pos)
        tok = logits.argmax(-1)
        for pos in range(s, s + 2):                          # warm-up
            logits, cache = model.decode_step(cache, tok, pos)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for pos in range(s + 2, s + steps):
                logits, cache = model.decode_step(cache, logits.argmax(-1),
                                                  pos)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    n = steps - 2
    if not spans:
        return {"steps": n, "wall_s": wall, "device_busy_s": "not measured"}
    busy, lo_, hi_ = 0.0, spans[0][0], spans[0][1]
    by_class: dict[str, float] = {}
    for lo, hi, name in spans:
        cls = _decode_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + (hi - lo) / 1e6
        if lo > hi_:
            busy += (hi_ - lo_) / 1e6
            lo_, hi_ = lo, hi
        else:
            hi_ = max(hi_, hi)
    busy += (hi_ - lo_) / 1e6
    return {"batch": b, "pos": [s + 2, s + steps - 1], "steps": n,
            "wall_s": wall, "ms_per_step": wall / n * 1e3,
            "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
            "kernels_per_step": len(spans) / n,
            "device_s_by_class": dict(sorted(by_class.items(),
                                             key=lambda kv: -kv[1]))}


def _full_width(name: str):
    """The full-width arch in fp32 (as the launcher forces), its model on
    the card from seed 0, and the same parameters on the CPU."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import Model, build_model
    from repro_torch.models.common import tree_map
    arch = get_arch(name)
    arch = arch.replace(model=arch.model.replace(dtype="float32"))
    cfg = arch.model
    t0 = time.perf_counter()
    model = build_model(arch, device="cuda", seed=0)
    cpu_model = Model(cfg, tree_map(lambda t: t.detach().cpu(), model.params))
    torch.cuda.synchronize()
    widths = (f"{cfg.num_heads}/{cfg.kv_heads} heads x {cfg.hdim}"
              if cfg.num_heads else "")
    if cfg.family != "dense":
        widths = (f"{cfg.ssm_heads} SSD heads x {cfg.ssm_head_dim}, state "
                  f"{cfg.ssm_state}" + (f"; every {cfg.attn_every} layers "
                                        f"a shared block of {widths}"
                                        if widths else ""))
    print(f"  {name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{widths}, vocab {cfg.vocab_size}, {model.param_count():,} "
          f"parameters (fp32); built in {time.perf_counter() - t0:.2f} s")
    return arch, model, cpu_model


def phase_serve() -> dict:
    """Full-width smollm-360m served on the card (see the module docstring,
    3d); returns the runs' numbers and the launch totals."""
    import numpy as np
    import torch
    from repro_torch.serving import Generator
    arch, model, cpu_model = _full_width("smollm-360m")
    cfg = arch.model
    rows = {}
    totals = {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}
    rng = np.random.default_rng(0)
    gen = Generator(arch, model, max_seq=16 + 32 + 1, device="cuda")
    for r in range(2):                   # (a) the launcher's defaults
        prompts = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        rows[f"a{r}"] = _serve_run(gen, model, cpu_model, prompts, 32, 0.8,
                                   r, f"(a) request {r}")
    gen = Generator(arch, model, max_seq=512 + 64 + 1, device="cuda")
    prompts = rng.integers(0, cfg.vocab_size, (8, 512)).astype(np.int32)
    rows["b"] = _serve_run(gen, model, cpu_model, prompts, 64, 0.0, 0,
                           "(b) batch 8, prompt 512")
    for row in rows.values():
        for k, v in row["launches"].items():
            totals[k] += v

    # (c) prefill at batch 4, s 2048 vs the token-by-token decode loop
    b, s = FLASH_PATH["b"], FLASH_PATH["s"]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_path_launches()
    with torch.no_grad():
        t0 = time.perf_counter()
        pl, pc = model.prefill({"tokens": toks}, max_seq=s)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        cache = model.init_cache(b, s)
        t0 = time.perf_counter()
        for pos in range(s):
            dl, cache = model.decode_step(cache, toks[:, pos], pos)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
    launches = _path_launches()
    peak = torch.cuda.max_memory_allocated()
    check(launches == _want_launches(cfg, s, 1),
          f"(c): launches {launches}, want {cfg.num_layers} flash (one "
          f"forward) and {cfg.num_layers} x {s} decode")
    errs = {"last_logits": float((pl - dl).abs().max()),
            "cache_k": float((pc["k"] - cache["k"]).abs().max()),
            "cache_v": float((pc["v"] - cache["v"]).abs().max())}
    scale = float(dl.abs().max())
    for what, err in errs.items():
        check(err <= SERVE_TOL * max(1.0, scale),
              f"(c): prefill {what} vs the decode loop differ by {err:.3e}")
    for k, v in launches.items():
        totals[k] += v
    rows["c"] = {"batch": b, "prompt": s, "prefill_s": t_prefill,
                 "prefill_tok_per_s": b * s / t_prefill,
                 "decode_loop_s": t_decode,
                 "ms_per_decode_step": t_decode / s * 1e3,
                 "peak_mem_bytes": peak, "max_abs_err": errs,
                 "logits_max_abs": scale, "launches": launches}
    print(f"  (c) prefill b{b} s{s}: {t_prefill:.3f} s "
          f"({b * s / t_prefill:.0f} tok/s); decode loop {t_decode:.3f} s "
          f"({t_decode / s * 1e3:.3f} ms/step); peak {peak / 2**30:.3f} GiB; "
          f"prefill vs decode loop: " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items())
          + f"; launches={launches}")
    del pc, cache, pl, dl
    torch.cuda.empty_cache()
    prof = _profile_decode(model, torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (8, 512))).cuda())
    print("  decode-step profile: " + json.dumps(prof))
    return {"runs": rows, "launches": totals, "decode_profile": prof}


def _ragged_forward(model, cpu_model, rng, b: int, s: int) -> dict:
    """The card's teacher-forced forward over ``s`` positions against the
    CPU's, where s is no multiple of the model's 256-position chunk (so the
    CPU runs one chunk of s), with exactly one SSD launch per Mamba2 layer.
    Logits within SERVE_TOL of the largest."""
    import torch
    cfg = model.cfg
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    _reset_path_launches()
    with torch.no_grad():
        card = model.forward({"tokens": toks.cuda()})[0].cpu()
        launches = _path_launches()
        cpu = cpu_model.forward({"tokens": toks})[0]
    check(launches == _want_launches(cfg, 0, 1),
          f"ragged forward b{b} s{s}: launches {launches}")
    err, scale = float((card - cpu).abs().max()), float(cpu.abs().max())
    print(f"  ragged forward b{b} s{s}: card vs CPU logits {err:.3e} (largest "
          f"|logit| {scale:.3f}) launches={launches}")
    check(err <= SERVE_TOL * max(1.0, scale),
          f"ragged forward b{b} s{s}: card vs CPU logits differ by {err:.3e}")
    return {"batch": b, "positions": s, "logits_max_abs_err": err,
            "logits_max_abs": scale, "launches": launches}


def phase_serve_ssm() -> dict:
    """Full-width mamba2-370m and zamba2-2.7b served on the card (see the
    module docstring, 3e); returns the runs' numbers and launch totals."""
    import numpy as np
    import torch
    from repro_torch.serving import Generator
    rows = {}
    totals = {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}
    rng = np.random.default_rng(1)
    arch, model, cpu_model = _full_width("mamba2-370m")
    vocab = arch.model.vocab_size
    gen = Generator(arch, model, max_seq=16 + 32 + 1, device="cuda")
    for r in range(2):                   # (a) the launcher's defaults
        prompts = rng.integers(0, vocab, (4, 16)).astype(np.int32)
        rows[f"mamba2 a{r}"] = _serve_run(gen, model, cpu_model, prompts, 32,
                                          0.8, r, f"mamba2 (a) request {r}")
    # (b) perplexity's forward over 449 + 64 - 1 = 512 positions: two of
    # the model's 256-position chunks on the CPU
    gen = Generator(arch, model, max_seq=449 + 64 + 1, device="cuda")
    prompts = rng.integers(0, vocab, (8, 449)).astype(np.int32)
    rows["mamba2 b"] = _serve_run(gen, model, cpu_model, prompts, 64, 0.0, 0,
                                  "mamba2 (b) batch 8, prompt 449")
    for row in rows.values():
        for k, v in row["launches"].items():
            totals[k] += v
    rows["mamba2 ragged"] = _ragged_forward(model, cpu_model, rng, 2, 575)
    totals["ssd_scan"] += rows["mamba2 ragged"]["launches"]["ssd_scan"]
    prof = _profile_decode(model, torch.from_numpy(
        rng.integers(0, vocab, (8, 32))).cuda())
    print("  mamba2 decode-step profile: " + json.dumps(prof))
    del gen, model, cpu_model
    torch.cuda.empty_cache()

    arch, model, cpu_model = _full_width("zamba2-2.7b")
    gen = Generator(arch, model, max_seq=16 + 32 + 1, device="cuda")
    prompts = rng.integers(0, arch.model.vocab_size, (4, 16)).astype(np.int32)
    rows["zamba2 a0"] = _serve_run(gen, model, cpu_model, prompts, 32, 0.8, 0,
                                   "zamba2 (a) request 0")
    for k, v in rows["zamba2 a0"]["launches"].items():
        totals[k] += v
    del gen, model, cpu_model
    torch.cuda.empty_cache()
    return {"runs": rows, "launches": totals, "mamba2_decode_profile": prof}


# ----------------------------------------------------------------- main ----

KERNELS = [
    ("quantize8_ef", "src/repro_torch/csrc/quant8.cu",
     "src/repro/kernels/quant8/kernel.py:79"),
    ("topk_ef", "src/repro_torch/csrc/topk_ef.cu",
     "src/repro/kernels/topk_ef/kernel.py:34"),
    ("quantize8", "src/repro_torch/csrc/quant8.cu",
     "src/repro/kernels/quant8/kernel.py:63"),
    ("dequantize8", "src/repro_torch/csrc/quant8.cu",
     "src/repro/kernels/quant8/kernel.py:100"),
]
ATTN_KERNELS = [
    ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention/kernel.py:70"),
    ("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
     "src/repro/kernels/decode_attention/kernel.py:60"),
]
SSD_KERNEL = ("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
              "src/repro/kernels/ssd_scan/kernel.py:70")
PATH_KERNELS = ("quantize8_ef", "topk_ef")


def main() -> int:
    t0 = time.time()

    def phase(name: str) -> None:
        print(f"phase {name} (at {time.time() - t0:.1f} s)")

    phase("1: device")
    card = phase_device()
    import torch
    phase("2: kernels")
    kern = phase_kernels()
    attn = phase_attention_kernels()
    ssd = phase_ssd_kernel()
    phase("3: path")
    launches, preset, cpu_losses = phase_path()
    for name in PATH_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} never launched on the path")
    phase("3a: control")
    phase_control(preset, cpu_losses)
    phase("3b: profile")
    print(json.dumps({"profile": phase_profile(preset)}))
    phase("3c: presets")
    phase_presets()
    phase("3d: serve")
    serve = phase_serve()
    print(json.dumps({"serve": serve}))
    phase("3e: serve mamba2-370m and zamba2-2.7b")
    serve_ssm = phase_serve_ssm()
    print(json.dumps({"serve_ssm": serve_ssm}))
    serve_launches = {k: serve["launches"][k] + serve_ssm["launches"][k]
                      for k in serve["launches"]}
    for name in ("flash_attention", "decode_attention", "ssd_scan"):
        check(serve_launches[name] > 0,
              f"{name} never launched on the serving path")
    phase("4: summary")
    summary = []
    for name, source, replaces in KERNELS:
        main_row = kern["rows"][name][MOBILENET_N]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches.get(name, 0),
                 "max_abs_err": kern["errs"].get(name, 0.0),
                 "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                 "bound_ms": main_row["bound_ms"],
                 "bound_by": main_row["bound_by"],
                 "library_ms": main_row["library_ms"],
                 "n": MOBILENET_N, "held_against_plain": True,
                 "resnet50": kern["rows"][name][RESNET50_N]}
        if "topk_tau_ms" in main_row:
            entry["topk_tau_ms"] = main_row["topk_tau_ms"]
        summary.append(entry)
        print(f"  {name:13s} held bitwise against its plain version; "
              f"ms={entry['ms']:.5f} bound_ms={entry['bound_ms']:.5f} "
              f"plain_ms={entry['plain_ms']:.5f} "
              f"launches_on_path={entry['launches']}")
    for name, source, replaces in ATTN_KERNELS:
        row = attn[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": serve_launches[name],
                 **{k: row[k] for k in (
                     "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "shape", "library", "max_abs_err_bf16",
                     "timed_max_abs_err", "sweep_max_abs_err")},
                 **{k: row[k] for k in ("bound_fp32_ms", "bytes_bound_ms",
                                        "launch_us", "vs_float64", "shapes")
                    if k in row},
                 "held_against_plain": True}
        summary.append(entry)
        print(f"  {name:16s} held within {ATTN_TOL[name]} of its plain "
              f"version; ms={entry['ms']:.5f} bound_ms="
              f"{entry['bound_ms']:.5f} plain_ms={entry['plain_ms']:.5f} "
              f"library_ms={entry['library_ms']:.5f} "
              f"launches_on_path={entry['launches']}")
    name, source, replaces = SSD_KERNEL
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": serve_launches[name],
             **{k: ssd[k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "shape", "library", "recurrence_ms",
                 "bound_fp32_ms", "bytes_bound_ms", "launch_us",
                 "timed_max_abs_err", "path_max_abs_err",
                 "sweep_max_abs_err", "vs_float64",
                 "reference_caveats", "shapes")},
             "held_against_plain": True}
    summary.append(entry)
    print(f"  {name:16s} held within {SSD_TOL} of its plain versions; "
          f"ms={entry['ms']:.5f} bound_ms={entry['bound_ms']:.5f} "
          f"plain_ms={entry['plain_ms']:.5f} library_ms=none "
          f"launches_on_path={entry['launches']}")
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
