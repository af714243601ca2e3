"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. device -- the card's name and power limit (nvidia-smi), and a build of
   the CUDA kernels from ``src/repro_torch/csrc/`` (one nvcc per source,
   started together), with the planted copies that the bf16 controls run
   (PLANTED) and ptxas's registers and spill bytes of every flash forward
   and backward instance, read from the build's own output (PTXAS,
   PTXAS_BWD);
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
   continuation property and bf16 inputs (held against the chunked plain
   version in bf16 at the kernel's own chunks, where both round at the JAX
   model's points, within SSD_BF16_TOL of the largest |y| and
   SSD_BF16_NORM_TOL norm-wise, which a planted copy of the kernel that
   rounds nothing must miss; where the
   chunked version's own fp32 rounding misses SSD_TOL, the kernel must be
   within it of the float64 recurrence and nearer to it: a reference
   caveat), then against
   the float64 recurrence at s = 512 and 575 (within twice the error of
   the kernel it replaced, SSD_FP64_PARENT), and timed at every (b, s) of
   3e with a 3xTF32 (the kernels line's), an fp32 and a bytes bound (no
   PyTorch call computes the SSD: no library time); flash attention's
   backward kernel against autograd of the plain version (FLASH_BWD_TOL
   of the largest gradient) over FLASH_BWD_SWEEP (head dims 20 to 128,
   GQA groups, causal and full, ragged lengths, sq != sk), at the
   training path's shapes (b 8, s 64; h 3 / m 1, d 20 and h 15 / m 5, d
   64) in fp32 and bf16 and at b 4, s 2048, each fp32 gradient, there
   and at every swept shape, within the bound that the kernel's 3xTF32
   arithmetic allows it against float64 gradients, element by element
   (``ref.bwd_error_bound``: each product's dropped lo x lo term and
   truncated lo bits, fp32 sums over the row's length, the softmax's
   rounding, carried through the backward's steps), two calls bitwise
   equal, and ``FlashAttention``'s gradient equal to the
   kernel's; timed backward alone (the kernel, the plain version's
   autograd backward, SDPA's backward as the library yardstick; the
   kernel's time by launch) and forward + backward, against the 3xTF32
   bound of its five s x s x d products (the kernels line's), the fp32
   and the bytes bounds; then each fp32 gradient against float64 at b 4,
   s 2048 on seeded inputs within twice the error of the kernel it
   replaced (FLASH_BWD_FP64_PARENT; ``redesign_baseline`` reads it in any
   checkout); the SSD scan's backward kernel (through ``ssd_scan_fused``
   under autograd) against autograd of the chunked plain version, each
   gradient within SSD_BWD_TOL of its largest plain |g| (fp32 and bf16)
   and in fp32 within twice the plain version's error against the
   float64 recurrence's gradient, in bf16 within SSD_BF16_NORM_TOL
   norm-wise, which a planted backward that keeps its cotangents fp32
   must miss (PLANTED), two calls equal bit for bit, at the training
   path's shapes (SSD_BWD_PATH: mamba2-370m and zamba2-2.7b at b 8, s
   64) and over SSD_BWD_SWEEP (p 128 with an initial state, several
   chunks, a ragged chunk), timed at the path's shapes (the backward
   alone, forward + backward, the plain backward; 3xTF32, fp32 and bytes
   bounds, no library call), and the forward in bf16 against the chunked
   version in bf16 at those shapes within SSD_BF16_FWD_TOL and
   SSD_BF16_NORM_TOL, which the planted unrounded forward must miss; the
   SSD backward's fp32 gradients against float64 at the training path's
   shapes within twice the replaced kernel's error (SSD_BWD_FP64_PARENT);
   bf16 attention, which rounds where the JAX model does, against its
   plain version at every bf16 shape above and at the training path's
   (FLASH_BWD_PATH, with zamba2's shared block) and the train launcher's
   (LAUNCHER_ATTN: b 8, s 128, smollm's heads) by ``hold_bf16``: the
   whole tensor norm-wise, the shares of elements and rows that differ,
   and every element of a forward output within the tie witness's reach
   (the values that rounding its row's near-tie scores and probabilities
   either way can give), timed at ATTN_BF16_TIMED, LAUNCHER_ATTN and
   DECODE_BF16_TIMED beside SDPA in bf16 (a yardstick, not the same
   function), planted copies of the three attention kernels without the
   rounding (PLANTED) missing the norm-wise limits, and a quarter of a
   forward's rows taken from them missing a limit; and the attention
   kernels' fp32 output bits equal to those of the kernels before the
   bf16 repair (ATTN_FP32_SHA256_PARENT); the flash forward widened to
   dk != dv and dk up to 192 against its plain version in fp32 and bf16
   (``hold_bf16``, tie witness and all) over FLASH_WIDE_SWEEP (MLA's h 16,
   dk 192, dv 128 at s 64, 512 and 47; a GQA group at dk 24 / dv 16 and
   16 / 24; dk = dv = 192; dk 192 beside dv 64) and at phase 3i's shapes
   (FLASH_MOE_PATH), timed at MLA's b 2, s 512 in fp32 and bf16
   (FLASH_MLA_TIMED; SDPA computes the fp32 function), decode attention
   timed at grok's heads (DECODE_GROK_TIMED), and the bf16 flash outputs
   at today's shapes equal to the bits of the kernel before the widening
   (ATTN_BF16_SHA256_PARENT); the backward widened to the same widths
   (``phase_flash_bwd_wide``): against autograd of the plain version over
   FLASH_BWD_WIDE (dk 192 / dv 128, 192 / 192, 24 / 16, causal and full,
   ragged GQA groups, h 16 / m 4 at 192 / 128) and phase 3j's shapes
   (FLASH_BWD_MOE_PATH) in fp32 (FLASH_BWD_TOL, within twice the plain
   version's float64 error) and bf16 (``hold_bf16``), two calls bitwise
   equal; at each shape above 128 the backward's tie witness's flips read
   and the unrounded function required to miss it
   (``wide_witness_controls``); timed at deepseek's b 8, s 64, h 16, dk
   192, dv 128 in fp32 and
   bf16 beside SDPA's backward, a gradient at 192 / 128 and 160 / 160
   taken on the card through ``FlashAttention`` and 200 / 128, 256 / 256
   refused with ``ValueError`` before any kernel, ptxas's registers and
   spill bytes of every backward instance (PTXAS_BWD), and its bf16 bits
   at the old widths equal to those of the kernel before the widening
   (FLASH_BWD_BF16_SHA256_PARENT); and at phases 3k's and 3l's shapes
   (``phase_vlm_encoder_kernels``): the flash forward at the vlm's h 64 /
   m 8, d 128 (self causal, cross full: sq 32 or 64 against the 1024
   image keys) and hubert's h 16, d 80 full (fp32, hubert's bf16 too),
   the decode kernel at the vlm's caches and its 1024 image keys, the
   backward at 3k (f)'s and 3l's gradient shapes and over
   FLASH_BWD_SWEEP_VLM_ENC (a full d 80 and a sq 64 / sk 1024 d 128
   shape), each against its plain version, then timed beside its bound and SDPA's time
   (FLASH_VLM_ENC_TIMED, FLASH_BWD_VLM_ENC_TIMED, DECODE_VLM_TIMED);
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
3c. presets -- every trial of every ported study preset (quick sizes)
   through ``run_experiment`` on the card and on the CPU, records
   compared (the two presets that train a zoo architecture are 3g's);
3d. serve -- full-width smollm-360m (fp32, random weights from a seeded
   ``torch.Generator``; the runs over its first SERVE_LAYERS of 32
   layers) through ``Generator`` and ``perplexity`` on
   ``device="cuda"``: (a) the launcher's defaults (2 requests of batch 4,
   prompt 16, 32 new tokens at temperature 0.8), (b) batch 8, prompt 512,
   64 new greedy tokens, (c) ``Model.prefill`` at batch 4, s 2048 against
   the token-by-token decode loop.  Launch counters are zeroed before each
   run and read after: decode launches must equal layers x decode steps,
   flash launches layers x forwards.  The card's per-step logits (those
   of the run's own decode steps, copied to the host as it makes them) and
   perplexity must match the same model's on the CPU, teacher-forced with
   those tokens, within SERVE_TOL; greedy tokens must be the card logits'
   argmax, and the CPU's wherever its top-two margin exceeds twice
   SERVE_TOL; then a profile of 16 decode steps; first, over all 32
   layers, the model's fp32
   logits over decode steps, a forward and a prefill hash as the port's
   before rope's tables were shared (SERVE_FP32_SHA256_PARENT);
3e. serve -- full-width mamba2-370m (over its first MAMBA2_SERVE_LAYERS
   of 48 layers) and zamba2-2.7b (fp32, seeded random weights): mamba2
   (a) the launcher's defaults, (b) batch 8, prompt 449, 64 greedy tokens
   (perplexity's forward over 512 positions, two of the model's
   256-position chunks), then a teacher-forced forward at batch 2
   over 575 positions (one chunk of 575 on the CPU) and a profile of 16
   decode steps; zamba2 (a) one request.  Each run as in 3d, and the
   card's forward logits held against its own decode steps' too;
   launches exact: SSD = Mamba2 layers x forwards (none in a decode step),
   flash = shared-block uses x forwards, decode = uses x steps;
3f. elastic, planner and CLI -- (a) phase 3's full-size int8 spec on an
   elastic fleet (``schedule:4@0,8@2``, 2 epochs) on the card and the
   CPU: metered fields and ``scaling_timeline`` equal, losses within
   CARD_VS_CPU_RTOL, and ``quantize8_ef`` launched exactly once per live
   worker per round (the live width summed over the rounds, read from the
   timeline; these launches join the kernels line's count); (b) every
   ``elastic_axis`` trial at full size (400,000 rows) on the card and the
   CPU, records compared as in 3c; (c) ``plan()`` picks faas for
   ``lr_higgs`` and iaas for ``mobilenet_cifar10``, ``python -m
   repro_torch plan`` prints the same rows on the card and the CPU (the
   two named workloads and (a)'s spec), and ``estimate_epochs`` on
   LR/Higgs counts the same epochs on both; (d) ``python -m repro_torch
   trace fig10_trace --quick --export chrome`` in a subprocess on the
   card: every conservation gate OK and every JSON file it writes loads.
   The seconds of (a)-(d) are printed, and the script's total;
3g. train smollm-360m -- (a) the 9 trials of ``faas_vs_pod`` and
   ``pod_local_sgd`` (quick: the reduced config in bf16) on the card and
   the CPU, records compared within ARCH_CARD_VS_CPU_RTOL, and a control
   at learning rate x ARCH_CONTROL_LR that must miss it; (b) full width
   (32 layers, d_model 960, 409,007,040 parameters), one TokenStream
   batch (b 8, s 64) through ``ArchWorkload.grad`` on the card and the
   CPU from one seeded init, in fp32 (loss within 1e-5, each leaf within
   FULL_FP32_GRAD_TOL of its largest |g|, wq/wk/wv non-zero) and bf16,
   a second card gradient compared leaf by leaf (recorded); (c) one
   full-width bf16 trial (FULL_TRIAL, cut by FULL_TRIAL_OVER so the CPU
   side stays near a minute; 3h's helper process makes the CPU run) on
   both, metered fields equal, losses within FULL_TRIAL_RTOL, a second card run compared (recorded), and
   exactly the launches of
   ``flash_attention``, ``flash_attention_bwd`` and ``quantize8_ef`` the
   spec implies; (d) ``python -m repro_torch serve --grid --no-cache`` on
   the card: the same text as on the CPU and the frontier's invariants.
   Launch counters are zeroed before each card run and read after; the
   training launches join the kernels line's counts.  The seconds of
   (a)-(d) are printed;
3h. train mamba2-370m and zamba2-2.7b -- 3g's checks, at 3g's constants
   except where these models' own rounding noise exceeds them,
   with the CPU sides in two helper processes started after phase 1
   (``--cpu-side``, 4 threads: 3g (c)'s, (c)'s and (b)'s CPU sides,
   then (b)'s card gradients; ``--cpu-side-moe``, 1 thread: (a)'s CPU
   records, then (b)'s op witness at 4 threads once let onto the card):
   (a) 3g (a)'s 9 trials with each model (reduced,
   bf16) card vs CPU within ARCH_CARD_VS_CPU_RTOL, a control at lr x
   ARCH_CONTROL_LR per model that must miss it; (b) one full-width
   gradient of each (b 8, s 64): fp32 within FULL_LOSS_RTOL and
   FULL_SSM_FP32_GRAD_TOL (3g's 2e-5 lies inside these models' own
   rounding noise: ``grad_witnesses``; mamba2's CPU gradient with its SSD
   in float64 is read beside it; a planted ddt x1.01 fault must miss it
   by SSD_CONTROL_MARGIN), bf16 within FULL_BF16_LOSS_RTOL (its leaves
   read: in bf16 they part by 4-19% norm-wise between any two correct
   implementations), every SSD backward of each gradient held in situ
   against the plain backward on its own inputs and cotangents (fp32
   within SSD_BWD_TOL, bf16 within SSD_BF16_NORM_TOL norm-wise; the
   planted ddt x1.01 must miss both by SSD_CONTROL_MARGIN), every other
   op of the bf16 gradient held against the same op on the CPU on the
   same inputs (``op_witness``, with two planted ops that must miss), a
   second card gradient equal bit for bit (the helpers make the card
   gradients and the witness from 3g on, beside 3g and (a)'s card runs);
   (c) FULL_TRIAL with mamba2-370m at full width in fp32 within
   FULL_TRIAL_RTOL, a control at lr x FULL_TRIAL_CONTROL_LR that must
   miss it.  Launches exact where 3g's are; they join the kernels line;
3i. serve the MoE family -- deepseek-v2-lite-16b at full width and depth
   (27 layers, MLA, 64 experts top 6 + 2 shared, 15.71 B parameters,
   fp32, seeded weights drawn on the card): (a) the launcher's defaults,
   each request's forward held against its replayed decode steps within
   SERVE_TOL (the absorbed MLA decode against the materialised MLA
   prefill through the widened flash kernel); the first MOE_CUT_LAYERS
   layers (1.67 B parameters) served greedily, card vs CPU within
   SERVE_TOL, greedy tokens by the margin rule, and the CPU's own
   forward-vs-decode gap read; (b) a teacher-forced forward at b 2 over
   512 positions, the cut's forward card vs CPU; (c) a profile of 16
   decode steps.  grok-1-314b at full width over its first GROK_LAYERS
   of 64 layers (11.45 B parameters): (a) the launcher's defaults, (b)
   ``Model.prefill`` at b 2, s 512 against the token-by-token decode
   loop, and the reduced grok card vs CPU.  Launches exact: flash =
   layers x forwards, decode attention = layers x steps (none for MLA).
   Routing: a token whose K-th and (K+1)-th gates differ by about the
   fp32 sums' rounding routes either way on two sound runs, so a run
   held against another takes the other's experts (``Routes``, a hook
   local to this script), each forced expert's gate within
   ROUTE_GATE_TOL of its token's own K-th (a planted wrong route must
   miss), and the forwards held against decode steps drop no assignment
   (a capacity factor of 1.0 drops them in a forward of b*s tokens, never
   in deepseek's step of 4); the phase's seconds are printed;
3j. train the MoE family -- (b) between 3h and 3i: deepseek-v2-lite-16b
   at full width over its first MOE_CUT_LAYERS layers (1.67 B parameters,
   seeded on the card), one FULL_BATCH gradient on the card in fp32 and
   bf16: launches exact, its seconds and peak memory, a second call equal
   bit for bit with every flash attention of it held in situ against the
   plain version on its own inputs (bf16: ``hold_bf16``), one profiled
   call's device time by class; the same gradients on the CPU with the
   card's experts forced (:class:`Routes`), in a thread beside 3i: fp32
   loss within FULL_LOSS_RTOL and each leaf within FULL_FP32_GRAD_TOL,
   bf16 loss within FULL_BF16_LOSS_RTOL (its leaves read), each forced
   bf16 route within ROUTE_BF16_ULPS of the logit it displaces (a
   planted wrong route must miss); (a) in the
   second helper process (``--cpu-side-moe``, after 3h's witness), the 9
   quick trials of ``faas_vs_pod`` and ``pod_local_sgd`` with deepseek
   and grok (reduced, MOE_TRIAL_DTYPE) on the card, then, once the first
   helper is done, on the CPU with the card's experts forced over the
   whole trial: metered
   fields equal, losses within ARCH_CARD_VS_CPU_RTOL, a control at lr x
   ARCH_CONTROL_LR per model that must miss it, every forced gate within
   ROUTE_GATE_TOL of its token's own K-th and a planted wrong route
   caught, launches exact (flash forward and backward, quantize8_ef per
   int8 merge); held after 3i, the phase's seconds printed;
3k, 3l. the vlm and encoder families -- their card-vs-CPU work is a third
   helper process's (``--cpu-side-vlm``), started before phase 1's build
   at the lowest CPU priority, which makes the CPU sides beside phases
   1-3c while the host's memory is free, then takes the card between 3c
   and 3d (the slot: the main process waits) and last holds on the CPU,
   beside 3d on, what needs the card's results.  Both sides build their
   parameters by ``_counter_params``: the same bits on the card and the
   CPU (a sample held equal), with no copy between them.
   3l: hubert-xlarge at full width and depth (48 layers, 944,487,680
   parameters, fp32): in the slot a forward at b 8 over 512 frames, two
   steps of its own TrainConfig (AdamW, lr 3e-4, clip 1.0) at b 2 over
   128 frames in fp32 and in bf16, an AdamW, an 8-bit AdamW and an SGD
   step from the first fp32 gradient (clip off, over ``_layer0``), the
   AdamW update alone timed with the port's card arithmetic, through
   float64 (held equal bit for bit) and in plain fp32, launches exact; then on the CPU: the fp32 loss within FULL_LOSS_RTOL
   and each gradient leaf within FULL_FP32_GRAD_TOL, the bf16 losses at
   the card's own parameters within FULL_BF16_LOSS_RTOL, the three steps'
   parameters within OPT_CARD_VS_CPU_ULPS with AdamW's moments and the
   8-bit codes and scales equal, the first clipped step (the global norm,
   the moments and the parameters) within OPT_CLIP_ULPS, and a planted
   wrong clip (each leaf by its own norm) that must miss it;
   3k: llama-3.2-vision-90b at full width.  In the slot its first group
   (5 layers, 6,379,626,496 parameters): (e) a forward at b 1 over 32
   positions and 8 decode steps card vs CPU (SERVE_TOL), (f) its fp32
   gradient at b 4, s 64 with every flash attention held in situ, card vs
   CPU (FULL_LOSS_RTOL, each leaf FULL_FP32_GRAD_TOL) when the host had
   VLM_GRAD_HOST_GIB free for it, and always the reduced config's
   gradient card vs CPU.  After 3j, in the main process with no CPU side
   running, its first VLM_GROUPS of 20 groups (10 layers,
   10,657,898,496 parameters, seeded on the card): (a) a forward at b 2
   over 32 positions with seeded image embeddings (1024 tokens) against
   32 teacher-forced decode steps after ``prime_cross_cache``
   (SERVE_TOL), (b) zeroed image embeddings must move the logits by 10x
   that, (c) ``Generator.generate`` (no image primed, as in the JAX
   package) held against the forward on zero image embeddings, (d) a
   profile of the decode steps.  Launches exact (the cross attention's
   decode through the decode kernel at length 1024);
3m. train through the launcher -- smollm-360m at full width (32 layers,
   409,007,040 parameters, its config's bf16 and AdamW) through
   ``launch.train.main`` in this process at the launcher's defaults (b 8,
   s 128, mesh 1x1): (a) 6 steps without a checkpoint against 4 steps
   that checkpoint, a resume to 5 with ``--lifetime 0`` (the guard fires
   and writes step 5), and a resume from the guard's checkpoint to 6:
   losses, parameters and AdamW state equal bit for bit; (b) a one-rank
   NCCL process group (a ``FileStore`` under ``build/``): the
   ``allreduce`` and the ``scatter_reduce`` steps over it equal the steps
   without a group bit for bit, and one step profiled (device busy and
   idle share); (c) two pods stacked on the card, ``--mesh 2x1x1
   --algorithm diloco --compress --sync-period 2``, 4 inner steps: each
   pod's loss per step, and after each outer step the replicas equal and
   the int8 residuals non-zero; (d) the reduced config's 6 launcher steps
   and its two-pod DiLoCo run, card vs CPU from one init, and two
   full-width steps from counter-built parameters against the third
   helper's CPU run, within LAUNCHER_CPU_RTOL; (e) flash attention's
   forward and backward launched exactly once per attention layer per
   step; they join the kernels line's counts.  Its seconds are printed;
4. summary -- one JSON line listing every ported kernel and the two
   backward kernels.

The last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the repository around it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12        # H100 SXM dense TF32 on the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 on the tensor cores
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
#: deepseek-v2-lite-16b's MLA prefill (phase 3i): h 16 over m 16 (the
#: per-head K materialised from the latent), dk 192 = nope 128 + rope 64,
#: dv 128; grok-1-314b's attention: h 48 over m 8, head_dim 128
MLA_HEADS, MLA_DK, MLA_DV = 16, 192, 128
GROK_HEADS, GROK_KV_HEADS, GROK_HEAD_DIM = 48, 8, 128
#: the widened flash forward against its plain version (b, sq, sk, h, m,
#: dk, dv, causal): MLA's heads at s 64, 512 and a ragged 47, a GQA group
#: with dk != dv (both up to 128: one padded width), dk = dv = 192, and
#: dk 192 beside dv 64 (dv padded to 128)
FLASH_WIDE_SWEEP = tuple(
    (2, s, s, MLA_HEADS, MLA_HEADS, MLA_DK, MLA_DV, causal)
    for s in (64, 512, 47) for causal in (True, False)) + (
    (2, 47, 47, 4, 2, 24, 16, True), (2, 47, 47, 4, 2, 24, 16, False),
    (1, 130, 577, 4, 2, 24, 16, False), (2, 47, 47, 4, 2, 16, 24, True),
    (2, 47, 47, 3, 1, 192, 192, True), (1, 577, 577, 3, 1, 192, 192, False),
    (2, 200, 200, 4, 2, 192, 64, True))
#: the shapes phase 3i's forwards give flash attention (b, s, h, m, dk,
#: dv): deepseek's launcher-default perplexities and its forward at b 2
#: over 512, grok's the same and its prefill
FLASH_MOE_PATH = ((4, 16 + 32 - 1, MLA_HEADS, MLA_HEADS, MLA_DK, MLA_DV),
                  (2, 512, MLA_HEADS, MLA_HEADS, MLA_DK, MLA_DV),
                  (4, 16 + 32 - 1, GROK_HEADS, GROK_KV_HEADS, GROK_HEAD_DIM,
                   GROK_HEAD_DIM),
                  (2, 512, GROK_HEADS, GROK_KV_HEADS, GROK_HEAD_DIM,
                   GROK_HEAD_DIM))
#: the MLA row of the kernel table: 3i's forward at b 2 over 512
FLASH_MLA_TIMED = FLASH_MOE_PATH[1]
#: the decode row at grok's heads: the last step of 3i (b)'s launcher
#: defaults (b 4, S 49, 48 positions)
DECODE_GROK_TIMED = (4, 16 + 32 + 1, 16 + 32)
#: flash attention against attention in float64 (the main shape, inputs
#: from FLASH_FP64_SEED): the CUDA-core kernel that the tensor-core one
#: replaced read this max |o - exact| on these inputs
#: (``flash_vs_float64`` run in its checkout, NVIDIA H100 80GB HBM3 at
#: 700 W); the tensor-core kernel may err by at most twice as much
FLASH_FP64_SEED = 3
FLASH_FP64_PARENT = 1.1232379750758525e-06
#: flash attention's backward kernel against float64 gradients (the main
#: shape, FLASH_PATH with smollm's heads, inputs from FLASH_BWD_FP64_SEED):
#: the CUDA-core kernel that the tensor-core one replaced read these max
#: |g - exact| per gradient on these inputs (``flash_bwd_vs_float64`` run
#: in its checkout, NVIDIA H100 80GB HBM3 at 700 W); the tensor-core kernel
#: may err by at most twice as much
FLASH_BWD_FP64_SEED = 4
FLASH_BWD_FP64_PARENT = {"dq": 1.1793459622211344e-06,
                         "dk": 3.1825717510258755e-06,
                         "dv": 4.822609632526564e-06}
#: flash attention's backward kernel against autograd of the plain version
#: on the card, relative to the largest |plain gradient|: fp32 sums in other
#: orders (up to 2.3e-6 of it measured on an H100); bf16 gradients are
#: rounded from fp32 by each side, and the plain version rounds each GQA
#: copy of dk/dv to bf16 before summing them (up to 7.8e-3)
FLASH_BWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: the training path's attention shapes (b, s, h, m, d): smollm-360m's
#: reduced config (phase 3g (a)) and full width (3g (b), (c)), and
#: zamba2-2.7b's shared block at full width (3h (b)), at b 8, s 64
_ZAMBA2_ATTN = (ZAMBA2_HEADS, ZAMBA2_KV_HEADS, ZAMBA2_HEAD_DIM)
FLASH_BWD_PATH = ((8, 64, 3, 1, 20), (8, 64, *_SMOLLM_ATTN),
                  (8, 64, *_ZAMBA2_ATTN))
#: the backward kernel against autograd of the plain version over head
#: dims, GQA groups, causal and full attention, ragged lengths and sq != sk
#: (b, sq, sk, h, m, d, causal): every code path of its launches
FLASH_BWD_SWEEP = ((2, 47, 47, 3, 3, 20, True), (2, 47, 47, 3, 1, 20, False),
                   (1, 577, 577, 15, 5, 64, True),
                   (1, 130, 577, 6, 2, 64, False),
                   (1, 577, 130, 6, 2, 64, True),
                   (2, 200, 200, 4, 1, 80, True),
                   (1, 150, 150, 4, 2, 128, True),
                   (1, 150, 150, 2, 2, 128, False))
#: the backward widened to the forward's widths (b, s, h, m, dk, dv,
#: causal), each against autograd of the plain version, within twice the
#: plain version's float64 error, bitwise on repeat, in fp32 and bf16:
#: MLA's h 16 at dk 192 / dv 128, dk = dv = 192 and dk 24 / dv 16 (the
#: reduced deepseek's MLA), causal and full, ragged GQA groups (the dk/dv
#: launch split over the query heads, its partials at dk + dv), h 16 / m 4
#: at 192 / 128 over a ragged 130 positions, and phase 3j's training
#: shapes (FLASH_BWD_MOE_PATH)
FLASH_BWD_WIDE = tuple(
    (2, 64, MLA_HEADS, MLA_HEADS, MLA_DK, MLA_DV, causal)
    for causal in (True, False)) + tuple(
    (2, 47, 4, 2, dk, dv, causal) for dk, dv in ((192, 192), (24, 16))
    for causal in (True, False)) + (
    (1, 130, MLA_HEADS, 4, MLA_DK, MLA_DV, True),)
#: phase 3j's attention shapes (b, s, h, m, dk, dv), causal: deepseek's
#: reduced MLA (3j (a)) and full width (3j (b): the kernels line's rows 5n
#: and 5o, timed), the reduced grok's GQA (3j (a))
FLASH_BWD_MOE_PATH = ((8, 64, 4, 4, 24, 16),
                      (8, 64, MLA_HEADS, MLA_HEADS, MLA_DK, MLA_DV),
                      (8, 64, 4, 2, 16, 16))
#: timed at the path's full-width shape and at the prefill's b 4, s 2048
#: (the kernels line's row: long enough to be more than launch latency)
FLASH_BWD_TIMED = ((FLASH_PATH["b"], FLASH_PATH["s"], *_SMOLLM_ATTN),
                   FLASH_BWD_PATH[1], FLASH_BWD_PATH[0])
#: bf16 attention kernels against their plain versions, which round where
#: the JAX model's _sdpa and gqa_decode round.  Where both round at the
#: same points they part only where an fp32 value lies within its last
#: bits of a bf16 rounding boundary (products summed in other orders,
#: another exp): a score or probability that rounds the other way moves
#: its row, the more the larger its probability against the row's output
#: (an H100 read 1.33e-3 norm-wise and 6% of the elements over a b 3, h 3
#: decode: one row of nine moved by 3.8e-3, reached by the witness through
#: its six near-tie scores, the largest of probability 0.0093, not its top
#: score).  The kernels without the rounding points (PLANTED:
#: the kernels before the repair) move every row, 3.2e-3 to 4.7e-3 and
#: 51-63% at the training path's shapes.  So ``hold_bf16`` holds the
#: whole tensor norm-wise, the share of its elements and the share of its
#: rows (a row: one output or gradient vector, the last dim) that differ
#: at all, and a forward output's every element within the tie witness
#: (``_bf16_reach``): the values that rounding the row's near-tie scores
#: and probabilities either way can give.  Outputs: ATTN_BF16_NORM_TOL
#: (between the sound kernels' 1.33e-3 and the planted 3.23e-3),
#: ATTN_BF16_SHARE_TOL (sound 6.0%, planted 51%); gradients, where a
#: flip spreads over the key axis in small parts, ATTN_BF16_GRAD_NORM_TOL
#: and ATTN_BF16_GRAD_SHARE_TOL (sound 1.37e-4 and 0.24%, planted 3.76e-3
#: and 57%); both ATTN_BF16_ROW_SHARE_TOL (sound 22%: two of a b 3, h 3
#: decode's nine rows, 16% of a 141-row flash; planted 98%).  Readings:
#: an H100 80GB HBM3 at 700 W over phase 2
ATTN_BF16_NORM_TOL = 2e-3
ATTN_BF16_SHARE_TOL = 0.1
ATTN_BF16_ROW_SHARE_TOL = 1 / 3
ATTN_BF16_GRAD_NORM_TOL = 5e-4
ATTN_BF16_GRAD_SHARE_TOL = 1e-2
#: the tie witness's fp32 error bands, in units of 2^-24 for a sum of n
#: terms: TIE_SUM_ULPS[0] + TIE_SUM_ULPS[1] sqrt(n) ulps of the sum of the
#: terms' magnitudes (the scores' d products, P V's keys); a probability:
#: TIE_P_ULPS[0] + TIE_P_ULPS[1] sqrt(n) + n / TIE_P_ULPS[2] ulps of
#: itself (exp, the division, the row's sum of n terms and its rescalings
#: by tile).  These are statistical bands (a sum's rounding errors add up
#: as a random walk), not worst-case ones, which would cover every bf16
#: boundary at long rows and catch nothing
TIE_SUM_ULPS = (4.0, 2.0)
TIE_P_ULPS = (16.0, 4.0, 16.0)
#: the backward's tie witness (``_bf16_bwd_explained``) tries at most
#: this many near ties per stage, those nearest a bf16 boundary first
TIE_FLIPS_TRIED = 256
#: the witness also runs at these multiples of its bands, read only (the
#: sound kernels' unexplained elements at narrower bands, the planted ones'
#: at wider): how far the bands are from the readings
TIE_SCALES_READ = (0.125, 8.0)
#: bf16 attention timed at the training path's shapes (b, s, h, m, d):
#: full-width smollm-360m (3g) and zamba2-2.7b's shared block (3h), and
#: decode attention in bf16 at smollm's heads (b, S, length)
ATTN_BF16_TIMED = (FLASH_BWD_PATH[1], FLASH_BWD_PATH[2])
DECODE_BF16_TIMED = DECODE_TIMED[0]
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
#: bf16 inputs: the kernel against the chunked plain version in bf16 at
#: the kernel's chunks (the same rounding points), relative to the largest
#: |y|: the two round fp32 values that differ in their last bits, so now
#: and then one masked score or x dt rounds to the neighbouring bf16
#: value, a term off by 2^-8 of itself (an H100 read 1.1e-3); the
#: attention kernels' bf16 rule
SSD_BF16_TOL = ATTN_TOL["flash_attention"]["bfloat16"]
#: the repaired bf16 forward against the chunked version in bf16 at the
#: training path's shapes (one chunk in both: the JAX model's rounding
#: points), max |kernel - plain| relative to the largest |y|: an H100 read
#: 2.45e-4 (mamba2) and 1.22e-4 (zamba2); its planted copy that rounds
#: nothing (PLANTED "ssd_scan", b87ae5a's kernel) read 4.204e-3 and
#: 2.804e-3, b87ae5a's own readings, and must miss it
SSD_BF16_FWD_TOL = 1e-3
#: bf16, kernel against plain, norm-wise: ||kernel - plain|| / ||plain||
#: of each output or gradient.  Where both round at the same points they
#: part only where an fp32 value lies within its last bits of a bf16
#: rounding boundary, a few elements in a thousand; a kernel that skips a
#: rounding point is off by up to half a bf16 ulp in every element.  An
#: H100 read: the forward at most 5.7e-5 over phase 2's sweep, its planted
#: unrounded copy at least 2.25e-3; the backward at most 9.5e-5 over phase
#: 2's rows, the planted backward that keeps its cotangents fp32 at least
#: 2.7e-3 in each row's worst gradient; in situ in 3h (b) at most 2.6e-4
#: (dC, real activations), a planted ddt x1.01 1.0e-2.  The planted
#: copies must miss it at every shape
SSD_BF16_NORM_TOL = 5e-4
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
#: the SSD backward kernel against autograd of the chunked plain version
#: on the card, each gradient relative to its largest plain |g|: fp32 sums
#: in other orders, the decays in float64 where the plain version takes
#: fp32 cumsums; bf16: both round the cotangents at the same five points,
#: from fp32 values that differ in their last bits (FLASH_BWD_TOL's rule)
SSD_BWD_TOL = FLASH_BWD_TOL
SSD_GRAD_NAMES = ("dx", "ddt", "da_log", "dB", "dC", "dinit")
#: the training path's SSD shapes (b, s, h, p, n): mamba2-370m and
#: zamba2-2.7b at b 8, s 64 (phase 3h (b), (c)), model-like inputs, no
#: initial state, the final state unused
SSD_BWD_PATH = ((8, 64, *MAMBA2_SSD), (8, 64, *ZAMBA2_SSD))
#: the backward's other shapes (b, s, h, p, n, initial state), with
#: tests/test_kernels.py's ranges and a cotangent of the final state: a
#: stress shape (p 128, n 64), several chunks with a ragged tail, and a
#: ragged single chunk at n 128
SSD_BWD_SWEEP = ((1, 64, 2, 128, 64, True), (2, 200, 4, 64, 32, True),
                 (2, 47, 3, 32, 128, False))
#: the SSD backward kernel against the float64 recurrence's gradients at
#: the training path's shapes (SSD_BWD_PATH, model-like inputs from
#: SSD_BWD_FP64_SEED, ``ssd_bwd_vs_float64``): the CUDA-core kernel that
#: the tensor-core one replaced (30f83f0) read these max |g - exact| per
#: gradient on an H100 80GB HBM3 at 700 W; the tensor-core kernel may err
#: by at most twice as much
SSD_BWD_FP64_SEED = 9
SSD_BWD_FP64_PARENT = {
    "b8 s64 h32 p64 n128": {
        "dx": {"kernel": 4.258244698007729e-05},
        "ddt": {"kernel": 0.00025093413046306523},
        "da_log": {"kernel": 0.00024903559227595906},
        "dB": {"kernel": 7.248248908808819e-05},
        "dC": {"kernel": 4.299599274304455e-05}},
    "b8 s64 h80 p64 n64": {
        "dx": {"kernel": 2.9794200273158822e-05},
        "ddt": {"kernel": 0.00023818629915695055},
        "da_log": {"kernel": 0.00021078774619809337},
        "dB": {"kernel": 6.263409605367087e-05},
        "dC": {"kernel": 5.819761590686312e-05}}}
#: card vs CPU loss tolerance: the card's fp32 matrix products sum in
#: another order than the CPU's, and one ulp of gradient difference can
#: move an int8 code by a step or swap a top-k survivor.  It lies between
#: the sound readings (at most 1.7e-6 relative on an H100) and the TF32
#: control of phase 3a, which must exceed it.
CARD_VS_CPU_RTOL = 1e-5

#: phase 3g (a): card vs CPU loss tolerance of the 9 quick zoo-training
#: trials (smollm-360m reduced, from bf16 parameters, the config's dtype;
#: fp32 from the first merge on, as in the JAX package): the first
#: gradients round to bf16 at other places on the card, and fp32 sums run
#: in other orders.  An H100 read at most 7.98e-6 over the 9 trials; a
#: learning rate x ARCH_CONTROL_LR on the first trial reads 1.02e-3 and
#: must miss it
ARCH_CARD_VS_CPU_RTOL = 1e-4
ARCH_CONTROL_LR = 1.01
#: 3g (c): the same for the full-width trial, whose first gradients carry
#: 32 layers of bf16 rounding at other places: an H100 read 1.26e-3 (and
#: 8.5e-4, 1.09e-3 in two runs of code that kept the parameters bf16)
FULL_TRIAL_RTOL = 3e-3
#: 3g (b): full-width smollm-360m, one batch (b 8, s 64), card vs CPU.  In
#: fp32 the loss within 1e-5 (relative) and each leaf's gradient within
#: FULL_FP32_GRAD_TOL of that leaf's largest |g| on the CPU (fp32 sums in
#: other orders through 32 layers: an H100 read 2.1e-6); in bf16 within
#: FULL_BF16_LOSS_RTOL and FULL_BF16_GRAD_TOL (bf16 rounding at other
#: places in each layer: 8.2e-5 and 1.3e-2)
FULL_LOSS_RTOL = 1e-5
FULL_FP32_GRAD_TOL = 2e-5
FULL_BF16_LOSS_RTOL = 1e-3
FULL_BF16_GRAD_TOL = 5e-2
FULL_BATCH = dict(b=8, s=64)
#: 3g (c): one full-width bf16 trial of pod_local_sgd's int8 LocalSGD
#: row, cut so that the CPU side stays near a minute (a full-width bf16
#: gradient takes about 8 s on the CPU, an int8 pass of the 409M-element
#: update a few): 2 workers, 20 rows (18 to train, 9 a worker, so 2 rounds
#: of batch 8 an epoch), one epoch, the codec at every round (local:1:c8)
#: -- 4 gradients, two int8 merges of 2 workers.  A time limit, not a
#: choice that hides a fault.
FULL_TRIAL = ("pod_local_sgd", "podsgd_local8_c8")
#: the bf16 controls' planted faults: a copy of a kernel's source with
#: its rounding points taken out, built beside the kernels in phase 1
#: (each text must occur once in the source)
PLANTED_DIR = ROOT / "build" / "planted"
_NO_BF16_ROUNDING = ("kRounds = sizeof(T) == 2;", "kRounds = false;")
PLANTED = {
    # the attention kernels before the bf16 repair (the float32 code path
    # for bf16 too), instantiated only for bf16 at head dims 20, 64 and 80
    # (what the controls run)
    "flash_attention": (_NO_BF16_ROUNDING,
                        ("dispatch<float>(q, k, v, o, lse, batch, heads, "
                         "group, sq, sk, d,\n                            dv, "
                         "st, sm_scale, div, causal, stream)",
                         "cudaErrorInvalidValue"),
                        *((f"    REPRO_FA_CASE({nc})\n", "")
                          for nc in (1, 3, 6, 7, 8)),
                        ("  if (nc <= 12 && nv <= 8) return launch<T, 12, 8>"
                         "(P, batch, stream);\n  if (nc <= 12 && nv <= 12) "
                         "return launch<T, 12, 12>(P, batch, stream);\n",
                         "")),
    "flash_attention_bwd": (_NO_BF16_ROUNDING,
                            ("run<float>(q, k, v, dout, lse, rows, part, dq, "
                             "dk, dv, batch,\n                       heads, "
                             "kv_heads, sq, sk, d, dv_d, st, sm_scale, div,"
                             "\n                       causal, stream)",
                             "cudaErrorInvalidValue"),
                            *((f"    REPRO_FAB_CASE({nc})\n", "")
                              for nc in (1, 3, 6, 7, 8))),
    "decode_attention": (_NO_BF16_ROUNDING,
                         ("err = dispatch<float>(P, units, piece, stream);",
                          "err = cudaErrorInvalidValue;")),
    # b87ae5a's forward: bf16 widened, x dt, the masked scores and the
    # decays kept in fp32
    "ssd_scan": (("return sizeof(T) == 2 ? __bfloat162float("
                  "__float2bfloat16_rn(v)) : v;", "return v;"),),
    # a backward that keeps the cotangents of W, of the masked scores and
    # of x dt in fp32 (the forward's values still rounded)
    "ssd_scan_bwd": (("round_as<T>(float(quad_sum(dws[hr])))",
                      "float(quad_sum(dws[hr]))"),
                     ("const float gd = round_as<T>(acc[j][e]);",
                      "const float gd = acc[j][e];"),
                     ("const float gx = round_as<T>(d[j][e] + xw[j][e]);",
                      "const float gx = d[j][e] + xw[j][e];")),
}
FULL_TRIAL_OVER = {"model_args": {"reduced": False}, "sync": "local:1:c8",
                   "rows": 20, "max_epochs": 1, "fleet.workers": 2}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ------------------------------------------------------------ 1. device ----

def require_card() -> None:
    """Fails without CUDA or without the repository around the script."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch/ beside {Path(__file__).name}: run it "
             f"from a checkout of the repository")


def phase_device(planted_copies: bool = True):
    """The card, and the kernels built (with the planted copies unless
    ``planted_copies`` is false: a checkout of another commit, whose
    sources the PLANTED texts need not match)."""
    import torch
    require_card()
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
                        "flash_attention_bwd", "decode_attention",
                        "ssd_scan", "ssd_scan_bwd"])
    print(f"build: {time.time() - t0:.2f} s, "
          + ", ".join(str(p.relative_to(ROOT)) for p in libs.values())
          + "; nvcc seconds by library (each waited in turn, so a library "
            "read after a slower one reads its time): "
          + json.dumps({k: round(v, 1) for k, v in build.SECONDS.items()}))
    PTXAS.update(read_ptxas(build.build_log("flash_attention")))
    PTXAS_BWD.update(read_ptxas(build.build_log("flash_attention_bwd")))
    print("flash_attention registers and spills (ptxas -v): "
          + json.dumps(PTXAS))
    print("flash_attention_bwd registers and spills (ptxas -v): "
          + json.dumps(PTXAS_BWD))
    if planted_copies:            # built beside phase 2, awaited at first use
        _PLANTED_PROCS.update(start_planted())
    return card


#: the flash forward's and backward's instances as ``nvcc -Xptxas -v``
#: reports them (registers, stack frame and spill bytes), read from phase
#: 1's build
PTXAS: dict = {}
PTXAS_BWD: dict = {}
def read_ptxas(log: str) -> dict:
    """{instance: {registers, stack, spill_stores, spill_loads}} from
    ptxas's report; an instance is named by its kernel (the backward's
    ``dq``, ``dkdv`` or ``gqa_sum``; the forward's fp32 one or its bf16
    ``rounded``), its type and its padded dk and dv."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"(?:Compiling entry function '|Function "
                          r"properties for )([^'\s]+)", line)
        if entry:
            mangled = entry.group(1)
            if "kernel" not in mangled:   # a device function's own report
                name = None
                continue
            widths = re.search(r"Li(\d+)E(?:Li(\d+)E)?", mangled)
            nc = int(widths.group(1)) if widths else 0
            nv = int(widths.group(2) or nc) if widths else 0
            kind = next((k for k in ("dq_", "dkdv_", "gqa_sum_same_",
                                     "gqa_sum_")
                         if f"{k}kernel" in mangled), "")
            name = (kind.replace("_", " ")
                    + ("rounded bf16" if "rounded" in mangled
                       else "bf16" if "bfloat16" in mangled else "fp32")
                    + (f" dk{16 * nc} dv{16 * nv}" if widths else ""))
            continue
        if name is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if frame:
            out.setdefault(name, {}).update(
                stack=int(frame.group(1)), spill_stores=int(frame.group(2)),
                spill_loads=int(frame.group(3)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out.setdefault(name, {})["registers"] = int(regs.group(1))
    check(out or not log, f"no ptxas report in nvcc's output:\n{log}")
    return out


def start_planted() -> dict:
    """One nvcc per PLANTED source, started beside phase 1's build: the
    source with each of its texts replaced, built into PLANTED_DIR."""
    from repro_torch.kernels import build
    PLANTED_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in PLANTED.items():
        text = (build.CSRC / f"{name}.cu").read_text()
        for old, new in subs:
            check(text.count(old) == 1, f"planted {name}: {old!r} found "
                                        f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        src = PLANTED_DIR / f"{name}.cu"
        src.write_text(text)
        lib = PLANTED_DIR / f"lib{name}.so"
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    return procs


#: the planted copies' nvcc processes still running (phase_device starts
#: them once the kernels are built; ``planted`` waits for them)
_PLANTED_PROCS: dict = {}


def finish_planted(procs: dict) -> None:
    t0 = time.time()
    for name in list(procs):
        log, _ = procs[name].communicate()
        check(procs[name].returncode == 0,
              f"planted {name}: nvcc failed:\n{log}")
        del procs[name]
    print(f"  planted copies built (waited {time.time() - t0:.1f} s)")


class planted:
    """Inside the block the wrappers of the kernels ``names`` launch their
    planted copies (PLANTED): a control's run, never the main path's."""

    def __init__(self, *names: str):
        self.names = names

    def __enter__(self):
        import ctypes
        from repro_torch.kernels import build
        from repro_torch.kernels.decode_attention import kernel as dk
        if _PLANTED_PROCS:
            finish_planted(_PLANTED_PROCS)
        from repro_torch.kernels.flash_attention import kernel as fk
        from repro_torch.kernels.ssd_scan import kernel as sk
        self.kept = {}
        for name in self.names:
            sigs = {"ssd_scan": sk._SIGNATURES,
                    "ssd_scan_bwd": sk._BWD_SIGNATURES,
                    "flash_attention": fk._SIGNATURES,
                    "flash_attention_bwd": fk._BWD_SIGNATURES,
                    "decode_attention": dk._SIGNATURES}[name]
            self.kept[name] = build.load(name, sigs)
            lib = ctypes.CDLL(str(PLANTED_DIR / f"lib{name}.so"))
            for fn, argtypes in sigs.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            build._LOADED[name] = lib

    def __exit__(self, *exc):
        from repro_torch.kernels import build
        build._LOADED.update(self.kept)


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


def decode_timed_row(gen, b: int, S: int, length: int,
                     heads: tuple = None) -> dict:
    """Decode attention at smollm's heads (or ``heads``: (h, m, d)) in fp32
    over a (b, S) cache with
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
    h, m, d = heads or (SMOLLM_HEADS, SMOLLM_KV_HEADS, SMOLLM_HEAD_DIM)
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
    on inputs from their own seed (the same in every checkout), and a
    hash of the kernel's fp32 output bits (y, then the final state).  It
    runs in a checkout of any commit: ``python3 -c 'import sys;
    sys.path.insert(0, "src"); import chip_smoke as c; c.ssd_vs_float64()'``."""
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
        y, state = ssd_scan_kernel(x, dt, decay_rates(a_log), B, C)
        got = {"kernel": y,
               "chunked": ssd_scan_chunked(x, dt, a_log, B, C,
                                           SSD_MODEL_CHUNK)[0]}
        vs_fp64[s] = {k: float((v.double() - exact).abs().max())
                      for k, v in got.items()}
        vs_fp64[s]["max_abs_y"] = float(exact.abs().max())
        # the serving path's output bits, comparable across checkouts
        vs_fp64[s]["kernel_sha256"] = hashlib.sha256(
            y.cpu().numpy().tobytes() + state.cpu().numpy().tobytes()
        ).hexdigest()
    print("  ssd_scan vs the float64 recurrence (mamba2 heads, b 2): "
          + json.dumps(vs_fp64))
    return vs_fp64


def _causal_pairs(sq: int, sk: int) -> int:
    """(query, key) pairs a top-left causal mask keeps."""
    return sum(min(sk, i + 1) for i in range(sq))


def flash_timed_row(gen, b: int, s: int, h: int, m: int, d: int,
                    dv: int | None = None, sk: int | None = None,
                    causal: bool = True) -> dict:
    """Flash attention, causal fp32 (full where ``causal`` is false), q (b,
    s, h, d), k (b, sk, m, d) and v (b, sk, m, dv) (dv: d, sk: s unless
    given):
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
    dv, sk = dv or d, sk or s
    q, k, v = _attn_inputs(gen, torch.float32, (b, s, h, d), (b, sk, m, d),
                           (b, sk, m, dv))

    def kernel_fn():
        return flash_attention_kernel(q, k, v, causal=causal)

    def plain_fn():
        return flash_attention_plain(q, k, v, causal=causal)

    def library_fn():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True).transpose(1, 2)

    out, again, ref, lib = kernel_fn(), kernel_fn(), plain_fn(), library_fn()
    torch.cuda.synchronize()
    pairs = _causal_pairs(s, sk) if causal else s * sk
    flop = 2 * b * h * pairs * (d + dv)
    nbytes = 4 * (b * s * h * (d + dv) + b * sk * m * (d + dv))
    b_ms, by = tf32x3_bound_ms(nbytes, flop)
    widths = f"d{d}" if dv == d else f"dk{d} dv{dv}"
    seqs = f"s{s}" if sk == s else f"sq{s} sk{sk}"
    row = {"shape": f"b{b} {seqs} h{h} m{m} {widths} "
                    f"{'causal' if causal else 'full'} fp32",
           "max_abs_err": float((out - ref).abs().max()),
           "repeat_bitwise": _bits_equal(out, again),
           "library_max_abs_err": float((lib - ref).abs().max()),
           "ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn),
           "library_ms": time_ms(library_fn),
           "library": f"F.scaled_dot_product_attention(..., "
                      f"is_causal={causal}, enable_gqa=True)",
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
    # the serving path's output bits, comparable across checkouts
    out["kernel_sha256"] = hashlib.sha256(
        got["kernel"].cpu().numpy().tobytes()).hexdigest()
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


def redesign_baseline(only: str | None = None) -> dict:
    """The redesigned kernels' readings alone, for a checkout of any commit
    with this file copied to its root: decode attention, the SSD scan,
    flash attention and its backward at their timed shapes, the SSD and
    flash kernels and the backward against float64, and smollm-360m's
    prefill end to end.  ``only="flash_attention_bwd"`` takes the
    backward's rows alone, ``only="ssd_scan_bwd"`` the SSD backward's
    (timed at SSD_BWD_PATH in fp32, and against float64).  ``python3 -c
    'import chip_smoke as c; c.phase_device(False); c.redesign_baseline()'``."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    if only == "ssd_scan_bwd":
        out = {"ssd_scan_bwd": [
                   ssd_bwd_row(gen, *shape, torch.float32, True, False, False,
                               timed=True, gate=False)
                   for shape in SSD_BWD_PATH],
               "ssd_bwd_vs_float64": ssd_bwd_vs_float64()}
        print(json.dumps({"redesign_baseline": out}))
        return out
    out = {"flash_attention_bwd": [
               flash_bwd_row(gen, *shape, torch.float32, timed=True)
               for shape in FLASH_BWD_TIMED],
           "flash_bwd_vs_float64": flash_bwd_vs_float64()}
    if only != "flash_attention_bwd":
        out.update(
            decode_attention=[decode_timed_row(gen, *shape)
                              for shape in DECODE_TIMED],
            ssd_scan=[ssd_timed_row(gen, b, s)[0] for b, s in SSD_TIMED],
            ssd_vs_float64=ssd_vs_float64(),
            flash_attention=[flash_timed_row(gen, *shape)
                             for shape in FLASH_TIMED],
            flash_vs_float64=flash_vs_float64(),
            prefill=prefill_timed())
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


def _score_ties(q, K, valid, div: float, scale: float = 1.0):
    """(delta, P), each (R, n) float64: how far each score's bf16 rounding
    chain bf16(bf16(s) / div) can move within its TIE_SUM_ULPS band
    (times ``scale``) around the float64 q.k (0: not a near-tie), and the
    softmax of the central scores over the valid keys."""
    import torch
    from repro_torch.kernels.flash_attention.ref import round_scores
    q64, K64 = q.double(), K.double()
    prod = torch.einsum("rd,rnd->rn", q64, K64)
    band = (TIE_SUM_ULPS[0] + TIE_SUM_ULPS[1] * q.shape[-1] ** 0.5) \
        * 2.0 ** -24 * scale * torch.einsum("rd,rnd->rn", q64.abs(),
                                             K64.abs())

    def chain(x):
        return round_scores(x.float(), torch.bfloat16, div).double()

    delta = (chain(prod + band) - chain(prod - band)).masked_fill(~valid, 0.0)
    return delta, torch.softmax(chain(prod).masked_fill(
        ~valid, float("-inf")), -1)


def _bf16_reach(q, K, V, valid, div: float, scale: float = 1.0):
    """The tie witness for R rows of bf16 attention: q (R, d), K and V (R,
    n, d) (bf16 values), valid (R, n) the keys a row reads, div bf16(sqrt
    d) -> (lo, hi), each (R, d) float64: the bf16 outputs a kernel may give
    that rounds where the JAX model rounds, its fp32 sums within the
    TIE_SUM_ULPS / TIE_P_ULPS bands (times ``scale``) of the float64 ones.
    Each score's float64 q.k takes the bf16 rounding chain bf16(bf16(s) /
    div) at both ends of its band: a near-tie score can come out either
    way, delta apart.  P = softmax of the central scores, in float64; a
    kernel's P_k is within exp(+-rho_k), rho_k = delta_k + log sum_j P_j
    exp(delta_j) + the probability band, so its bf16 P_b is between the
    roundings of the two ends; the output is sum_k P_b,k v_k within
    sum_k |dP_b,k| |v_k| and the sum band, rounded at both ends."""
    import torch
    u = 2.0 ** -24 * scale
    V64 = V.double()
    n = valid.sum(-1, keepdim=True).double()
    delta, p = _score_ties(q, K, valid, div, scale)
    rho = delta + torch.log((p * torch.exp(delta)).sum(-1, keepdim=True)) \
        + (TIE_P_ULPS[0] + TIE_P_ULPS[1] * n.sqrt() + n / TIE_P_ULPS[2]) * u

    def rn(x):
        return x.float().bfloat16().double()

    pb, pb_lo, pb_hi = rn(p), rn(p * torch.exp(-rho)), rn(p * torch.exp(rho))
    dpb = torch.maximum(pb_hi - pb, pb - pb_lo)
    va = V64.abs()
    o = torch.einsum("rn,rnd->rd", pb, V64)
    spread = torch.einsum("rn,rnd->rd", dpb, va) + (
        TIE_SUM_ULPS[0] + TIE_SUM_ULPS[1] * n.sqrt()) * u * torch.einsum(
        "rn,rnd->rd", pb_hi, va)
    return rn(o - spread), rn(o + spread)


def flash_rows(q, k, v, causal: bool):
    """The rows of flash attention's output (b, sq, h, d), flattened, for
    the tie witness: idx -> (q, K, V, valid) of those rows."""
    import torch
    b, sq, h, d = q.shape
    sk, m = k.shape[1], k.shape[2]

    def rows(idx):
        bi, qi, hi = idx // (sq * h), idx // h % sq, idx % h
        kv = hi // (h // m)
        keys = torch.arange(sk, device=q.device)
        valid = (keys[None] <= qi[:, None]) if causal else \
            torch.ones(len(idx), sk, dtype=torch.bool, device=q.device)
        return q[bi, qi, hi], k[bi, :, kv], v[bi, :, kv], valid
    return rows


def decode_rows(q, k, v, length: int):
    """The rows of decode attention's output (b, h, d) over a cache's
    first ``length`` positions, for the tie witness."""
    import torch
    b, h, d = q.shape
    m = k.shape[2]

    def rows(idx):
        bi, hi = idx // h, idx % h
        kv = hi // (h // m)
        return (q[bi, hi], k[bi, :length, kv], v[bi, :length, kv],
                torch.ones(len(idx), length, dtype=torch.bool,
                           device=q.device))
    return rows


def _unexplained(x, idx, rows, div: float, scale: float = 1.0) -> int:
    """How many elements of the rows ``idx`` of x (bf16 output, flattened
    to (rows, d)) lie outside the tie witness's reach, rows taken in
    chunks of at most 2^24 float64s of K."""
    import torch
    if len(idx) == 0:
        return 0
    q0, K0, _, _ = rows(idx[:1])
    per = max(1, 2 ** 24 // (K0.shape[1] * K0.shape[2]))
    out = 0
    for c in range(0, len(idx), per):
        part = idx[c:c + per]
        lo, hi = _bf16_reach(*rows(part), div, scale)
        val = x[part].double()
        out += int(((val < lo) | (val > hi)).sum())
    return out


def _bf16_gaps(outs, refs, rows=None) -> dict:
    """Over pairs of tensors: ||out - ref|| / ||ref||, and the worst share
    of elements and of rows (the last dim) that differ; with ``rows`` (one
    forward output and its rows for the tie witness) also how many of its
    elements lie outside the witness's reach ("unexplained"), how many of
    the plain version's do (none, or the witness is wrong), the same at
    the TIE_SCALES_READ multiples of its bands, and of its first 4096
    moved rows how many hold a near-tie score ("tie_rows") and how many
    their top-probability key's ("top_tie_rows")."""
    import torch
    out = {"norm_rel": _norm_rel(outs, refs), "share": 0.0, "row_share": 0.0,
           "rows": 0}
    for o, r in zip(outs, refs):
        of = o.reshape(-1, o.shape[-1])
        rf = r.reshape(-1, r.shape[-1])
        differ = of != rf
        out["share"] = max(out["share"], float(differ.double().mean()))
        out["row_share"] = max(out["row_share"],
                               float(differ.any(-1).double().mean()))
        out["rows"] += of.shape[0]
    if rows is not None:
        from repro_torch.kernels.flash_attention.ref import bf16_divisor
        of = outs[0].reshape(-1, outs[0].shape[-1])
        rf = refs[0].reshape(-1, refs[0].shape[-1])
        moved = (of != rf).any(-1).nonzero().flatten()
        # the scores' divisor is bf16(sqrt dk), q's width (dv may differ)
        dk = rows(torch.zeros(1, dtype=torch.long,
                              device=of.device))[0].shape[-1]
        div = bf16_divisor(dk ** -0.5)
        out["moved_rows"] = len(moved)
        out["unexplained"] = _unexplained(of, moved, rows, div)
        out["plain_unexplained"] = _unexplained(rf, moved, rows, div)
        for scale in TIE_SCALES_READ:
            out[f"unexplained_x{scale:g}"] = _unexplained(of, moved, rows,
                                                          div, scale)
        if len(moved):
            q, K, _, valid = rows(moved[:4096])
            delta, p = _score_ties(q, K, valid, div)
            top = p.argmax(-1, keepdim=True)
            out["tie_rows"] = int((delta > 0).any(-1).sum())
            out["top_tie_rows"] = int((delta.gather(-1, top) > 0).sum())
    return out


def bf16_misses(gaps: dict, grads: bool = False) -> list:
    """The limits a bf16 reading (``_bf16_gaps``) misses: forward outputs
    ATTN_BF16_NORM_TOL, ATTN_BF16_SHARE_TOL and the tie witness, gradients
    ATTN_BF16_GRAD_NORM_TOL and ATTN_BF16_GRAD_SHARE_TOL, both
    ATTN_BF16_ROW_SHARE_TOL."""
    norm, share = ((ATTN_BF16_GRAD_NORM_TOL, ATTN_BF16_GRAD_SHARE_TOL)
                   if grads else (ATTN_BF16_NORM_TOL, ATTN_BF16_SHARE_TOL))
    out = []
    if gaps["norm_rel"] > norm:
        out.append(f"norm-wise {gaps['norm_rel']:.3e} > {norm:g}")
    if gaps["share"] > share:
        out.append(f"{gaps['share']:.4f} of the elements differ (> {share:g})")
    if gaps["row_share"] > ATTN_BF16_ROW_SHARE_TOL:
        out.append(f"{gaps['row_share']:.4f} of the rows moved (> "
                   f"{ATTN_BF16_ROW_SHARE_TOL:g})")
    if gaps.get("unexplained", 0):
        out.append(f"{gaps['unexplained']} elements outside the tie "
                   f"witness's reach")
    return out


def hold_bf16(what: str, outs, refs, worst: dict | None = None,
              rows=None, grads: bool = False, inputs=None) -> dict:
    """Fails unless bf16 ``outs`` are within their limits of the plain
    version's ``refs`` (:func:`bf16_misses`; ``rows``: the tie witness's
    rows of a forward output, ``grads``: gradients' limits), and unless
    the witness explains every element of the plain version's moved rows
    (a check of the witness itself); keeps the worst readings in
    ``worst``, and the sums of the counts of rows and elements.  Where
    gradients miss and ``inputs`` (q, k, v, dO, causal) are given, they
    are held to the same limits against the backward's tie witness
    instead (:func:`_bf16_bwd_explained`: the function in float64 with
    its near-tie roundings taken the gradients' way), which must also
    hold the plain version's ``refs``; both readings are kept."""
    import torch
    torch.cuda.synchronize()
    gaps = _bf16_gaps(outs, refs, rows)
    check(not gaps.get("plain_unexplained", 0),
          f"{what} bf16: the tie witness does not reach the plain version "
          f"({gaps}): its bands are too narrow")
    misses = bf16_misses(gaps, grads)
    if misses and grads and inputs is not None:
        ref, flips = _bf16_bwd_explained(*inputs, outs)
        plain_ref, plain_flips = _bf16_bwd_explained(*inputs, refs)
        gaps["witness"] = {**_bf16_gaps(outs, ref), "flips": flips}
        gaps["plain_witness"] = {**_bf16_gaps(refs, plain_ref),
                                 "flips": plain_flips}
        check(not bf16_misses(gaps["plain_witness"], grads),
              f"{what} bf16: the backward's tie witness does not hold the "
              f"plain version ({gaps})")
        misses = [f"{m} (against the plain version)" for m in misses] \
            if bf16_misses(gaps["witness"], grads) else []
    check(not misses, f"{what} bf16 against the plain version: "
                      f"{'; '.join(misses)} ({gaps})")
    if worst is not None:
        for k, v in gaps.items():
            if isinstance(v, dict):
                worst.setdefault(k, []).append(v)
                continue
            worst[k] = (worst.get(k, 0) + v) if isinstance(v, int) \
                else max(worst.get(k, 0.0), v)
    return gaps


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
    #: the worst bf16 readings against the plain version (``_bf16_gaps``)
    bf16 = {name: {} for name in ATTN_TOL}

    def hold(name, out, ref, dtype, what, group="sweep", rows=None):
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
        if dtype == torch.bfloat16:
            hold_bf16(f"{name} {what}", [out], [ref], bf16[name], rows)
        n[name] += 1
        return err

    def hold_flash(b, sq, sk, h, m, d, causal, dtype, group="sweep",
                   dv=None):
        dv = dv or d
        q, k, v = _attn_inputs(gen, dtype, (b, sq, h, d), (b, sk, m, d),
                               (b, sk, m, dv))
        widths = f"d{d}" if dv == d else f"dk{d} dv{dv}"
        hold("flash_attention", flash_attention_kernel(q, k, v, causal=causal),
             flash_attention_plain(q, k, v, causal=causal), dtype,
             f"b{b} sq{sq} sk{sk} h{h} m{m} {widths} causal={causal}", group,
             flash_rows(q, k, v, causal))

    def hold_decode(b, S, lengths, h, m, d, dtype, group="sweep"):
        q, k, v = _attn_inputs(gen, dtype, (b, h, d), (b, S, m, d),
                               (b, S, m, d))
        for length in lengths:
            hold("decode_attention", decode_attention_kernel(q, k, v, length),
                 decode_plain(q, k, v, length), dtype,
                 f"b{b} S{S} length{length} h{h} m{m} d{d}", group,
                 decode_rows(q, k, v, length))

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
        # the widened forward (dk != dv, dk > 128), then phase 3i's shapes:
        # deepseek's MLA prefill and grok's forwards, and grok's caches at
        # the first, a middle and the last length of its launcher defaults
        for b, sq, sk, h, m, d, dv, causal in FLASH_WIDE_SWEEP:
            hold_flash(b, sq, sk, h, m, d, causal, dtype, dv=dv)
        for b, s, h, m, d, dv in FLASH_MOE_PATH:
            hold_flash(b, s, s, h, m, d, True, dtype, "path", dv=dv)
        b, S, length = DECODE_GROK_TIMED
        hold_decode(b, S, (1, 16, length), GROK_HEADS, GROK_KV_HEADS,
                    GROK_HEAD_DIM, dtype, "path")
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
    mla = flash_timed_row(gen, *FLASH_MLA_TIMED)
    check(mla["repeat_bitwise"], f"flash_attention {mla['shape']}: two "
                                 f"calls differ")
    check(mla["library_max_abs_err"] <= 1e-4,
          "flash_attention: the library call is not the same function at "
          "MLA's widths")
    check(mla["max_abs_err"] <= ATTN_TOL["flash_attention"]["float32"],
          f"flash_attention timed {mla['shape']}: max |kernel - plain| "
          f"{mla['max_abs_err']:.3e}")
    mla_bf16 = flash_bf16_timed_row(gen, *FLASH_MLA_TIMED)
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
        "bf16_vs_plain": bf16["flash_attention"],
        "vs_float64": vs_fp64, "shapes": shapes,
        "mla": {"float32": mla, "bfloat16": mla_bf16}}
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
    grok = decode_timed_row(gen, *DECODE_GROK_TIMED,
                            heads=(GROK_HEADS, GROK_KV_HEADS, GROK_HEAD_DIM))
    check(grok["repeat_bitwise"] and grok["library_max_abs_err"] <= 1e-4
          and grok["max_abs_err"] <= ATTN_TOL["decode_attention"]["float32"],
          f"decode_attention timed {grok['shape']}: {grok}")
    main = shapes[0]
    rows["decode_attention"] = {
        **{k: main[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "library")},
        "timed_max_abs_err": main["max_abs_err"],
        "max_abs_err": errs["decode_attention"]["path"]["float32"],
        "max_abs_err_bf16": errs["decode_attention"]["path"]["bfloat16"],
        "sweep_max_abs_err": errs["decode_attention"]["sweep"],
        "bf16_vs_plain": bf16["decode_attention"], "shapes": shapes,
        "grok": grok}
    print("  bf16 against the plain versions (worst; counts summed): "
          + json.dumps(bf16))
    torch.cuda.empty_cache()
    return rows


def _attention_f64_grads(q, k, v, do, causal: bool = True):
    """(dq, dk, dv) of attention computed in float64 end to end (scores,
    softmax, products and the GQA sums), by autograd; k at q's width dk,
    v and do at dv."""
    import torch
    from repro_torch.kernels.flash_attention.ops import fold_gqa
    from repro_torch.kernels.flash_attention.ref import NEG_INF
    leaves = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
    b, s, h, d = q.shape
    qf, kf, vf = fold_gqa(*leaves)
    sc = torch.einsum("bqd,bkd->bqk", qf, kf) * d ** -0.5
    if causal:
        keep = torch.ones(s, kf.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        sc = sc.masked_fill(~keep, NEG_INF)
    o = torch.einsum("bqk,bkd->bqd", sc.softmax(dim=-1), vf)
    o = o.reshape(b, h, s, v.shape[-1]).transpose(1, 2)
    return torch.autograd.grad(o, leaves, do.double())


def _bf16_bwd_explained(q, k, v, do, causal: bool, got) -> tuple:
    """The tie witness of a bf16 backward: the gradients of the JAX
    model's bf16 attention as ``jax.vjp`` rounds them
    (``flash_attention_bwd_plain``'s rounding points: S = bf16(bf16(q k^T)
    / bf16(sqrt dk)), P = softmax(S), dP_b = bf16(dO v^T), dv = bf16(P_b^T
    dO), dS = P (dP_b - rowsum(P dP_b)), dS_1 = bf16(bf16(dS) / bf16(sqrt
    dk)), dq = bf16(dS_1 k), dk = bf16(dS_1^T q), dk and dv summed over the
    GQA group before their rounding) with every sum in float64, and its
    near-tie roundings taken the way that brings them nearest ``got`` (dq,
    dk, dv).  A rounding is a near tie where the
    value before it lies within its fp32 band (TIE_SUM_ULPS for the sums
    q k^T and dO v^T over their widths, TIE_P_ULPS for P and dS over the
    row's keys) of a bf16 boundary, so that two sound fp32 computations
    can round it either way; a flip of dO v^T or dS feeds dS = P (dP_b -
    D), whose difference can cancel, and moves a whole row of dq and dk.
    Greedy: the scores' and dP_b's near ties, nearest the boundary first,
    each kept flipped if that brings the gradients nearer ``got``; then
    P_b's and dS_1's on the result.  -> ((dq, dk, dv) in q's dtype, the
    number of flips taken)."""
    import torch
    from repro_torch.kernels.flash_attention.ref import bf16_divisor
    u = 2.0 ** -24

    def rb(x):
        return x.float().bfloat16().double()
    b, sq, h, d = q.shape
    sk, m, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // m
    div = bf16_divisor(d ** -0.5)
    qd, dod = (t.double().transpose(1, 2) for t in (q, do))
    kd, vd = (t.double().transpose(1, 2).repeat_interleave(g, dim=1)
              for t in (k, v))
    keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        keep = keep.tril()
    n = keep.sum(-1, keepdim=True).double()
    p_band = (TIE_P_ULPS[0] + TIE_P_ULPS[1] * n.sqrt()
              + n / TIE_P_ULPS[2]) * u
    gd = [t.double() for t in got]

    def near(pre, band, f):
        lo, hi = f(pre - band), f(pre + band)
        mid = f(pre)
        return (lo != hi) & keep, torch.where(lo != mid, lo, hi), \
            (pre - f(pre)).abs() / band.clamp_min(1e-300)

    def grads(S, dpb, pb_flip=None, ds_flip=None):
        p = S.masked_fill(~keep, float("-inf")).softmax(-1)
        pb = rb(p)
        if pb_flip is not None:
            pb = torch.where(pb_flip[0], pb_flip[1], pb)
        ds = p * (dpb - (p * dpb).sum(-1, keepdim=True))
        ds1 = rb(rb(ds) / div)
        if ds_flip is not None:
            ds1 = torch.where(ds_flip[0], ds_flip[1], ds1)
        dq = rb(ds1 @ kd)
        dkd = rb((ds1.transpose(-1, -2) @ qd).reshape(b, m, g, sk, -1).sum(2))
        dvd = rb((pb.transpose(-1, -2) @ dod).reshape(b, m, g, sk, -1).sum(2))
        return [dq.transpose(1, 2), dkd.transpose(1, 2),
                dvd.transpose(1, 2)], p, ds

    def nearest(tie, closeness, what):
        """The near ties of ``tie``, nearest a boundary first."""
        idx, c = tie.nonzero(), closeness[tie]
        order = c.argsort()[:TIE_FLIPS_TRIED]
        return [(v, what, tuple(i)) for v, i in
                zip(c[order].tolist(), idx[order].tolist())]

    def dist(x):
        return sum(float((a - c).square().sum() / c.square().sum().clamp_min(
            1e-300)) for a, c in zip(gd, x))

    tie_s, alt_s, near_s = near(
        qd @ kd.transpose(-1, -2),
        (TIE_SUM_ULPS[0] + TIE_SUM_ULPS[1] * d ** 0.5) * u
        * (qd.abs() @ kd.abs().transpose(-1, -2)),
        lambda x: rb(rb(x) / div))
    tie_dp, alt_dp, near_dp = near(
        dod @ vd.transpose(-1, -2),
        (TIE_SUM_ULPS[0] + TIE_SUM_ULPS[1] * dv ** 0.5) * u
        * (dod.abs() @ vd.abs().transpose(-1, -2)), rb)
    S = rb(rb(qd @ kd.transpose(-1, -2)) / div)
    dpb = rb(dod @ vd.transpose(-1, -2))
    cur, p, ds = grads(S, dpb)
    best, flips = dist(cur), 0
    cands = nearest(tie_s, near_s, "s") + nearest(tie_dp, near_dp, "dp")
    for _, kind, i in sorted(cands, key=lambda c: c[0])[:TIE_FLIPS_TRIED]:
        t_s, t_dp = S.clone(), dpb.clone()
        if kind == "s":
            t_s[i] = alt_s[i]
        else:
            t_dp[i] = alt_dp[i]
        trial, t_p, t_ds = grads(t_s, t_dp)
        if dist(trial) < best:
            S, dpb, cur, p, ds, best, flips = (t_s, t_dp, trial, t_p, t_ds,
                                              dist(trial), flips + 1)
    dpb_abs = (p * dpb.abs()).sum(-1, keepdim=True)
    tie_pb, alt_pb, near_pb = near(p, p_band * p, rb)
    tie_ds, alt_ds, near_ds = near(ds, p_band * p * (dpb.abs() + dpb_abs),
                                   lambda x: rb(rb(x) / div))
    pb_flip = [torch.zeros_like(tie_pb), alt_pb]
    ds_flip = [torch.zeros_like(tie_ds), alt_ds]
    cands = nearest(tie_pb, near_pb, 0) + nearest(tie_ds, near_ds, 1)
    for _, which, i in sorted(cands, key=lambda c: c[0])[:TIE_FLIPS_TRIED]:
        flip = (pb_flip, ds_flip)[which]
        flip[0][i] = True
        trial = grads(S, dpb, pb_flip, ds_flip)[0]
        if dist(trial) < best:
            cur, best, flips = trial, dist(trial), flips + 1
        else:
            flip[0][i] = False
    return tuple(t.to(q.dtype) for t in cur), flips


def _bwd_kernel(q, k, v, do, causal: bool = True, with_o: bool = False):
    """(dq, dk, dv) of the backward kernel on a forward made here (with
    ``with_o``: (o, (dq, dk, dv)))."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    o, lse = flash_attention_kernel(q, k, v, causal=causal, with_lse=True)
    grads = flash_attention_bwd_kernel(q, k, v, do, lse, causal=causal)
    return (o, grads) if with_o else grads


def flash_bwd_within_bound(what: str, q, k, v, do, causal: bool, got,
                           plain=None) -> dict:
    """The backward kernel's fp32 gradients against float64 gradients:
    every element's error within ``ref.bwd_error_bound``, the bound that
    the kernel's 3xTF32 products (lo x lo dropped, fp32 sums that may
    truncate) and the softmax's rounding allow it (queue C 5: it replaces
    the rule "within twice the plain version's error", which a sound
    kernel can miss at d 20, where both errors are small).  Returns each
    gradient's largest error, the plain version's (read), and the
    largest error over its bound (must be at most 1)."""
    from repro_torch.kernels.flash_attention.ref import bwd_error_bound
    exact, bound = bwd_error_bound(q, k, v, do, causal=causal)
    out = {}
    for i, name in enumerate(("dq", "dk", "dv")):
        err = (got[i].double() - exact[i]).abs()
        out[name] = {"kernel": float(err.max()),
                     "bound_ratio": float((err / bound[i]).max()),
                     "bound_at_max": float(bound[i].max())}
        if plain is not None:
            out[name]["plain"] = float((plain[i].double() - exact[i])
                                       .abs().max())
        check(out[name]["bound_ratio"] <= 1.0,
              f"{what} {name}: an element errs {out[name]['bound_ratio']:.3g}"
              f"x its 3xTF32 bound against float64")
    del exact, bound
    return out


def flash_bwd_sweep(gen, shapes=FLASH_BWD_SWEEP) -> float:
    """The backward kernel against autograd of the plain version at every
    shape of ``shapes`` (FLASH_BWD_SWEEP's form) in fp32 and bf16 (within
    FLASH_BWD_TOL of the largest |plain gradient|; bf16 also
    ``hold_bf16``, its forward with the tie witness); returns the largest
    fp32 error relative to that."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_plain, flash_attention_plain)
    worst = worst_bound = 0.0
    bf16 = {"forward": {}, "backward": {}}
    for b, sq, sk, h, m, d, causal in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = _attn_inputs(gen, dtype, (b, sq, h, d),
                                       (b, sk, m, d), (b, sk, m, d),
                                       (b, sq, h, d))
            o, got = _bwd_kernel(q, k, v, do, causal, with_o=True)
            plain = flash_attention_bwd_plain(q, k, v, do, causal=causal)
            torch.cuda.synchronize()
            key = str(dtype).replace("torch.", "")
            scale = max(float(p.float().abs().max()) for p in plain)
            err = max(float((a.float() - p.float()).abs().max())
                      for a, p in zip(got, plain))
            what = (f"flash_attention_bwd b{b} sq{sq} sk{sk} h{h} m{m} d{d} "
                    f"causal={causal}")
            check(err <= FLASH_BWD_TOL[key] * scale,
                  f"{what} {key}: max |kernel - plain| {err:.3e} > "
                  f"{FLASH_BWD_TOL[key]:g} x {scale:.3e}")
            if dtype == torch.float32:
                worst = max(worst, err / scale)
                bound = flash_bwd_within_bound(what, q, k, v, do, causal, got)
                worst_bound = max(worst_bound, *(e["bound_ratio"]
                                                 for e in bound.values()))
            else:
                hold_bf16(f"{what} forward", [o], [flash_attention_plain(
                    q, k, v, causal=causal)], bf16["forward"],
                    flash_rows(q, k, v, causal))
                hold_bf16(what, got, plain, bf16["backward"], grads=True,
                          inputs=(q, k, v, do, causal))
    print(f"  flash_attention_bwd sweep: {len(shapes)} shapes x "
          f"fp32/bf16 within FLASH_BWD_TOL (fp32 worst {worst:.3e} of the "
          f"largest gradient; against float64 at most {worst_bound:.3e} of "
          f"the 3xTF32 bound); bf16 against the plain versions (worst; "
          f"counts summed): {json.dumps(bf16)}")
    return worst


def flash_bwd_vs_float64() -> dict:
    """Rounding at the main shape: the backward kernel and the plain
    version's autograd against float64 gradients, causal, smollm's heads,
    on inputs from their own seed (the same in every checkout)."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_plain)
    b, s = FLASH_PATH["b"], FLASH_PATH["s"]
    h, m, d = SMOLLM_HEADS, SMOLLM_KV_HEADS, SMOLLM_HEAD_DIM
    gen = torch.Generator(device="cuda").manual_seed(FLASH_BWD_FP64_SEED)
    q, k, v, do = _attn_inputs(gen, torch.float32, (b, s, h, d),
                               (b, s, m, d), (b, s, m, d), (b, s, h, d))
    got = _bwd_kernel(q, k, v, do)
    plain = flash_attention_bwd_plain(q, k, v, do, causal=True)
    exact = _attention_f64_grads(q, k, v, do)
    out = {name: {"kernel": float((a.double() - x).abs().max()),
                  "plain": float((p.double() - x).abs().max()),
                  "max_abs_grad": float(x.abs().max())}
           for name, a, p, x in zip(("dq", "dk", "dv"), got, plain, exact)}
    del q, k, v, do, got, plain, exact
    torch.cuda.empty_cache()
    print(f"  flash_attention_bwd vs float64 (b{b} s{s} h{h} m{m} d{d} "
          f"causal): " + json.dumps(out))
    return out


def flash_bwd_row(gen, b: int, s: int, h: int, m: int, d: int, dtype,
                  timed: bool = False, dv: int | None = None,
                  causal: bool = True, sk: int | None = None) -> dict:
    """Flash attention's backward kernel (causal unless ``causal`` is
    false), q (b, s, h, d), k (b, sk, m, d), v (b, sk, m, dv) and dO (b,
    s, h, dv) (dv = d, sk = s unless given), against autograd of the plain
    version
    (within
    FLASH_BWD_TOL of the largest |plain gradient|), two calls compared
    bitwise; in fp32 also against float64 gradients: each of dq, dk, dv
    must err by at most twice what the fp32 plain version errs.  With
    ``timed``: CUDA-event times of the backward alone -- the kernel, the
    plain version's autograd backward and ``F.scaled_dot_product_attention``'s
    backward (a library yardstick; the port never calls it), each from a
    forward made outside the timed call -- and of forward + backward for
    all three.  Three bounds: five s x s x d products over the causal pairs
    (S and dP recomputed, dv, dk, dq) as 3xTF32 on the tensor cores, the
    fastest the card does fp32-accurate products (the kernels line's), the
    same in fp32 on the CUDA cores, and the bytes (q, k, v, dO and the
    log-sum-exp read once, dq, dk, dv written).  S, dk and dq are products
    over dk, dP and dv over dv."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ops import (
        FlashAttention, flash_attention_bwd_plain, flash_attention_plain)
    dv = d if dv is None else dv
    sk = sk or s
    q, k, v, do = _attn_inputs(gen, dtype, (b, s, h, d), (b, sk, m, d),
                               (b, sk, m, dv), (b, s, h, dv))
    _o, lse = flash_attention_kernel(q, k, v, causal=causal, with_lse=True)

    def kernel_fn():
        return flash_attention_bwd_kernel(q, k, v, do, lse, causal=causal)

    def plain_fn():
        return flash_attention_bwd_plain(q, k, v, do, causal=causal)

    got, again, plain = kernel_fn(), kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    key = str(dtype).replace("torch.", "")
    scale = max(float(p.float().abs().max()) for p in plain)
    err = max(float((a.float() - p.float()).abs().max())
              for a, p in zip(got, plain))
    widths = f"d{d}" if dv == d else f"dk{d} dv{dv}"
    seqs = f"s{s}" if sk == s else f"sq{s} sk{sk}"
    row = {"shape": f"b{b} {seqs} h{h} m{m} {widths} "
                    f"{'causal' if causal else 'full'} {key}",
           "max_abs_err": err, "max_abs_grad": scale,
           "repeat_bitwise": all(_bits_equal(a, c)
                                 for a, c in zip(got, again))}
    check(err <= FLASH_BWD_TOL[key] * scale,
          f"flash_attention_bwd {row['shape']}: max |kernel - plain| "
          f"{err:.3e} > {FLASH_BWD_TOL[key]:g} x {scale:.3e}")
    check(row["repeat_bitwise"], f"flash_attention_bwd {row['shape']}: two "
                                 f"calls differ")
    if dtype == torch.bfloat16:
        row["bf16_vs_plain"] = {
            "forward": hold_bf16(f"flash_attention {row['shape']}", [_o],
                                 [flash_attention_plain(q, k, v,
                                                        causal=causal)],
                                 rows=flash_rows(q, k, v, causal)),
            "backward": hold_bf16(f"flash_attention_bwd {row['shape']}", got,
                                  plain, grads=True,
                                  inputs=(q, k, v, do, causal))}
    if dtype == torch.float32:
        row["vs_float64"] = flash_bwd_within_bound(
            f"flash_attention_bwd {row['shape']}", q, k, v, do, causal, got,
            plain)
    if timed:
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2)

        def library_fwd():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        def library_fwd_bwd():
            return torch.autograd.grad(library_fwd(), (qt, kt, vt), dot)

        def kernel_fwd_bwd():
            o = FlashAttention.apply(*leaves, causal)
            return torch.autograd.grad(o, leaves, do)

        lib = [g.transpose(1, 2) for g in library_fwd_bwd()]
        row["library_max_abs_err"] = max(
            float((a.float() - p.float()).abs().max())
            for a, p in zip(lib, plain))
        check(row["library_max_abs_err"] <= 1e-3 * scale,
              "flash_attention_bwd: the library call is not the same "
              "function")
        fused = kernel_fwd_bwd()
        check(all(_bits_equal(a, c) for a, c in zip(fused, got)),
              "flash_attention_bwd: FlashAttention's gradient is not the "
              "backward kernel's")
        del lib, fused
        es = q.element_size()
        pairs = _causal_pairs(s, sk) if causal else s * sk
        flop = 2 * b * h * pairs * (3 * d + 2 * dv)
        nbytes = es * (b * s * h * (d + dv) + b * sk * m * (d + dv)) \
            + 4 * b * h * s + es * (b * s * h * d + b * sk * m * (d + dv))
        b_ms, by = tf32x3_bound_ms(nbytes, flop)
        row.update(ms=time_ms(kernel_fn, reps=10),
                   launch_us=_launch_profile(kernel_fn),
                   fwd_bwd_ms=time_ms(kernel_fwd_bwd, reps=10),
                   plain_fwd_bwd_ms=time_ms(plain_fn, reps=5),
                   library_fwd_bwd_ms=time_ms(library_fwd_bwd, reps=10))
        with torch.enable_grad():
            o_plain = flash_attention_plain(*leaves, causal=causal)
        row["plain_ms"] = time_ms(lambda: torch.autograd.grad(
            o_plain, leaves, do, retain_graph=True), reps=5)
        del o_plain
        o_lib = library_fwd()
        row["library_ms"] = time_ms(lambda: torch.autograd.grad(
            o_lib, (qt, kt, vt), dot, retain_graph=True), reps=10)
        del o_lib
        row.update(library="F.scaled_dot_product_attention(..., "
                           f"is_causal={causal}, enable_gqa=True)'s "
                           "backward (torch.autograd.grad)",
                   bound_ms=b_ms, bound_by=by,
                   bound_fp32_ms=bound_ms(nbytes, flop)[0],
                   bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   bound_bytes=nbytes, bound_flop=flop)
        del qt, kt, vt, leaves
    print(f"  flash_attention_bwd {row['shape']}: max|err|={err:.3e} "
          f"(largest |g| {scale:.3e})"
          + (f" bf16_vs_plain={json.dumps(row['bf16_vs_plain'])}"
             if "bf16_vs_plain" in row else "")
          + (f" vs_float64={json.dumps(row['vs_float64'])}"
             if "vs_float64" in row else "")
          + (f" backward: ms={row['ms']:.5f} bound_ms="
             f"{row['bound_ms']:.5f} (3xTF32 {row['bound_by']}; fp32 "
             f"{row['bound_fp32_ms']:.5f}, bytes {row['bytes_bound_ms']:.5f})"
             f" plain_ms={row['plain_ms']:.5f} library_ms="
             f"{row['library_ms']:.5f}; forward + backward: ms="
             f"{row['fwd_bwd_ms']:.5f} plain_ms={row['plain_fwd_bwd_ms']:.5f}"
             f" library_ms={row['library_fwd_bwd_ms']:.5f} launch_us="
             + json.dumps(row["launch_us"]) if timed else ""))
    del q, k, v, do, _o, lse, got, again, plain
    torch.cuda.empty_cache()
    return row


def phase_flash_bwd() -> dict:
    """Flash attention's backward kernel against autograd of the plain
    version over FLASH_BWD_SWEEP and at the training path's shapes
    (FLASH_BWD_PATH) in fp32 and bf16, and at FLASH_BWD_TIMED's first
    shape, timed there and at the path's shapes (see
    :func:`flash_bwd_row`); then against float64 gradients within twice
    the replaced kernel's error (FLASH_BWD_FP64_PARENT)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(5)
    sweep = flash_bwd_sweep(gen)
    for shape in FLASH_BWD_PATH:
        for dtype in (torch.float32, torch.bfloat16):
            flash_bwd_row(gen, *shape, dtype)
    shapes = [flash_bwd_row(gen, *shape, torch.float32, timed=True)
              for shape in FLASH_BWD_TIMED]
    vs_fp64 = flash_bwd_vs_float64()
    for name, e in vs_fp64.items():
        check(e["kernel"] <= 2 * FLASH_BWD_FP64_PARENT[name],
              f"flash_attention_bwd vs float64 {name}: {e['kernel']:.3e}, "
              f"over twice the replaced kernel's "
              f"{FLASH_BWD_FP64_PARENT[name]:.3e}")
    main = shapes[0]
    return {**{k: main[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "bound_fp32_ms",
                                    "bytes_bound_ms", "library_ms",
                                    "library", "fwd_bwd_ms",
                                    "plain_fwd_bwd_ms",
                                    "library_fwd_bwd_ms", "vs_float64",
                                    "launch_us")},
            "timed_max_abs_err": main["max_abs_err"],
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "sweep_rel_err": sweep, "vs_float64_seeded": vs_fp64,
            "shapes": shapes}


def _bf16_controls(what: str, out, ctrl, ref, rows) -> dict:
    """A forward output's controls against the plain version ``ref``: the
    planted copy's ``ctrl`` (the kernel before the bf16 repair) must miss
    ATTN_BF16_NORM_TOL, and a mix, ``out`` with every fourth row taken
    from ``ctrl`` (a kernel that drops the rounding on a quarter of its
    rows), must miss a limit of ``hold_bf16``."""
    import torch
    torch.cuda.synchronize()
    mixed = out.reshape(-1, out.shape[-1]).clone()
    mixed[::4] = ctrl.reshape(-1, out.shape[-1])[::4]
    res = {"planted": _bf16_gaps([ctrl], [ref], rows),
           "mixed": _bf16_gaps([mixed.reshape(ref.shape)], [ref], rows)}
    res["mixed_misses"] = bf16_misses(res["mixed"])
    check(res["planted"]["norm_rel"] > ATTN_BF16_NORM_TOL,
          f"{what}: the kernel without the bf16 rounding reads "
          f"{res['planted']} against the plain version, within "
          f"{ATTN_BF16_NORM_TOL:g}: the limit does not catch it")
    check(bool(res["mixed_misses"]),
          f"{what}: a quarter of the rows without the bf16 rounding reads "
          f"{res['mixed']}, within every limit: they do not catch it")
    return res


def _planted_attention_rows(row, shape, q, k, v, do, o, o_plain, g_plain,
                            rows) -> None:
    """The bf16 forward and backward's planted copies (the kernels before
    the bf16 repair) on attention_bf16_row's inputs: the forward's
    controls (:func:`_bf16_controls`) and the backward's, which must miss
    ATTN_BF16_GRAD_NORM_TOL; read into ``row``."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    with planted("flash_attention", "flash_attention_bwd"):
        o_c, lse_c = flash_attention_kernel(q, k, v, causal=True,
                                            with_lse=True)
        g_c = flash_attention_bwd_kernel(q, k, v, do, lse_c, causal=True)
        torch.cuda.synchronize()
    controls = _bf16_controls(f"flash_attention {shape}", o, o_c, o_plain,
                              rows)
    row["planted_forward"] = controls["planted"]
    row["mixed_forward"] = controls["mixed"]
    row["planted_backward"] = _bf16_gaps(g_c, g_plain)
    check(row["planted_backward"]["norm_rel"] > ATTN_BF16_GRAD_NORM_TOL,
          f"flash_attention_bwd {shape}: the kernel without the bf16 "
          f"rounding reads {row['planted_backward']} against the plain "
          f"version, within {ATTN_BF16_GRAD_NORM_TOL:g}: the limit does not "
          f"catch it")
    ref, flips = _bf16_bwd_explained(q, k, v, do, True, g_c)
    row["planted_backward_witness"] = {**_bf16_gaps(g_c, ref),
                                       "flips": flips}
    check(row["planted_backward_witness"]["norm_rel"]
          > ATTN_BF16_GRAD_NORM_TOL,
          f"flash_attention_bwd {shape}: the backward's tie witness explains "
          f"the kernel without the bf16 rounding "
          f"({row['planted_backward_witness']}): it would hide a fault")


def attention_bf16_row(gen, b: int, s: int, h: int, m: int, d: int,
                       dv: int | None = None, controls: bool = True) -> dict:
    """bf16 flash attention at a training-path shape, causal, q (b, s, h,
    d), k (b, s, m, d), v (b, s, m, dv) and dO (b, s, h, dv) (dv = d
    unless given): the forward and backward kernels against their plain
    versions (``hold_bf16``) and, with ``controls``, their planted copies
    (the kernels before the bf16 repair, built at head dims 20, 64 and
    80), which must miss ATTN_BF16_NORM_TOL and ATTN_BF16_GRAD_NORM_TOL,
    with the forward's mixed control (:func:`_bf16_controls`);
    then CUDA-event times of each kernel, its plain version and
    ``F.scaled_dot_product_attention`` in bf16 -- a yardstick only: SDPA
    keeps scores and probabilities in fp32, another function than the JAX
    model's.  Bounds: the forward's two and the backward's five s x s x d
    products over the causal pairs at the tensor cores' bf16 rate, and the
    bytes (inputs read once, outputs and the log-sum-exp written once:
    the backward reads q, k, v, dO and the log-sum-exp and writes dq, dk,
    dv)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_plain, flash_attention_plain)
    dv = d if dv is None else dv
    q, k, v, do = _attn_inputs(gen, torch.bfloat16, (b, s, h, d),
                               (b, s, m, d), (b, s, m, dv), (b, s, h, dv))
    o, lse = flash_attention_kernel(q, k, v, causal=True, with_lse=True)
    grads = flash_attention_bwd_kernel(q, k, v, do, lse, causal=True)
    o_plain = flash_attention_plain(q, k, v, causal=True)
    g_plain = flash_attention_bwd_plain(q, k, v, do, causal=True)
    widths = f"d{d}" if dv == d else f"dk{d} dv{dv}"
    shape = f"b{b} s{s} h{h} m{m} {widths} causal bf16"
    rows = flash_rows(q, k, v, True)
    row = {"shape": shape,
           "forward": hold_bf16(f"flash_attention {shape}", [o], [o_plain],
                                rows=rows),
           "backward": hold_bf16(f"flash_attention_bwd {shape}", grads,
                                 g_plain, grads=True,
                                 inputs=(q, k, v, do, True))}
    grads_again = flash_attention_bwd_kernel(q, k, v, do, lse, causal=True)
    row["repeat_bitwise"] = all(_bits_equal(a, c)
                                for a, c in zip(grads, grads_again))
    check(row["repeat_bitwise"], f"flash_attention_bwd {shape}: two calls "
                                 f"differ")
    del grads_again
    if controls:
        _planted_attention_rows(row, shape, q, k, v, do, o, o_plain,
                                g_plain, rows)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def library_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    with torch.enable_grad():
        o_graph = flash_attention_plain(*leaves, causal=True)
        o_lib = library_fwd()
    pairs = _causal_pairs(s, s)
    io = 2 * (b * s * h * (d + dv) + b * s * m * (d + dv)) + 4 * b * h * s
    fwd_b, fwd_by = bound_ms(io, 2 * b * h * pairs * (d + dv),
                             BF16_OPS_PER_S)
    bwd_io = 2 * (b * s * h * (2 * d + dv) + 2 * b * s * m * (d + dv)) \
        + 4 * b * h * s
    bwd_b, bwd_by = bound_ms(bwd_io, 2 * b * h * pairs * (3 * d + 2 * dv),
                             BF16_OPS_PER_S)
    with torch.no_grad():
        row["forward"].update(
            ms=time_ms(lambda: flash_attention_kernel(q, k, v, causal=True,
                                                      with_lse=True)),
            plain_ms=time_ms(lambda: flash_attention_plain(q, k, v,
                                                           causal=True)),
            library_ms=time_ms(library_fwd), bound_ms=fwd_b,
            bound_by=fwd_by)
    row["backward"].update(
        ms=time_ms(lambda: flash_attention_bwd_kernel(q, k, v, do, lse,
                                                      causal=True)),
        plain_ms=time_ms(lambda: torch.autograd.grad(
            o_graph, leaves, do, retain_graph=True), reps=10),
        library_ms=time_ms(lambda: torch.autograd.grad(
            o_lib, (qt, kt, vt), dot, retain_graph=True)),
        bound_ms=bwd_b, bound_by=bwd_by)
    row["library"] = ("F.scaled_dot_product_attention(..., is_causal=True, "
                      "enable_gqa=True) in bf16 (not the JAX model's "
                      "rounding)")
    print(f"  flash_attention bf16 {shape}: " + json.dumps(
        {k: row[k] for k in ("forward", "backward", "planted_forward",
                             "mixed_forward", "planted_backward")
         if k in row}))
    del q, k, v, do, o, lse, grads, o_plain, g_plain, o_graph, o_lib, leaves
    torch.cuda.empty_cache()
    return row


def decode_bf16_row(gen, b: int, S: int, length: int, h: int, m: int,
                    d: int, timed: bool = False) -> dict:
    """bf16 decode attention over a (b, S) cache with ``length`` valid
    positions: the kernel against its plain version (``hold_bf16``), two
    calls bitwise equal, its planted copy (the kernel before the bf16
    repair) that must miss ATTN_BF16_NORM_TOL and the mixed control
    (:func:`_bf16_controls`); with ``timed`` CUDA-event
    times of the kernel, the plain version and SDPA in bf16 (a yardstick:
    not the JAX model's rounding) against the bytes bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_kernel)
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_plain)
    q, k, v = _attn_inputs(gen, torch.bfloat16, (b, h, d), (b, S, m, d),
                           (b, S, m, d))
    out = decode_attention_kernel(q, k, v, length)
    again = decode_attention_kernel(q, k, v, length)
    ref = decode_attention_plain(q, k, v, length)
    shape = f"b{b} S{S} length{length} h{h} m{m} d{d} bf16"
    rows = decode_rows(q, k, v, length)
    row = {"shape": shape,
           "vs_plain": hold_bf16(f"decode_attention {shape}", [out], [ref],
                                 rows=rows),
           "repeat_bitwise": _bits_equal(out, again)}
    check(row["repeat_bitwise"], f"decode_attention {shape}: two calls "
                                 f"differ")
    with planted("decode_attention"):
        ctrl = decode_attention_kernel(q, k, v, length)
        torch.cuda.synchronize()
    controls = _bf16_controls(f"decode_attention {shape}", out, ctrl, ref,
                              rows)
    row["planted"], row["mixed"] = controls["planted"], controls["mixed"]
    if timed:
        nbytes = 2 * (2 * b * length * m * d + 2 * b * h * d)
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, 4 * b * h * length * d, BF16_OPS_PER_S)
        row.update(
            ms=time_ms(lambda: decode_attention_kernel(q, k, v, length)),
            plain_ms=time_ms(lambda: decode_attention_plain(q, k, v, length)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], k[:, :length].transpose(1, 2),
                v[:, :length].transpose(1, 2), enable_gqa=True)),
            library="F.scaled_dot_product_attention(..., enable_gqa=True) "
                    "in bf16 (not the JAX model's rounding)")
    print(f"  decode_attention {shape}: " + json.dumps(row))
    return row


def flash_bf16_timed_row(gen, b: int, s: int, h: int, m: int, d: int,
                         dv: int) -> dict:
    """bf16 flash attention forward at q (b, s, h, d), k (b, s, m, d), v
    (b, s, m, dv), causal: the kernel against its plain version
    (``hold_bf16`` with the tie witness), then CUDA-event times of the
    kernel, its plain version and ``F.scaled_dot_product_attention`` in
    bf16 (a yardstick: another function).  Bound: QK^T and P V over the
    causal pairs at the tensor cores' bf16 rate, and the bytes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    q, k, v = _attn_inputs(gen, torch.bfloat16, (b, s, h, d), (b, s, m, d),
                           (b, s, m, dv))
    shape = f"b{b} s{s} h{h} m{m} dk{d} dv{dv} causal bf16"
    o = flash_attention_kernel(q, k, v, causal=True)
    row = {"shape": shape, **hold_bf16(
        f"flash_attention {shape}", [o], [flash_attention_plain(
            q, k, v, causal=True)], rows=flash_rows(q, k, v, True))}

    def library_fn():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    nbytes = 2 * (b * s * h * (d + dv) + b * s * m * (d + dv))
    b_ms, by = bound_ms(nbytes, 2 * b * h * _causal_pairs(s, s) * (d + dv),
                        BF16_OPS_PER_S)
    row.update(ms=time_ms(lambda: flash_attention_kernel(q, k, v,
                                                         causal=True)),
               plain_ms=time_ms(lambda: flash_attention_plain(q, k, v,
                                                              causal=True)),
               library_ms=time_ms(library_fn), bound_ms=b_ms, bound_by=by,
               library="F.scaled_dot_product_attention(..., is_causal=True, "
                       "enable_gqa=True) in bf16 (not the JAX model's "
                       "rounding)")
    print(f"  flash_attention {shape}: " + json.dumps(row))
    del q, k, v, o
    return row


def wide_gradient_taken(gen) -> dict:
    """A gradient through flash attention on the card at dk != dv or dk >
    128 (MLA's 192 / 128, and 160 / 160) runs the forward and backward
    kernels once each (``FlashAttention``) and matches autograd of the
    plain version within FLASH_BWD_TOL; wider than the kernels take (200 /
    128, 256 / 256) is refused with ``ValueError`` before any kernel
    runs."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_plain)
    out = {"taken": [], "refused": []}
    for dk, dv in ((MLA_DK, MLA_DV), (160, 160)):
        q, k, v, do = _attn_inputs(gen, torch.float32, (1, 8, 2, dk),
                                   (1, 8, 2, dk), (1, 8, 2, dv),
                                   (1, 8, 2, dv))
        leaves = [t.requires_grad_(True) for t in (q, k, v)]
        fk.reset_launches()
        got = torch.autograd.grad(flash_attention(*leaves, causal=True),
                                  leaves, do)
        launches = dict(fk.launches)
        plain = flash_attention_bwd_plain(q, k, v, do, causal=True)
        scale = max(float(p.abs().max()) for p in plain)
        err = max(float((a - p).abs().max()) for a, p in zip(got, plain))
        check(launches == {"flash_attention": 1, "flash_attention_bwd": 1}
              and err <= FLASH_BWD_TOL["float32"] * scale,
              f"flash attention's gradient at dk {dk}, dv {dv} on the card: "
              f"launches {launches}, max |kernel - plain| {err:.3e} of "
              f"{scale:.3e}")
        out["taken"].append({"dk": dk, "dv": dv, "max_abs_err": err})
    for dk, dv in ((200, 128), (256, 256)):
        q, k, v = _attn_inputs(gen, torch.float32, (1, 8, 2, dk),
                               (1, 8, 2, dk), (1, 8, 2, dv))
        fk.reset_launches()
        try:
            flash_attention(q.requires_grad_(True), k, v, causal=True)
            said = None
        except ValueError as e:
            said = str(e)
        check(said is not None and not any(fk.launches.values()),
              f"flash attention at dk {dk}, dv {dv} on the card was not "
              f"refused before any kernel: {said!r}, {fk.launches}")
        out["refused"].append({"dk": dk, "dv": dv, "said": said})
    fk.reset_launches()
    print(f"  flash attention's gradient on the card: taken at "
          f"{[(r['dk'], r['dv']) for r in out['taken']]} (max |kernel - "
          f"plain| {max(r['max_abs_err'] for r in out['taken']):.3e}), "
          f"refused before any kernel at "
          f"{[(r['dk'], r['dv']) for r in out['refused']]}")
    return out


def flash_bwd_bf16_sha256() -> str:
    """sha256 of flash attention's backward in bf16 (dq, dk, dv) on seeded
    inputs at the old widths (dk = dv <= 128: the training path's b 8, s
    64 with smollm's and zamba2's heads, a ragged GQA one, causal and
    full), each from the forward kernel's log-sum-exp.  It runs in a
    checkout of any commit since the bf16 repair: ``python3 -c 'import
    chip_smoke as c; c.phase_device(False); print(c.flash_bwd_bf16_sha256())'``."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    gen = torch.Generator(device="cuda").manual_seed(10)
    h = hashlib.sha256()
    for b, s, hh, m, d in ((8, 64, *_SMOLLM_ATTN), (8, 64, *_ZAMBA2_ATTN),
                           (2, 47, 6, 2, 20)):
        q, k, v, do = _attn_inputs(gen, torch.bfloat16, (b, s, hh, d),
                                   (b, s, m, d), (b, s, m, d), (b, s, hh, d))
        for causal in (True, False):
            _o, lse = flash_attention_kernel(q, k, v, causal=causal,
                                             with_lse=True)
            for g in flash_attention_bwd_kernel(q, k, v, do, lse,
                                                causal=causal):
                h.update(g.view(torch.int16).cpu().numpy().tobytes())
    digest = h.hexdigest()
    print(f"  flash attention backward bf16 sha256: {digest}")
    return digest


def phase_flash_bwd_wide() -> dict:
    """The backward widened to dk != dv and dk up to 192 (see
    FLASH_BWD_WIDE): each shape of FLASH_BWD_WIDE and FLASH_BWD_MOE_PATH
    against autograd of the plain version in fp32 (also within twice the
    plain version's float64 error) and bf16 (``hold_bf16``), two calls
    bitwise equal (:func:`flash_bwd_row`); deepseek's full-width training
    shape timed in fp32 (row 5n: the kernel, the plain version's autograd,
    SDPA's backward at the same widths) and bf16 (row 5o,
    :func:`attention_bf16_row` without the planted copies, which are
    built at the old widths only); and a gradient at those widths taken
    on the card through ``FlashAttention`` while wider ones are refused
    (:func:`wide_gradient_taken`)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(11)
    t0 = time.time()
    shapes = [(b, s, h, m, dk, dv, causal)
              for b, s, h, m, dk, dv, causal in FLASH_BWD_WIDE] + [
        (*shape, True) for shape in FLASH_BWD_MOE_PATH]
    rows, worst = [], {}
    for b, s, h, m, dk, dv, causal in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            r = flash_bwd_row(gen, b, s, h, m, dk, dtype, dv=dv,
                              causal=causal)
            key = str(dtype).replace("torch.", "")
            worst[key] = max(worst.get(key, 0.0),
                             r["max_abs_err"] / r["max_abs_grad"])
            rows.append({k: r[k] for k in ("shape", "max_abs_err",
                                           "max_abs_grad", "repeat_bitwise",
                                           "vs_float64") if k in r})
    witness = wide_witness_controls(gen, [
        shape for shape in shapes if shape[4] > MAX_BWD_OLD_WIDTH])
    b, s, h, m, dk, dv = FLASH_BWD_MOE_PATH[1]
    fp32 = flash_bwd_row(gen, b, s, h, m, dk, torch.float32, timed=True,
                         dv=dv)
    bf16 = attention_bf16_row(gen, b, s, h, m, dk, dv=dv, controls=False)
    taken = wide_gradient_taken(gen)
    out = {"rows": rows, "worst_rel": worst, "float32": fp32,
           "bfloat16": bf16, "gradient": taken, "witness": witness,
           "seconds": time.time() - t0}
    print(f"  flash_attention_bwd widened: {len(rows)} rows within "
          f"FLASH_BWD_TOL (worst relative {json.dumps(worst)}), fp32 "
          f"within 2x the plain version's float64 error, bitwise on "
          f"repeat; {out['seconds']:.1f} s")
    return out


#: the backward's widest instances before its widening (dk = dv <= 128)
MAX_BWD_OLD_WIDTH = 128


def wide_witness_controls(gen, shapes) -> list:
    """The backward's tie witness (:func:`_bf16_bwd_explained`) at the
    wide widths, where the planted copies (built at head dims 20, 64 and
    80) do not reach: at each of ``shapes`` (b, s, h, m, dk, dv, causal),
    on bf16 inputs of its own, the kernel's gradients held by
    ``hold_bf16`` (the witness's flips read where it is used), and the
    unrounded function -- the plain version in fp32 on the same inputs,
    rounded once at its outputs, a kernel without the bf16 rounding points
    -- held against the witness steered toward it, which must miss
    ATTN_BF16_GRAD_NORM_TOL (it must not explain a fault)."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_plain)
    out = []
    for b, s, h, m, dk, dv, causal in shapes:
        q, k, v, do = _attn_inputs(gen, torch.bfloat16, (b, s, h, dk),
                                   (b, s, m, dk), (b, s, m, dv), (b, s, h, dv))
        shape = (f"b{b} s{s} h{h} m{m} dk{dk} dv{dv} "
                 f"{'causal' if causal else 'full'} bf16")
        _, lse = flash_attention_kernel(q, k, v, causal=causal,
                                        with_lse=True)
        grads = flash_attention_bwd_kernel(q, k, v, do, lse, causal=causal)
        plain = flash_attention_bwd_plain(q, k, v, do, causal=causal)
        gaps = hold_bf16(f"flash_attention_bwd {shape}", grads, plain,
                         grads=True, inputs=(q, k, v, do, causal))
        unrounded = [t.to(torch.bfloat16) for t in flash_attention_bwd_plain(
            q.float(), k.float(), v.float(), do.float(), causal=causal)]
        ref, flips = _bf16_bwd_explained(q, k, v, do, causal, unrounded)
        control = {**_bf16_gaps(unrounded, ref), "flips": flips}
        check(control["norm_rel"] > ATTN_BF16_GRAD_NORM_TOL,
              f"flash_attention_bwd {shape}: the backward's tie witness "
              f"explains the unrounded function ({control}): it would hide "
              f"a fault")
        out.append({"shape": shape, "norm_rel": gaps["norm_rel"],
                    "witness": gaps.get("witness"),
                    "unrounded_vs_witness": control})
    used = {r["shape"]: r["witness"]["flips"] for r in out if r["witness"]}
    print(f"  flash_attention_bwd bf16 tie witness at the wide widths: used "
          f"at {len(used)} of {len(out)} shapes (flips {json.dumps(used)}); "
          f"the unrounded function misses it at every shape (least "
          f"norm-wise {min(r['unrounded_vs_witness']['norm_rel'] for r in out):.3e}"
          f" > {ATTN_BF16_GRAD_NORM_TOL:g})")
    return out


def flash_bf16_sha256() -> str:
    """sha256 of flash attention's bf16 outputs (o and the log-sum-exp) on
    seeded inputs at the shapes ``attention_fp32_sha256`` and
    ``phase_attention_bf16`` give it (the training path's b 8, s 64 with
    smollm's and zamba2's heads, a ragged GQA one).  It runs in a checkout
    of any commit since the bf16 repair: ``python3 -c 'import chip_smoke
    as c; c.phase_device(False); print(c.flash_bf16_sha256())'``."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_kernel)
    gen = torch.Generator(device="cuda").manual_seed(9)
    h = hashlib.sha256()
    for b, s, hh, m, d in ((8, 64, *_SMOLLM_ATTN), (8, 64, *_ZAMBA2_ATTN),
                           (2, 47, 6, 2, 20)):
        q, k, v = _attn_inputs(gen, torch.bfloat16, (b, s, hh, d),
                               (b, s, m, d), (b, s, m, d))
        for causal in (True, False):
            o, lse = flash_attention_kernel(q, k, v, causal=causal,
                                            with_lse=True)
            h.update(o.view(torch.int16).cpu().numpy().tobytes())
            h.update(lse.cpu().numpy().tobytes())
    digest = h.hexdigest()
    print(f"  flash attention bf16 sha256: {digest}")
    return digest


#: the attention kernels' fp32 output bits on seeded inputs
#: (``attention_fp32_sha256``): the kernels before the bf16 repair
#: (4a52093) read these on an H100 80GB HBM3 at 700 W; fp32 must not move
ATTN_FP32_SHA256_PARENT = {
    "flash_attention":
        "068a005006ffc6db931074393a59eba84605d328568a611a17324ae09613cbf9",
    "flash_attention_bwd":
        "e1edadc8b9daeb8b6b3c2767c9d5ec8f9480206809854b922fec3153b10d40ac",
    "decode_attention":
        "bf10b8c153c2bf00ab98b6b09ca05e34d1fd15cf9847c2a923e6c0fb66d41bd0"}


#: flash attention's bf16 output bits on seeded inputs
#: (``flash_bf16_sha256``): the kernel before the widening to dk != dv
#: (e6a6006) read this on an H100 80GB HBM3 at 700 W; they must not move
ATTN_BF16_SHA256_PARENT = (
    "6e0c7e32e78f55706b43cd36fa18ec6cc5959012f25800da656fc3db8447e267")
#: the backward's bf16 output bits on seeded inputs at the old widths
#: (``flash_bwd_bf16_sha256``): the backward before its widening to dk !=
#: dv (a2dbd51) read this on an H100 80GB HBM3 at 700 W; they must not move
FLASH_BWD_BF16_SHA256_PARENT = (
    "37ddd2c88aa95454d2dd362e041603d201791835701989c8535eeb8469c71965")


def attention_fp32_sha256() -> dict:
    """sha256 of the fp32 outputs of the three attention kernels on inputs
    from their own seed, at the training path's shape and a ragged GQA
    one: flash attention (o and the log-sum-exp), its backward (dq, dk,
    dv), and decode at DECODE_TIMED[0].  It runs in a checkout of any
    commit since the backward kernel (the wrappers' signatures are the
    same): ``python3 -c 'import chip_smoke as c; c.phase_device();
    c.attention_fp32_sha256()'``."""
    import torch
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_kernel)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    gen = torch.Generator(device="cuda").manual_seed(8)
    digest = {}

    def sha(*tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()

    fwd, bwd = [], []
    for b, s, h, m, d in ((8, 64, *_SMOLLM_ATTN), (2, 47, 6, 2, 20)):
        q, k, v, do = _attn_inputs(gen, torch.float32, (b, s, h, d),
                                   (b, s, m, d), (b, s, m, d), (b, s, h, d))
        o, lse = flash_attention_kernel(q, k, v, causal=True, with_lse=True)
        fwd += [o, lse]
        bwd += list(flash_attention_bwd_kernel(q, k, v, do, lse,
                                               causal=True))
    digest["flash_attention"] = sha(*fwd)
    digest["flash_attention_bwd"] = sha(*bwd)
    b, S, length = DECODE_TIMED[0]
    h, m, d = _SMOLLM_ATTN
    q, k, v = _attn_inputs(gen, torch.float32, (b, h, d), (b, S, m, d),
                           (b, S, m, d))
    digest["decode_attention"] = sha(decode_attention_kernel(q, k, v, length))
    print("  attention fp32 sha256: " + json.dumps(digest))
    return digest


def phase_attention_bf16() -> dict:
    """bf16 attention at the training path's shapes (ATTN_BF16_TIMED and
    the launcher's LAUNCHER_ATTN: forward and backward) and decode at
    DECODE_BF16_TIMED, timed, and
    decode at zamba2's cache of phase 3e (a): each kernel against its
    plain version and its planted copy without the rounding points."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(6)
    t0 = time.time()
    flash = [attention_bf16_row(gen, *shape) for shape in ATTN_BF16_TIMED]
    b, S, length = DECODE_BF16_TIMED
    decode = [decode_bf16_row(gen, b, S, length, *_SMOLLM_ATTN, timed=True),
              decode_bf16_row(gen, 4, 16 + 32 + 1, 48, *_ZAMBA2_ATTN)]
    # the train launcher's shape (3m; rows 5u, 5v), last: the rows above
    # keep their inputs
    flash.append(attention_bf16_row(gen, *LAUNCHER_ATTN, controls=False))
    print(f"  bf16 attention phase: {time.time() - t0:.1f} s")
    return {"flash": flash, "decode": decode}


# ------------------------------ phase 2: the vlm's and encoder's shapes ---

#: llama-3.2-vision-90b's attention (self and cross alike): h 64 over m 8,
#: head_dim 128, 1024 image tokens; hubert-xlarge's: h 16 over m 16, 80
VLM_HEADS, VLM_KV_HEADS, VLM_HEAD_DIM, VLM_IMAGE = 64, 8, 128, 1024
HUBERT_HEADS, HUBERT_HEAD_DIM = 16, 80
_VLM_ATTN = (VLM_HEADS, VLM_KV_HEADS, VLM_HEAD_DIM)
_HUBERT_ATTN = (HUBERT_HEADS, HUBERT_HEADS, HUBERT_HEAD_DIM)
#: the flash forward at every shape phases 3k and 3l give it (b, sq, sk,
#: h, m, d, causal), fp32 and (hubert's: 3l trains in bf16 too) bf16:
#: 3k (a)'s forward at b 2 over 32 positions (self causal, cross full
#: against the 1024 image keys), 3k (e)'s at b 1, 3k (f)'s gradient at b
#: 4, s 64; 3l's forward at b 8, s 512 and its steps at b 2, s 128
FLASH_VLM_ENC_PATH = (
    (2, 32, 32, *_VLM_ATTN, True), (2, 32, VLM_IMAGE, *_VLM_ATTN, False),
    (1, 32, 32, *_VLM_ATTN, True), (1, 32, VLM_IMAGE, *_VLM_ATTN, False),
    (4, 64, 64, *_VLM_ATTN, True), (4, 64, VLM_IMAGE, *_VLM_ATTN, False),
    (8, 512, 512, *_HUBERT_ATTN, False), (2, 128, 128, *_HUBERT_ATTN, False))
#: the decode kernel at 3k's caches (b, S, lengths): (a)'s teacher-forced
#: 32 steps, the Generator's 16 + 16 (S 33), (e)'s 8 steps at b 1, and
#: the cross attention's image K/V, every one of the 1024 positions valid
DECODE_VLM_PATH = ((2, 32, (1, 16, 32)), (2, 33, (1, 16, 32)),
                   (1, 8, (1, 8)), (2, VLM_IMAGE, (VLM_IMAGE,)),
                   (1, VLM_IMAGE, (VLM_IMAGE,)))
#: the backward's sweep (FLASH_BWD_SWEEP's form) widened to these
#: families: the encoder's full attention at d 80, the vlm's cross
#: attention (64 queries against 1024 image keys) at d 128
FLASH_BWD_SWEEP_VLM_ENC = ((2, 47, 47, 4, 4, 80, False),
                           (1, 64, 1024, 8, 1, 128, False))
#: the backward at 3k (f)'s and 3l's gradient shapes (b, sq, sk, h, m, d,
#: causal, dtypes): the vlm's self and cross attention in fp32, hubert's
#: in fp32 and bf16
FLASH_BWD_VLM_ENC_PATH = (
    (4, 64, 64, *_VLM_ATTN, True, ("float32",)),
    (4, 64, VLM_IMAGE, *_VLM_ATTN, False, ("float32",)),
    (2, 128, 128, *_HUBERT_ATTN, False, ("float32", "bfloat16")))
#: timed (fp32; the kernel table's rows): the forward at 3k (f)'s cross
#: and self shapes and 3l's forward, the backward at 3k (f)'s cross and
#: 3l's shape, decode at the cross attention's 1024 image keys and at the
#: Generator's last self-attention step
FLASH_VLM_ENC_TIMED = (FLASH_VLM_ENC_PATH[5], FLASH_VLM_ENC_PATH[4],
                       FLASH_VLM_ENC_PATH[6])
FLASH_BWD_VLM_ENC_TIMED = (FLASH_BWD_VLM_ENC_PATH[1][:7],
                           FLASH_BWD_VLM_ENC_PATH[2][:7])
DECODE_VLM_TIMED = ((2, VLM_IMAGE, VLM_IMAGE), (2, 33, 32))


def phase_vlm_encoder_kernels() -> dict:
    """Phase 2 at phases 3k's and 3l's shapes: the flash forward
    (FLASH_VLM_ENC_PATH) and decode kernel (DECODE_VLM_PATH) against their
    plain versions (ATTN_TOL; bf16 also ``hold_bf16``), the backward over
    FLASH_BWD_SWEEP_VLM_ENC as :func:`flash_bwd_sweep` holds it and at
    FLASH_BWD_VLM_ENC_PATH as :func:`flash_bwd_row` does, then the
    timed rows: FLASH_VLM_ENC_TIMED, FLASH_BWD_VLM_ENC_TIMED and
    DECODE_VLM_TIMED, each beside its bound and SDPA's time."""
    import torch
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_kernel)
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention_plain)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_kernel)
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {"flash_attention": 0.0, "decode_attention": 0.0}
    bf16: dict = {}
    for b, sq, sk, h, m, d, causal in FLASH_VLM_ENC_PATH:
        dtypes = (torch.float32,) + ((torch.bfloat16,) if h == HUBERT_HEADS
                                     else ())
        for dtype in dtypes:
            q, k, v = _attn_inputs(gen, dtype, (b, sq, h, d), (b, sk, m, d),
                                   (b, sk, m, d))
            out = flash_attention_kernel(q, k, v, causal=causal)
            ref = flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            what = (f"flash_attention b{b} sq{sq} sk{sk} h{h} m{m} d{d} "
                    f"causal={causal}")
            err = float((out.float() - ref.float()).abs().max())
            if dtype == torch.float32:
                check(err <= ATTN_TOL["flash_attention"]["float32"],
                      f"{what}: max |kernel - plain| {err:.3e}")
                worst["flash_attention"] = max(worst["flash_attention"], err)
            else:
                hold_bf16(what, [out], [ref], bf16,
                          flash_rows(q, k, v, causal))
            del q, k, v, out, ref
    for b, S, lengths in DECODE_VLM_PATH:
        q, k, v = _attn_inputs(gen, torch.float32, (b, VLM_HEADS,
                                                    VLM_HEAD_DIM),
                               (b, S, VLM_KV_HEADS, VLM_HEAD_DIM),
                               (b, S, VLM_KV_HEADS, VLM_HEAD_DIM))
        for length in lengths:
            err = float((decode_attention_kernel(q, k, v, length)
                         - decode_attention_plain(q, k, v, length))
                        .abs().max())
            check(err <= ATTN_TOL["decode_attention"]["float32"],
                  f"decode_attention b{b} S{S} length{length} (vlm heads): "
                  f"max |kernel - plain| {err:.3e}")
            worst["decode_attention"] = max(worst["decode_attention"], err)
    sweep = flash_bwd_sweep(gen, FLASH_BWD_SWEEP_VLM_ENC)
    bwd = []
    for b, sq, sk, h, m, d, causal, dtypes in FLASH_BWD_VLM_ENC_PATH:
        for dtype in dtypes:
            row = flash_bwd_row(gen, b, sq, h, m, d, getattr(torch, dtype),
                                causal=causal, sk=sk)
            bwd.append({k: row[k] for k in ("shape", "max_abs_err",
                                            "max_abs_grad")})
    print(f"  vlm and encoder shapes: {len(FLASH_VLM_ENC_PATH)} flash, "
          f"{sum(len(x[2]) for x in DECODE_VLM_PATH)} decode and "
          f"{len(bwd)} backward holds; max |kernel - plain| fp32 "
          + json.dumps(worst) + "; bf16 " + json.dumps(bf16))
    flash = [flash_timed_row(gen, b, sq, h, m, d, sk=sk, causal=causal)
             for b, sq, sk, h, m, d, causal in FLASH_VLM_ENC_TIMED]
    flash_bwd = [flash_bwd_row(gen, b, sq, h, m, d, torch.float32,
                               timed=True, causal=causal, sk=sk)
                 for b, sq, sk, h, m, d, causal in FLASH_BWD_VLM_ENC_TIMED]
    decode = [decode_timed_row(gen, b, S, length, heads=_VLM_ATTN)
              for b, S, length in DECODE_VLM_TIMED]
    for row in flash + decode:
        check(row["repeat_bitwise"] and row["library_max_abs_err"] <= 1e-4
              and row["max_abs_err"] <= 2e-5,
              f"timed {row['shape']}: {json.dumps(row)}")
    seconds = time.time() - t0
    print(f"  vlm and encoder shapes: {seconds:.1f} s")
    torch.cuda.empty_cache()
    return {"flash": flash, "flash_bwd": flash_bwd, "decode": decode,
            "max_abs_err": worst, "bf16_vs_plain": bf16,
            "bwd_held": bwd, "bwd_sweep_rel_err": sweep,
            "seconds": seconds}


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


def kernel_chunks_bf16(x, dt, a_log, B, C):
    """The chunked plain version at the kernel's own chunks (positions
    past s padded with dt = 0 and x = 0, as the kernel pads its last
    chunk): in bf16 it rounds where the kernel rounds."""
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan.kernel import CHUNK, n_chunks
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked
    s = x.shape[1]
    pad = n_chunks(s) * CHUNK - s
    y, state = ssd_scan_chunked(F.pad(x, (0, 0, 0, 0, 0, pad)),
                                F.pad(dt, (0, 0, 0, pad)), a_log,
                                F.pad(B, (0, 0, 0, pad)),
                                F.pad(C, (0, 0, 0, pad)), CHUNK)
    return y[:, :s], state


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
            "continuation": 0.0, "bfloat16_rel": 0.0, "bfloat16_norm": 0.0,
            "bfloat16_planted_norm_min": float("inf"), "float64": 0.0}
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

    def hold_bf16(what, out, ref, control):
        """bf16 inputs: the kernel rounds at the JAX model's points, so its
        reference is the chunked plain version in bf16 at the kernel's own
        chunks: within SSD_BF16_TOL of the largest |ref| and within
        SSD_BF16_NORM_TOL norm-wise, which ``control`` (the planted
        unrounded kernel's outputs) must miss."""
        nonlocal n_checks
        torch.cuda.synchronize()
        scale = max(float(r.abs().max()) for r in ref)
        err, norm, ctrl = gap(out, ref), _norm_rel(out, ref), \
            _norm_rel(control, ref)
        check(all(bool(o.isfinite().all()) for o in out)
              and err <= SSD_BF16_TOL * scale and norm <= SSD_BF16_NORM_TOL,
              f"ssd_scan {what} vs the chunked version in bf16: max "
              f"|kernel - plain| {err:.3e} (limit {SSD_BF16_TOL} x "
              f"{scale:.3e}), norm-wise {norm:.3e} (limit "
              f"{SSD_BF16_NORM_TOL:g})")
        check(ctrl > SSD_BF16_NORM_TOL,
              f"ssd_scan {what}: the planted unrounded kernel reads "
              f"{ctrl:.3e} norm-wise, within {SSD_BF16_NORM_TOL:g}: the "
              f"limit would not catch it")
        errs["bfloat16_rel"] = max(errs["bfloat16_rel"], err / scale)
        errs["bfloat16_norm"] = max(errs["bfloat16_norm"], norm)
        errs["bfloat16_planted_norm_min"] = min(
            errs["bfloat16_planted_norm_min"], ctrl)
        n_checks += 1

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
        with planted("ssd_scan"):
            control = ssd_scan_kernel(xb, dt, A, Bb, Cb)
        hold_bf16(what + " bf16", ssd_scan_kernel(xb, dt, A, Bb, Cb),
                  kernel_chunks_bf16(xb, dt, a_log, Bb, Cb), control)

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
          f"of the plain versions (bf16: {SSD_BF16_TOL} of the largest |y|"
          f" and {SSD_BF16_NORM_TOL} norm-wise); max |err| " + ", ".join(
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


def _short(d: dict) -> str:
    """``d``'s numbers to 4 figures, as JSON."""
    return json.dumps({k: float(f"{v:.3e}") for k, v in d.items()})


def _norm_rel(outs, refs) -> float:
    """The largest ||out - ref|| / ||ref|| over pairs of tensors (float64
    sums)."""
    return max(float((o.double() - r.double()).norm() / r.double().norm())
               for o, r in zip(outs, refs))


def _ssd_grads(fn, leaves, init, dy, dstate):
    """Autograd of ``fn(x, dt, a_log, B, C, init)`` -> (y, final state)
    at the leaves (and the initial state, if any) for the cotangents dy
    and dstate (None: the final state unused) -> the gradients by name."""
    import torch
    wrt = list(leaves) + ([] if init is None else [init])
    y, state = fn(*leaves, init)
    outs, cots = ([y], [dy]) if dstate is None else ([y, state], [dy, dstate])
    grads = torch.autograd.grad(outs, wrt, cots)
    return dict(zip(SSD_GRAD_NAMES, grads))


def _ssd_bwd_inputs(gen, b, s, h, p, n, dtype, model_like, with_init,
                    with_dstate):
    import torch
    x, dt, a_log, B, C = _ssd_inputs(gen, b, s, h, p, n, dtype, model_like)
    leaves = [t.requires_grad_(True) for t in (x, dt, a_log, B, C)]

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    init = rnd(b, h, p, n).requires_grad_(True) if with_init else None
    return leaves, init, rnd(b, s, h, p), rnd(b, h, p, n) if with_dstate \
        else None


def ssd_bwd_flop(b: int, s: int, h: int, p: int, n: int, init: bool,
                 dstate: bool) -> int:
    """The operations the SSD's gradient needs on these inputs, by the
    closed form (``ref.ssd_scan_chunked_bwd``), two per multiply-add: per
    chunk of l positions and head, dy xc^T and M^T dy over the causal
    pairs (l^2 p), and the products with G and S_prev that are nonzero
    (l p n each: B G^T and xc G when G is, dy S_prev when S_prev is,
    e dy C^T when there are several chunks or an initial state); per
    (b, chunk), C B^T, (dM o L)^T C and (dM o L) B over the causal pairs
    (3 l^2 n / 2; dM o L summed over the heads first)."""
    nc = -(-s // 64)
    flop = 0
    for c in range(nc):
        l = min(64, s - 64 * c)
        g = dstate or c < nc - 1
        prev = init or c > 0
        states = nc > 1 or init
        per_head = l * l * p + l * p * n * (2 * g + prev + states)
        flop += 2 * b * (h * per_head + 3 * l * l * n // 2)
    return flop


def ssd_bwd_row(gen, b: int, s: int, h: int, p: int, n: int, dtype,
                model_like: bool, with_init: bool, with_dstate: bool,
                timed: bool = False, gate: bool = True) -> dict:
    """The SSD backward kernel (through ``ssd_scan_fused`` under autograd:
    ``SSDScan``) against autograd of the chunked plain version, each
    gradient within SSD_BWD_TOL of its largest plain |g|, two calls equal
    bit for bit; in fp32 also against autograd of the float64 recurrence:
    each gradient within twice the plain version's error.  The closed
    form (``ref.ssd_scan_chunked_bwd``) is read beside them.  With
    ``timed``: CUDA-event times of the backward alone (the kernel's
    wrapper; the plain version's autograd backward from a forward made
    outside the timed call) and of forward + backward, with a 3xTF32, an
    fp32 and a bytes bound (no PyTorch call computes this gradient).
    Without ``gate`` (another checkout's kernel, read for comparison) a
    miss is recorded in ``misses`` instead of failing."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel as sk

    misses = []

    def gate_check(cond, msg):
        if gate:
            check(cond, msg)
        elif not cond:
            misses.append(msg)
    from repro_torch.kernels.ssd_scan.ops import (
        decay_rates, ssd_scan_fused, ssd_scan_recurrence)
    from repro_torch.kernels.ssd_scan.ref import (
        ssd_scan_chunked, ssd_scan_chunked_bwd)
    key = str(dtype).replace("torch.", "")
    leaves, init, dy, dstate = _ssd_bwd_inputs(
        gen, b, s, h, p, n, dtype, model_like, with_init, with_dstate)

    def kernel_fn(*a):
        return ssd_scan_fused(*a[:5], init_state=a[5])

    def plain_fn(*a):
        return ssd_scan_chunked(*a[:5], SSD_MODEL_CHUNK, a[5])

    before = sk.launches["ssd_scan_bwd"]
    got = _ssd_grads(kernel_fn, leaves, init, dy, dstate)
    gate_check(sk.launches["ssd_scan_bwd"] == before + 1,
          "ssd_scan_fused under autograd did not launch the backward kernel")
    again = _ssd_grads(kernel_fn, leaves, init, dy, dstate)
    plain = _ssd_grads(plain_fn, leaves, init, dy, dstate)
    closed = dict(zip(SSD_GRAD_NAMES, ssd_scan_chunked_bwd(
        *(t.detach() for t in leaves), SSD_MODEL_CHUNK,
        None if init is None else init.detach(), dy, dstate)))
    torch.cuda.synchronize()
    what = (f"b{b} s{s} h{h} p{p} n{n} {key}" + (" init" if with_init else "")
            + (" dstate" if with_dstate else ""))
    row = {"shape": what, "rel_err": {}, "closed_form_rel_err": {},
           "repeat_bitwise": all(_bits_equal(got[k], again[k]) for k in got)}
    gate_check(row["repeat_bitwise"], f"ssd_scan_bwd {what}: two calls differ")
    if dtype == torch.bfloat16:
        with planted("ssd_scan_bwd"):
            ctrl = _ssd_grads(kernel_fn, leaves, init, dy, dstate)
        row["norm_rel"] = {k: _norm_rel([got[k]], [plain[k]]) for k in got}
        row["planted_norm_rel"] = {k: _norm_rel([ctrl[k]], [plain[k]])
                                   for k in got}
        del ctrl
        over = {k: v for k, v in row["norm_rel"].items()
                if v > SSD_BF16_NORM_TOL}
        gate_check(not over, f"ssd_scan_bwd {what}: norm-wise {over} from the "
                        f"plain gradient, over {SSD_BF16_NORM_TOL:g}")
        gate_check(max(row["planted_norm_rel"].values()) > SSD_BF16_NORM_TOL,
              f"ssd_scan_bwd {what}: the planted backward that keeps its "
              f"cotangents fp32 reads {row['planted_norm_rel']} norm-wise, "
              f"within {SSD_BF16_NORM_TOL:g}: the limit would not catch it")
    for name, g in got.items():
        scale = float(plain[name].float().abs().max())
        gate_check(bool(g.float().isfinite().all()) and g.dtype == plain[name].dtype,
              f"ssd_scan_bwd {what} {name}: not finite or {g.dtype}")
        err = float((g.float() - plain[name].float()).abs().max())
        row["rel_err"][name] = err / scale if scale else err
        row["closed_form_rel_err"][name] = float(
            (g.float() - closed[name].float()).abs().max()) / (scale or 1.0)
        gate_check(err <= SSD_BWD_TOL[key] * scale,
              f"ssd_scan_bwd {what} {name}: max |kernel - plain| {err:.3e} "
              f"> {SSD_BWD_TOL[key]:g} x {scale:.3e}")
    if dtype == torch.float32:
        exact = _ssd_grads(
            lambda *a: ssd_scan_recurrence(*a[:5], a[5]),
            [t.detach().double().requires_grad_(True) for t in leaves],
            None if init is None else init.detach().double().requires_grad_(
                True), dy.double(),
            None if dstate is None else dstate.double())
        row["vs_float64"] = {
            name: {"kernel": float((got[name].double() - x).abs().max()),
                   "plain": float((plain[name].double() - x).abs().max()),
                   "max_abs_grad": float(x.abs().max())}
            for name, x in exact.items()}
        del exact
        for name, e in row["vs_float64"].items():
            gate_check(e["kernel"] <= 2 * e["plain"],
                  f"ssd_scan_bwd {what} {name}: {e['kernel']:.3e} from "
                  f"float64, over twice the plain version's {e['plain']:.3e}")
    if timed:
        x, dt, a_log, B, C = (t.detach() for t in leaves)
        A = decay_rates(a_log)
        prev = None if init is None else init.detach()

        def bwd_fn():
            return sk.ssd_scan_bwd_kernel(x, dt, A, B, C, prev, dy, dstate,
                                          with_dinit=init is not None)

        wrt = list(leaves) + ([] if init is None else [init])
        with torch.enable_grad():
            y_plain = plain_fn(*leaves, init)
        outs = [y_plain[0]] if dstate is None else list(y_plain)
        cots = [dy] if dstate is None else [dy, dstate]
        es = x.element_size()
        nbytes = (es * 2 * b * s * h * p + 4 * b * s * h * p + 8 * b * s * h
                  + es * 4 * b * s * n
                  + (8 * b * h * p * n if with_init else 0)
                  + (4 * b * h * p * n if with_dstate else 0))
        flop = ssd_bwd_flop(b, s, h, p, n, with_init, with_dstate)
        b_ms, by = tf32x3_bound_ms(nbytes, flop)
        row.update(
            ms=time_ms(bwd_fn),
            launch_us=_launch_profile(bwd_fn),
            fwd_bwd_ms=time_ms(lambda: _ssd_grads(kernel_fn, leaves, init,
                                                  dy, dstate)),
            plain_ms=time_ms(lambda: torch.autograd.grad(
                outs, wrt, cots, retain_graph=True), reps=10),
            plain_fwd_bwd_ms=time_ms(lambda: _ssd_grads(
                plain_fn, leaves, init, dy, dstate), reps=10),
            bound_ms=b_ms, bound_by=by,
            bound_fp32_ms=bound_ms(nbytes, flop)[0],
            bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bound_bytes=nbytes, bound_flop=flop, library_ms=None,
            library="none (no PyTorch call computes the SSD scan's "
                    "gradient)")
        del y_plain, outs
    if misses:
        row["misses"] = misses
    print(f"  ssd_scan_bwd {what}: |kernel - plain| / largest plain |g| "
          + json.dumps({k: float(f"{v:.3e}") for k, v in row["rel_err"].items()})
          + "; closed form " + json.dumps(
              {k: float(f"{v:.3e}")
               for k, v in row["closed_form_rel_err"].items()})
          + (f"; norm-wise {_short(row['norm_rel'])}, planted "
             f"{_short(row['planted_norm_rel'])}" if "norm_rel" in row
             else "")
          + (f"; vs_float64={json.dumps(row['vs_float64'])}"
             if "vs_float64" in row else "")
          + (f"; backward ms={row['ms']:.5f} bound_ms={row['bound_ms']:.5f} "
             f"(3xTF32 {row['bound_by']}; fp32 {row['bound_fp32_ms']:.5f}, "
             f"bytes {row['bytes_bound_ms']:.5f}) plain_ms="
             f"{row['plain_ms']:.5f}; forward + backward ms="
             f"{row['fwd_bwd_ms']:.5f} plain_ms={row['plain_fwd_bwd_ms']:.5f}"
             f" launch_us=" + json.dumps(row["launch_us"]) if timed else ""))
    del leaves, init, dy, dstate, got, again, plain, closed
    torch.cuda.empty_cache()
    return row


def ssd_bwd_vs_float64() -> dict:
    """Rounding of the SSD backward kernel at the training path's shapes
    (SSD_BWD_PATH, fp32, model-like inputs from their own seed, the same in
    every checkout): the gradients of ``ssd_scan_fused`` (the kernel under
    autograd) and of the chunked plain version against autograd of the
    float64 recurrence, max |g - exact| per gradient, and a hash of the
    kernel's gradient bits.  It runs in a checkout of any commit since the
    backward kernel (``redesign_baseline(only="ssd_scan_bwd")``)."""
    import torch
    from repro_torch.kernels.ssd_scan.ops import (
        ssd_scan_fused, ssd_scan_recurrence)
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked
    gen = torch.Generator(device="cuda").manual_seed(SSD_BWD_FP64_SEED)
    out = {}
    for b, s, h, p, n in SSD_BWD_PATH:
        leaves, init, dy, dstate = _ssd_bwd_inputs(
            gen, b, s, h, p, n, torch.float32, True, False, False)
        got = _ssd_grads(lambda *a: ssd_scan_fused(*a[:5], init_state=a[5]),
                         leaves, init, dy, dstate)
        plain = _ssd_grads(lambda *a: ssd_scan_chunked(
            *a[:5], SSD_MODEL_CHUNK, a[5]), leaves, init, dy, dstate)
        exact = _ssd_grads(
            lambda *a: ssd_scan_recurrence(*a[:5], a[5]),
            [t.detach().double().requires_grad_(True) for t in leaves],
            None, dy.double(), None)
        row = {name: {"kernel": float((got[name].double() - x).abs().max()),
                      "plain": float((plain[name].double() - x).abs().max()),
                      "max_abs_grad": float(x.abs().max())}
               for name, x in exact.items()}
        h_ = hashlib.sha256()
        for name in exact:
            h_.update(got[name].cpu().numpy().tobytes())
        row["kernel_sha256"] = h_.hexdigest()
        out[f"b{b} s{s} h{h} p{p} n{n}"] = row
        del leaves, dy, got, plain, exact
    torch.cuda.empty_cache()
    print("  ssd_scan_bwd vs the float64 recurrence: " + json.dumps(out))
    return out


def ssd_forward_bf16(gen) -> dict:
    """The forward in bf16 against the chunked plain version in bf16 at the
    training path's shapes (one chunk in both, so the JAX model's rounding
    points): the largest |kernel - plain| over y and the state, relative
    to the largest plain |y|, within SSD_BF16_FWD_TOL, and norm-wise
    within SSD_BF16_NORM_TOL; the planted copy that rounds nothing (the
    kernel of b87ae5a, PLANTED) must miss both.  It runs in a checkout of
    any commit that has the forward (``python3 -c 'import sys;
    sys.path.insert(0, "src"); import chip_smoke as c, torch;
    c.ssd_forward_bf16(torch.Generator(device="cuda").manual_seed(7))'``,
    with the planted copy built by ``c.finish_planted(c.start_planted())``)."""
    import torch
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_kernel
    from repro_torch.kernels.ssd_scan.ops import decay_rates
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked
    out = {}
    for b, s, h, p, n in SSD_BWD_PATH:
        x, dt, a_log, B, C = _ssd_inputs(gen, b, s, h, p, n, torch.bfloat16,
                                         True)
        A = decay_rates(a_log)
        got = ssd_scan_kernel(x, dt, A, B, C)
        with planted("ssd_scan"):
            ctrl = ssd_scan_kernel(x, dt, A, B, C)
        ref = ssd_scan_chunked(x, dt, a_log, B, C, SSD_MODEL_CHUNK)
        torch.cuda.synchronize()
        scale = float(ref[0].abs().max())
        out[f"b{b} s{s} h{h} p{p} n{n}"] = {
            "max_rel": max(float((g - r).abs().max())
                           for g, r in zip(got, ref)) / scale,
            "norm_rel": _norm_rel(got, ref),
            "planted_max_rel": max(float((g - r).abs().max())
                                   for g, r in zip(ctrl, ref)) / scale,
            "planted_norm_rel": _norm_rel(ctrl, ref)}
    print("  ssd_scan bf16 forward vs the chunked plain version in bf16 "
          "(max |kernel - plain| / largest |y|, and norm-wise; the planted "
          "unrounded kernel beside it): " + json.dumps(out))
    for what, r in out.items():
        check(r["max_rel"] <= SSD_BF16_FWD_TOL
              and r["norm_rel"] <= SSD_BF16_NORM_TOL,
              f"ssd_scan bf16 {what}: {r['max_rel']:.3e} of the largest |y| "
              f"(limit {SSD_BF16_FWD_TOL:g}), {r['norm_rel']:.3e} norm-wise "
              f"(limit {SSD_BF16_NORM_TOL:g}) from the chunked version")
        check(r["planted_max_rel"] > SSD_BF16_FWD_TOL
              and r["planted_norm_rel"] > SSD_BF16_NORM_TOL,
              f"ssd_scan bf16 {what}: the planted unrounded kernel reads "
              f"{r['planted_max_rel']:.3e} / {r['planted_norm_rel']:.3e}, "
              f"within a limit: it would not catch it")
    return out


def phase_ssd_bwd() -> dict:
    """The SSD scan's backward kernel against autograd of the chunked plain
    version and the float64 recurrence (:func:`ssd_bwd_row`) at the
    training path's shapes (SSD_BWD_PATH) in fp32 and bf16, timed there in
    fp32, and over SSD_BWD_SWEEP in fp32 (bf16 only where one chunk makes
    the rounding points the plain version's); then the repaired bf16
    forward (:func:`ssd_forward_bf16`)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for shape in SSD_BWD_PATH:
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(ssd_bwd_row(gen, *shape, dtype, True, False, False,
                                    timed=dtype == torch.float32))
    for *shape, with_init in SSD_BWD_SWEEP:
        dtypes = (torch.float32, torch.bfloat16) if shape[1] <= 64 \
            else (torch.float32,)
        for dtype in dtypes:
            rows.append(ssd_bwd_row(gen, *shape, dtype, False, with_init,
                                    True))
    fwd = ssd_forward_bf16(torch.Generator(device="cuda").manual_seed(7))
    vs_fp64 = ssd_bwd_vs_float64()
    for shape, row in vs_fp64.items():
        for name, e in row.items():
            if name == "kernel_sha256":
                continue
            parent = SSD_BWD_FP64_PARENT[shape][name]["kernel"]
            check(e["kernel"] <= 2 * parent,
                  f"ssd_scan_bwd vs float64 {shape} {name}: "
                  f"{e['kernel']:.3e}, over twice the replaced kernel's "
                  f"{parent:.3e}")
    timed = [r for r in rows if "ms" in r]
    main = timed[0]
    return {**{k: main[k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "bound_fp32_ms", "bytes_bound_ms", "library_ms", "library",
                "fwd_bwd_ms", "plain_fwd_bwd_ms", "vs_float64",
                "launch_us")},
            "max_abs_err": max(max(r["rel_err"].values()) for r in rows
                               if "float32" in r["shape"]),
            "max_rel_err_bf16": max(max(r["rel_err"].values()) for r in rows
                                    if "bfloat16" in r["shape"]),
            "max_norm_rel_bf16": max(max(r["norm_rel"].values())
                                     for r in rows if "norm_rel" in r),
            "min_planted_norm_rel_bf16": min(
                max(r["planted_norm_rel"].values())
                for r in rows if "norm_rel" in r),
            "forward_bf16_rel_err": fwd, "vs_float64_seeded": vs_fp64,
            "timed": timed, "rows": rows}


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
    """Every trial of every ported study preset (quick sizes) through
    ``run_experiment`` on the card and on the CPU: the records must agree
    on every metered field and on the losses to CARD_VS_CPU_RTOL.  This
    reaches the paths the comm specs above do not: MA-SGD, ADMM, SSP/ASP,
    the hybrid PS, spot kills, checkpoint cadences and traces.  The
    presets that train a zoo architecture (bf16) are phase 3g's."""
    from repro_torch.core.workloads import is_arch_workload
    from repro_torch.experiments import PRESETS
    n, worst = 0, 0.0
    for preset in PRESETS.values():
        for spec in preset.build(True):
            if is_arch_workload(spec.model):
                continue
            worst = max(worst, _records_agree(spec))
            n += 1
    print(f"  {n} preset trials: card records equal the CPU's (losses "
          f"within {CARD_VS_CPU_RTOL:g}; largest gap {worst:.3e})")
    return n


def _records_agree(spec, rtol: float = CARD_VS_CPU_RTOL,
                   card: dict | None = None, cpu: dict | None = None) -> float:
    """One spec through ``run_experiment`` on the card and on the CPU (or
    ``card`` and ``cpu``, those records' results made elsewhere): the
    records must agree on every metered field (``scaling_timeline``
    included) and on the losses to ``rtol``.  Returns the largest
    relative loss gap."""
    from repro_torch.experiments import run_experiment
    worst = 0.0
    if card is None:
        card = run_experiment(spec, device="cuda").result
    if cpu is None:
        cpu = run_experiment(spec, device="cpu").result
    else:                                # as JSON gives it back
        card = json.loads(json.dumps(card))
    for key, val in cpu.items():
        if key not in ("history", "final_loss"):
            check(card[key] == val, f"{spec.name}: {key} differs "
                                    f"on the card: {card[key]!r}")
    check([t for t, _ in card["history"]]
          == [t for t, _ in cpu["history"]],
          f"{spec.name}: history timestamps differ on the card")
    for (_, a), (_, b) in zip(card["history"], cpu["history"]):
        check(abs(a - b) <= rtol * abs(b),
              f"{spec.name}: card loss {a!r} vs cpu {b!r}")
        worst = max(worst, abs(a - b) / abs(b))
    return worst


# ------------------------------------------ 3f. elastic, planner and CLI ---

#: phase 3f (a): phase 3's full-size int8 spec on an elastic fleet that
#: starts at 4 workers and grows to 8 at round 2
ELASTIC_SPEC = PATH_SPECS[0]
ELASTIC_OVER = {"scaling": "schedule:4@0,8@2", "fleet.min_workers": 2,
                "fleet.max_workers": 16, "max_epochs": 2}
#: phase 3f (c): the estimator's workload (LR on Higgs at the dataset
#: stand-in's default 100,000 rows) and target loss
ESTIMATE_TARGET = 0.6


def _round_widths(res) -> list[int]:
    """The live fleet width in each round: a timeline entry ``(r, w, ...)``
    sets the width from round r on."""
    entries = sorted((r, w) for r, w, _s, _c in res.scaling_timeline)
    return [next(w for r, w in reversed(entries) if r <= k)
            for k in range(res.rounds)]


def _metered(res) -> dict:
    return {"system": res.system, "workers": res.workers,
            "rounds": res.rounds, "sim_time": res.sim_time, "cost": res.cost,
            "comm_bytes": res.comm_bytes, "comm_cost": res.comm_cost,
            "ckpt_bytes": res.ckpt_bytes, "ckpt_time": res.ckpt_time,
            "ckpt_cost": res.ckpt_cost, "preemptions": res.preemptions,
            "max_staleness": res.max_staleness, "breakdown": res.breakdown,
            "times": [t for t, _ in res.history],
            "scaling_timeline": [tuple(x) for x in res.scaling_timeline]}


def _plan_text(argv: list[str], device: str) -> str:
    import contextlib
    import io
    from repro_torch.__main__ import main as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(["plan", *argv, "--device", device])
    check(rc == 0, f"plan {argv} on {device}: rc {rc}")
    return buf.getvalue()


def phase_elastic(preset) -> dict:
    """This slice's path at full size: (a) an elastic run through the int8
    kernel, (b) the elastic_axis preset at --full, (c) the planner and
    the epoch estimator, (d) ``python -m repro_torch trace`` in a
    subprocess.  Card against CPU throughout."""
    import torch
    from repro_torch.core import make_algorithm, make_study_model
    from repro_torch.core.analytical import CostInputs, estimate_epochs
    from repro_torch.core.elastic import plan
    from repro_torch.data import make_dataset, train_val_split
    from repro_torch.experiments import get_preset
    out = {"seconds": {}}

    # (a) the int8 comm spec, 4 -> 8 workers at round 2
    t0 = time.time()
    spec = preset[ELASTIC_SPEC].with_(**ELASTIC_OVER)
    res, launches, seen, wall = _drive(spec, "cuda")
    check(not res.error, f"3f (a): {res.error}")
    check(seen == {("merged", "cuda"), ("params", "cuda")},
          f"3f (a): merges/params not all on the card: {seen}")
    widths = _round_widths(res)
    check(widths[0] == 4 and widths[-1] == 8,
          f"3f (a): widths {widths} do not grow from 4 to 8")
    check(launches["quantize8_ef"] == sum(widths),
          f"3f (a): quantize8_ef launches {launches}, want the live width "
          f"summed over the rounds, {sum(widths)}")
    ref, _, _, cpu_wall = _drive(spec, "cpu")
    check(_metered(res) == _metered(ref),
          f"3f (a): card metered fields {_metered(res)} differ from the "
          f"CPU's {_metered(ref)}")
    card_l, cpu_l = _history_losses(res), _history_losses(ref)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
    check(len(card_l) == len(cpu_l) and rel <= CARD_VS_CPU_RTOL,
          f"3f (a): card losses {card_l} vs cpu {cpu_l}")
    out["launches"] = launches["quantize8_ef"]
    out["a"] = {"rounds": res.rounds, "widths": widths,
                "scaling_timeline": res.scaling_timeline,
                "sim_time": res.sim_time, "final_loss": res.final_loss,
                "wall_s": wall, "cpu_wall_s": cpu_wall,
                "max_rel_loss_vs_cpu": rel}
    print(f"  (a) {spec.name} under {ELASTIC_OVER['scaling']}: "
          f"rounds={res.rounds} widths={widths} "
          f"quantize8_ef={launches['quantize8_ef']} wall_s={wall:.3f} "
          f"cpu_wall_s={cpu_wall:.3f} max_rel_loss_vs_cpu={rel:.3e}")
    out["seconds"]["a"] = time.time() - t0

    # (b) elastic_axis at full size, every trial on the card and the CPU
    t0 = time.time()
    worst = 0.0
    trials = get_preset("elastic_axis").build(False)
    for trial in trials:
        worst = max(worst, _records_agree(trial))
    out["b"] = {"trials": len(trials), "rows": trials[0].rows,
                "max_rel_loss_vs_cpu": worst}
    print(f"  (b) elastic_axis --full: {len(trials)} trials at "
          f"{trials[0].rows} rows, card records equal the CPU's (largest "
          f"loss gap {worst:.3e})")
    out["seconds"]["b"] = time.time() - t0

    # (c) the planner, card against CPU, and the estimator on the card
    t0 = time.time()
    for name, want in (("lr_higgs", "faas"), ("mobilenet_cifar10", "iaas")):
        for objective in ("cheapest", "fastest"):
            top = plan(name, objective)[0]
            check(top.platform == want,
                  f"3f (c): plan({name}, {objective}) picks {top.platform}")
    spec_json = ROOT / "build" / "phase3f_spec.json"
    spec_json.parent.mkdir(parents=True, exist_ok=True)
    spec_json.write_text(spec.to_json())
    for argv in (["lr_higgs"], ["mobilenet_cifar10"],
                 [str(spec_json), "--objective", "fastest"]):
        card_text = _plan_text(argv, "cuda")
        check(card_text == _plan_text(argv, "cpu"),
              f"3f (c): plan {argv} prints other rows on the card")
    spec_rows = plan(spec, R=spec.max_epochs)
    tr, _ = train_val_split(make_dataset("higgs"))
    model = make_study_model("lr", tr)
    algo = make_algorithm("ga_sgd", lr=0.2, batch_size=128)
    r_card = estimate_epochs(model, algo, tr, ESTIMATE_TARGET, device="cuda")
    torch.cuda.synchronize()
    r_cpu = estimate_epochs(model, algo, tr, ESTIMATE_TARGET, device="cpu")
    check(r_card == r_cpu, f"3f (c): estimate_epochs {r_card} on the card, "
                           f"{r_cpu} on the CPU")
    rows = [plan(CostInputs.from_workload(model, tr, R=r), "cheapest")
            for r in (r_card, r_cpu)]
    check(rows[0] == rows[1], "3f (c): planned rows differ card vs CPU")
    out["c"] = {"estimated_epochs": r_card, "spec_pick": [
        spec_rows[0].platform, spec_rows[0].workers],
        "lr_higgs_pick": [rows[0][0].platform, rows[0][0].workers]}
    print(f"  (c) plan: lr_higgs -> faas, mobilenet_cifar10 -> iaas; "
          f"{spec.name} -> {spec_rows[0].platform} w={spec_rows[0].workers}; "
          f"estimate_epochs(LR/higgs, {ESTIMATE_TARGET}) = {r_card} on the "
          f"card and the CPU")
    out["seconds"]["c"] = time.time() - t0

    # (d) the trace command in a subprocess, on the card
    t0 = time.time()
    trace_dir = ROOT / "build" / "phase3f_trace"
    for old in trace_dir.glob("*.json"):
        old.unlink()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "trace", "fig10_trace",
         "--quick", "--export", "chrome", "--out",
         str(trace_dir / "fig10.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    check(proc.returncode == 0,
          f"3f (d): trace exited {proc.returncode}: {proc.stderr[-2000:]}")
    n_specs = proc.stdout.count("byte conservation")
    gates = proc.stdout.count("[OK  ]")
    check(n_specs == len(get_preset("fig10_trace").build(True))
          and gates == 3 * n_specs and "[FAIL]" not in proc.stdout,
          f"3f (d): {gates} OK gates over {n_specs} specs:\n{proc.stdout}")
    files = sorted(trace_dir.glob("*.json"))
    check(len(files) == n_specs, f"3f (d): {len(files)} trace files")
    events = sum(len(json.loads(f.read_text())["traceEvents"])
                 for f in files)
    out["d"] = {"specs": n_specs, "gates_ok": gates, "files": len(files),
                "trace_events": events}
    print(f"  (d) trace fig10_trace --export chrome: {gates} gates OK over "
          f"{n_specs} specs, {len(files)} JSON files load "
          f"({events} events)")
    out["seconds"]["d"] = time.time() - t0
    out["seconds"]["total"] = sum(out["seconds"].values())
    print("  3f seconds: " + ", ".join(
        f"{k}={v:.1f}" for k, v in out["seconds"].items()))
    return out


# ------------------------------------------------------------- 3d. serve ---

def _path_launches() -> dict:
    """The serving path's kernels (flash attention's backward is 3g's)."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    return {"flash_attention": fk.launches["flash_attention"], **dk.launches,
            "ssd_scan": sk.launches["ssd_scan"]}


def _reset_path_launches() -> None:
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_scan import kernel as sk
    fk.reset_launches()
    dk.reset_launches()
    sk.reset_launches()


def _attention_layers(cfg) -> int:
    """The attention calls one pass makes: one per layer (the vlm's self
    and cross layers alike, the encoder's), one per shared-block use
    (hybrid), none (ssm)."""
    layers = cfg.num_layers
    return {"dense": layers, "moe": layers, "vlm": layers,
            "encoder": layers, "ssm": 0,
            "hybrid": layers // max(cfg.attn_every, 1)}[cfg.family]


def _want_launches(cfg, steps: int, forwards: int) -> dict:
    """Exact launch counts of ``steps`` decode steps and ``forwards``
    forwards: flash per attention layer per forward, decode attention per
    attention layer per step (none with MLA: its decode is plain products
    in the latent space; the vlm's cross attention is one of each in its
    group's last layer), the SSD scan per Mamba2 layer per forward (never
    in a decode step: that is the single-step recurrence)."""
    layers = cfg.num_layers
    attn = _attention_layers(cfg)
    mamba = layers if cfg.family in ("ssm", "hybrid") else 0
    return {"flash_attention": attn * forwards,
            "decode_attention": 0 if cfg.use_mla else attn * steps,
            "ssd_scan": mamba * forwards}


#: a forced expert's own gate may lie this far below the K-th largest
#: gate of its token (gates are fp32 softmax probabilities, ~1/E): two
#: sound runs whose fp32 sums differ (card vs CPU, a forward vs decode
#: steps) route a token whose K-th and (K+1)-th gates lie within their
#: rounding either way; an expert further below is a wrong route
ROUTE_GATE_TOL = 1e-5
#: in bf16 the router's logits are rounded to bf16 before the fp32
#: softmax, and its inputs part between two sound runs by the earlier
#: layers' bf16 roundings: each logit may move by up to two bf16 ulps (at
#: its token's largest |logit|), one of its own rounding and one of its
#: inputs', so a forced route is held at its logit no further than the
#: two logits' four ulps below the largest logit outside the forced set
#: (:meth:`Routes.hold_bf16`).  One ulp a logit does not hold: deepseek's
#: cut on an H100 beside the CPU read 2.5 ulps; a planted wrong route
#: reads hundreds (:func:`_route_control_bf16`)
ROUTE_BF16_ULPS = 4.0


#: the router hooks of :class:`Routes`: installed while any thread holds a
#: Routes block, each thread's innermost block deciding its own calls
_ROUTE_LOCK = threading.Lock()
_ROUTE_STATE: dict = {"users": 0, "kept": None}
_ROUTE_LOCAL = threading.local()


def _route_hook(gates, k):
    stack = getattr(_ROUTE_LOCAL, "stack", None)
    if stack:
        return stack[-1]._route(gates, k)
    return _ROUTE_STATE["kept"][0](gates, k)


def _capacity_hook(tokens, cfg):
    stack = getattr(_ROUTE_LOCAL, "stack", None)
    if stack and stack[-1].no_drops:
        return max(tokens, cfg.experts_per_token)
    return _ROUTE_STATE["kept"][1](tokens, cfg)


def _moe_block_hook(x, p, cfg):
    """A forced call's router logits, kept for its route: the product
    ``moe_block`` makes, on the same inputs."""
    import torch
    stack = getattr(_ROUTE_LOCAL, "stack", None)
    if stack and stack[-1].force is not None:
        with torch.no_grad():
            stack[-1].logits = (x.reshape(-1, x.shape[-1])
                                @ p["router"]).float()
    return _ROUTE_STATE["kept"][2](x, p, cfg)


def bf16_ulp(a):
    """The spacing of bf16 values at |a| (8 significant bits)."""
    import torch
    a = a.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


class Routes:
    """A hook local to this script on the MoE router
    (``repro_torch.models.moe.route``, swapped in for the block, for the
    calls of the thread that entered it): every
    call's chosen experts are kept (``records``, on the card, in call
    order).  ``force``: a list of expert choices, one per call, that the
    calls take instead of their own -- so that two runs whose fp32 sums
    differ route alike -- each forced expert's own gate held at least its
    own K-th largest gate less ROUTE_GATE_TOL (:meth:`hold`).
    ``no_drops``: every call's capacity is its token count, so no
    assignment is dropped (a forward's tokens then route as decode steps
    at batch 4 do: the model's capacity factor of 1.0 drops assignments in
    a forward of b*s tokens and none in a step of b)."""

    def __init__(self, force=None, no_drops: bool = False):
        self.force = None if force is None else list(force)
        self.no_drops = no_drops
        self.records: list = []
        self.slack = float("inf")      # least forced gate - own K-th gate
        self.ulps = float("inf")       # the same at the logits, in bf16 ulps
        self.moved = 0                 # tokens whose forced set differs
        self.logits = None

    def __enter__(self):
        from repro_torch.models import moe
        with _ROUTE_LOCK:
            if _ROUTE_STATE["users"] == 0:
                _ROUTE_STATE["kept"] = (moe.route, moe._capacity,
                                        moe.moe_block)
                moe.route, moe._capacity, moe.moe_block = (
                    _route_hook, _capacity_hook, _moe_block_hook)
            _ROUTE_STATE["users"] += 1
        _ROUTE_LOCAL.__dict__.setdefault("stack", []).append(self)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        _ROUTE_LOCAL.stack.pop()
        with _ROUTE_LOCK:
            _ROUTE_STATE["users"] -= 1
            if _ROUTE_STATE["users"] == 0:
                moe.route, moe._capacity, moe.moe_block = \
                    _ROUTE_STATE["kept"]

    def _route(self, gates, k):
        import torch
        g, idx = _ROUTE_STATE["kept"][0](gates, k)
        if self.force is not None:
            check(bool(self.force), "Routes: more router calls than forced "
                                    "choices")
            want = self.force.pop(0).to(gates.device)
            check(want.shape == idx.shape, f"Routes: forced {want.shape}, "
                                           f"the call routes {idx.shape}")
            forced = gates.gather(-1, want)
            self.slack = min(self.slack,
                             float((forced - g[:, -1:]).min().detach()))
            if self.logits is not None:
                lg, self.logits = self.logits, None
                rest = lg.scatter(-1, want, float("-inf")).amax(-1)
                gap = lg.gather(-1, want).amin(-1) - rest
                self.ulps = min(self.ulps, float(
                    (gap / bf16_ulp(lg.abs().amax(-1))).min()))
            self.moved += int((torch.sort(want, -1).values
                               != torch.sort(idx, -1).values).any(-1).sum())
            g, idx = forced, want
        self.records.append(idx.clone())
        return g, idx

    def reading(self) -> dict:
        return {"calls": len(self.records), "moved_tokens": self.moved,
                "least_slack": self.slack, "least_bf16_ulps": self.ulps}

    def hold_bf16(self, what: str) -> None:
        """Fails unless every forced choice was used and every forced
        expert's logit lies at most ROUTE_BF16_ULPS bf16 ulps (at its
        token's largest |logit|) below the largest logit outside the
        forced set: the routes of a bf16 run that the logits' rounding
        alone can explain."""
        check(not self.force, f"{what}: {len(self.force)} forced routes "
                              f"left unused")
        check(self.ulps >= -ROUTE_BF16_ULPS,
              f"{what}: a forced expert's logit lies {-self.ulps:.2f} bf16 "
              f"ulps below the largest outside its token's forced set (> "
              f"ROUTE_BF16_ULPS {ROUTE_BF16_ULPS:g}): a wrong route, not a "
              f"rounding")

    def hold(self, what: str) -> None:
        """Fails unless every forced choice was used and none lies further
        than ROUTE_GATE_TOL below its token's own K-th gate."""
        if self.force is None:
            return
        check(not self.force, f"{what}: {len(self.force)} forced routes "
                              f"left unused")
        check(self.slack >= -ROUTE_GATE_TOL,
              f"{what}: a forced expert's gate lies {-self.slack:.3e} below "
              f"its token's K-th (> ROUTE_GATE_TOL {ROUTE_GATE_TOL:g}): a "
              f"wrong route, not a near-tie")


def moe_layers(cfg) -> int:
    """The MoE layers of a moe config (the router's calls a pass makes)."""
    return cfg.num_layers - cfg.first_k_dense if cfg.family == "moe" else 0


def steps_as_forward(records: list, layers: int, b: int, s: int) -> list:
    """Routes recorded over the decode steps that fed the first s - 1
    tokens of (b, s) -- step-major, one (b, K) per MoE layer -- as the
    calls of a forward over those s - 1 positions: one (b (s-1), K) per
    layer, tokens batch-major."""
    import torch
    if not layers:
        return []
    steps = len(records) // layers
    check(steps * layers == len(records) and steps == s - 1,
          f"{len(records)} routed calls for {layers} MoE layers over "
          f"{s - 1} steps")
    return [torch.stack([records[t * layers + i] for t in range(steps)],
                        dim=1).reshape(b * steps, -1)
            for i in range(layers)]


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


class _StepLogits:
    """The logits of every decode step of a Generator's next run, kept as
    the run makes them: each step's are copied into pinned host memory on
    the card's stream (asynchronously, so the run's device memory and its
    timing are its own), in step order.  Step t's logits predict token t +
    1.  :meth:`stop` gives the Generator back its own step."""

    def __init__(self, gen, b: int, steps: int):
        import torch
        self.gen, self.n = gen, 0
        self.buf = torch.empty((steps, b, gen.model.cfg.vocab_size),
                               dtype=torch.float32, pin_memory=True)
        step = gen._decode

        def decode(cache, token, pos):
            logits, cache = step(cache, token, pos)
            self.buf[self.n].copy_(logits, non_blocking=True)
            self.n += 1
            return logits, cache
        gen._decode = decode

    def stop(self) -> None:
        del self.gen._decode                 # the class's own again

    def logits(self, steps: int):
        """(b, steps, V): the first ``steps`` steps' logits."""
        import torch
        torch.cuda.synchronize()
        check(self.n >= steps, f"{self.n} decode steps recorded, want "
                               f"{steps}")
        out = self.buf[:steps].transpose(0, 1).contiguous()
        del self.buf
        return out


def _vs_cpu(cpu_model, out, card, what: str, routes=None) -> dict:
    """The card's per-step logits ``card`` against the same model on the
    CPU, teacher-forced with the card's tokens ``out`` (b, s), within
    SERVE_TOL of the largest; the CPU's perplexity (``perplexity``'s
    arithmetic: the loss with AUX_COEF of the MoE layers' aux).  MoE (``routes``: the card's, as ``_serve_run`` keeps
    them): the CPU forward that the steps are held against drops nothing
    and takes the card's decode steps' experts, the one that gives the
    perplexity the card perplexity forward's (:class:`Routes`)."""
    import torch
    from repro_torch.models.common import cross_entropy
    from repro_torch.models.transformer import AUX_COEF
    routes = routes or {}
    moe = cpu_model.cfg.family == "moe"
    with torch.no_grad():
        with Routes(force=routes.get("steps_as_forward"),
                    no_drops=moe) as held:
            cpu, aux = cpu_model.forward({"tokens": out[:, :-1]})
        held.hold(f"{what}: the CPU forward held against the card's steps")
        ppl_logits = cpu
        if moe:
            with Routes(force=routes["perplexity"]) as held:
                ppl_logits, aux = cpu_model.forward({"tokens": out[:, :-1]})
            held.hold(f"{what}: the CPU perplexity forward")
    err = float((card - cpu).abs().max())
    scale = float(cpu.abs().max())
    check(err <= SERVE_TOL * max(1.0, scale),
          f"{what}: card vs CPU teacher-forced logits differ by {err:.3e}")
    return {"logits_max_abs_err": err, "logits_max_abs": scale,
            "cpu_ppl": float(torch.exp(cross_entropy(ppl_logits, out[:, 1:])
                                       + AUX_COEF * aux)),
            "cpu_logits": cpu}


def _serve_run(gen, model, cpu_model, prompts, new_tokens, temperature,
               seed, what: str) -> dict:
    """One generate() + perplexity on the card, launches counted; then the
    card's teacher-forced forward against the logits of the decode steps
    that made the tokens (:class:`_StepLogits`), and the CPU comparison
    (none when ``cpu_model`` is None).  MoE: the forward held against the
    steps drops nothing and takes the steps' experts, so the steps are
    replayed with no drops either (a step of b tokens drops an assignment
    only where more than C of them pick one expert: grok at batch 4, C =
    2; deepseek's C = 6 never drops at 4) (:class:`Routes`)."""
    import torch
    from repro_torch.serving import perplexity
    moe = model.cfg.family == "moe"
    gen.decode_steps = 0
    b, s = prompts.shape
    recorded = None if moe else _StepLogits(gen, b, s + new_tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_path_launches()
    t0 = time.perf_counter()
    try:
        out = gen.generate(prompts, max_new_tokens=new_tokens,
                           temperature=temperature, seed=seed)
    finally:
        if recorded is not None:
            recorded.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with Routes() as ppl_routes:
        ppl = perplexity(model, out)
    launches = _path_launches()
    peak = torch.cuda.max_memory_allocated()
    check(gen.decode_steps == s + new_tokens,
          f"{what}: {gen.decode_steps} decode steps, want {s + new_tokens}")
    want = _want_launches(model.cfg, gen.decode_steps, 1)
    check(launches == want, f"{what}: launches {launches}, want {want} "
                            f"({gen.decode_steps} decode steps, one forward)")
    check(out.shape == (b, s + new_tokens)
          and bool(((out >= 0) & (out < model.cfg.vocab_size)).all()),
          f"{what}: tokens out of range or of shape {out.shape}")
    check(ppl == ppl and ppl > 1.0, f"{what}: perplexity {ppl!r}")
    out_t = torch.from_numpy(out).long()
    with Routes(no_drops=moe) as step_routes:
        card = (_card_step_logits(model, out_t, gen.max_seq) if moe
                else recorded.logits(s + new_tokens - 1))
    routes = {"perplexity": ppl_routes.records,
              "steps_as_forward": steps_as_forward(
                  step_routes.records, moe_layers(model.cfg), *out_t.shape)}
    with torch.no_grad(), Routes(force=routes["steps_as_forward"],
                                 no_drops=moe) as held:
        card_fwd = model.forward({"tokens": out_t[:, :-1].cuda()})[0].cpu()
    held.hold(f"{what}: the card's forward held against its steps")
    fwd_err = float((card_fwd - card).abs().max())
    check(fwd_err <= SERVE_TOL * max(1.0, float(card.abs().max())),
          f"{what}: the card's forward vs its decode steps differ by "
          f"{fwd_err:.3e}")
    del card_fwd
    row = {"batch": b, "prompt": s, "new_tokens": new_tokens,
           "temperature": temperature, "wall_s": wall,
           "tok_per_s": b * new_tokens / wall,
           "ms_per_decode_step": wall / gen.decode_steps * 1e3,
           "peak_mem_bytes": peak, "ppl": ppl,
           "forward_vs_decode_max_abs_err": fwd_err,
           "forward_vs_decode_routes": held.reading(),
           "launches": launches}
    if cpu_model is None:
        print(f"  {what}: {b}x{new_tokens} tokens in {wall:.3f} s "
              f"({row['tok_per_s']:.1f} tok/s, "
              f"{row['ms_per_decode_step']:.3f} ms/decode step, peak "
              f"{peak / 2**30:.3f} GiB) ppl={ppl:.4f}, forward vs decode "
              f"{fwd_err:.3e} launches={launches}")
        return row
    cmp = _vs_cpu(cpu_model, out_t, card, what, routes if moe else None)
    cpu = cmp.pop("cpu_logits")
    rel = abs(ppl - cmp["cpu_ppl"]) / cmp["cpu_ppl"]
    check(rel <= SERVE_TOL, f"{what}: ppl {ppl!r} on the card vs "
                            f"{cmp['cpu_ppl']!r} on the CPU")
    row.update(ppl_rel_vs_cpu=rel, **cmp)
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


def _full_width(name: str, cpu: bool = True, layers: int | None = None):
    """The full-width arch in fp32 (as the launcher forces; ``layers``: its
    first that many), its model on the card from seed 0, and (``cpu``) the
    same parameters on the CPU."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import Model, build_model
    from repro_torch.models.common import tree_map
    arch = get_arch(name)
    arch = arch.replace(model=arch.model.replace(
        dtype="float32", num_layers=layers or arch.model.num_layers))
    cfg = arch.model
    t0 = time.perf_counter()
    model = build_model(arch, device="cuda", seed=0)
    cpu_model = (Model(cfg, tree_map(lambda t: t.detach().cpu(),
                                     model.params)) if cpu else None)
    torch.cuda.synchronize()
    widths = (f"{cfg.num_heads}/{cfg.kv_heads} heads x {cfg.hdim}"
              if cfg.num_heads else "")
    if cfg.use_mla:
        widths = (f"MLA {cfg.num_heads} heads, latent {cfg.kv_lora_rank}, "
                  f"dk {cfg.qk_nope_head_dim} + {cfg.qk_rope_head_dim}, dv "
                  f"{cfg.v_head_dim}")
    if cfg.family == "moe":
        widths += (f"; {cfg.num_experts} experts x {cfg.moe_d_ff} top "
                   f"{cfg.experts_per_token}"
                   + (f" + {cfg.num_shared_experts} shared"
                      if cfg.num_shared_experts else "")
                   + (f", {cfg.first_k_dense} dense first layer of "
                      f"{cfg.dense_d_ff}" if cfg.first_k_dense else ""))
    elif cfg.family == "vlm":
        widths += (f"; every {cfg.cross_attn_every}th layer cross attention "
                   f"on {cfg.num_image_tokens} image tokens")
    elif cfg.family == "encoder":
        widths += ", bidirectional, frames in"
    elif cfg.family != "dense":
        widths = (f"{cfg.ssm_heads} SSD heads x {cfg.ssm_head_dim}, state "
                  f"{cfg.ssm_state}" + (f"; every {cfg.attn_every} layers "
                                        f"a shared block of {widths}"
                                        if widths else ""))
    print(f"  {name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{widths}, vocab {cfg.vocab_size}, {model.param_count():,} "
          f"parameters (fp32); built in {time.perf_counter() - t0:.2f} s")
    return arch, model, cpu_model


#: full-width smollm-360m's fp32 logits on the card (``serve_fp32_sha256``):
#: the port before rope's tables were shared (e6a6006) read this on an
#: H100 80GB HBM3 at 700 W; building the tables once a step must not move
#: a bit
SERVE_FP32_SHA256_PARENT = (
    "d15b2c2dce993732bbb46a7d167c56216ad4d68aec458a2e1b76e5411246374a")


def serve_fp32_sha256(model=None) -> str:
    """sha256 of full-width smollm-360m's fp32 logits on the card (seed 0,
    or ``model``): 48 decode steps at batch 4 from a fresh cache, the
    teacher-forced forward and ``Model.prefill``'s last logits over the
    same tokens (from their own seed).  It runs in a checkout of any
    commit since the zoo serves: ``python3 -c 'import chip_smoke as c;
    c.phase_device(False); print(c.serve_fp32_sha256())'``."""
    import numpy as np
    import torch
    if model is None:
        _arch, model, _ = _full_width("smollm-360m", cpu=False)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, model.cfg.vocab_size, (4, 48))).cuda()
    h = hashlib.sha256()
    with torch.no_grad():
        cache = model.init_cache(4, 48)
        for pos in range(48):
            logits, cache = model.decode_step(cache, toks[:, pos], pos)
            h.update(logits.cpu().numpy().tobytes())
        h.update(model.forward({"tokens": toks})[0].cpu().numpy().tobytes())
        h.update(model.prefill({"tokens": toks})[0].cpu().numpy().tobytes())
    digest = h.hexdigest()
    print(f"  smollm-360m fp32 logits sha256: {digest}")
    return digest


#: 3d serves full-width smollm-360m over its first this many of 32
#: layers (the fp32 hash runs all 32): the decode loops are bound by the
#: host's launches, about 4 s a layer over 3d's steps (cut to keep the
#: script within its time with phase 3m added)
SERVE_LAYERS = 20


def phase_serve() -> dict:
    """Full-width smollm-360m served on the card (see the module docstring,
    3d); returns the runs' numbers and the launch totals."""
    import numpy as np
    import torch
    from repro_torch.serving import Generator
    arch, model, cpu_model = _full_width("smollm-360m")
    check(serve_fp32_sha256(model) == SERVE_FP32_SHA256_PARENT,
          "smollm-360m's fp32 logits differ from the bits of the port "
          "before rope's tables were shared (SERVE_FP32_SHA256_PARENT)")
    model, cpu_model = _cut(model, SERVE_LAYERS), _cut(cpu_model,
                                                        SERVE_LAYERS)
    arch = arch.replace(model=model.cfg)
    cfg = arch.model
    print(f"  served over the first {SERVE_LAYERS} of its 32 layers "
          f"({model.param_count():,} parameters)")
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


#: 3e serves mamba2-370m over its first this many of 48 layers: its
#: decode steps and the CPU's teacher-forced checks take time in
#: proportion (cut, with 3d, to keep the script within its time)
MAMBA2_SERVE_LAYERS = 32


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
    model, cpu_model = (_cut(model, MAMBA2_SERVE_LAYERS),
                        _cut(cpu_model, MAMBA2_SERVE_LAYERS))
    arch = arch.replace(model=model.cfg)
    print(f"  mamba2 served over the first {MAMBA2_SERVE_LAYERS} of its 48 "
          f"layers ({model.param_count():,} parameters)")
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


# ------------------------------------------------ 3i. serve the MoE family ---

#: 3i: deepseek-v2-lite-16b's card-vs-CPU hold runs its first
#: MOE_CUT_LAYERS layers (the dense layer and two MoE layers, the real
#: embed and unembed: 1.67 B parameters) on both
MOE_CUT_LAYERS = 3
#: grok-1-314b at full width over its first GROK_LAYERS of 64 layers (the
#: whole model is 1,266 GB in fp32 and fits no card; these 11.45 B
#: parameters are 45.8 GB)
GROK_LAYERS = 2
#: deepseek's teacher-forced forward (the perplexity's) and grok's prefill
#: against its decode loop: (b, positions)
MOE_FORWARD = (2, 512)


def _cut(model, layers: int):
    """A dense or moe model's first ``layers`` layers with its embed, final
    norm and unembed, as a Model of that depth over views of its
    parameters."""
    from repro_torch.models import Model
    from repro_torch.models.common import tree_map
    cfg = model.cfg
    params = dict(model.params)
    params["blocks"] = tree_map(lambda a: a[:layers - cfg.first_k_dense],
                                params["blocks"])
    return Model(cfg.replace(num_layers=layers), params)


def _route_control(card_model, cpu_model, toks) -> dict:
    """The routing hold's control: the card's experts for a forward, with
    every token's K-th expert of the first MoE layer moved half the experts
    on, forced on the CPU: the hold must read it as a wrong route."""
    import torch
    with torch.no_grad(), Routes() as card:
        card_model.forward({"tokens": toks.cuda()})
    wrong = [r.cpu() for r in card.records]
    e = card_model.cfg.num_experts
    wrong[0][:, -1] = (wrong[0][:, -1] + e // 2) % e
    with torch.no_grad(), Routes(force=wrong) as planted_run:
        cpu_model.forward({"tokens": toks})
    out = planted_run.reading()
    check(out["least_slack"] < -ROUTE_GATE_TOL,
          f"routing control: a planted wrong route reads {out}, within "
          f"ROUTE_GATE_TOL: the hold does not catch it")
    return out


def phase_serve_moe() -> dict:
    """The MoE family served on the card (see the module docstring, 3i);
    returns the runs' numbers, the launch totals and the phase's
    seconds."""
    import numpy as np
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.models import Model, build_model
    from repro_torch.models.common import tree_map
    from repro_torch.serving import Generator, perplexity
    t_phase = time.perf_counter()
    rows = {}
    totals = {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}

    def count(launches):
        for k, v in launches.items():
            totals[k] += v

    rng = np.random.default_rng(3)
    torch.cuda.empty_cache()
    arch, model, _ = _full_width("deepseek-v2-lite-16b", cpu=False)
    cfg = arch.model
    vocab = cfg.vocab_size
    gen = Generator(arch, model, max_seq=16 + 32 + 1, device="cuda")
    for r in range(2):                   # (a) the launcher's defaults
        prompts = rng.integers(0, vocab, (4, 16)).astype(np.int32)
        rows[f"deepseek a{r}"] = _serve_run(gen, model, None, prompts, 32,
                                            0.8, r, f"deepseek (a) request {r}")
        count(rows[f"deepseek a{r}"]["launches"])
    # the first MOE_CUT_LAYERS layers, card vs CPU: a greedy request, then
    # the model's own forward (capacity drops and all) at (b)'s tokens
    cut = _cut(model, MOE_CUT_LAYERS)
    cpu_cut = Model(cut.cfg, tree_map(lambda t: t.detach().cpu(),
                                      cut.params))
    gen_cut = Generator(arch.replace(model=cut.cfg), cut,
                        max_seq=16 + 32 + 1, device="cuda")
    prompts = rng.integers(0, vocab, (4, 16)).astype(np.int32)
    rows["deepseek cut"] = _serve_run(
        gen_cut, cut, cpu_cut, prompts, 32, 0.0, 0,
        f"deepseek first {MOE_CUT_LAYERS} layers, card vs CPU, greedy")
    count(rows["deepseek cut"]["launches"])
    # the CPU's own gap between its forward (nothing dropped, its steps'
    # experts) and its decode steps, which SERVE_TOL's forward-vs-decode
    # hold must exceed
    toks = torch.from_numpy(rng.integers(0, vocab, (4, 16 + 32)))
    with Routes(no_drops=True) as cpu_steps:
        steps = _card_step_logits(cpu_cut, toks, 16 + 32 + 1)
    with torch.no_grad(), Routes(force=steps_as_forward(
            cpu_steps.records, moe_layers(cut.cfg), *toks.shape),
            no_drops=True) as held:
        fwd = cpu_cut.forward({"tokens": toks[:, :-1]})[0]
    held.hold("deepseek: the CPU forward held against its steps")
    gap, scale = float((fwd - steps).abs().max()), float(steps.abs().max())
    check(gap <= SERVE_TOL * max(1.0, scale),
          f"deepseek first {MOE_CUT_LAYERS} layers on the CPU: forward vs "
          f"decode steps {gap:.3e}, over SERVE_TOL")
    rows["deepseek cut"]["cpu_forward_vs_decode_max_abs_err"] = gap
    print(f"  deepseek first {MOE_CUT_LAYERS} layers on the CPU: forward vs "
          f"its decode steps {gap:.3e} (largest |logit| {scale:.3f})")
    del steps, fwd

    # (b) the teacher-forced forward at b 2 over 512 positions
    b, s = MOE_FORWARD
    toks = torch.from_numpy(rng.integers(0, vocab, (b, s + 1)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_path_launches()
    t0 = time.perf_counter()
    ppl = perplexity(model, toks)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    launches = _path_launches()
    check(launches == _want_launches(cfg, 0, 1),
          f"deepseek (b): launches {launches}, want {cfg.num_layers} flash")
    check(ppl == ppl and ppl > 1.0, f"deepseek (b): perplexity {ppl!r}")
    count(launches)
    _reset_path_launches()
    with torch.no_grad(), Routes() as card_routes:
        card = cut.forward({"tokens": toks[:, :-1].cuda()})[0].cpu()
    count(_path_launches())
    with torch.no_grad(), Routes(force=card_routes.records) as held:
        cpu = cpu_cut.forward({"tokens": toks[:, :-1]})[0]
    held.hold(f"deepseek (b) first {MOE_CUT_LAYERS} layers: the CPU forward")
    err, scale = float((card - cpu).abs().max()), float(cpu.abs().max())
    check(err <= SERVE_TOL * max(1.0, scale),
          f"deepseek (b) first {MOE_CUT_LAYERS} layers: card vs CPU logits "
          f"differ by {err:.3e}")
    rows["deepseek b"] = {
        "batch": b, "positions": s, "seconds": t_fwd, "ppl": ppl,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "cut_logits_max_abs_err": err,
        "cut_logits_max_abs": scale, "cut_routes": held.reading(),
        "route_control": _route_control(cut, cpu_cut, toks[:1, :33])}
    print(f"  deepseek (b) forward b{b} s{s}: {t_fwd:.3f} s, ppl={ppl:.4f}, "
          f"launches={launches}; first {MOE_CUT_LAYERS} layers card vs CPU "
          f"{err:.3e} (largest |logit| {scale:.3f}), routes "
          f"{held.reading()}, control {rows['deepseek b']['route_control']}")
    del card, cpu, cut, cpu_cut, gen_cut
    # (c) 16 decode steps profiled
    prof = _profile_decode(model, torch.from_numpy(
        rng.integers(0, vocab, (8, 16))).cuda())
    print("  deepseek decode-step profile: " + json.dumps(prof))
    del gen, model
    torch.cuda.empty_cache()

    # grok-1-314b over its first GROK_LAYERS layers
    arch, model, _ = _full_width("grok-1-314b", cpu=False, layers=GROK_LAYERS)
    cfg = arch.model
    print(f"  grok-1-314b: layers 0-{GROK_LAYERS - 1} of 64 ran (the first "
          f"{GROK_LAYERS}), full width")
    vocab = cfg.vocab_size
    gen = Generator(arch, model, max_seq=16 + 32 + 1, device="cuda")
    for r in range(2):                   # (a) the launcher's defaults
        prompts = rng.integers(0, vocab, (4, 16)).astype(np.int32)
        rows[f"grok a{r}"] = _serve_run(gen, model, None, prompts, 32, 0.8,
                                        r, f"grok (a) request {r}")
        count(rows[f"grok a{r}"]["launches"])
    # (b) Model.prefill against the token-by-token decode loop; the prefill
    # drops nothing and takes the loop's experts (Routes)
    b, s = MOE_FORWARD
    toks = torch.from_numpy(rng.integers(0, vocab, (b, s))).cuda()
    torch.cuda.synchronize()
    _reset_path_launches()
    with torch.no_grad():
        t0 = time.perf_counter()
        cache = model.init_cache(b, s)
        with Routes(no_drops=True) as loop_routes:
            for pos in range(s):
                dl, cache = model.decode_step(cache, toks[:, pos], pos)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        force = steps_as_forward(loop_routes.records, moe_layers(cfg), b,
                                 s + 1)
        t0 = time.perf_counter()
        with Routes(force=force, no_drops=True) as held:
            pl, pc = model.prefill({"tokens": toks}, max_seq=s)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
    held.hold("grok (b): the prefill held against the decode loop")
    launches = _path_launches()
    check(launches == _want_launches(cfg, s, 1),
          f"grok (b): launches {launches}, want {cfg.num_layers} flash and "
          f"{cfg.num_layers} x {s} decode")
    count(launches)
    errs = {"last_logits": float((pl - dl).abs().max()),
            "cache_k": float((pc["k"] - cache["k"]).abs().max()),
            "cache_v": float((pc["v"] - cache["v"]).abs().max())}
    scale = float(dl.abs().max())
    for what, e in errs.items():
        check(e <= SERVE_TOL * max(1.0, scale),
              f"grok (b): prefill {what} vs the decode loop differ by {e:.3e}")
    rows["grok b"] = {"batch": b, "prompt": s, "prefill_s": t_prefill,
                      "decode_loop_s": t_decode,
                      "ms_per_decode_step": t_decode / s * 1e3,
                      "max_abs_err": errs, "logits_max_abs": scale,
                      "routes": held.reading(), "launches": launches}
    print(f"  grok (b) prefill b{b} s{s}: {t_prefill:.3f} s; decode loop "
          f"{t_decode:.3f} s ({t_decode / s * 1e3:.3f} ms/step); prefill vs "
          f"decode loop: " + ", ".join(f"{k} {v:.3e}" for k, v in
                                       errs.items())
          + f"; routes {held.reading()}; launches={launches}")
    del pc, cache, pl, dl, gen, model
    torch.cuda.empty_cache()
    # card vs CPU at grok's reduced config (the same seeded parameters)
    red = get_reduced("grok-1-314b")
    red = red.replace(model=red.model.replace(dtype="float32"))
    cpu_red = build_model(red, device="cpu", seed=0)
    card_red = Model(red.model, tree_map(lambda t: t.cuda(), cpu_red.params))
    gen = Generator(red, card_red, max_seq=16 + 32 + 1, device="cuda")
    # greedy at batch 2, where a step's capacity (2) drops nothing, so the
    # generated tokens are the replayed steps' argmax
    for r, (batch, temperature) in enumerate(((2, 0.0), (4, 0.8))):
        prompts = rng.integers(0, red.model.vocab_size, (batch, 16)).astype(
            np.int32)
        rows[f"grok reduced {r}"] = _serve_run(
            gen, card_red, cpu_red, prompts, 32, temperature, r,
            f"grok reduced, card vs CPU, temperature {temperature}")
        count(rows[f"grok reduced {r}"]["launches"])
    seconds = time.perf_counter() - t_phase
    print(f"  3i: {seconds:.1f} s")
    return {"runs": rows, "launches": totals, "deepseek_decode_profile": prof,
            "seconds": seconds}


# ------------------------------------------------- 3g. train smollm-360m ---

def _train_launches() -> dict:
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.quant8 import kernel as qk
    from repro_torch.kernels.ssd_scan import kernel as sk
    return {**fk.launches, **sk.launches,
            "quantize8_ef": qk.launches["quantize8_ef"]}


def _reset_train_launches() -> None:
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.quant8 import kernel as qk
    from repro_torch.kernels.ssd_scan import kernel as sk
    fk.reset_launches()
    qk.reset_launches()
    sk.reset_launches()


def _want_train_launches(cfg, grads: int, evals: int, syncs: int = 0) -> dict:
    """Exact training launches of ``grads`` gradients and ``evals``
    evaluations: the forward kernels per attention (shared-block use) or
    Mamba2 layer per forward, their backward kernels per gradient, and
    quantize8_ef per int8 merge of a worker's update."""
    layers = cfg.num_layers
    attn = _attention_layers(cfg)
    mamba = layers if cfg.family in ("ssm", "hybrid") else 0
    return {"flash_attention": attn * (grads + evals),
            "flash_attention_bwd": attn * grads,
            "ssd_scan": mamba * (grads + evals), "ssd_scan_bwd": mamba * grads,
            "quantize8_ef": syncs}


def _add(totals: dict, more: dict) -> None:
    for k, v in more.items():
        totals[k] = totals.get(k, 0) + v


def _with_dtype(wl, dtype: str):
    """``wl`` with its config's dtype replaced (the parameter layout does
    not depend on the dtype)."""
    from repro_torch.models.common import DTYPES
    wl.cfg = wl.cfg.replace(dtype=dtype)
    wl.arch = wl.arch.replace(model=wl.cfg)
    wl.dtype = DTYPES[dtype]
    return wl


def _arch_full(name: str, dtype: str):
    """Full-width ``name`` as an ``ArchWorkload`` in ``dtype``."""
    from repro_torch.core.workloads import ArchWorkload
    return _with_dtype(ArchWorkload(name, reduced=False), dtype)


def _full_batch(wl) -> dict:
    """FULL_BATCH's TokenStream batch on the CPU."""
    import torch
    from repro_torch.data.tokens import TokenStream
    b = TokenStream(wl.cfg.vocab_size, seed=0).batch(FULL_BATCH["b"],
                                                     FULL_BATCH["s"])
    return {"x": torch.from_numpy(b["tokens"]),
            "y": torch.from_numpy(b["labels"])}


def _card_grad(name: str, dtype: str, params32) -> dict:
    """One FULL_BATCH batch through the full-width model's loss and
    gradient on the card from ``params32`` (the seeded fp32 init, cast to
    ``dtype`` as the init casts each leaf), launches exact, and a second
    call compared leaf by leaf (its launches are not the path's), with
    every SSD backward of it read in situ (:class:`_ssd_in_situ`).  The
    gradient comes back on the CPU."""
    import torch
    wl = _arch_full(name, dtype)
    card_batch = {k: v.cuda() for k, v in _full_batch(wl).items()}
    params = params32.to(wl.dtype).cuda()
    _reset_train_launches()
    t0 = time.time()
    loss_c, g_c = wl.grad(params, card_batch)
    torch.cuda.synchronize()
    card_s = time.time() - t0
    launches = _train_launches()
    want = _want_train_launches(wl.cfg, grads=1, evals=0)
    check(launches == want, f"full {name} {dtype}: launches {launches}, "
                            f"want {want}")
    with _ssd_in_situ() as situ:          # the second call, held in situ
        loss_r, g_r = wl.grad(params, card_batch)
    repeat = {"loss_bitwise": _bits_equal(loss_c, loss_r),
              "grad_bitwise": _bits_equal(g_c, g_r),
              "max_abs_diff": float((g_c.float() - g_r.float()).abs().max())}
    repeat["leaves_differ"] = [
        "/".join(path) for (path, _), a, b2 in zip(
            wl.layout, *(wl._views(g)[1] for g in (g_c, g_r)))
        if not _bits_equal(a, b2)]
    out = {"name": name, "dtype": dtype, "loss": float(loss_c),
           "grad": g_c.float().cpu(), "card_s": card_s,
           "launches": launches, "card_repeat": repeat,
           "in_situ": situ.worst(), "in_situ_calls": len(situ.rows)}
    del params, g_c, g_r, card_batch
    torch.cuda.empty_cache()
    return out


def _plain_ssd(x, dt, a_log, B, C, chunk, init_state=None):
    """The chunked plain SSD on any device, under autograd: the CPU's
    algorithm, run on the card (3h's witnesses)."""
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked
    return ssd_scan_chunked(x, dt, a_log, B, C, chunk, init_state)


class _ssd_as:
    """The model's SSD scan replaced by ``fn`` inside the block."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        from repro_torch.models import ssm
        self.kept, ssm.ssd_scan = ssm.ssd_scan, self.fn

    def __exit__(self, *exc):
        from repro_torch.models import ssm
        ssm.ssd_scan = self.kept


SSD_IN_SITU_NAMES = ("dx", "ddt", "dA", "dB", "dC")


class _ssd_in_situ:
    """Inside the block every backward of ``SSDScan`` (the kernel's, or a
    planted one installed before the block) is held on its own inputs and
    cotangents against autograd of the chunked plain version: ``rows``
    gets, per call, each gradient's norm-wise gap and its largest gap
    relative to the largest plain |g|.  One chunk only (the training
    path's s 64): the saved tensors hold the initial state there."""

    def __init__(self):
        self.rows = []

    def __enter__(self):
        from repro_torch.kernels.ssd_scan import ops as so
        self.kept = kept = so.SSDScan.backward
        rows = self.rows

        def backward(ctx, dy, dstate):
            got = kept(ctx, dy, dstate)
            rows.append(_in_situ_row(*ctx.saved_tensors, dy, dstate, got))
            return got
        so.SSDScan.backward = staticmethod(backward)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.ssd_scan import ops as so
        so.SSDScan.backward = staticmethod(self.kept)

    def worst(self) -> dict:
        """Per gradient, the largest norm-wise and max gap over the calls."""
        return {k: {"norm_rel": max(r["norm_rel"][k] for r in self.rows),
                    "max_rel": max(r["max_rel"][k] for r in self.rows)}
                for k in SSD_IN_SITU_NAMES} if self.rows else {}


def _in_situ_row(x, dt, A, B, C, init, dy, dstate, got) -> dict:
    """:class:`_ssd_in_situ`'s reading of one call."""
    import torch
    from repro_torch.kernels.ssd_scan.kernel import n_chunks
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked
    check(n_chunks(x.shape[1]) == 1, "in-situ SSD check: several chunks")
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, dt, torch.log(-A), B, C)]
        y, state = ssd_scan_chunked(*leaves, SSD_MODEL_CHUNK, init)
        outs = [y] + ([] if dstate is None else [state])
        cots = [torch.zeros_like(y) if dy is None else dy] + (
            [] if dstate is None else [dstate])
        dx, ddt, da_log, dB, dC = torch.autograd.grad(outs, leaves, cots)
    plain = (dx, ddt, da_log / A, dB, dC)
    row = {"norm_rel": {}, "max_rel": {}}
    for name, g, r in zip(SSD_IN_SITU_NAMES, got[:5], plain):
        g, r = g.double(), r.double()
        big = float(r.abs().max())
        row["norm_rel"][name] = float((g - r).norm() / r.norm()) if big \
            else 0.0
        row["max_rel"][name] = float((g - r).abs().max()) / big if big \
            else 0.0
    return row


def _card_grad_plain(name: str, dtype: str, params32) -> dict:
    """:func:`_card_grad`'s gradient with the chunked plain SSD in place
    of the kernels (the witness of how far two correct implementations
    part on the card)."""
    import torch
    wl = _arch_full(name, dtype)
    with _ssd_as(_plain_ssd):
        loss, g = wl.grad(params32.to(wl.dtype).cuda(),
                          {k: v.cuda() for k, v in _full_batch(wl).items()})
    out = {"loss": float(loss), "grad": g.float().cpu()}
    del g
    torch.cuda.empty_cache()
    return out


def _ssd_float64(x, dt, a_log, B, C, chunk, init_state=None):
    """The SSD scan in float64 end to end, as one chunk of s (exact
    arithmetic needs no chunks), handing fp32 (y, state) back to the
    model: 3h (b)'s witness of the exact fp32-model gradient."""
    import torch
    from repro_torch.kernels.ssd_scan.ref import segsum
    x, dt, B, C = (t.double() for t in (x, dt, B, C))
    da = dt * -torch.exp(a_log.double())                   # (b, s, h)
    xdt = x * dt[..., None]
    cum = torch.cumsum(da, 1)
    L = torch.exp(segsum(da.transpose(1, 2)))              # (b, h, l, m)
    y = torch.einsum("bln,bmn,bhlm,bmhp->blhp", C, B, L, xdt)
    state = torch.einsum("bsh,bsn,bshp->bhpn", torch.exp(cum[:, -1:] - cum),
                         B, xdt)
    if init_state is not None:
        init = init_state.double()
        y = y + torch.einsum("bln,bhpn,blh->blhp", C, init, torch.exp(cum))
        state = state + init * torch.exp(cum[:, -1])[..., None, None]
    return y.float(), state.float()


def _cpu_grad(name: str, dtype: str, params32, ssd_float64=False) -> dict:
    """The same batch and parameters as :func:`_card_grad` through the
    CPU; with ``ssd_float64`` the model's SSD scan in float64
    (:func:`_ssd_float64`)."""
    from repro_torch.models import ssm
    wl = _arch_full(name, dtype)
    with _ssd_as(_ssd_float64 if ssd_float64 else ssm.ssd_scan):
        t0 = time.time()
        loss_h, g_h = wl.grad(params32.to(wl.dtype), _full_batch(wl))
    return {"loss": float(loss_h), "grad": g_h, "cpu_s": time.time() - t0}


def _leaf_gaps(wl, a, ref, norm: bool = False,
               device: str = "cuda") -> tuple:
    """max |a - ref| over each leaf of two flat gradients (CPU tensors,
    compared on ``device``), relative to the leaf's largest |ref| (by layer
    too), or with ``norm`` ||a - ref|| / ||ref|| over the leaf (by layer:
    over the layer's slice) -> (by leaf, by layer of each stacked leaf)."""
    import torch
    leaves, layers = {}, {}
    for (path, _), c, h in zip(wl.layout, wl._views(a)[1],
                               wl._views(ref)[1]):
        c, h = c.to(device).float(), h.to(device).float()   # leaf by leaf
        leaf = "/".join(path)
        if norm:
            c, h = c.double(), h.double()
            gap, big = (c - h).norm(), h.norm()
        else:
            gap, big = (c - h).abs().max(), h.abs().max()
        big = float(big)
        leaves[leaf] = float(gap) / big if big else 0.0
        if path[0] == "blocks" and c.dim() > 1:
            d, r = (c - h).reshape(c.shape[0], -1), h.reshape(c.shape[0], -1)
            per, bigs = ((d.norm(dim=1), r.norm(dim=1)) if norm
                         else (d.abs().amax(1), [big] * len(d)))
            layers[leaf] = [float(v) / float(w) if float(w) else 0.0
                            for v, w in zip(per, bigs)]
    if device == "cuda":
        torch.cuda.empty_cache()
    return leaves, layers


def _norm_spread(wl, a, ref, device: str = "cuda") -> dict:
    """||a - ref|| / ||ref|| over each leaf of two flat gradients: the
    smallest and largest over the leaves, and over the stacked leaves'
    last layer."""
    leaves, layers = _leaf_gaps(wl, a, ref, norm=True, device=device)
    last = [v[-1] for v in layers.values()]
    return {"leaf_min": min(leaves.values()), "leaf_max": max(leaves.values()),
            "last_layer_min": min(last), "last_layer_max": max(last)}


def _spread_text(d: dict) -> str:
    return (f"norm-wise {d['leaf_min']:.2e}-{d['leaf_max']:.2e} over the "
            f"leaves ({d['last_layer_min']:.2e}-{d['last_layer_max']:.2e} in "
            f"the last layer)")


def _vs_cpu_grad(card: dict, cpu: dict, nonzero=(),
                 grad_tol: float | None = None,
                 hold_leaves: bool = True, wl=None,
                 device: str = "cuda") -> dict:
    """The card's gradient held against the CPU's: the loss within
    FULL_LOSS_RTOL (fp32) or FULL_BF16_LOSS_RTOL, each leaf within
    ``grad_tol`` (default FULL_FP32_GRAD_TOL or FULL_BF16_GRAD_TOL) of
    that leaf's largest |g| on the CPU (read, not held, without
    ``hold_leaves``: the bf16 gradients of the ssm and hybrid families,
    see FULL_SSM_FP32_GRAD_TOL), the card's leaves named in ``nonzero``
    (the last key of their path) not all zero, and every SSD backward of
    the card's gradient held in situ (:class:`_ssd_in_situ`): fp32 within
    SSD_BWD_TOL of the plain gradient's largest |g|, bf16 within
    SSD_BF16_NORM_TOL norm-wise and SSD_BWD_TOL.  Witnesses, read beside
    it where ``cpu`` holds them: ``"ssd64"``, the CPU's gradient with the
    SSD scan in float64 (which side is nearer the exact one), and
    ``"plain"``, the card's gradient through the chunked plain SSD (how
    far two correct implementations part).  Every reading is printed
    before any check.  ``wl``: the gradients' workload (default the
    full-width arch); ``device``: where the leaves are compared."""
    import torch
    name, dtype = card["name"], card["dtype"]
    wl = wl or _arch_full(name, dtype)
    loss_c, loss_h = card["loss"], cpu["loss"]
    loss_tol = FULL_LOSS_RTOL if dtype == "float32" else FULL_BF16_LOSS_RTOL
    if grad_tol is None:
        grad_tol = FULL_FP32_GRAD_TOL if dtype == "float32" else \
            FULL_BF16_GRAD_TOL
    rel_loss = abs(loss_c - loss_h) / abs(loss_h)
    leaves, layers = _leaf_gaps(wl, card["grad"], cpu["grad"], device=device)
    spread = _norm_spread(wl, card["grad"], cpu["grad"], device)
    worst = max(leaves, key=leaves.get)
    over = sorted(k for k, v in leaves.items() if v > grad_tol)
    out = {"name": name, "dtype": dtype, "n_params": wl.n_params,
           "loss_card": loss_c, "loss_cpu": loss_h, "rel_loss": rel_loss,
           "worst_leaf": worst, "worst_leaf_rel": leaves[worst],
           "by_layer": layers.get(worst), "leaf_rel": leaves,
           "norm_spread": spread,
           "grad_tol": grad_tol if hold_leaves else None,
           "leaves_over_grad_tol": over, "card_s": card["card_s"],
           "cpu_s": cpu["cpu_s"], "launches": card["launches"],
           "card_repeat": card["card_repeat"], "in_situ": card["in_situ"],
           "in_situ_calls": card["in_situ_calls"]}
    shown = ""
    for key, other, ref in (("ssd64", card, cpu.get("ssd64")),
                            ("ssd64_cpu", cpu, cpu.get("ssd64")),
                            ("plain", cpu.get("plain"), cpu),
                            ("card_plain", card, cpu.get("plain"))):
        if ref is None or other is None:
            continue
        gaps, by_layer = _leaf_gaps(wl, other["grad"], ref["grad"])
        w = max(gaps, key=gaps.get)
        out[f"witness_{key}"] = {"worst_leaf": w, "worst_leaf_rel": gaps[w],
                                 "by_layer": by_layer.get(w),
                                 "norm_spread": _norm_spread(
                                     wl, other["grad"], ref["grad"]),
                                 "rel_loss": abs(other["loss"] - ref["loss"])
                                 / abs(ref["loss"])}
        what = {"ssd64": "card vs the CPU with its SSD in float64",
                "ssd64_cpu": "the CPU vs the CPU with its SSD in float64",
                "plain": "the card with the plain SSD vs the CPU",
                "card_plain": "the card vs the card with the plain SSD"}[key]
        shown += (f"; {what}: worst leaf {w} {gaps[w]:.3e}, "
                  + _spread_text(out[f"witness_{key}"]["norm_spread"]))
    print(f"  full width {name} {dtype}: {wl.n_params} parameters, loss card "
          f"{loss_c!r} cpu {loss_h!r} (rel {rel_loss:.3e}); worst leaf "
          f"{worst} {leaves[worst]:.3e} of its largest |g| (by layer "
          + (" ".join(f"{v:.1e}" for v in layers[worst])
             if worst in layers else "-") + f"), {_spread_text(spread)}"
          f"{shown}; SSD backward in situ "
          f"({card['in_situ_calls']} calls) " + json.dumps(card["in_situ"])
          + f"; card {card['card_s']:.2f} s, cpu {cpu['cpu_s']:.2f} s; "
          f"launches {card['launches']}; a second card gradient: "
          + json.dumps(card["card_repeat"]), flush=True)
    check(torch.isfinite(card["grad"]).all() and rel_loss <= loss_tol,
          f"full {name} {dtype}: card loss {loss_c!r} vs cpu {loss_h!r}")
    if hold_leaves:
        check(not over, f"full {name} {dtype}: leaves {over} lie beyond "
                        f"{grad_tol:g} of their largest |g| from the CPU's")
    for grad, r in card["in_situ"].items():
        ok = (r["max_rel"] <= SSD_BWD_TOL["float32"] if dtype == "float32"
              else r["norm_rel"] <= SSD_BF16_NORM_TOL
              and r["max_rel"] <= SSD_BWD_TOL["bfloat16"])
        check(ok, f"full {name} {dtype}: the SSD backward's {grad} in situ "
                  f"{r} from the plain gradient on the same inputs")
    for (path, _), g in zip(wl.layout, wl._views(card["grad"])[1]):
        if path[-1] in nonzero:
            check(float(g.abs().max()) > 0.0, f"full {name} {dtype} "
                                              f"{'/'.join(path)}: zero "
                                              f"gradient on the card")
    return out


def _full_grads(dtype: str, params32, totals: dict) -> dict:
    """3g (b): one TokenStream batch through full-width smollm-360m's loss
    and gradient on the card and on the CPU, from ``params32`` (the seeded
    fp32 init, cast to ``dtype`` as the init casts each leaf)."""
    card = _card_grad("smollm_360m", dtype, params32)
    _add(totals, card["launches"])
    return _vs_cpu_grad(card, _cpu_grad("smollm_360m", dtype, params32),
                        nonzero=("wq", "wk", "wv"))


def _counted(wl) -> dict:
    """Count ``wl``'s gradient and evaluation calls (wraps them)."""
    n = {"grad": 0, "eval": 0}
    grad, eval_loss = wl.grad, wl.eval_loss

    def counted_grad(*a, **k):
        n["grad"] += 1
        return grad(*a, **k)

    def counted_eval(*a, **k):
        n["eval"] += 1
        return eval_loss(*a, **k)

    wl.grad, wl.eval_loss = counted_grad, counted_eval
    return n


def _trial_spec(model: str | None = None):
    """FULL_TRIAL cut by FULL_TRIAL_OVER, training ``model`` if given."""
    from repro_torch.experiments import get_preset
    preset, name = FULL_TRIAL
    spec = next(s for s in get_preset(preset).build(True) if s.name == name)
    spec = spec.with_(**FULL_TRIAL_OVER)
    return spec.with_(model=model) if model else spec


def _trial_run(spec, device: str, dtype: str | None = None) -> dict:
    """One run of ``spec`` on ``device`` (its model in ``dtype`` if given):
    its metered fields (as JSON gives them back), losses, gradient and
    evaluation counts, launches and seconds."""
    import torch
    wl, algo, tr, va = spec.build_workload()
    if dtype:
        _with_dtype(wl, dtype)
    n = _counted(wl)
    _reset_train_launches()
    t0 = time.time()
    res = spec.build_runtime().train(wl, algo, tr, va,
                                     max_epochs=spec.max_epochs,
                                     device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    check(not res.error, f"{spec.name} ({spec.model}) on {device}: "
                         f"{res.error}")
    return {"metered": json.loads(json.dumps(_metered(res))),
            "losses": _history_losses(res), "rounds": res.rounds,
            "counts": n, "launches": _train_launches(),
            "seconds": time.time() - t0, "cfg": wl.cfg}


def _full_trial(totals: dict, model: str | None = None, cpu: dict | None = None,
                control_lr: float | None = None,
                dtype: str | None = None) -> dict:
    """3g (c), 3h (c): FULL_TRIAL at full width in bf16 (training ``model``
    if given) on the card and the CPU (``cpu``: the CPU run, made
    elsewhere): metered fields equal, losses within FULL_TRIAL_RTOL, and
    the launches the spec implies: the forward kernels per layer per
    gradient and per evaluation, the backward kernels per layer per
    gradient (one gradient per worker per round), quantize8_ef per worker
    per sync (local:1 syncs every round).  Then a second card run, compared
    (recorded), or with ``control_lr`` a card run at that multiple of the
    learning rate, which must miss FULL_TRIAL_RTOL.  ``dtype`` replaces
    the model's."""
    import torch
    spec = _trial_spec(model)
    card = _trial_run(spec, "cuda", dtype)
    if cpu is None:
        cpu = _trial_run(spec, "cpu", dtype)
    _add(totals, card["launches"])
    n, w = card["counts"], spec.fleet.workers
    want = _want_train_launches(card["cfg"], grads=n["grad"], evals=n["eval"],
                                syncs=w * card["rounds"])
    check(n["grad"] == w * card["rounds"]
          and n["eval"] == len(card["losses"]),
          f"full trial: {n} for {card['rounds']} rounds of {w} workers")
    check(card["launches"] == want,
          f"full trial launches {card['launches']}, want {want}")
    check(card["metered"] == cpu["metered"],
          "full trial: metered fields differ between the card and the CPU")
    card_l, cpu_l = card["losses"], cpu["losses"]

    def gap(losses):
        return max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_l))
    rel = gap(card_l)
    check(rel <= FULL_TRIAL_RTOL,
          f"full trial: card losses {card_l} vs cpu {cpu_l}")
    out = {"spec": spec.name, "model": spec.model, "dtype": card["cfg"].dtype,
           "over": FULL_TRIAL_OVER,
           "rounds": card["rounds"], "grads": n["grad"], "evals": n["eval"],
           "launches": card["launches"], "losses_card": card_l,
           "losses_cpu": cpu_l, "rel_loss": rel, "card_s": card["seconds"],
           "cpu_s": cpu["seconds"]}
    if control_lr is None:
        # is the card's training repeatable?  A second card run (its
        # launches are not the path's)
        again = _trial_run(spec, "cuda")["losses"]
        out.update(card_repeat_equal=again == card_l, losses_card_again=again)
        seen = ("repeats them" if again == card_l else f"reads {again}")
    else:
        ctrl = spec.with_(algo_args={**spec.algo_args,
                                     "lr": spec.algo_args["lr"] * control_lr})
        out["control_rel_loss"] = ctrl_gap = gap(
            _trial_run(ctrl, "cuda", dtype)["losses"])
        check(ctrl_gap > FULL_TRIAL_RTOL,
              f"full trial control (lr x{control_lr}) within "
              f"{FULL_TRIAL_RTOL:g} of the CPU: the limit would not catch it")
        seen = f"a control at lr x{control_lr} reads {ctrl_gap:.3e}"
    print(f"  full-width trial {spec.name} ({spec.model}, {out['dtype']}) "
          f"{FULL_TRIAL_OVER}: "
          f"{card['rounds']} rounds, {n['grad']} gradients, launches "
          f"{card['launches']}; losses card {card_l} cpu {cpu_l} (rel "
          f"{rel:.3e}); {seen}; card {card['seconds']:.2f} s, cpu "
          f"{cpu['seconds']:.2f} s", flush=True)
    torch.cuda.empty_cache()
    return out


def _serve_grid(device: str) -> str:
    """``serve --grid --no-cache``'s text: the command itself in a
    subprocess on the card, its ``main`` in this process on the CPU."""
    argv = ["serve", "--grid", "--no-cache", "--device", device]
    if device == "cpu":
        import contextlib
        import io
        from repro_torch.__main__ import main as cli
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            check(cli(argv) == 0, "serve --grid on the CPU failed")
        return buf.getvalue()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", *argv], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"serve --grid on {device}: {out.stderr}")
    return out.stdout


def _check_serve_grid(text: str) -> dict:
    """The frontier's invariants (the JAX package's verify recipe): faas
    cheapest on the poisson:0.005 and flash: rows, iaas cheapest and pod
    fastest on poisson:5, every cost nonzero unless no request came."""
    rows = {}
    for line in text.splitlines():
        parts = line.split()
        if not parts or line.startswith("#") or parts[0] == "name":
            continue
        platform, arrival = parts[0].split("/", 1)
        rows.setdefault(arrival, {})[platform] = {
            "req": int(parts[2]), "p99_ms": float(parts[6]),
            "cost": float(parts[7])}
    check(len(rows) == 3 and all(len(r) == 3 for r in rows.values()),
          f"serve --grid: rows {rows}")
    for arrival, by in rows.items():
        cheapest = min(by, key=lambda p: by[p]["cost"])
        if arrival == "poisson:5":
            check(cheapest == "iaas", f"serve {arrival}: cheapest {cheapest}")
            fastest = min(by, key=lambda p: by[p]["p99_ms"])
            check(fastest == "pod", f"serve {arrival}: fastest {fastest}")
        else:
            check(cheapest == "faas", f"serve {arrival}: cheapest {cheapest}")
        for p, r in by.items():
            check(r["cost"] > 0 or r["req"] == 0,
                  f"serve {p}/{arrival}: zero cost for {r['req']} requests")
    return rows


def phase_train(helper: "CpuSide") -> dict:
    """3g: (a) every trial of the two presets that train smollm-360m
    (quick: reduced, bf16) on the card and the CPU, records compared within
    ARCH_CARD_VS_CPU_RTOL, and a control with the learning rate x
    ARCH_CONTROL_LR that must miss it; (b) full-width gradients card vs
    CPU in fp32 and bf16; (c) one full-width bf16 trial with exact launch
    counts (its CPU run made by 3h's helper process, ``helper``); (d) the
    serving simulator's frontier on the card, equal to the
    CPU's text and holding its invariants.  Returns the training launches
    (they join the kernels line) and each part's numbers and seconds.
    From here on 3h's helper shares the card (:meth:`CpuSide.go`): 3g and
    3h time no kernel, and their seconds are those of a shared card."""
    import torch
    from repro_torch.core.workloads import is_arch_workload
    from repro_torch.experiments import PRESETS, run_experiment
    totals: dict = {}
    out = {"seconds": {}}
    helper.go()
    t0 = time.time()
    trials = [spec for preset in PRESETS.values()
              for spec in preset.build(True) if is_arch_workload(spec.model)]
    check(len(trials) == 9, f"3g (a): {len(trials)} zoo-training trials, "
                            f"want 9")
    n, worst = len(trials), 0.0
    for spec in trials:
        _reset_train_launches()
        worst = max(worst, _records_agree(spec, ARCH_CARD_VS_CPU_RTOL))
        _add(totals, _train_launches())
    first = trials[0]
    ctrl = first.with_(algo_args={
        **first.algo_args, "lr": first.algo_args["lr"] * ARCH_CONTROL_LR})
    card_l = [l for _, l in run_experiment(ctrl, device="cuda")
              .result["history"]]
    cpu_l = [l for _, l in run_experiment(first, device="cpu")
             .result["history"]]
    ctrl_gap = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
    print(f"  (a) {n} zoo-training trials: card records equal the CPU's "
          f"(losses within {ARCH_CARD_VS_CPU_RTOL:g}; largest gap "
          f"{worst:.3e}); control lr x{ARCH_CONTROL_LR}: gap {ctrl_gap:.3e}")
    check(ctrl_gap > ARCH_CARD_VS_CPU_RTOL,
          f"3g control (lr x{ARCH_CONTROL_LR}) within "
          f"{ARCH_CARD_VS_CPU_RTOL:g} of the CPU: the tolerance would not "
          f"catch it")
    out["presets"] = {"trials": n, "worst_rel_loss": worst,
                      "control_rel_loss": ctrl_gap}
    out["seconds"]["a"] = time.time() - t0
    t0 = time.time()
    params32 = _arch_full("smollm_360m", "float32").init(
        torch.Generator().manual_seed(0))
    out["full"] = [_full_grads(dtype, params32, totals)
                   for dtype in ("float32", "bfloat16")]
    del params32
    out["seconds"]["b"] = time.time() - t0
    t0 = time.time()
    out["trial"] = _full_trial(totals, cpu=helper.smollm_trial())
    out["seconds"]["c"] = time.time() - t0
    t0 = time.time()
    card_text = _serve_grid("cuda")
    check(card_text == _serve_grid("cpu"),
          "serve --grid prints other rows on the card than on the CPU")
    out["serve_grid"] = _check_serve_grid(card_text)
    print("  (d) serve --grid: faas cheapest on the trickle and flash rows, "
          "iaas cheapest and pod fastest on poisson:5, card == cpu text")
    out["seconds"]["d"] = time.time() - t0
    out["launches"] = totals
    for name in ("flash_attention", "flash_attention_bwd", "quantize8_ef"):
        check(totals.get(name, 0) > 0,
              f"{name} never launched on the training path")
    print("  3g seconds: " + json.dumps(
        {k: round(v, 1) for k, v in out["seconds"].items()}))
    return out


# ------------------------------- 3h. train mamba2-370m and zamba2-2.7b ---

#: 3h: the ssm and hybrid families, trained through 3g's checks at 3g's
#: constants
SSM_TRAIN_MODELS = ("mamba2_370m", "zamba2_2_7b")
#: 3h (c)'s control: the full-width mamba2 trial at this multiple of the
#: learning rate must miss FULL_TRIAL_RTOL
FULL_TRIAL_CONTROL_LR = 1.5
#: the helper process's CPU threads, of the host's (phases 2-3g run
#: beside it)
CPU_SIDE_THREADS = 4
CPU_SIDE_DIR = ROOT / "build" / "cpu_side"
#: 3h (b)'s control: a fault planted in the SSD backward's ddt, which the
#: fp32 check and the in-situ checks (fp32 and bf16) must miss by at
#: least SSD_CONTROL_MARGIN x their limits
SSD_PLANTED_FAULT = 1.01
SSD_CONTROL_MARGIN = 5
#: 3h (b): full-width mamba2-370m and zamba2-2.7b, one batch, fp32, card
#: vs CPU, each leaf relative to its largest |g|.  FULL_FP32_GRAD_TOL
#: (2e-5) lies inside these models' own rounding noise: an H100 read
#: 2.83e-5 (mamba2, blocks/mixer/conv_x, layer 0; 3e-7 at layer 47) and
#: 2.25e-5 (zamba2); the CPU against itself with one intra-op thread read
#: 1.66e-5, the card through the chunked plain SSD against the CPU 2.08e-5,
#: and against the CPU with its SSD in float64 the card read 2.66e-5 and
#: the CPU 1.17e-5 (``grad_witnesses``: the card's extra error is its
#: forward kernel's fp32 cumsum and 3xTF32 sums).  A ddt x1.01
#: fault planted in the SSD backward reads 1.05e-2, 105x this limit.  In
#: bf16 no leaf limit can do both: every leaf, in every layer, of the
#: card's gradient parts from the CPU's by 4.8-11% norm-wise (4-19% in
#: the last layer), and so does the card's through the plain SSD (4.8-12%)
#: and the card's through the kernels from it (3.5-8.5%), while the
#: planted fault moves the card's own gradient by at most 2.8% (1.1% in
#: the last layer; an H100, mamba2 and zamba2): one-ulp flips of bf16
#: GEMMs and sums (``op_witness``: no op computes another function) grow
#: through the layers.  So in bf16 the loss is held at
#: FULL_BF16_LOSS_RTOL, every SSD backward in situ at SSD_BF16_NORM_TOL,
#: every other op by ``op_witness``, and the leaves are read
FULL_SSM_FP32_GRAD_TOL = 1e-4


def _zoo_trials(models):
    """3g (a)'s trials (the two presets that train a zoo model), each
    training each of ``models``."""
    from repro_torch.core.workloads import is_arch_workload
    from repro_torch.experiments import PRESETS
    base = [spec for preset in PRESETS.values()
            for spec in preset.build(True) if is_arch_workload(spec.model)]
    return [spec.with_(model=m) for m in models for spec in base]


def _ssm_trials():
    return _zoo_trials(SSM_TRAIN_MODELS)


def cpu_side(out: Path, side: Path) -> None:
    """3h's CPU sides, in a helper process (``python3 chip_smoke.py
    --cpu-side PATH SIDE``) that runs beside phases 2-3g: first 3g (c)'s CPU
    run (``PATH.3g``), then the CPU run of (c)'s full-width fp32 trial and
    (b)'s full-width CPU gradients (both models, fp32 and bf16; mamba2's
    fp32 also with the SSD in float64), the heavy part, once the third
    helper (SIDE, its output) has left its card slot and freed the vlm's
    host memory (``SIDE.slot``); then, once the main process has reached
    3g (``PATH.go``: phases 2-3f time kernels and serving loops
    and must have the card alone), (b)'s card gradients, each with a
    second call read in situ, held against the CPU's
    (:func:`_vs_cpu_grad`), and mamba2's planted controls
    (:func:`_planted_ddt_control`).  (a)'s CPU records and the op witness
    are the other helper's (:func:`cpu_side_moe`).  Writes PATH as JSON; a
    failed check exits non-zero, as in the main process."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(CPU_SIDE_THREADS)
    seconds = {}
    t0 = time.time()
    smollm = _trial_run(_trial_spec(), "cpu")
    del smollm["cfg"]
    _write_part(out, ".3g", smollm)
    seconds["3g_c"] = time.time() - t0
    t0 = time.time()
    trial = _trial_run(_trial_spec(SSM_TRAIN_MODELS[0]), "cpu", "float32")
    del trial["cfg"]
    seconds["c"] = time.time() - t0
    t0 = time.time()
    while not side.with_suffix(".slot").exists():
        time.sleep(0.5)
    seconds["waited_slot"] = time.time() - t0
    t0 = time.time()
    inits = {name: _arch_full(name, "float32").init(
        torch.Generator().manual_seed(0)) for name in SSM_TRAIN_MODELS}
    full = [(name, dtype) for name in SSM_TRAIN_MODELS
            for dtype in ("float32", "bfloat16")]
    cpus = [_cpu_grad(name, dtype, inits[name]) for name, dtype in full]
    # the witness of FULL_SSM_FP32_GRAD_TOL's first reading (mamba2)
    cpus[0]["ssd64"] = _cpu_grad(*full[0], inits[full[0][0]],
                                 ssd_float64=True)
    seconds["b_cpu"] = time.time() - t0
    t0 = time.time()
    while not out.with_suffix(".go").exists():
        time.sleep(0.5)
    seconds["waited"] = time.time() - t0
    t0 = time.time()
    rows, controls = [], {}
    for (name, dtype), cpu in zip(full, cpus):
        card = _card_grad(name, dtype, inits[name])
        fp32 = dtype == "float32"
        if not fp32:
            cpu["plain"] = _card_grad_plain(name, dtype, inits[name])
        rows.append(_vs_cpu_grad(
            card, cpu, nonzero=("a_log", "in_x", "in_B", "in_C", "in_dt"),
            grad_tol=FULL_SSM_FP32_GRAD_TOL if fp32 else None,
            hold_leaves=fp32))
        if name == SSM_TRAIN_MODELS[0]:
            controls[dtype] = _planted_ddt_control(name, dtype, inits[name],
                                                   cpu, card["grad"])
        cpu.clear()
        card.clear()
    seconds["b_card"] = time.time() - t0
    out.write_text(json.dumps({"full": rows, "controls": controls,
                               "trial": trial, "seconds": seconds}))


def grad_witnesses(name: str = "mamba2_370m",
                   dtypes=("float32", "bfloat16")) -> dict:
    """Where 3h (b)'s card and CPU gradients part, and which side is
    nearer the exact one.  Full-width ``name`` at FULL_BATCH from the
    seeded init, its gradient on the card through the SSD kernels
    ("card"), on the card through the chunked plain SSD under autograd
    ("card_plain"), on the CPU ("cpu"), on the CPU with one intra-op
    thread ("cpu_1thread": other sums), and in fp32 on the CPU with the
    SSD in float64 ("cpu_ssd64").  Prints each pair's worst leaf (max gap
    over the leaf relative to its largest |g| on the second side) and,
    for the pair's worst leaf, the gap layer by layer (layer 0 first).
    ``python3 -c 'import chip_smoke as c; c.phase_device();
    c.grad_witnesses()'``."""
    import torch
    from repro_torch.models import ssm

    def grad(dtype, device, ssd=None, threads=None):
        wl = _arch_full(name, dtype)
        batch = {k: v.to(device) for k, v in _full_batch(wl).items()}
        n = torch.get_num_threads()
        if threads:
            torch.set_num_threads(threads)
        try:
            with _ssd_as(ssd or ssm.ssd_scan):
                loss, g = wl.grad(params32.to(wl.dtype).to(device), batch)
        finally:
            torch.set_num_threads(n)
        return float(loss), g.float().cpu()

    params32 = _arch_full(name, "float32").init(
        torch.Generator().manual_seed(0))
    out = {}
    for dtype in dtypes:
        wl = _arch_full(name, dtype)
        g = {"card": grad(dtype, "cuda"),
             "card_plain": grad(dtype, "cuda", _plain_ssd),
             "cpu": grad(dtype, "cpu"),
             "cpu_1thread": grad(dtype, "cpu", threads=1)}
        if dtype == "float32":
            g["cpu_ssd64"] = grad(dtype, "cpu", _ssd_float64)
        pairs = [("card", "cpu"), ("card_plain", "cpu"),
                 ("card", "card_plain"), ("cpu_1thread", "cpu")]
        if dtype == "float32":
            pairs += [("card", "cpu_ssd64"), ("card_plain", "cpu_ssd64"),
                      ("cpu", "cpu_ssd64")]
        rows = {}
        for a, b in pairs:
            leaves, layers = _leaf_gaps(wl, g[a][1], g[b][1])
            worst = max(leaves, key=leaves.get)
            rows[f"{a} vs {b}"] = {
                "rel_loss": abs(g[a][0] - g[b][0]) / abs(g[b][0]),
                "worst_leaf": worst, "worst_leaf_rel": leaves[worst],
                "by_layer": layers.get(worst)}
            print(f"  {name} {dtype} {a} vs {b}: loss rel "
                  f"{rows[f'{a} vs {b}']['rel_loss']:.3e}, worst leaf "
                  f"{worst} {leaves[worst]:.3e}" + (
                      "; by layer " + " ".join(
                          f"{v:.1e}" for v in layers[worst])
                      if worst in layers else ""), flush=True)
        out[dtype] = rows
    return out


#: the op witness skips ops that make or view tensors, and ops on the flat
#: parameter or gradient vector (over this many elements)
WITNESS_SKIP = ("empty", "empty_like", "new_empty", "zeros", "zeros_like",
                "new_zeros", "ones", "ones_like", "full", "scalar_tensor",
                "view", "_unsafe_view", "reshape", "expand", "permute",
                "transpose", "t", "squeeze", "unsqueeze", "slice", "select",
                "split", "split_with_sizes", "as_strided", "detach", "alias",
                "lift_fresh", "_to_copy", "copy", "clone", "unbind",
                "_local_scalar_dense", "is_same_size")
WITNESS_MAX_NUMEL = 50_000_000
#: sums and products, whose rounding scales with the sum of the terms'
#: magnitudes: their gaps are read relative to the same op on |inputs|
WITNESS_SUMS = ("sum", "mean", "cumsum", "mm", "bmm", "addmm")
#: 3h (b): given the same inputs, every op of the card's bf16 gradient
#: must give the CPU's output within one rounding: a bf16 output differs
#: in at most WITNESS_BF16_SHARE of its elements, by at most one bf16 ulp
#: of its largest |element| (2^-7 of it); an fp32 output within
#: WITNESS_FP32_REL of its largest |element| -- for fp32 sums and
#: products (WITNESS_SUMS), each element within that share of its terms'
#: magnitudes (the same op on |inputs|: a sum that cancels to near zero
#: parts by 0.36 of the largest output in zamba2's attention backward).
#: An H100 read at most 0.78% of a bf16 sum's elements (GEMMs 0.62%,
#: within 5.1e-3 of the largest; every elementwise bf16 op equal bit for
#: bit) and 6.0e-7 of an fp32 output or its terms (libm functions 1-4
#: fp32 ulps).  Controls that must miss: silu as x *
#: sigmoid(x) in bf16 (a second rounding: 28% of its elements), and the
#: fp32 softplus of dt computed in bf16 (about 2^-9 of it)
WITNESS_BF16_SHARE = 0.02
WITNESS_BF16_REL = 2.0 ** -7
WITNESS_FP32_REL = 1e-5
#: the op witness runs each model cut to this depth (the ops of a layer
#: are the same in every layer; zamba2's is one group of 6 Mamba2 layers
#: and its shared attention block)
WITNESS_LAYERS = {"mamba2_370m": 4, "zamba2_2_7b": 6}


def _arch_cut(name: str, dtype: str, layers: int):
    """Full-width ``name`` cut to ``layers`` layers, in ``dtype``."""
    from repro_torch.core import workloads as w
    kept = w._arch_config

    def cut(n, reduced):
        arch = kept(n, reduced)
        return arch.replace(model=arch.model.replace(num_layers=layers))
    w._arch_config = cut
    try:
        wl = w.ArchWorkload(name, reduced=False)
    finally:
        w._arch_config = kept
    return _with_dtype(wl, dtype)


def _witness_reading(out, host, terms=None) -> dict:
    """One op's reading: the share of elements that differ and the
    largest gap relative to the largest |CPU output|, or with ``terms``
    (the op on |inputs|) relative to each element's terms."""
    out, host = out.detach().cpu().double(), host.double()
    diff = out != host
    gap = (out - host).abs()
    if terms is None:
        big = float(host.abs().max()) or 1.0
        max_rel = float(gap.max()) / big
    else:
        terms = terms.double().abs()
        max_rel = float((gap / terms.where(terms > 0, 1.0)).max())
    return {"share": float(diff.double().mean()), "max_rel": max_rel}


def _witness_misses(dtype, r) -> bool:
    import torch
    if dtype == torch.bfloat16:
        return r["share"] > WITNESS_BF16_SHARE or r["max_rel"] > \
            WITNESS_BF16_REL
    return r["max_rel"] > WITNESS_FP32_REL


def op_witness(name: str = "mamba2_370m", dtype: str = "bfloat16",
               device: str = "cuda") -> dict:
    """Where the card's gradient parts from the CPU's, op by op.
    ``name`` at full width cut to WITNESS_LAYERS, FULL_BATCH from the
    seeded init, its loss and gradient on ``device`` with the SSD scan and
    attention as their plain versions (every op an ATen op; the kernels
    are held on their own: phase 2 and :class:`_ssd_in_situ`), each op
    also run on the CPU on copies of its inputs: the share of elements
    that differ and the largest gap relative to the largest |CPU output|,
    per op and output dtype, held within WITNESS_BF16_SHARE /
    WITNESS_BF16_REL (bf16) and WITNESS_FP32_REL (fp32); the first op (in
    call order) whose output differs.  Two planted ops on the same inputs
    must miss those limits: bf16 silu with a second rounding, and the
    fp32 softplus of dt computed in bf16.  ``python3 -c 'import chip_smoke as c;
    c.phase_device(); c.op_witness()'``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves, tree_map
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    from repro_torch.models import attention

    def cpu(t):
        if isinstance(t, torch.Tensor):
            return t.detach().cpu()
        if isinstance(t, torch.device) and t.type != "cpu":
            return torch.device("cpu")
        return t

    def bf16_softplus(x, *rest):
        return torch.ops.aten.softplus(x.bfloat16(), *rest).float()
    #: op -> a planted variant, run once on the first call's inputs
    planted = {("silu", torch.bfloat16): lambda x: x * torch.sigmoid(x),
               ("softplus", torch.float32): bf16_softplus}
    ops, order, controls = {}, [], {}

    class Witness(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            op = func.overloadpacket.__name__
            tensors = [t for t in tree_leaves((args, kwargs))
                       if isinstance(t, torch.Tensor)]
            skip = (op.rstrip("_") in WITNESS_SKIP or not tensors
                    or any(t.numel() > WITNESS_MAX_NUMEL for t in tensors))
            if not skip:
                host_args, host_kwargs = tree_map(cpu, (args, kwargs))
            out = func(*args, **kwargs)
            if skip:
                return out
            host = func(*host_args, **host_kwargs)
            terms = None
            if op in WITNESS_SUMS:
                abs_args, abs_kwargs = tree_map(
                    lambda t: t.abs() if isinstance(t, torch.Tensor)
                    and t.is_floating_point() else t,
                    (host_args, host_kwargs))
                terms = func(*abs_args, **abs_kwargs)
            outs = out if isinstance(out, (tuple, list)) else [out]
            hosts = host if isinstance(host, (tuple, list)) else [host]
            for o, h in zip(outs, hosts):
                if not (isinstance(o, torch.Tensor) and o.numel()
                        and o.dtype in (torch.bfloat16, torch.float32)):
                    continue
                key = f"{op} {o.dtype}".replace("torch.", "")
                r = _witness_reading(o, h, terms if o.dtype == torch.float32
                                     else None)
                row = ops.setdefault(key, {"calls": 0, "share": 0.0,
                                           "max_rel": 0.0})
                row["calls"] += 1
                row["share"] = max(row["share"], r["share"])
                row["max_rel"] = max(row["max_rel"], r["max_rel"])
                row["misses"] = row.get("misses", False) or \
                    _witness_misses(o.dtype, r)
                if r["share"] and len(order) < 8:
                    order.append(f"{op} {tuple(o.shape)}")
                fault = planted.pop((op, o.dtype), None)
                if fault is not None:
                    controls[key] = c = _witness_reading(
                        fault(*args, **kwargs), h)
                    c["misses"] = _witness_misses(o.dtype, c)
            return out

    wl = _arch_cut(name, dtype, WITNESS_LAYERS[name])
    params = wl.init(torch.Generator().manual_seed(0)).to(device)
    batch = {k: v.to(device) for k, v in _full_batch(wl).items()}
    t0 = time.time()
    kept_attn = attention.flash_attention
    attention.flash_attention = flash_attention_plain
    try:
        with _ssd_as(_plain_ssd), Witness():
            wl.grad(params, batch)
    finally:
        attention.flash_attention = kept_attn
    out = {"name": name, "dtype": dtype, "layers": wl.cfg.num_layers,
           "seconds": time.time() - t0, "first_differing": order,
           "ops": ops, "controls": controls}
    print(f"  op witness {name} ({wl.cfg.num_layers} layers) {dtype} "
          f"({out['seconds']:.1f} s), ops given the same inputs on the card "
          f"and the CPU (share of elements that differ, largest gap / "
          f"largest |output|): " + json.dumps(
              {k: [v["calls"], float(f"{v['share']:.3e}"),
                   float(f"{v['max_rel']:.3e}")] for k, v in ops.items()
               if v["share"]}) + f"; the rest equal bit for bit; first "
          f"that differ {order[:4]}; planted controls "
          + json.dumps(controls), flush=True)
    over = sorted(k for k, v in ops.items() if v["misses"])
    check(not over, f"op witness {name} {dtype}: {over} on the card part from "
                    f"the CPU's on the same inputs by more than a rounding")
    check(len(controls) == 2 and all(c["misses"] for c in controls.values()),
          f"op witness {name}: a planted op stays within the limits: "
          f"{controls}")
    return out


def _planted_ddt_control(name: str, dtype: str, params32, cpu: dict,
                         sound_grad) -> dict:
    """3h (b)'s control: the card's gradient with a planted fault, the SSD
    backward's ddt x SSD_PLANTED_FAULT, against the CPU's by leaf, against
    the card's sound gradient ``sound_grad`` norm-wise (how far the fault
    moves it), and read in situ (:class:`_ssd_in_situ`)."""
    from repro_torch.kernels.ssd_scan import ops as so
    sound = so.SSDScan.backward

    def planted_bwd(ctx, dy, dstate):
        g = list(sound(ctx, dy, dstate))
        g[1] = g[1] * SSD_PLANTED_FAULT
        return tuple(g)
    so.SSDScan.backward = staticmethod(planted_bwd)
    try:
        card = _card_grad(name, dtype, params32)
    finally:
        so.SSDScan.backward = staticmethod(sound)
    wl = _arch_full(name, dtype)
    leaves, _ = _leaf_gaps(wl, card["grad"], cpu["grad"])
    worst = max(leaves, key=leaves.get)
    out = {"fault": f"ddt x{SSD_PLANTED_FAULT}", "dtype": dtype,
           "worst_leaf": worst, "worst_leaf_rel": leaves[worst],
           "vs_sound": _norm_spread(wl, card["grad"], sound_grad),
           "in_situ": card["in_situ"]}
    print(f"  control {name} {dtype}, {out['fault']} planted in the SSD "
          f"backward: worst leaf {worst} {leaves[worst]:.3e} from the CPU's;"
          f" from the card's sound gradient {_spread_text(out['vs_sound'])};"
          f" in situ {json.dumps(card['in_situ'])}", flush=True)
    situ = card["in_situ"]["ddt"]
    if dtype == "float32":
        check(leaves[worst] > SSD_CONTROL_MARGIN * FULL_SSM_FP32_GRAD_TOL,
              f"3h (b) control: {leaves[worst]:.3e} is not "
              f"{SSD_CONTROL_MARGIN}x FULL_SSM_FP32_GRAD_TOL: the limit would "
              f"not catch the fault")
        check(situ["max_rel"] > SSD_CONTROL_MARGIN * SSD_BWD_TOL["float32"],
              f"3h (b) control: ddt in situ {situ} is not "
              f"{SSD_CONTROL_MARGIN}x SSD_BWD_TOL: the check would not "
              f"catch the fault")
    else:
        check(situ["norm_rel"] > SSD_CONTROL_MARGIN * SSD_BF16_NORM_TOL,
              f"3h (b) control: ddt in situ {situ} is not "
              f"{SSD_CONTROL_MARGIN}x SSD_BF16_NORM_TOL: the check would not "
              f"catch the fault")
    return out


def _write_part(out: Path, suffix: str, part) -> None:
    """A helper's part ``part`` as JSON beside its output ``out`` (``out``
    with ``suffix``), whole or not at all."""
    tmp = out.with_suffix(suffix + ".tmp")
    tmp.write_text(json.dumps(part))
    os.replace(tmp, out.with_suffix(suffix))     # readers never see half


class CpuSide:
    """A helper process, started after phase 1 and let onto the card at 3g
    (:meth:`go`): :func:`cpu_side` (``--cpu-side``), its card work beside
    3g and 3h, waited for at 3h (:meth:`result`); or :func:`cpu_side_moe`
    (``--cpu-side-moe``, given the first helper's output, ``after``),
    whose parts 3h reads (:meth:`part`) and which is waited for after 3i;
    or, started before phase 1's build, :func:`cpu_side_vlm`
    (``--cpu-side-vlm``), let onto the card after 3c and waited for after
    3k.  Stopped by :meth:`stop` whatever happens."""

    PARTS = (".go", ".3g", ".3h", ".witness", ".ready", ".slot", ".3m")

    def __init__(self, flag: str = "--cpu-side", name: str = "cpu_side",
                 after: "CpuSide | None" = None):
        CPU_SIDE_DIR.mkdir(parents=True, exist_ok=True)
        self.name = name
        self.out = CPU_SIDE_DIR / f"{name}.{os.getpid()}.json"
        for suffix in (".json", *self.PARTS):
            self.out.with_suffix(suffix).unlink(missing_ok=True)
        self.log = open(self.out.with_suffix(".log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), flag,
             str(self.out), *((str(after.out),) if after else ())],
            cwd=ROOT, stdout=self.log, stderr=subprocess.STDOUT)

    def _failed(self) -> str:
        self.log.flush()
        return self.out.with_suffix(".log").read_text()[-4000:]

    def part(self, suffix: str):
        """The part the helper writes beside its output (``suffix``), once
        it has written it."""
        path = self.out.with_suffix(suffix)
        while not path.exists():
            check(self.proc.poll() is None,
                  f"{self.name} failed:\n" + self._failed())
            time.sleep(0.5)
        return json.loads(path.read_text())

    def smollm_trial(self) -> dict:
        """3g (c)'s CPU run, once the helper has written it."""
        return self.part(".3g")

    def go(self) -> None:
        """The card is the helper's to share from here on."""
        self.out.with_suffix(".go").write_text("")

    def result(self) -> dict:
        t0 = time.time()
        rc = self.proc.wait()
        check(rc == 0, f"{self.name} exited {rc}:\n" + self._failed())
        out = json.loads(self.out.read_text())
        out["waited_s"] = time.time() - t0
        self.log.flush()
        print(self.out.with_suffix(".log").read_text().rstrip())
        return out

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


def phase_train_ssm(helper: CpuSide, moe_helper: CpuSide) -> dict:
    """3h: (a) 3g (a)'s 9 trials with mamba2-370m and with zamba2-2.7b
    (reduced, bf16) on the card against the helper's CPU records within
    ARCH_CARD_VS_CPU_RTOL, and per model a control at learning rate x
    ARCH_CONTROL_LR that must miss it; (b) the helper's full-width
    gradients of both (fp32 and bf16, b 8, s 64; see
    FULL_SSM_FP32_GRAD_TOL and :func:`_vs_cpu_grad`), a second card
    gradient equal bit for bit, launches exact, its SSD backwards held in
    situ, mamba2's planted ddt controls and both models' op witness (the
    helpers hold them); (c) FULL_TRIAL with mamba2-370m at full width in
    fp32 against the helper's CPU run, within FULL_TRIAL_RTOL, a control
    at learning rate x FULL_TRIAL_CONTROL_LR that must miss it, launches
    exact.  Returns the training launches (they join the kernels line)
    and each part's numbers and seconds."""
    from repro_torch.experiments import run_experiment
    totals: dict = {}
    out = {"seconds": {}}
    t0 = time.time()
    trials = _ssm_trials()
    check(len(trials) == 9 * len(SSM_TRAIN_MODELS),
          f"3h (a): {len(trials)} trials")
    cards = []
    for spec in trials:                  # the card beside the helper's
        _reset_train_launches()
        cards.append(run_experiment(spec, device="cuda").result)
        _add(totals, _train_launches())
    firsts = {m: next(s for s in trials if s.model == m)
              for m in SSM_TRAIN_MODELS}
    ctrls = {m: [l for _, l in run_experiment(first.with_(algo_args={
        **first.algo_args, "lr": first.algo_args["lr"] * ARCH_CONTROL_LR}),
        device="cuda").result["history"]] for m, first in firsts.items()}
    t1 = time.time()
    records = moe_helper.part(".3h")["records"]
    cpu = helper.result()
    witness = moe_helper.part(".witness")
    out["seconds"]["helper"] = cpu["seconds"]
    out["seconds"]["waited"] = time.time() - t1
    worst, controls = {}, {}
    for spec, card in zip(trials, cards):
        gap = _records_agree(spec, ARCH_CARD_VS_CPU_RTOL, card,
                             records[f"{spec.model}/{spec.name}"])
        worst[spec.model] = max(worst.get(spec.model, 0.0), gap)
    for model, first in firsts.items():
        cpu_l = [l for _, l in
                 records[f"{model}/{first.name}"]["history"]]
        controls[model] = max(abs(a - b) / abs(b)
                              for a, b in zip(ctrls[model], cpu_l))
        check(controls[model] > ARCH_CARD_VS_CPU_RTOL,
              f"3h control {model} (lr x{ARCH_CONTROL_LR}) within "
              f"{ARCH_CARD_VS_CPU_RTOL:g} of the CPU: the tolerance would "
              f"not catch it")
    print(f"  (a) {len(trials)} trials: card records equal the CPU's "
          f"(losses within {ARCH_CARD_VS_CPU_RTOL:g}; largest gap "
          + json.dumps(worst) + f"); controls lr x{ARCH_CONTROL_LR}: "
          + json.dumps(controls))
    out["presets"] = {"trials": len(trials), "worst_rel_loss": worst,
                      "control_rel_loss": controls}
    out["seconds"]["a"] = time.time() - t0
    out["controls"] = cpu["controls"]
    out["witness"] = witness
    for row in cpu["full"]:
        check(row["card_repeat"]["grad_bitwise"]
              and row["card_repeat"]["loss_bitwise"],
              f"full {row['name']} {row['dtype']}: a second card gradient "
              f"differs: {row['card_repeat']}")
        _add(totals, row["launches"])
    out["full"] = cpu["full"]
    t0 = time.time()
    out["trial"] = _full_trial(totals, SSM_TRAIN_MODELS[0], cpu["trial"],
                               FULL_TRIAL_CONTROL_LR, "float32")
    out["seconds"]["c"] = time.time() - t0
    out["launches"] = totals
    for name in ("ssd_scan", "ssd_scan_bwd", "flash_attention",
                 "flash_attention_bwd", "quantize8_ef"):
        check(totals.get(name, 0) > 0,
              f"{name} never launched on 3h's training path")
    print("  3h seconds: " + json.dumps(
        {k: v if isinstance(v, dict) else round(v, 1)
         for k, v in out["seconds"].items()}))
    return out


# ------------------------------------------------- 3j. train the MoE family ---

#: 3j: the MoE family trained through 3g's checks: deepseek-v2-lite-16b
#: (MLA at dk 192 / dv 128, 64 experts top 6 + 2 shared, a dense first
#: layer) and grok-1-314b (GQA, 8 experts top 2)
MOE_TRAIN_MODELS = ("deepseek_v2_lite_16b", "grok_1_314b")
#: 3j (a)'s trials run the reduced configs in fp32, as their CPU tests do
#: (``tests/test_torch_preset_*_{deepseek,grok}.py``): in bf16 a router's
#: gates differ between two sound runs by the logits' bf16 rounding (2.7e-4
#: read on an H100 beside the CPU), far beyond ROUTE_GATE_TOL, so a forced
#: route could not be told from a wrong one
MOE_TRIAL_DTYPE = "float32"


class _flash_in_situ:
    """Inside the block every call of the models' ``sdpa`` keeps its
    inputs and, once autograd reaches it, its output's gradient;
    :meth:`hold` then runs the flash kernels (forward and backward) on
    each call's own inputs against the plain versions: fp32 within
    FLASH_BWD_TOL of the largest plain gradient (ATTN_TOL for the
    output), bf16 by ``hold_bf16`` (the output with the tie witness, the
    gradients by the gradient rules).  Its launches are not the path's.
    Only the entering thread's calls are kept (a CPU side may run the
    models in another thread meanwhile)."""

    def __enter__(self):
        from repro_torch.models import attention as attn
        self._kept, self.calls = attn.sdpa, []
        thread = threading.get_ident()

        def sdpa(q, k, v, *, causal):
            out = self._kept(q, k, v, causal=causal)
            if threading.get_ident() != thread:
                return out
            call = {"q": q.detach(), "k": k.detach(), "v": v.detach(),
                    "causal": causal}
            self.calls.append(call)
            if out.requires_grad:
                out.register_hook(
                    lambda g, call=call: call.__setitem__("do", g.detach()))
            return out
        attn.sdpa = sdpa
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as attn
        attn.sdpa = self._kept

    def hold(self, what: str) -> dict:
        import torch
        from repro_torch.kernels.flash_attention.kernel import (
            flash_attention_bwd_kernel, flash_attention_kernel)
        from repro_torch.kernels.flash_attention.ops import (
            flash_attention_bwd_plain, flash_attention_plain)
        worst: dict = {}
        for i, call in enumerate(self.calls):
            q, k, v, causal = call["q"], call["k"], call["v"], call["causal"]
            check("do" in call, f"{what}: attention call {i} got no gradient")
            do = call["do"].contiguous()
            o, lse = flash_attention_kernel(q, k, v, causal=causal,
                                            with_lse=True)
            grads = flash_attention_bwd_kernel(q, k, v, do, lse,
                                               causal=causal)
            o_plain = flash_attention_plain(q, k, v, causal=causal)
            plain = flash_attention_bwd_plain(q, k, v, do, causal=causal)
            at = f"{what} attention {i} {tuple(q.shape)} / {v.shape[-1]}"
            if q.dtype == torch.bfloat16:
                hold_bf16(f"{at} forward", [o], [o_plain],
                          worst.setdefault("forward", {}),
                          flash_rows(q, k, v, causal))
                hold_bf16(at, grads, plain, worst.setdefault("backward", {}),
                          grads=True, inputs=(q, k, v, do, causal))
                continue
            err_o = float((o - o_plain).abs().max())
            scale = max(float(p.abs().max()) for p in plain)
            err = max(float((a - p).abs().max())
                      for a, p in zip(grads, plain))
            check(err_o <= ATTN_TOL["flash_attention"]["float32"]
                  and err <= FLASH_BWD_TOL["float32"] * scale,
                  f"{at}: output {err_o:.3e}, gradient {err:.3e} of "
                  f"{scale:.3e} from the plain version")
            worst["max_abs_err_output"] = max(
                worst.get("max_abs_err_output", 0.0), err_o)
            worst["max_rel_err_grad"] = max(
                worst.get("max_rel_err_grad", 0.0), err / scale)
        worst["calls"] = len(self.calls)
        return worst


def _moe_cut_params():
    """deepseek-v2-lite-16b's first MOE_CUT_LAYERS layers at full width as
    ``_arch_cut``'s flat fp32 parameters, drawn on the card from seed 0
    (``build_model``'s init), and the workload."""
    import torch
    from repro_torch.models import build_model
    wl = _arch_cut(MOE_TRAIN_MODELS[0], "float32", MOE_CUT_LAYERS)
    model = build_model(wl.arch, device="cuda", seed=0)
    flat = wl.flatten(model.params)
    del model
    torch.cuda.empty_cache()
    return wl, flat


def _moe_card_grad(dtype: str, params32) -> dict:
    """One FULL_BATCH gradient of the deepseek cut on the card in
    ``dtype``: seconds, peak device memory, launches exact (flash forward
    and backward once per layer), the routes its routers chose, a second
    call compared bit for bit with every flash attention of it held in
    situ (:class:`_flash_in_situ`).  The gradient comes back on the
    CPU."""
    import torch
    wl = _arch_cut(MOE_TRAIN_MODELS[0], dtype, MOE_CUT_LAYERS)
    batch = {k: v.cuda() for k, v in _full_batch(wl).items()}
    params = params32.to(wl.dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_launches()
    t0 = time.time()
    with Routes() as routes:
        loss, g = wl.grad(params, batch)
    torch.cuda.synchronize()
    card_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = _train_launches()
    want = _want_train_launches(wl.cfg, grads=1, evals=0)
    check(launches == want, f"3j (b) {dtype}: launches {launches}, want "
                            f"{want}")
    with _flash_in_situ() as situ:
        loss_r, g_r = wl.grad(params, batch)
    in_situ = situ.hold(f"3j (b) {dtype}")
    repeat = {"loss_bitwise": _bits_equal(loss, loss_r),
              "grad_bitwise": _bits_equal(g, g_r)}
    check(repeat["loss_bitwise"] and repeat["grad_bitwise"],
          f"3j (b) {dtype}: a second card gradient differs")
    out = {"name": MOE_TRAIN_MODELS[0], "dtype": dtype, "loss": float(loss),
           "grad": g.cpu(), "card_s": card_s,
           "peak_gib": peak / 2 ** 30, "launches": launches,
           "card_repeat": repeat, "in_situ": {}, "in_situ_calls": 0,
           "flash_in_situ": in_situ,
           "routes": [r.cpu() for r in routes.records]}
    del params, g, g_r, batch
    torch.cuda.empty_cache()
    return out


def _moe_grad_profile(wl, params, batch) -> dict:
    """torch.profiler over one card gradient: the device time by class
    (GEMM, flash, flash backward, scatter and gather, other), busy and
    idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    wl.grad(params, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wl.grad(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return {"wall_s": wall, "device_busy_s": "not measured"}

    def cls(name):
        low = name.lower()
        for keys, c in ((("dq_kernel", "dkdv_kernel", "gqa_sum"),
                         "flash_backward"),
                        (("flash_attention", "rounded_kernel"), "flash"),
                        (("gemm", "gemv", "cutlass", "xmma"), "gemm"),
                        (("index", "scatter", "gather"),
                         "scatter_and_gather")):
            if any(k in low for k in keys):
                return c
        return "other"
    busy, lo_, hi_ = 0.0, spans[0][0], spans[0][1]
    by_class: dict[str, float] = {}
    for lo, hi, name in spans:
        c = cls(name)
        by_class[c] = by_class.get(c, 0.0) + (hi - lo) / 1e6
        if lo > hi_:
            busy += (hi_ - lo_) / 1e6
            lo_, hi_ = lo, hi
        else:
            hi_ = max(hi_, hi)
    busy += (hi_ - lo_) / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall, "kernels": len(spans),
            "device_s_by_class": dict(sorted(by_class.items(),
                                             key=lambda kv: -kv[1]))}


def _moe_trial(spec, device: str, routes=None) -> dict:
    """:func:`_trial_run` of a quick trial, its routers recorded (or, with
    ``routes``, taking those experts) and its int8 codec calls counted
    (each must launch quantize8_ef once on the card)."""
    from repro_torch.core import sync
    calls = {"int8": 0}
    encode = sync.int8_encode_decode

    def counted(*a, **k):
        calls["int8"] += 1
        return encode(*a, **k)
    sync.int8_encode_decode = counted
    try:
        with Routes(force=routes) as held:
            run = _trial_run(spec, device, MOE_TRIAL_DTYPE)
    finally:
        sync.int8_encode_decode = encode
    run.update(routes=held, int8_calls=calls["int8"])
    return run


def _moe_held_grads(params32, cards: dict, wls: dict, out: dict) -> None:
    """3j (b)'s CPU sides, in a thread beside 3i: each dtype's gradient of
    the cut on the CPU from the same parameters with the card's experts
    forced (:class:`Routes`, whose hook is per thread; in fp32 every forced
    gate held within ROUTE_GATE_TOL, in bf16 every forced logit within
    ROUTE_BF16_ULPS of the logit it displaces, with a planted wrong route
    that must miss it: :func:`_route_control_bf16`), held against the
    card's (:func:`_vs_cpu_grad`, the leaves compared on the CPU).  Fills
    ``out[dtype]`` with the readings, or ``out["error"]``."""
    try:
        for dtype, card in cards.items():
            wl = wls[dtype]
            with Routes(force=card["routes"]) as routes:
                t0 = time.time()
                loss, g = wl.grad(params32.to(wl.dtype), _full_batch(wl))
                cpu = {"loss": float(loss), "grad": g,
                       "cpu_s": time.time() - t0}
            control = None
            if dtype == "float32":
                routes.hold(f"3j (b) {dtype}")
            else:
                routes.hold_bf16(f"3j (b) {dtype}")
                control = _route_control_bf16(wl, params32, card["routes"])
            row = _vs_cpu_grad(card, cpu, nonzero=("wq", "w_kv_down",
                                                   "router", "w_gate"),
                               hold_leaves=dtype == "float32", wl=wl,
                               device="cpu")
            row.pop("leaf_rel")
            row.update(peak_gib=card["peak_gib"], routes=routes.reading(),
                       route_control=control,
                       flash_in_situ=card["flash_in_situ"])
            out[dtype] = row
            del card["grad"], cpu, g
    except BaseException as e:           # noqa: BLE001 -- the caller fails
        out["error"] = repr(e)


def _route_control_bf16(wl, params32, card_routes) -> dict:
    """The bf16 routing hold's control: the cut's forward on the CPU in
    bf16 with the card's experts, every token's K-th expert of the first
    MoE layer moved half the experts on: the hold must read it as a wrong
    route (:meth:`Routes.hold_bf16`)."""
    e = wl.cfg.num_experts
    wrong = [r.clone() for r in card_routes]
    wrong[0][:, -1] = (wrong[0][:, -1] + e // 2) % e
    with Routes(force=wrong) as planted_run:
        wl.eval_loss(params32.to(wl.dtype), _full_batch(wl))
    out = planted_run.reading()
    check(out["least_bf16_ulps"] < -ROUTE_BF16_ULPS,
          f"3j (b) bf16 routing control: a planted wrong route reads {out}, "
          f"within ROUTE_BF16_ULPS: the hold does not catch it")
    return out


def _moe_card_trials() -> dict:
    """3j (a)'s card runs: the 9 quick trials of ``faas_vs_pod`` and
    ``pod_local_sgd`` with each of MOE_TRAIN_MODELS (reduced, in
    MOE_TRIAL_DTYPE), their routers recorded, launches exact (flash forward
    per layer per gradient and evaluation, its backward per layer per
    gradient, quantize8_ef per int8 merge), per model a control at lr x
    ARCH_CONTROL_LR, and the routing hold's control
    (:func:`_route_control`) on the reduced deepseek."""
    import numpy as np
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.models import Model, build_model
    from repro_torch.models.common import tree_map
    totals: dict = {}
    out = {"card": {}, "controls": {}, "routes": {}}
    trials = _zoo_trials(MOE_TRAIN_MODELS)
    check(len(trials) == 9 * len(MOE_TRAIN_MODELS),
          f"3j (a): {len(trials)} trials")
    for spec in trials:
        key = f"{spec.model}/{spec.name}"
        card = _moe_trial(spec, "cuda")
        n = card["counts"]
        want = _want_train_launches(card["cfg"], grads=n["grad"],
                                    evals=n["eval"], syncs=card["int8_calls"])
        check(card["launches"] == want,
              f"3j (a) {key}: launches {card['launches']}, want {want}")
        check(("c8" in spec.sync) == (card["int8_calls"] > 0),
              f"3j (a) {key}: {card['int8_calls']} int8 merges")
        _add(totals, card["launches"])
        out["routes"][key] = [r.cpu() for r in card["routes"].records]
        out["card"][key] = {"metered": card["metered"],
                            "losses": card["losses"],
                            "seconds": card["seconds"]}
        if spec.model not in out["controls"]:    # each model's first trial
            ctrl = spec.with_(algo_args={
                **spec.algo_args,
                "lr": spec.algo_args["lr"] * ARCH_CONTROL_LR})
            out["controls"][spec.model] = {
                "spec": key,
                "losses": _trial_run(ctrl, "cuda", MOE_TRIAL_DTYPE)["losses"]}
    arch = get_reduced("deepseek-v2-lite-16b")
    arch = arch.replace(model=arch.model.replace(dtype="float32"))
    card_model = build_model(arch, device="cuda", seed=0)
    cpu_model = Model(arch.model, tree_map(lambda t: t.detach().cpu(),
                                           card_model.params))
    toks = torch.from_numpy(np.random.default_rng(23).integers(
        0, arch.model.vocab_size, (FULL_BATCH["b"], FULL_BATCH["s"])))
    out["route_control"] = _route_control(card_model, cpu_model, toks)
    out["launches"] = totals
    return out


def cpu_side_moe(out: Path, side: Path) -> None:
    """The second helper process (``python3 chip_smoke.py --cpu-side-moe
    PATH SIDE``, SIDE the first helper's output): started after phase 1,
    it runs 3h (a)'s CPU records (``PATH.3h``) beside phases 2-3f, waits
    for the card (``PATH.go``, given at 3g: phases 2-3f time kernels and
    serving loops and must have the card alone), runs 3h (b)'s op witness
    of both models (:func:`op_witness`, ``PATH.witness``) and 3j (a)'s
    quick trials on the card (:func:`_moe_card_trials`) beside 3g and 3h,
    then, once the first helper is done (SIDE written), 3j (a)'s trials on
    the CPU, each taking the card's experts over the whole trial (every
    forced gate held within ROUTE_GATE_TOL).  Writes PATH as JSON; a
    failed check exits non-zero."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.experiments import run_experiment
    # the reduced models' ops are tiny: more threads would only spin
    # against the first helper and the main process
    torch.set_num_threads(1)
    seconds = {}
    t0 = time.time()
    _write_part(out, ".3h", {"records": {
        f"{spec.model}/{spec.name}": run_experiment(spec, device="cpu").result
        for spec in _ssm_trials()}})
    seconds["3h_a"] = time.time() - t0
    t0 = time.time()
    while not out.with_suffix(".go").exists():
        time.sleep(0.5)
    seconds["waited"] = time.time() - t0
    t0 = time.time()
    torch.set_num_threads(CPU_SIDE_THREADS)     # full-width ops, each on
    _write_part(out, ".witness",                # the CPU too
                {name: op_witness(name) for name in SSM_TRAIN_MODELS})
    torch.set_num_threads(1)
    seconds["3h_witness"] = time.time() - t0
    t0 = time.time()
    trials = _moe_card_trials()
    routes = trials.pop("routes")
    seconds["a_card"] = time.time() - t0
    t0 = time.time()
    while not side.exists():            # the CPU trials after its CPU work
        time.sleep(0.5)
    seconds["waited_side"] = time.time() - t0
    t0 = time.time()
    records = {}
    for spec in _zoo_trials(MOE_TRAIN_MODELS):
        key = f"{spec.model}/{spec.name}"
        run = _moe_trial(spec, "cpu", routes[key])
        run["routes"].hold(f"3j (a) {key}")
        records[key] = {"metered": run["metered"], "losses": run["losses"],
                        "routes": run["routes"].reading(),
                        "seconds": run["seconds"]}
    seconds["a_cpu"] = time.time() - t0
    out.write_text(json.dumps({"records": records, **trials,
                               "seconds": seconds}))


def phase_train_moe_card() -> dict:
    """3j (b)'s card side, between 3h and 3i (the card's memory is free
    then): the deepseek cut's gradients on the card in fp32 and bf16
    (:func:`_moe_card_grad`) and one profiled call; their CPU sides start
    in a thread (:func:`_moe_held_grads`) that runs beside 3i.  Returns
    the thread's handle and the card's readings."""
    import torch
    t0 = time.time()
    wl, params32 = _moe_cut_params()
    cards = {dtype: _moe_card_grad(dtype, params32)
             for dtype in ("float32", "bfloat16")}
    batch = {k: v.cuda() for k, v in _full_batch(wl).items()}
    profile = _moe_grad_profile(wl, params32, batch)
    params32 = params32.cpu()
    del batch
    torch.cuda.empty_cache()
    launches: dict = {}
    for card in cards.values():
        _add(launches, card["launches"])
    wls = {dtype: _arch_cut(MOE_TRAIN_MODELS[0], dtype, MOE_CUT_LAYERS)
           for dtype in cards}
    full: dict = {}
    thread = threading.Thread(target=_moe_held_grads,
                              args=(params32, cards, wls, full), daemon=True)
    thread.start()
    seconds = time.time() - t0
    print(f"  (b) the deepseek cut's gradients on the card: {seconds:.1f} s; "
          f"their CPU sides run beside 3i")
    return {"thread": thread, "full": full, "profile": profile,
            "launches": launches, "seconds": seconds}


def phase_train_moe(helper: "CpuSide", b: dict) -> dict:
    """3j, after 3i: the helper's runs (:func:`cpu_side_moe`) held: (a)
    each trial's card record against its CPU run with the card's experts
    forced, metered fields equal, losses within ARCH_CARD_VS_CPU_RTOL, the
    controls missing it, a planted wrong route caught; (b) the deepseek
    cut's gradients (fp32 loss within FULL_LOSS_RTOL and each leaf within
    FULL_FP32_GRAD_TOL, bf16 loss within FULL_BF16_LOSS_RTOL, every flash
    attention held in situ, held in the helper), their launches exact,
    seconds, peak memory and (c) one profiled call's device time by class.
    Returns the training launches (they join the kernels line), each
    part's numbers and seconds."""
    t0 = time.time()
    b["thread"].join()
    check("error" not in b["full"], f"3j (b): {b['full'].get('error')}")
    waited_b = time.time() - t0
    cpu = helper.result()
    out = {"seconds": {"b_card": b["seconds"], "b_waited": waited_b,
                       "helper": cpu["seconds"], "waited": cpu["waited_s"]},
           "route_control": cpu["route_control"],
           "profile": b["profile"],
           "full": [b["full"][d] for d in ("float32", "bfloat16")],
           "launches": dict(cpu["launches"])}
    _add(out["launches"], b["launches"])
    check(cpu["route_control"]["least_slack"] < -ROUTE_GATE_TOL,
          f"3j routing control: {cpu['route_control']}")
    worst, slack, moved = {}, float("inf"), 0
    for key, c in cpu["card"].items():
        h = cpu["records"][key]
        check(c["metered"] == h["metered"],
              f"3j (a) {key}: metered fields differ between the card and "
              f"the CPU")
        gap = max(abs(a - b) / abs(b) for a, b in zip(c["losses"],
                                                      h["losses"]))
        check(gap <= ARCH_CARD_VS_CPU_RTOL,
              f"3j (a) {key}: card losses {c['losses']} vs cpu "
              f"{h['losses']}")
        model = key.split("/")[0]
        worst[model] = max(worst.get(model, 0.0), gap)
        slack = min(slack, h["routes"]["least_slack"])
        moved += h["routes"]["moved_tokens"]
    controls = {}
    for model, ctrl in cpu["controls"].items():
        ref = cpu["records"][ctrl["spec"]]["losses"]
        controls[model] = max(abs(a - b) / abs(b)
                              for a, b in zip(ctrl["losses"], ref))
        check(controls[model] > ARCH_CARD_VS_CPU_RTOL,
              f"3j control {model} (lr x{ARCH_CONTROL_LR}) within "
              f"{ARCH_CARD_VS_CPU_RTOL:g} of the CPU: the tolerance would "
              f"not catch it")
    out["presets"] = {"trials": len(cpu["card"]), "worst_rel_loss": worst,
                      "control_rel_loss": controls, "least_slack": slack,
                      "moved_tokens": moved}
    print(f"  (a) {len(cpu['card'])} trials ({MOE_TRIAL_DTYPE}): card "
          f"records equal the CPU's with the card's experts forced (losses "
          f"within {ARCH_CARD_VS_CPU_RTOL:g}; largest gap "
          f"{json.dumps(worst)}; least forced-gate slack {slack:.3e}, "
          f"{moved} tokens moved); controls lr x{ARCH_CONTROL_LR}: "
          f"{json.dumps(controls)}; a planted wrong route reads "
          f"{cpu['route_control']}")
    for row in out["full"]:
        check(row["launches"] == _want_train_launches(
            _arch_cut(MOE_TRAIN_MODELS[0], row["dtype"],
                      MOE_CUT_LAYERS).cfg, grads=1, evals=0),
              f"3j (b) {row['dtype']}: launches {row['launches']}")
        print(f"  (b) deepseek cut {row['dtype']}: loss card "
              f"{row['loss_card']!r} cpu {row['loss_cpu']!r} (rel "
              f"{row['rel_loss']:.3e}), worst leaf {row['worst_leaf']} "
              f"{row['worst_leaf_rel']:.3e}; card {row['card_s']:.2f} s, "
              f"cpu {row['cpu_s']:.2f} s, peak {row['peak_gib']:.2f} GiB; "
              f"forced routes {row['routes']}"
              + (f", a planted wrong route {row['route_control']}"
                 if row["route_control"] else "") + "; flash in situ "
              + json.dumps(row["flash_in_situ"]))
    print("  (c) one fp32 gradient profiled: " + json.dumps(b["profile"]))
    for name in ("flash_attention", "flash_attention_bwd", "quantize8_ef"):
        check(out["launches"].get(name, 0) > 0,
              f"{name} never launched on 3j's training path")
    out["seconds"]["total"] = b["seconds"] + time.time() - t0
    print("  3j seconds: " + json.dumps(
        {k: v if isinstance(v, dict) else round(v, 1)
         for k, v in out["seconds"].items()}))
    return out


# ------------------------------------ 3k, 3l: the vlm and encoder families ---

VLM = "llama-3.2-vision-90b"
HUBERT = "hubert-xlarge"
#: 3k serves llama-3.2-vision-90b at full width over its first VLM_GROUPS
#: of 20 groups (a group: 4 self-attention blocks, then one cross-attention
#: block on the image K/V): 10 of 100 layers, 10,657,898,496 parameters,
#: 42.6 GB in fp32 (the whole model, 351 GB, fits no card); its decode
#: crosses a group boundary of the stacked cache
VLM_GROUPS = 2
#: (a) the teacher-forced decode: b, positions (VLM_IMAGE image tokens)
VLM_DECODE = (2, 32)
#: (c) the Generator's request: b, prompt, new greedy tokens
VLM_GENERATE = (2, 16, 16)
#: (e) card vs CPU over the first group (5 layers, 6,379,626,496
#: parameters, 25.5 GB a side): a forward at b 1 over 32 positions, then
#: 8 decode steps
VLM_CPU_FORWARD, VLM_CPU_STEPS = (1, 32), 8
#: (f) one fp32 gradient of the first group, card vs CPU
VLM_GRAD_BATCH = (4, 64)
#: host memory (GiB) the first group's CPU gradient needs: its parameters
#: and gradient (51 GB) and the activations.  With less available when the
#: third helper starts, (f) is held on the card alone (every flash
#: attention in situ) and card vs CPU on the reduced config only
VLM_GRAD_HOST_GIB = 60
#: (f) the reduced vlm's fp32 gradient card vs CPU (always): b, s
VLM_REDUCED_GRAD_BATCH = (2, 16)
#: 3l: hubert-xlarge at full width and depth (48 layers, 944,487,680
#: parameters, 3.8 GB in fp32): a forward at b 8 over 512 frames, two steps
#: of its own TrainConfig (AdamW, lr 3e-4, clip 1.0) at b 2 over 128
HUBERT_FORWARD = (8, 512)
HUBERT_TRAIN = (2, 128)
#: the AdamW, 8-bit AdamW and SGD steps card vs CPU from the card's first
#: gradient with the clip off, over the first layer of every stacked leaf
#: and the other leaves whole (``_layer0``: the update is elementwise, so
#: this is the whole step's arithmetic at 2.6% of its CPU time):
#: parameters within this many ulps of their leaf's largest |p|.  From its
#: own gradient the CPU's first AdamW step would part further: u = m^ /
#: (sqrt(v^) + 1e-8) ~ sign(g) moves by up to dg / 4e-8 where |g| lies
#: near 1e-8 (an H100 beside its host read |dp| / lr 1.4e-2 at full width)
OPT_CARD_VS_CPU_ULPS = 1
#: the card's first clipped step (hubert's TrainConfig: clip 1.0 against a
#: gradient norm near 19) against the CPU's from the card's gradient: the
#: CPU clips the whole gradient by its own global norm (each leaf's sum of
#: squares in its own order, so the scale can part by an ulp) and steps
#: ``_layer0``.  The global norm, the first moments (linear in the scale),
#: the second moments and the parameters within this many ulps of each
#: leaf's largest |x|: an H100 beside its host read 0 on all four (the
#: norms equal bit for bit), and one ulp allows another summation order
OPT_CLIP_ULPS = 1
#: the planted wrong clip (each leaf clipped by its own norm) must miss
#: OPT_CLIP_ULPS by at least this factor on the first moments
OPT_CLIP_CONTROL_MARGIN = 100
#: the third helper's CPU priority, the lowest: its CPU sides take the
#: cores that the build, phases 2-3c and the other helpers leave idle
VLM_SIDE_NICE = 19


# --- parameters that are the same bits on the card and the CPU

#: a counter-built leaf is a sequence of COUNTER_SEGMENT-element pieces of
#: one pool of COUNTER_POOL uniform values, each piece at a hashed offset
COUNTER_POOL = 2 ** 26
COUNTER_SEGMENT = 1024
#: the pool's half-width in units of a leaf's scale: the variance of the
#: zoo's normal truncated to [-2, 2] (0.773741)
COUNTER_HALF_WIDTH = (3 * 0.773741) ** 0.5


def _counter_hash(start: int, n: int, salt: int, device: str):
    """A 32-bit hash (int64 tensor) of the counters ``start .. start + n``
    and ``salt``: integer steps only, each product below 2^63, so the
    card and the CPU compute the same values."""
    import torch
    mask = 0xFFFFFFFF
    x = torch.arange(start, start + n, dtype=torch.int64, device=device)
    x.mul_(0x6F4F2A35).add_(salt).bitwise_and_(mask)
    for shift, mul in ((16, 0x7FEB352D), (15, 0x4B3B8E35)):
        x.bitwise_xor_(x >> shift).mul_(mul).bitwise_and_(mask)
    return x.bitwise_xor_(x >> 16)


def _counter_params(cfg, device: str, seed: int = 0) -> dict:
    """``cfg``'s parameters in fp32 on ``device``, the same bits on the card
    and the CPU, so that a helper builds on the host what the card builds,
    with no copy between them and no truncated normal drawn on the host
    (slow there at the vlm group's 6.4 billion elements).  A pool of
    COUNTER_POOL values uniform in (-1, 1) comes from
    :func:`_counter_hash` by exact fp32 steps; a leaf of scale s is
    COUNTER_SEGMENT-element pieces of the pool at hashed offsets, times
    fp32(COUNTER_HALF_WIDTH x s) (one rounded product: the zoo's
    truncated normal's variance); norm scales are ones and scale 0 zeros,
    as :func:`init_params`."""
    import torch
    from repro_torch.models.common import is_spec, tree_map
    from repro_torch.models.transformer import model_spec
    seg, span = COUNTER_SEGMENT, COUNTER_POOL - COUNTER_SEGMENT + 1
    chunk = 2 ** 20
    pool = torch.empty(COUNTER_POOL, dtype=torch.float32, device=device)
    for off in range(0, COUNTER_POOL, chunk):
        torch.sub((_counter_hash(off, chunk, seed, device) >> 9).float(),
                  4194303.5, out=pool[off:off + chunk])
    pool.mul_(2.0 ** -22)                       # exact: (-1, 1)
    pieces = pool.unfold(0, seg, 1)             # every piece, as views
    place = iter(range(1, 1 << 30))

    def one(s):
        shape, _axes, scale = s
        salt = (seed * 0x3C6EF35F + next(place) * 0x2545F491) & 0xFFFFFFFF
        if scale == 0.0:
            return torch.zeros(shape, dtype=torch.float32, device=device)
        if scale == 1.0 and len(shape) == 1:
            return torch.ones(shape, dtype=torch.float32, device=device)
        out = torch.empty(shape, dtype=torch.float32, device=device)
        flat = out.view(-1)
        rows = -(-flat.numel() // seg)
        offs = _counter_hash(0, rows, salt, device) % span
        whole = flat.numel() // seg
        torch.index_select(pieces, 0, offs[:whole],
                           out=flat[:whole * seg].view(whole, seg))
        if whole < rows:
            flat[whole * seg:] = pieces[int(offs[whole])][
                :flat.numel() - whole * seg]
        a = torch.tensor(COUNTER_HALF_WIDTH * scale,
                         dtype=torch.float32).item()
        return out.mul_(a)
    return tree_map(one, model_spec(cfg), is_spec)


def _counter_sample(params) -> str:
    """sha256 of every 4099th element of every leaf (fp32 bits, the
    leaves in order): the card's and the host's counter-built parameters
    are held equal by it."""
    digest = hashlib.sha256()
    for _path, t in _paths(params):
        digest.update(t.reshape(-1)[::4099].cpu().numpy().tobytes())
    return digest.hexdigest()


def _paths(tree, path=()) -> list:
    """[(path, leaf)] of a nested dict, keys in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _paths(tree[k], path + (k,))]
    return [(path, tree)]


def _tree_gaps(a, ref) -> dict:
    """max |a - ref| / max |ref| per leaf ("x/y"), on ``a``'s device."""
    out = {}
    for (path, x), (_, y) in zip(_paths(a), _paths(ref)):
        x, y = x.float(), y.to(x.device).float()
        big = float(y.abs().max())
        out["/".join(path)] = float((x - y).abs().max()) / big if big else 0.0
    return out


#: the elements of a host tensor staged at a time through one pinned buffer
#: to the card (:func:`_staged_gaps`)
STAGE_CHUNK = 2 ** 26


def _staged_gaps(card, host) -> dict:
    """:func:`_tree_gaps` of a card tree against a host tree of fp32
    leaves, each host leaf sent to the card in STAGE_CHUNK pieces through
    one pinned buffer (the vlm group's gradient is 25.5 GB)."""
    import torch
    buf = torch.empty(STAGE_CHUNK, dtype=torch.float32, pin_memory=True)
    out = {}
    for (path, x), (_, y) in zip(_paths(card), _paths(host)):
        xf, yf = x.reshape(-1), y.reshape(-1)
        diff = big = 0.0
        for off in range(0, yf.numel(), STAGE_CHUNK):
            n = min(STAGE_CHUNK, yf.numel() - off)
            buf[:n].copy_(yf[off:off + n])
            ref = buf[:n].to(x.device, non_blocking=True)
            diff = max(diff, float((xf[off:off + n] - ref).abs().max()))
            big = max(big, float(ref.abs().max()))     # the buffer is free
        out["/".join(path)] = diff / big if big else diff
    return out


def _train_steps(cfg, train, params, batches) -> dict:
    """One step of ``train``'s optimizer per batch: the losses, the grad
    norms, the first gradient, the parameters and state after the first
    step."""
    from repro_torch.models.transformer import value_and_grad
    from repro_torch.optim import make_optimizer
    opt = make_optimizer(train)
    state = opt.init(params)
    out = {"losses": [], "grad_norms": []}
    for batch in batches:
        loss, grads = value_and_grad(params, batch, cfg)
        params, state, stats = opt.update(grads, state, params)
        out["losses"].append(float(loss))
        out["grad_norms"].append(float(stats["grad_norm"]))
        out.setdefault("first_grad", grads)
        out.setdefault("first_params", params)
        out.setdefault("first_state", state)
        del grads
    return out


def _host_gib() -> float:
    """MemAvailable of the host, GiB (/proc/meminfo)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) / 2 ** 20
    return float("nan")


def _layer0(params) -> dict:
    """The first layer's slice of every stacked leaf (``blocks``), the
    other leaves whole, as views."""
    from repro_torch.models.common import tree_map
    return dict(params, blocks=tree_map(lambda a: a[:1], params["blocks"]))


def _loss(cfg, params, batch):
    from repro_torch.models.transformer import loss_fn
    return loss_fn(params, batch, cfg)[0]


def _ulps(x, ref) -> float:
    """max |x - ref| in ulps of the largest |ref| (fp32)."""
    import math
    import torch
    big = float(ref.abs().max())
    if not big:
        return 0.0 if not bool(x.any()) else float("inf")
    ulp = torch.finfo(torch.float32).eps * 2.0 ** math.floor(math.log2(big))
    return float((x.float() - ref.float()).abs().max()) / ulp


def _tree_ulps(a, ref) -> float:
    """The largest :func:`_ulps` over the leaves."""
    return max(_ulps(x, y.to(x.device))
               for (_, x), (_, y) in zip(_paths(a), _paths(ref)))


def _teacher_forced(model, toks, img, max_seq: int):
    """Every decode step's logits (b, s, V) over ``toks`` (b, s), the
    cross cache primed from ``img`` (None: left zero)."""
    import torch
    b, s = toks.shape
    steps = []
    with torch.no_grad():
        cache = model.init_cache(b, max_seq)
        if img is not None:
            model.prime_cross_cache(cache, img)
        for pos in range(s):
            logits, cache = model.decode_step(cache, toks[:, pos], pos)
            steps.append(logits)
    return torch.stack(steps, dim=1)


def _vlm_arch(groups: int = 1, reduced: bool = False):
    """The vlm in fp32 at full width over its first ``groups`` groups, or
    its reduced config."""
    from repro_torch.configs import get_arch, get_reduced
    arch = (get_reduced if reduced else get_arch)(VLM)
    cfg = arch.model
    layers = cfg.num_layers if reduced else groups * cfg.cross_attn_every
    return arch.replace(model=cfg.replace(dtype="float32", num_layers=layers))


def _hubert_arch():
    from repro_torch.configs import get_arch
    arch = get_arch(HUBERT)
    return arch.replace(model=arch.model.replace(dtype="float32"))


def _vlm_batches(device: str) -> dict:
    """(e)'s, (f)'s and the reduced gradient's batches."""
    from repro_torch.launch.specs import make_batch
    return {"e": make_batch(_vlm_arch(), *VLM_CPU_FORWARD, seed=8,
                            device=device),
            "f": make_batch(_vlm_arch(), *VLM_GRAD_BATCH, seed=10,
                            device=device),
            "reduced": make_batch(_vlm_arch(reduced=True),
                                  *VLM_REDUCED_GRAD_BATCH, seed=11,
                                  device=device)}


def _vlm_cpu_side() -> dict:
    """3k (e)'s and (f)'s CPU sides, in the third helper before the slot:
    the first group counter-built on the host, its forward and decode
    steps, its fp32 gradient (when the host had VLM_GRAD_HOST_GIB free at
    the start), and the reduced config's gradient."""
    import torch
    from repro_torch.models import Model
    from repro_torch.models.transformer import value_and_grad
    out, seconds = {"host_gib": _host_gib()}, {}
    t0 = time.time()
    cfg = _vlm_arch().model
    params = _counter_params(cfg, "cpu")
    out["sample"] = _counter_sample(params)
    batches = _vlm_batches("cpu")
    seconds["init"] = time.time() - t0
    t0 = time.time()
    model = Model(cfg, params)
    eb = batches["e"]
    with torch.no_grad():
        out["forward"] = model.forward(eb)[0]
    out["steps"] = _teacher_forced(model, eb["tokens"][:, :VLM_CPU_STEPS],
                                   eb["image_embeds"], VLM_CPU_STEPS)
    seconds["e"] = time.time() - t0
    if out["host_gib"] >= VLM_GRAD_HOST_GIB:
        t0 = time.time()
        loss, out["grad"] = value_and_grad(params, batches["f"], cfg)
        out["loss"] = float(loss)
        seconds["f"] = time.time() - t0
    del model, params
    rcfg = _vlm_arch(reduced=True).model
    loss, grad = value_and_grad(_counter_params(rcfg, "cpu"),
                                batches["reduced"], rcfg)
    out["reduced"] = {"loss": float(loss), "grad": grad}
    out["seconds"] = seconds
    return out


def _vlm_card_side(cpu: dict) -> dict:
    """3k (e), (f) in the slot: the first group counter-built on the card
    (its sampled bits equal the host's), (e) its forward and decode steps
    against the CPU's within SERVE_TOL, (f) its fp32 gradient with every
    flash attention held in situ, against the CPU's (FULL_LOSS_RTOL, each
    leaf FULL_FP32_GRAD_TOL) where the host could hold it, and the reduced
    config's gradient card vs CPU at the same limits; launches exact."""
    import torch
    from repro_torch.models import Model
    from repro_torch.models.transformer import value_and_grad
    t0 = time.time()
    cfg = _vlm_arch().model
    params = _counter_params(cfg, "cuda")
    check(_counter_sample(params) == cpu["sample"],
          "3k (e): the card's counter-built parameters differ from the "
          "host's")
    group = Model(cfg, params)
    batches = {k: {n: t.cuda() for n, t in b.items()}
               for k, b in _vlm_batches("cpu").items()}
    init_s = time.time() - t0
    t0 = time.time()
    eb = batches["e"]
    _reset_path_launches()
    with torch.no_grad():
        fwd = group.forward(eb)[0]
    steps = _teacher_forced(group, eb["tokens"][:, :VLM_CPU_STEPS],
                            eb["image_embeds"], VLM_CPU_STEPS)
    launches = _path_launches()
    want = _want_launches(cfg, VLM_CPU_STEPS, 1)
    check(launches == want, f"3k (e): launches {launches}, want {want}")
    e_err = float((fwd.cpu() - cpu["forward"]).abs().max())
    s_err = float((steps.cpu() - cpu["steps"]).abs().max())
    e_scale = float(cpu["forward"].abs().max())
    rows = {"e": {"batch": VLM_CPU_FORWARD[0],
                  "positions": VLM_CPU_FORWARD[1], "steps": VLM_CPU_STEPS,
                  "forward_max_abs_err": e_err, "steps_max_abs_err": s_err,
                  "logits_max_abs": e_scale, "seconds": time.time() - t0,
                  "launches": dict(launches)}}
    print(f"  3k (e) the first group card vs CPU: forward b"
          f"{VLM_CPU_FORWARD[0]} s{VLM_CPU_FORWARD[1]} {e_err:.3e}, "
          f"{VLM_CPU_STEPS} decode steps {s_err:.3e} (largest |logit| "
          f"{e_scale:.3f})", flush=True)
    check(max(e_err, s_err) <= SERVE_TOL * max(1.0, e_scale),
          f"3k (e): card vs CPU logits differ by {max(e_err, s_err):.3e}")
    del fwd, steps
    gb, gs = VLM_GRAD_BATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_train_launches()
    t0 = time.time()
    with _flash_in_situ() as situ:
        loss, grads = value_and_grad(params, batches["f"], cfg)
    torch.cuda.synchronize()
    f_s = time.time() - t0
    got = _train_launches()
    want = _want_train_launches(cfg, grads=1, evals=0)
    check(got == want, f"3k (f): launches {got}, want {want}")
    _add(launches, got)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    in_situ = situ.hold("3k (f)")
    f = {"batch": gb, "positions": gs, "card_s": f_s, "peak_gib": peak,
         "loss_card": float(loss), "flash_in_situ": in_situ,
         "launches": got, "host_gib": cpu["host_gib"]}
    if "grad" in cpu:
        t0 = time.time()
        gaps = _staged_gaps(grads, cpu["grad"])
        worst = max(gaps, key=gaps.get)
        f.update(loss_cpu=cpu["loss"], rel_loss=abs(float(loss) - cpu["loss"])
                 / abs(cpu["loss"]), worst_leaf=worst,
                 worst_leaf_rel=gaps[worst], compare_s=time.time() - t0)
    rows["f"] = f
    print(f"  3k (f) the first group's gradient b{gb} s{gs}: {f_s:.2f} s on "
          f"the card, peak {peak:.2f} GiB, loss card {float(loss)!r}"
          + (f" cpu {f['loss_cpu']!r} (rel {f['rel_loss']:.3e}), worst leaf "
             f"{f['worst_leaf']} {f['worst_leaf_rel']:.3e} (compared in "
             f"{f['compare_s']:.1f} s)" if "grad" in cpu else
             f"; the host had {cpu['host_gib']:.1f} GiB free at the start, "
             f"under VLM_GRAD_HOST_GIB {VLM_GRAD_HOST_GIB}: held in situ and "
             f"on the reduced config only")
          + f"; flash in situ {json.dumps(in_situ)}", flush=True)
    if "grad" in cpu:
        check(f["rel_loss"] <= FULL_LOSS_RTOL,
              f"3k (f): loss rel {f['rel_loss']:.3e}")
        check(f["worst_leaf_rel"] <= FULL_FP32_GRAD_TOL,
              f"3k (f): gradient leaf {worst} {f['worst_leaf_rel']:.3e}")
    del grads, params, group, loss
    torch.cuda.empty_cache()
    rcfg = _vlm_arch(reduced=True).model
    rparams = _counter_params(rcfg, "cuda")
    _reset_train_launches()
    loss, grads = value_and_grad(rparams, batches["reduced"], rcfg)
    got = _train_launches()
    want = _want_train_launches(rcfg, grads=1, evals=0)
    check(got == want, f"3k (f) reduced: launches {got}, want {want}")
    _add(launches, got)
    ref = cpu["reduced"]
    gaps = _tree_gaps(grads, ref["grad"])
    worst = max(gaps, key=gaps.get)
    rel = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
    rows["reduced"] = {"batch": VLM_REDUCED_GRAD_BATCH, "rel_loss": rel,
                       "worst_leaf": worst, "worst_leaf_rel": gaps[worst],
                       "launches": got}
    print(f"  3k (f) the reduced vlm's gradient card vs CPU: loss rel "
          f"{rel:.3e}, worst leaf {worst} {gaps[worst]:.3e}", flush=True)
    check(rel <= FULL_LOSS_RTOL and gaps[worst] <= FULL_FP32_GRAD_TOL,
          f"3k (f) reduced: loss rel {rel:.3e}, leaf {worst} "
          f"{gaps[worst]:.3e}")
    return {"runs": rows, "launches": launches, "init_s": init_s}


class _optim_arith:
    """Inside the block the optimizers' fused multiply-adds and square
    roots are ``fma(a, b, c)`` and ``sqrt(x)`` in place of the port's
    (:data:`FLOAT64`: the CPU's route through float64 on every device;
    :data:`PLAIN_FP32`: ``a * b + c`` rounded twice and PyTorch's sqrt):
    what the port's card arithmetic is timed and held against."""

    def __init__(self, fma, sqrt):
        self.fma, self.sqrt = fma, sqrt

    def __enter__(self):
        from repro_torch import optim
        self._kept = optim._fma, optim._sqrt
        optim._fma, optim._sqrt = self.fma, self.sqrt
        return self

    def __exit__(self, *exc):
        from repro_torch import optim
        optim._fma, optim._sqrt = self._kept


def _plain_fma(a, b, c):
    return b * a + c


def _torch_sqrt(x):
    return x.sqrt()


def _float64_route():
    from repro_torch import optim
    return optim._fma64, optim._sqrt64


PLAIN_FP32 = (_plain_fma, _torch_sqrt)


def _update_ms(opt, grads, state, params, reps: int = 3) -> float:
    """Median CUDA-event time of ``opt.update`` alone, ms."""
    import torch
    times = []
    for _ in range(reps + 1):                 # the first call warms up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = opt.update(grads, state, params)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        del out
    return statistics.median(times[1:])


def _encoder_card_side() -> dict:
    """3l's card side in the slot: hubert-xlarge counter-built on the card,
    a forward at HUBERT_FORWARD, two steps of its own TrainConfig at
    HUBERT_TRAIN in fp32 and bf16, the AdamW, 8-bit AdamW and SGD steps
    from the first fp32 gradient with the clip off (``_layer0``), launches
    exact, and the optimizer update alone timed with the port's card
    arithmetic (held equal bit for bit to the CPU's float64 route) and in
    plain fp32.  What the CPU holds afterwards goes to the host
    (``host``)."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.specs import make_batch
    from repro_torch.models import Model
    from repro_torch.models.common import DTYPES, tree_map
    from repro_torch.models.transformer import value_and_grad
    from repro_torch.optim import make_optimizer
    t_phase = time.time()
    arch = _hubert_arch()
    cfg = arch.model
    params32 = _counter_params(cfg, "cuda")
    model = Model(cfg, params32)
    host = {"sample": _counter_sample(params32)}
    launches: dict = {}
    b, s = HUBERT_FORWARD
    batch = make_batch(arch, b, s, seed=0, device="cuda")
    torch.cuda.synchronize()
    _reset_train_launches()
    t0 = time.time()
    with torch.no_grad():
        logits, _ = model.forward(batch)
    torch.cuda.synchronize()
    fwd_s = time.time() - t0
    got = _train_launches()
    check(got == _want_train_launches(cfg, grads=0, evals=1),
          f"3l forward: launches {got}")
    check(tuple(logits.shape) == (b, s, cfg.vocab_size)
          and bool(logits.isfinite().all()), f"3l forward: {logits.shape}")
    _add(launches, got)
    del logits, batch
    b, s = HUBERT_TRAIN
    batches = [make_batch(arch, b, s, seed=1 + i, device="cuda")
               for i in range(2)]
    runs, card = {}, {}
    for dtype in ("float32", "bfloat16"):
        a = arch.replace(model=cfg.replace(dtype=dtype))
        params = tree_map(lambda t: t.to(DTYPES[dtype]), params32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_train_launches()
        t0 = time.time()
        run = _train_steps(a.model, a.train, params, batches)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        got = _train_launches()
        want = _want_train_launches(a.model, grads=2, evals=0)
        check(got == want, f"3l {dtype} steps: launches {got}, want {want}")
        check(all(x == x for x in run["losses"] + run["grad_norms"]),
              f"3l {dtype}: losses {run['losses']}")
        _add(launches, got)
        runs[dtype] = {"losses": run["losses"],
                       "grad_norms": run["grad_norms"], "seconds": seconds,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "launches": got}
        card[dtype] = run
        print(f"  3l two {a.train.optimizer} steps (lr "
              f"{a.train.learning_rate:g}, clip {a.train.grad_clip:g}) in "
              f"{dtype} at b{b} s{s}: losses {run['losses']}, grad norms "
              f"{run['grad_norms']}, {seconds:.2f} s, peak "
              f"{runs[dtype]['peak_gib']:.2f} GiB", flush=True)
    g32 = card["float32"]["first_grad"]
    first = card["float32"]
    host.update(
        grad=tree_map(lambda t: t.cpu(), g32),
        first=tree_map(lambda t: t.cpu(), {
            "params": _layer0(first["first_params"]),
            "m": _layer0(first["first_state"]["m"]),
            "v": _layer0(first["first_state"]["v"])}),
        bf16_p1=tree_map(lambda t: t.cpu(),
                         card["bfloat16"]["first_params"]),
        losses={d: r["losses"] for d, r in runs.items()},
        grad_norm=first["grad_norms"][0])
    del card, first
    # the three optimizers' steps from the card's first fp32 gradient
    sub_p, sub_g = _layer0(params32), _layer0(g32)
    opts = {}
    for name in ("adamw", "adamw8bit", "sgd"):
        tc = TrainConfig(optimizer=name, learning_rate=arch.train.learning_rate,
                         weight_decay=arch.train.weight_decay, grad_clip=1e9)
        opt = make_optimizer(tc)
        new, state, _ = opt.update(sub_g, opt.init(sub_p), sub_p)
        opts[name] = tree_map(lambda t: t.cpu(),
                              {"params": new, "state": state})
    host["opts"] = opts
    # the update alone (the arch's AdamW over the whole model), with the
    # port's arithmetic and with plain fp32, beside one gradient's time
    opt = make_optimizer(arch.train)
    state = opt.init(params32)
    update_ms = {"port": _update_ms(opt, g32, state, params32)}
    with _optim_arith(*PLAIN_FP32):
        update_ms["plain_fp32"] = _update_ms(opt, g32, state, params32)
    with _optim_arith(*_float64_route()):
        update_ms["float64"] = _update_ms(opt, g32, state, params32)
        f64 = opt.update(g32, state, params32)
    port = opt.update(g32, state, params32)
    update_ms["port_is_float64_bitwise"] = all(
        _bits_equal(x, y) for (_, x), (_, y) in zip(
            _paths({"p": port[0], "s": port[1]}),
            _paths({"p": f64[0], "s": f64[1]})))
    del state, f64, port
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        value_and_grad(params32, batches[0], cfg)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    update_ms["gradient"] = statistics.median(times)
    print(f"  3l the AdamW update alone over {model.param_count():,} "
          f"parameters: {update_ms['port']:.2f} ms with the port's card "
          f"arithmetic, {update_ms['float64']:.2f} ms through float64 as on "
          f"the CPU (bit for bit the same: "
          f"{update_ms['port_is_float64_bitwise']}), "
          f"{update_ms['plain_fp32']:.2f} ms in plain fp32; one gradient at "
          f"b{b} s{s} {update_ms['gradient']:.2f} ms (CUDA events)",
          flush=True)
    check(update_ms["port_is_float64_bitwise"],
          "3l: the card's AdamW update parts from the float64 route's")
    del model, params32, g32, sub_p, sub_g, batches
    return {"runs": runs, "forward_s": fwd_s, "launches": launches,
            "update_ms": update_ms, "card_s": time.time() - t_phase,
            "host": host}


def _encoder_hold(card: dict) -> dict:
    """3l held on the CPU, after the slot, against the card's results: the
    fp32 loss within FULL_LOSS_RTOL and each gradient leaf within
    FULL_FP32_GRAD_TOL; the bf16 losses (the second at the card's own
    parameters after its first step) within FULL_BF16_LOSS_RTOL; the
    AdamW, 8-bit AdamW and SGD steps from the card's gradient with the
    clip off (parameters within OPT_CARD_VS_CPU_ULPS, AdamW's moments and
    the 8-bit codes and scales equal); the first clipped step (the arch's
    TrainConfig) from the card's gradient within OPT_CLIP_ULPS, and a
    planted wrong clip that must miss it."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.specs import make_batch
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import value_and_grad
    from repro_torch.optim import clip_by_global_norm, make_optimizer
    arch = _hubert_arch()
    cfg = arch.model
    seconds, t0 = {}, time.time()
    params = _counter_params(cfg, "cpu")
    check(_counter_sample(params) == card["sample"],
          "3l: the card's counter-built parameters differ from the host's")
    b, s = HUBERT_TRAIN
    batches = [make_batch(arch, b, s, seed=1 + i, device="cpu")
               for i in range(2)]
    loss, grads = value_and_grad(params, batches[0], cfg)
    seconds["fp32_grad"] = time.time() - t0
    losses = card["losses"]
    rel = abs(losses["float32"][0] - float(loss)) / abs(float(loss))
    gaps = _tree_gaps(card["grad"], grads)
    worst_g = max(gaps, key=gaps.get)
    del grads
    t0 = time.time()
    bcfg = cfg.replace(dtype="bfloat16")
    with torch.no_grad():
        cpu16 = [float(_loss(bcfg, tree_map(lambda t: t.bfloat16(), params),
                             batches[0])),
                 float(_loss(bcfg, card["bf16_p1"], batches[1]))]
    seconds["bf16_losses"] = time.time() - t0
    bf16 = [abs(a - c) / abs(c) for a, c in zip(losses["bfloat16"], cpu16)]
    out = {"fp32_rel_loss": rel, "worst_grad_leaf": worst_g,
           "worst_grad_rel": gaps[worst_g], "bf16_rel_losses": bf16,
           "bf16_cpu_losses": cpu16}
    t0 = time.time()
    sub_p, sub_g = _layer0(params), _layer0(card["grad"])
    opts = {}
    for name in ("adamw", "adamw8bit", "sgd"):
        tc = TrainConfig(optimizer=name, learning_rate=arch.train.learning_rate,
                         weight_decay=arch.train.weight_decay, grad_clip=1e9)
        opt = make_optimizer(tc)
        new, state, _ = opt.update(sub_g, opt.init(sub_p), sub_p)
        c = card["opts"][name]
        bitwise = all(_bits_equal(x, y) for (_, x), (_, y) in zip(
            _paths(c["params"]), _paths(new)))
        states: dict = {}
        for (path, x), (_, y) in zip(_paths(c["state"]), _paths(state)):
            kind = path[-1] if name == "adamw8bit" else path[0]
            states[kind] = states.get(kind, True) and _bits_equal(x, y)
        opts[name] = {"params_bitwise": bitwise,
                      "params_ulps": _tree_ulps(c["params"], new),
                      "states_equal": states}
    out["optimizers"] = opts
    # the first clipped step: the CPU clips the card's whole gradient by its
    # own global norm, then steps the first layer with the clip off
    noclip = make_optimizer(TrainConfig(
        optimizer=arch.train.optimizer,
        learning_rate=arch.train.learning_rate,
        weight_decay=arch.train.weight_decay, grad_clip=1e9))

    def clipped_step(clipped) -> dict:
        new, state, _ = noclip.update(_layer0(clipped), noclip.init(sub_p),
                                      sub_p)
        return {"params": new, "m": state["m"], "v": state["v"]}

    clipped, gnorm = clip_by_global_norm(card["grad"], arch.train.grad_clip)
    cpu_step = clipped_step(clipped)
    ulp = torch.finfo(torch.float32).eps * 2.0 ** torch.floor(
        torch.log2(gnorm)).item()
    clip = {"grad_norm_card": card["grad_norm"], "grad_norm_cpu": float(gnorm),
            "grad_norm_ulps": abs(card["grad_norm"] - float(gnorm)) / ulp,
            **{f"{k}_ulps": _tree_ulps(card["first"][k], cpu_step[k])
               for k in ("params", "m", "v")}}

    def per_leaf(g):
        n = g.float().square().sum().sqrt()
        return g * torch.minimum(torch.ones(()), arch.train.grad_clip / n)
    planted = clipped_step(tree_map(per_leaf, card["grad"]))
    clip["planted_m_ulps"] = _tree_ulps(card["first"]["m"], planted["m"])
    out["clipped_step"] = clip
    seconds["optimizers"] = time.time() - t0
    out["seconds"] = seconds
    print(f"  3l card vs CPU: fp32 loss rel {rel:.3e}, worst gradient leaf "
          f"{worst_g} {gaps[worst_g]:.3e} of its largest |g|; bf16 losses "
          f"card {losses['bfloat16']} cpu {cpu16} (rel {bf16}); optimizer "
          f"steps from the card's gradient, clip off (first layer): "
          + json.dumps(opts) + "; the first clipped AdamW step: "
          + json.dumps(clip) + "; CPU seconds "
          + json.dumps({k: round(v, 1) for k, v in seconds.items()}),
          flush=True)
    check(rel <= FULL_LOSS_RTOL, f"3l fp32 loss: card vs CPU rel {rel:.3e}")
    check(gaps[worst_g] <= FULL_FP32_GRAD_TOL,
          f"3l fp32 gradient: {worst_g} {gaps[worst_g]:.3e}")
    check(max(bf16) <= FULL_BF16_LOSS_RTOL, f"3l bf16 losses: rel {bf16}")
    for name, o in opts.items():
        check(all(o["states_equal"].values())
              and o["params_ulps"] <= OPT_CARD_VS_CPU_ULPS,
              f"3l {name} step card vs CPU: {o}")
    check(max(clip[k] for k in ("grad_norm_ulps", "params_ulps", "m_ulps",
                                "v_ulps")) <= OPT_CLIP_ULPS,
          f"3l the first clipped step card vs CPU: {clip}")
    check(clip["planted_m_ulps"] >= OPT_CLIP_CONTROL_MARGIN * OPT_CLIP_ULPS,
          f"3l a planted wrong clip (each leaf by its own norm) is not "
          f"caught: {clip}")
    return out


def cpu_side_vlm(out: Path) -> None:
    """The third helper process (``python3 chip_smoke.py --cpu-side-vlm
    PATH``), started before phase 1's build at CPU priority VLM_SIDE_NICE,
    so it takes the cores the build, phases 2-3c and the other helpers
    leave idle while the host's memory is free: 3k (e)'s and (f)'s CPU
    sides (:func:`_vlm_cpu_side`, ``PATH.ready``), then 3m (d)'s
    full-width launcher steps on the CPU (:func:`_launcher_cpu_side`,
    ``PATH.3m``) while it waits for the card; then, given the card
    after 3c (``PATH.go``) while the main process waits, 3k (e), (f) and
    3l's card sides and the holds that need both
    (:func:`_vlm_card_side`, :func:`_encoder_card_side`; ``PATH.slot``
    once the card is free again); then, beside phase 3d on, the CPU work
    on the card's results (:func:`_encoder_hold`).  Writes PATH as JSON;
    a failed check exits non-zero."""
    import torch
    os.nice(VLM_SIDE_NICE)
    sys.path.insert(0, str(ROOT / "src"))
    seconds = {}
    t0 = time.time()
    cpu = _vlm_cpu_side()
    seconds["cpu"] = time.time() - t0
    seconds.update({f"cpu_{k}": v for k, v in cpu["seconds"].items()})
    _write_part(out, ".ready", {"host_gib": cpu["host_gib"],
                                "seconds": seconds})
    # 3m (d)'s CPU side in the time it waits for the slot (after 3c): it
    # would take cores from 3d and 3e's CPU sides later on
    t0 = time.time()
    _write_part(out, ".3m", _launcher_cpu_side())
    seconds["launcher"] = time.time() - t0
    torch.zeros(1, device="cuda")       # the context, before the slot
    t0 = time.time()
    while not out.with_suffix(".go").exists():
        time.sleep(0.2)
    seconds["waited"] = time.time() - t0
    t0 = time.time()
    vlm = _vlm_card_side(cpu)
    del cpu
    torch.cuda.empty_cache()
    enc = _encoder_card_side()
    host = enc.pop("host")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    seconds["slot"] = time.time() - t0
    _write_part(out, ".slot", {"vlm": vlm, "encoder": enc,
                               "seconds": seconds})
    t0 = time.time()
    held = _encoder_hold(host)
    seconds["held"] = time.time() - t0
    out.write_text(json.dumps({"encoder_held": held, "seconds": seconds}))


def phase_vlm_encoder_slot(side: "CpuSide") -> dict:
    """3k (e), (f) and 3l's card sides, between 3c and 3d: the card is the
    third helper's (:func:`cpu_side_vlm`) while the main process waits,
    first for the helper's CPU sides if they are not done.  Returns the
    helper's readings and launches, and the main process's seconds."""
    import torch
    t0 = time.time()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ready = side.part(".ready")
    waited = time.time() - t0
    side.go()
    slot = side.part(".slot")
    seconds = time.time() - t0
    print(f"  the slot: {seconds:.1f} s of the main process ({waited:.1f} s "
          f"waiting for the helper's CPU sides; host memory free at its "
          f"start {ready['host_gib']:.1f} GiB); the helper's seconds "
          + json.dumps({k: round(v, 1) for k, v in slot["seconds"].items()}))
    return {**slot, "main_s": seconds, "waited_s": waited}


def phase_vlm() -> dict:
    """3k (a)-(d) (see the module docstring): llama-3.2-vision-90b's first
    VLM_GROUPS groups at full width on the card, seeded there, with no CPU
    side running.  Returns the readings and launch totals."""
    import numpy as np
    import torch
    from repro_torch.launch.specs import make_batch
    from repro_torch.serving import Generator
    t_phase = time.time()
    rows: dict = {}
    totals = {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}
    arch, model, _ = _full_width(VLM, cpu=False, layers=VLM_GROUPS
                                 * _vlm_arch().model.cross_attn_every)
    cfg = arch.model
    print(f"  {VLM}: layers 0-{cfg.num_layers - 1} of 100 ran (the first "
          f"{VLM_GROUPS} of 20 groups), full width")
    b, s = VLM_DECODE
    batch = make_batch(arch, b, s, seed=7, device="cuda")
    toks, img = batch["tokens"], batch["image_embeds"]
    # (a) the forward against the teacher-forced decode steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_path_launches()
    t0 = time.time()
    with torch.no_grad():
        fwd = model.forward({"tokens": toks, "image_embeds": img})[0]
    steps = _teacher_forced(model, toks, img, s)
    torch.cuda.synchronize()
    a_s = time.time() - t0
    got = _path_launches()
    want = _want_launches(cfg, s, 1)
    check(got == want, f"3k (a): launches {got}, want {want}")
    _add(totals, got)
    scale = float(fwd.abs().max())
    err = float((fwd - steps).abs().max())
    check(err <= SERVE_TOL * max(1.0, scale),
          f"3k (a): the forward vs its decode steps differ by {err:.3e}")
    # (b) the control: zeroed image embeddings move the logits past it
    _reset_path_launches()
    with torch.no_grad():
        fwd0 = model.forward({"tokens": toks,
                              "image_embeds": torch.zeros_like(img)})[0]
    _add(totals, _path_launches())
    moved = float((fwd0 - fwd).abs().max())
    check(moved > 10 * SERVE_TOL * max(1.0, scale),
          f"3k (b): zeroed image embeddings move the logits by only "
          f"{moved:.3e}")
    rows["a"] = {"batch": b, "positions": s, "seconds": a_s,
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                 "forward_vs_decode_max_abs_err": err,
                 "logits_max_abs": scale, "launches": got,
                 "zero_image_moves": moved}
    print(f"  3k (a) at {time.time() - t_phase:.1f} s: forward and {s} "
          f"decode steps at b{b} (image primed, {cfg.num_image_tokens} "
          f"tokens): {a_s:.3f} s, forward vs decode {err:.3e} (largest "
          f"|logit| {scale:.3f}), launches {got}; (b) zeroed image "
          f"embeddings move the logits {moved:.3e}")
    del fwd, steps
    # (c) the Generator: no image primed, as the JAX package's
    gb, prompt_len, new = VLM_GENERATE
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, cfg.vocab_size, (gb, prompt_len)).astype(
        np.int32)
    gen = Generator(arch, model, max_seq=prompt_len + new + 1, device="cuda")
    recorded = _StepLogits(gen, gb, prompt_len + new)
    _reset_path_launches()
    t0 = time.time()
    try:
        out = gen.generate(prompts, max_new_tokens=new)
    finally:
        recorded.stop()
    torch.cuda.synchronize()
    c_s = time.time() - t0
    got = _path_launches()
    want = _want_launches(cfg, prompt_len + new, 0)
    check(gen.decode_steps == prompt_len + new and got == want,
          f"3k (c): {gen.decode_steps} steps, launches {got}, want {want}")
    _add(totals, got)
    card = recorded.logits(prompt_len + new - 1)
    out_t = torch.from_numpy(out).long().cuda()
    _reset_path_launches()
    with torch.no_grad():
        fwd0 = model.forward({"tokens": out_t[:, :-1],
                              "image_embeds": torch.zeros(
                                  gb, cfg.num_image_tokens, cfg.d_model,
                                  device="cuda")})[0].cpu()
    _add(totals, _path_launches())
    gerr = float((fwd0 - card).abs().max())
    check(gerr <= SERVE_TOL * max(1.0, float(card.abs().max())),
          f"3k (c): the zero-image forward vs the Generator's steps differ "
          f"by {gerr:.3e}")
    check(bool((card[:, prompt_len - 1:].argmax(-1)
                == torch.from_numpy(out[:, prompt_len:]).long()).all()),
          "3k (c): generated tokens are not the step logits' argmax")
    rows["c"] = {"batch": gb, "prompt": prompt_len, "new_tokens": new,
                 "wall_s": c_s, "ms_per_decode_step":
                 c_s / gen.decode_steps * 1e3,
                 "zero_image_forward_vs_steps": gerr, "launches": got}
    print(f"  3k (c) at {time.time() - t_phase:.1f} s: Generator {gb}x{new} "
          f"greedy tokens after a prompt of {prompt_len}: {c_s:.3f} s "
          f"({rows['c']['ms_per_decode_step']:.3f} ms/step), the zero-image "
          f"forward vs its steps {gerr:.3e}, launches {got}")
    del gen, card, fwd0
    # (d) a profile of the decode steps
    prof = _profile_decode(model, torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, 4))).cuda(), steps=6)
    rows["d_profile"] = prof
    print(f"  3k (d) at {time.time() - t_phase:.1f} s: decode-step profile "
          + json.dumps(prof))
    del model
    torch.cuda.empty_cache()
    seconds = time.time() - t_phase
    print(f"  3k (a)-(d): {seconds:.1f} s")
    return {"runs": rows, "launches": totals, "seconds": seconds}


# --------------------------------------------- phase 3m: the train launcher ---

#: phase 3m: smollm-360m at full width through ``launch/train.py`` (its
#: config's bf16, AdamW, one card), at the launcher's defaults
LAUNCHER_ARCH = "smollm-360m"
LAUNCHER = ["--arch", LAUNCHER_ARCH, "--mesh", "1x1", "--batch", "8",
            "--seq", "128", "--log-every", "1"]
LAUNCHER_SHAPE = (8, 128)
#: the launcher's attention: rows 5u (forward) and 5v (backward) in bf16
LAUNCHER_ATTN = (*LAUNCHER_SHAPE, *_SMOLLM_ATTN)
#: the third helper's threads for 3m (d)'s CPU steps, beside phases 2-3c
LAUNCHER_CPU_THREADS = 4
#: card vs CPU of zoo training (PERF.md section 2): losses in fp32 / bf16
LAUNCHER_CPU_RTOL = {"float32": 1e-4, "bfloat16": 1e-3}
#: (a) runs at full width over the first this many of the 32 layers: a
#: checkpoint holds 10 bytes a parameter (bf16 weights, fp32 moments), 4.1
#: GB at full depth, where (a)'s four saves and two loads took about 60 s
#: of its 67.8 s (an H100 80GB HBM3 at 700 W); over 2 layers 1.13 GB
LAUNCHER_CKPT_LAYERS = 2
#: (c): two pods stacked on the card, DiLoCo with int8 deltas
LAUNCHER_PODS = ["--mesh", "2x1x1", "--algorithm", "diloco", "--compress",
                 "--sync-period", "2", "--steps", "4"]


def _launch(argv, params=None, device=None, quiet: bool = False) -> dict:
    """``launch.train.main(argv)`` in this process (``--device`` when
    given), its output echoed (or, ``quiet``, returned as "log")."""
    import contextlib
    import io
    from repro_torch.launch import train as launcher
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = launcher.main(argv + (["--device", device] if device else []),
                            params=params)
    out["log"] = buf.getvalue()
    if not quiet:
        print("    " + out["log"].rstrip().replace("\n", "\n    "))
    return out


class _launcher_layers:
    """The launcher's ``get_arch`` over the first ``n`` layers of each arch
    (its widths unchanged) within the block."""

    def __init__(self, n: int):
        self.n = n

    def __enter__(self):
        from repro_torch.launch import train as launcher
        self.get = get = launcher.get_arch

        def cut(name):
            arch = get(name)
            return arch.replace(model=arch.model.replace(num_layers=self.n))
        launcher.get_arch = cut

    def __exit__(self, *exc):
        from repro_torch.launch import train as launcher
        launcher.get_arch = self.get


def _trees_bit_equal(a, b) -> bool:
    pa, pb = _paths(a), _paths(b)
    return len(pa) == len(pb) and all(
        x == y and _bits_equal(ta, tb) for (x, ta), (y, tb) in zip(pa, pb))


def _launcher_full_params(device: str) -> dict:
    """Full-width smollm-360m's parameters built alike on the card and the
    host (``_counter_params``), in the config's dtype; and the fp32
    sample hash that holds the two equal."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.common import DTYPES, tree_map
    cfg = get_arch(LAUNCHER_ARCH).model
    p32 = _counter_params(cfg, device)
    sample = _counter_sample(p32)
    dt = DTYPES[cfg.dtype]
    return tree_map(lambda t: t.to(dt), p32), sample


def _launcher_cpu_side() -> dict:
    """3m (d)'s full-width CPU side (in the third helper): two launcher
    steps on the CPU from the counter-built parameters."""
    import torch
    t0 = time.time()
    threads = torch.get_num_threads()
    torch.set_num_threads(LAUNCHER_CPU_THREADS)    # cores for the main one
    try:
        params, sample = _launcher_full_params("cpu")
        out = _launch([*LAUNCHER, "--steps", "2"], params, "cpu",
                      quiet=True)
    finally:
        torch.set_num_threads(threads)
    return {"losses": out["losses"], "sample": sample,
            "seconds": time.time() - t0}


def _profile_train_step(step, params, opt_state, batch) -> dict:
    """torch.profiler over one launcher train step (after ``step`` has run
    once): wall, device busy and idle share, device time by class."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step.fn(params, opt_state, batch)
        float(out[2]["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return {"wall_s": wall, "device_busy_s": "not measured"}
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
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall, "kernels": len(spans),
            "device_s_by_class": dict(sorted(by_class.items(),
                                             key=lambda kv: -kv[1]))}


def phase_train_launcher(side: "CpuSide") -> dict:
    """3m (see the module docstring): smollm-360m at full width through
    ``launch.train.main``; returns the readings, the launches and the main
    process's seconds."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_arch, get_reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.distributed import local_sgd as lsgd
    from repro_torch.distributed.step import COMM_LOG, build_train_step
    from repro_torch.launch.mesh import Mesh, make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.optim import make_optimizer
    t0 = time.time()
    arch = get_arch(LAUNCHER_ARCH)
    cfg = arch.model
    rows, seconds, steps = {}, {}, {"full": 0, "cut": 0, "reduced": 0}
    _reset_train_launches()

    # (a) resume bit for bit; the guard's checkpoint resumes
    ts = time.time()
    ckdir = ROOT / "build" / "ckpt_3m"
    shutil.rmtree(ckdir, ignore_errors=True)
    with _launcher_layers(LAUNCHER_CKPT_LAYERS):
        whole = _launch([*LAUNCHER, "--steps", "6"])
        first = _launch([*LAUNCHER, "--steps", "4", "--ckpt-dir",
                         str(ckdir)])
        guard = _launch([*LAUNCHER, "--steps", "5", "--ckpt-dir",
                         str(ckdir), "--lifetime", "0"])
        kept = ckpt.list_steps(ckdir)
        last = _launch([*LAUNCHER, "--steps", "6", "--ckpt-dir", str(ckdir)])
    steps["cut"] += 6 + 4 + 1 + 1
    shutil.rmtree(ckdir, ignore_errors=True)
    check((first["step0"], guard["step0"], last["step0"]) == (0, 4, 5),
          f"3m (a): resumed from {guard['step0']}, {last['step0']}; want 4, "
          f"5")
    check("lifetime deadline -- checkpointed" in guard["log"]
          and kept == [4, 5], f"3m (a): the guard did not checkpoint step 5 "
          f"(steps kept {kept})")
    losses = first["losses"] + guard["losses"] + last["losses"]
    check(losses == whole["losses"], f"3m (a): the resumed losses {losses} "
          f"differ from the uninterrupted run's {whole['losses']}")
    check(_trees_bit_equal(last["params"], whole["params"])
          and _trees_bit_equal(last["opt"], whole["opt"]),
          "3m (a): the resumed parameters or optimizer state differ from "
          "the uninterrupted run's")
    rows["a"] = {"losses": whole["losses"], "resumed_equal_bitwise": True,
                 "guard_kept": kept}
    del whole, first, guard, last
    torch.cuda.empty_cache()
    seconds["a"] = time.time() - ts
    print(f"  3m (a), full width over the first {LAUNCHER_CKPT_LAYERS} "
          f"layers: 6 steps = 4 + 1 (the guard's) + 1 resumed, bit for "
          f"bit; losses {rows['a']['losses']}; {seconds['a']:.1f} s")

    # (b) DDP and FSDP over a one-rank NCCL group vs no group, bit for bit
    ts = time.time()
    shape = ShapeConfig("3m", LAUNCHER_SHAPE[1], LAUNCHER_SHAPE[0], "train")
    params = build_model(arch, device="cuda", seed=0).params
    opt0 = make_optimizer(arch.train).init(params)
    batch = {k: torch.from_numpy(v).cuda() for k, v in TokenStream(
        cfg.vocab_size, seed=0).batch(*LAUNCHER_SHAPE).items()}
    lone = Mesh(("data", "model"), {"data": 1, "model": 1},
                device=torch.device("cuda"))
    store = tempfile.mkdtemp(dir=ROOT / "build")
    tb = {"setup": time.time() - ts}
    dist.init_process_group("nccl", store=dist.FileStore(
        str(Path(store) / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        tb["group_mesh"] = time.time() - ts - tb["setup"]
        for pattern in ("allreduce", "scatter_reduce"):
            a = arch.replace(train=dataclasses.replace(
                arch.train, comm_pattern=pattern))
            ref = build_train_step(a, lone, shape)
            grp = build_train_step(a, mesh, shape)
            check(ref.comm.group is None and grp.comm.group is not None,
                  "3m (b): the step's group")
            want = ref.fn(params, opt0, batch)
            COMM_LOG.clear()
            got = grp.fn(grp.shard(params), grp.shard(opt0, 1), batch)
            torch.cuda.synchronize()
            calls = {op: n for (g, op), n in COMM_LOG.items()
                     if g == "train" and op != "bytes"}
            same = (_trees_bit_equal(got[0], want[0])
                    and _trees_bit_equal(got[1], want[1])
                    and _trees_bit_equal(got[2], want[2]))
            check(same, f"3m (b): {pattern} over a one-rank NCCL group "
                        f"differs from the step without a group")
            rows[f"b_{pattern}"] = {"loss": float(got[2]["loss"]),
                                    "equal_bitwise": same,
                                    "collectives": calls}
            steps["full"] += 2
            tb[pattern] = time.time() - ts - sum(tb.values())
            if pattern == "allreduce":
                rows["profile"] = _profile_train_step(ref, params, opt0,
                                                      batch)
                steps["full"] += 1
                tb["profile"] = time.time() - ts - sum(tb.values())
            del want, got
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    del params, opt0
    torch.cuda.empty_cache()
    seconds["b"] = time.time() - ts
    print(f"  3m (b): allreduce and scatter_reduce over a one-rank NCCL "
          f"group equal the steps without one bit for bit: "
          + json.dumps({k: v for k, v in rows.items() if k.startswith("b_")})
          + f"; one step profiled: {json.dumps(rows['profile'])}; "
          f"{seconds['b']:.1f} s ({json.dumps(tb)})")

    # (c) two stacked pods, DiLoCo with int8 deltas
    ts = time.time()
    outer_reads = []
    build = lsgd.build_local_sgd

    def reading(*args, **kw):
        ls = build(*args, **kw)
        outer = ls.outer_fn

        def read_outer(params_st, state):
            new_p, new_s = outer(params_st, state)
            leaves = [x for _p, x in _paths(new_p)]
            res = [x for _p, x in _paths(new_s["residual"])]
            outer_reads.append({
                "replicas_equal": all(bool(torch.equal(x[0], x[1]))
                                      for x in leaves),
                "residual_leaves_nonzero": sum(bool(r.abs().max() > 0)
                                               for r in res),
                "leaves": len(res)})
            return new_p, new_s
        ls.outer_fn = read_outer
        return ls

    lsgd.build_local_sgd = reading
    try:
        pods = _launch([*LAUNCHER, *LAUNCHER_PODS])
    finally:
        lsgd.build_local_sgd = build
    steps["full"] += 4 * 2
    check(len(outer_reads) == 2 and all(
        r["replicas_equal"] and 2 * r["residual_leaves_nonzero"] > r["leaves"]
        for r in outer_reads), f"3m (c): after the outer steps {outer_reads}")
    check(all(x == x for pl in pods["pod_losses"] for x in pl),
          "3m (c): a pod's loss is not finite")
    rows["c"] = {"pod_losses": pods["pod_losses"], "outer": outer_reads}
    del pods
    torch.cuda.empty_cache()
    seconds["c"] = time.time() - ts
    print(f"  3m (c): {json.dumps(rows['c'])}; {seconds['c']:.1f} s")

    # (d) card vs CPU: the reduced config's runs, one full-width step
    ts = time.time()
    reduced = get_reduced(LAUNCHER_ARCH)
    rp = build_model(reduced, device="cpu", seed=0).params
    gaps = {}
    rtol = LAUNCHER_CPU_RTOL[reduced.model.dtype]
    for name, argv, n in (("reduced", ["--steps", "6"], 6),
                          ("reduced_pods", LAUNCHER_PODS, 8)):
        argv = ["--reduced", *LAUNCHER[:2], "--log-every", "1",
                "--batch", "8", "--seq", "128"] + (
            ["--mesh", "1x1"] if name == "reduced" else []) + argv
        card = _launch(argv, tree_map(lambda t: t.cuda(), rp), quiet=True)
        host = _launch(argv, rp, "cpu", quiet=True)
        key = "pod_losses" if name == "reduced_pods" else "losses"
        a, b = (torch.tensor(card[key], dtype=torch.float64),
                torch.tensor(host[key], dtype=torch.float64))
        gaps[name] = float(((a - b).abs() / b.abs()).max())
        check(gaps[name] <= rtol, f"3m (d): {name} card vs CPU losses part "
                                  f"by {gaps[name]:.3e} > {rtol:g}")
        steps["reduced"] += n
    params, sample = _launcher_full_params("cuda")
    full = _launch([*LAUNCHER, "--steps", "2"], params)
    steps["full"] += 2
    del params
    torch.cuda.empty_cache()
    cpu = side.part(".3m")
    check(cpu["sample"] == sample, "3m (d): the helper's counter-built "
                                   "parameters differ from the card's")
    rtol = LAUNCHER_CPU_RTOL[cfg.dtype]
    gaps["full"] = max(abs(a - b) / abs(b) for a, b in zip(full["losses"],
                                                          cpu["losses"]))
    check(gaps["full"] <= rtol, f"3m (d): full-width launcher losses card "
                                f"{full['losses']} vs CPU {cpu['losses']}")
    rows["d"] = {"rel_gaps": gaps, "full_losses": full["losses"],
                 "full_cpu_losses": cpu["losses"],
                 "cpu_side_s": cpu["seconds"]}
    seconds["d"] = time.time() - ts
    print(f"  3m (d): card vs CPU {json.dumps(rows['d'])}; "
          f"{seconds['d']:.1f} s")

    # (e) launches: every step's flash forward and backward
    launches = _train_launches()
    want = _want_train_launches(cfg, steps["full"], 0)
    _add(want, _want_train_launches(cfg.replace(
        num_layers=LAUNCHER_CKPT_LAYERS), steps["cut"], 0))
    _add(want, _want_train_launches(reduced.model, steps["reduced"], 0))
    for name in ("flash_attention", "flash_attention_bwd"):
        check(launches[name] == want[name],
              f"3m (e): {name} launched {launches[name]} times, want "
              f"{want[name]} ({steps} steps)")
    seconds["main"] = time.time() - t0
    print(f"  3m: {seconds['main']:.1f} s of the main process; launches "
          + json.dumps({k: launches[k] for k in ("flash_attention",
                                                 "flash_attention_bwd")}))
    return {"runs": rows, "launches": launches, "seconds": seconds,
            "steps": steps}


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
#: the gradient of flash attention: the JAX package has no backward Pallas
#: kernel (its models differentiate the jnp attention, ``_sdpa``)
BWD_KERNEL = ("flash_attention_bwd",
              "src/repro_torch/csrc/flash_attention_bwd.cu",
              "src/repro/models/attention.py:56")
#: the gradient of the SSD scan: the JAX package has no backward Pallas
#: kernel (its models differentiate the jnp scan)
SSD_BWD_KERNEL = ("ssd_scan_bwd", "src/repro_torch/csrc/ssd_scan_bwd.cu",
                  "src/repro/models/ssm.py:59")
PATH_KERNELS = ("quantize8_ef", "topk_ef")


def main() -> int:
    t0 = time.time()

    def phase(name: str) -> None:
        print(f"phase {name} (at {time.time() - t0:.1f} s)")

    phase("1: device")
    require_card()
    # its CPU sides beside the build, while the host's memory is free
    vlm_side = CpuSide("--cpu-side-vlm", "cpu_side_vlm")
    sides = [vlm_side]
    try:
        card = phase_device()
        helper = CpuSide(after=vlm_side)
        sides.append(helper)
        moe_helper = CpuSide("--cpu-side-moe", "cpu_side_moe", after=helper)
        sides.append(moe_helper)
        return _phases(t0, phase, card, helper, moe_helper, vlm_side)
    finally:
        for side in sides:
            side.stop()


def _phases(t0, phase, card, helper, moe_helper, vlm_side) -> int:
    import torch
    phase("2: kernels")
    kern = phase_kernels()
    attn = phase_attention_kernels()
    bwd = phase_flash_bwd()
    bwd_wide = phase_flash_bwd_wide()
    vlm_enc = phase_vlm_encoder_kernels()
    attn_bf16 = phase_attention_bf16()
    fp32_bits = attention_fp32_sha256()
    check(fp32_bits == ATTN_FP32_SHA256_PARENT,
          "the attention kernels' fp32 outputs differ from the bits of the "
          "kernels before the bf16 repair (ATTN_FP32_SHA256_PARENT)")
    bf16_bits = flash_bf16_sha256()
    check(bf16_bits == ATTN_BF16_SHA256_PARENT,
          "flash attention's bf16 outputs differ from the bits of the kernel "
          "before the widening (ATTN_BF16_SHA256_PARENT)")
    bwd_bf16_bits = flash_bwd_bf16_sha256()
    check(bwd_bf16_bits == FLASH_BWD_BF16_SHA256_PARENT,
          "flash attention's backward bf16 outputs differ from the bits of "
          "the kernel before its widening (FLASH_BWD_BF16_SHA256_PARENT)")
    ssd = phase_ssd_kernel()
    ssd_bwd = phase_ssd_bwd()
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
    phase("3k, 3l: the vlm group's and hubert-xlarge's card sides (the third "
          "helper's; its CPU sides ran beside phases 1-3c)")
    slot = phase_vlm_encoder_slot(vlm_side)
    phase("3d: serve")
    serve = phase_serve()
    print(json.dumps({"serve": serve}))
    phase("3e: serve mamba2-370m and zamba2-2.7b")
    serve_ssm = phase_serve_ssm()
    print(json.dumps({"serve_ssm": serve_ssm}))
    phase("3f: elastic, planner and CLI")
    elastic = phase_elastic(preset)
    print(json.dumps({"elastic": elastic}))
    phase("3g: train smollm-360m")
    moe_helper.go()                # its card work beside 3g and 3h
    train = phase_train(helper)
    print(json.dumps({"train": {k: v for k, v in train.items()
                                if k != "full"}}))
    phase("3h: train mamba2-370m and zamba2-2.7b")
    train_ssm = phase_train_ssm(helper, moe_helper)
    print(json.dumps({"train_ssm": {k: v for k, v in train_ssm.items()
                                    if k != "full"}}))
    phase("3j: train the MoE family (the card's gradients; their CPU sides "
          "beside 3i)")
    moe_b = phase_train_moe_card()
    phase("3i: serve the MoE family")
    serve_moe = phase_serve_moe()
    print(json.dumps({"serve_moe": serve_moe}))
    phase("3j: train the MoE family (held)")
    train_moe = phase_train_moe(moe_helper, moe_b)
    print(json.dumps({"train_moe": train_moe}))
    phase("3k: llama-3.2-vision-90b, the vlm family (a)-(d)")
    vlm = phase_vlm()
    phase("3k, 3l: held (the third helper's CPU work on the card's results)")
    t_held = time.time()
    held = vlm_side.result()
    encoder = slot["encoder"]
    _add(vlm["launches"], slot["vlm"]["launches"])
    main_s = slot["main_s"] + vlm["seconds"] + time.time() - t_held
    print(f"  3k + 3l: {main_s:.1f} s of the main process (the slot "
          f"{slot['main_s']:.1f} s, {slot['waited_s']:.1f} s of it waiting "
          f"for the helper's CPU sides; (a)-(d) {vlm['seconds']:.1f} s; the "
          f"hold {time.time() - t_held:.1f} s, waited {held['waited_s']:.1f} "
          f"s)")
    print(json.dumps({"encoder": {k: encoder[k] for k in (
        "runs", "forward_s", "launches", "update_ms", "card_s")},
        "encoder_held": held["encoder_held"],
        "vlm": {"runs": {**vlm["runs"], **slot["vlm"]["runs"]},
                "launches": vlm["launches"], "seconds": vlm["seconds"]},
        "seconds": {"main": main_s, "slot": slot["main_s"],
                    "slot_waited": slot["waited_s"],
                    "helper": held["seconds"]}}))
    phase("3m: train smollm-360m through the launcher")
    launcher = phase_train_launcher(vlm_side)
    print(json.dumps({"train_launcher": {k: launcher[k] for k in (
        "runs", "seconds", "steps")}}))
    trained = {k: train["launches"].get(k, 0) + train_ssm["launches"].get(k, 0)
               + train_moe["launches"].get(k, 0)
               + encoder["launches"].get(k, 0)
               + vlm["launches"].get(k, 0)
               + launcher["launches"].get(k, 0)
               for k in train_ssm["launches"]}
    launches["quantize8_ef"] = launches.get("quantize8_ef", 0) \
        + elastic["launches"] + trained["quantize8_ef"]
    serve_launches = {k: serve["launches"][k] + serve_ssm["launches"][k]
                      + serve_moe["launches"][k] for k in serve["launches"]}
    for name in ("flash_attention", "decode_attention", "ssd_scan"):
        check(serve_launches[name] > 0,
              f"{name} never launched on the serving path")
    for name in ("flash_attention", "flash_attention_bwd"):
        check(encoder["launches"].get(name, 0) > 0,
              f"{name} never launched on 3l's path")
    for name in ("flash_attention", "flash_attention_bwd", "decode_attention"):
        check(vlm["launches"].get(name, 0) > 0,
              f"{name} never launched on 3k's path")
    serve_launches["decode_attention"] += vlm["launches"]["decode_attention"]
    serve_launches["flash_attention"] += trained["flash_attention"]
    serve_launches["ssd_scan"] += trained["ssd_scan"]
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
                                        "launch_us", "vs_float64", "shapes",
                                        "bf16_vs_plain", "mla", "grok")
                    if k in row},
                 **({"ptxas": PTXAS} if name == "flash_attention" else {}),
                 "bf16_rows": ([r["forward"] | {"shape": r["shape"]}
                                for r in attn_bf16["flash"]]
                               if name == "flash_attention"
                               else attn_bf16["decode"]),
                 "vlm_encoder": vlm_enc["flash" if name == "flash_attention"
                                        else "decode"],
                 "fp32_sha256": fp32_bits[name],
                 **({"bf16_sha256": bf16_bits}
                    if name == "flash_attention" else {}),
                 "held_against_plain": True}
        summary.append(entry)
        print(f"  {name:16s} held within {ATTN_TOL[name]} of its plain "
              f"version; ms={entry['ms']:.5f} bound_ms="
              f"{entry['bound_ms']:.5f} plain_ms={entry['plain_ms']:.5f} "
              f"library_ms={entry['library_ms']:.5f} "
              f"launches_on_path={entry['launches']}")
    name, source, replaces = BWD_KERNEL
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces,
             "replaces_note": "no TPU kernel: the gradient of _sdpa's jnp "
                              "attention",
             "launches": trained["flash_attention_bwd"],
             **{k: bwd[k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "shape", "library", "bound_fp32_ms",
                 "bytes_bound_ms", "fwd_bwd_ms", "plain_fwd_bwd_ms",
                 "library_fwd_bwd_ms", "timed_max_abs_err", "vs_float64",
                 "launch_us", "sweep_rel_err", "vs_float64_seeded",
                 "shapes")},
             "bf16_rows": [r["backward"] | {"shape": r["shape"]}
                           for r in attn_bf16["flash"]],
             "fp32_sha256": fp32_bits[name], "bf16_sha256": bwd_bf16_bits,
             "wide": {"shape": bwd_wide["float32"]["shape"],
                      **{k: bwd_wide["float32"][k] for k in (
                          "ms", "plain_ms", "bound_ms", "bound_by",
                          "bound_fp32_ms", "bytes_bound_ms", "library_ms",
                          "library", "max_abs_err", "vs_float64",
                          "fwd_bwd_ms", "plain_fwd_bwd_ms",
                          "library_fwd_bwd_ms", "launch_us")},
                      "bfloat16": bwd_wide["bfloat16"]["backward"]
                      | {"shape": bwd_wide["bfloat16"]["shape"]},
                      "rows": bwd_wide["rows"],
                      "witness": bwd_wide["witness"],
                      "worst_rel": bwd_wide["worst_rel"],
                      "gradient": bwd_wide["gradient"]},
             "ptxas": PTXAS_BWD,
             "vlm_encoder": vlm_enc["flash_bwd"],
             "held_against_plain": True}
    summary.append(entry)
    print(f"  {name:16s} held within {FLASH_BWD_TOL} of its plain version; "
          f"ms={entry['ms']:.5f} bound_ms={entry['bound_ms']:.5f} "
          f"plain_ms={entry['plain_ms']:.5f} "
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
    name, source, replaces = SSD_BWD_KERNEL
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces,
             "replaces_note": "no TPU kernel: the gradient of the jnp scan",
             "launches": trained["ssd_scan_bwd"],
             **{k: ssd_bwd[k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "shape", "library", "bound_fp32_ms",
                 "bytes_bound_ms", "fwd_bwd_ms", "plain_fwd_bwd_ms",
                 "vs_float64", "launch_us", "max_rel_err_bf16",
                 "max_norm_rel_bf16", "min_planted_norm_rel_bf16",
                 "forward_bf16_rel_err", "timed")},
             "max_abs_err_note": "relative to each gradient's largest plain "
                                 "|g|, fp32",
             "held_against_plain": True}
    summary.append(entry)
    print(f"  {name:16s} held within {SSD_BWD_TOL} of its plain version; "
          f"ms={entry['ms']:.5f} bound_ms={entry['bound_ms']:.5f} "
          f"plain_ms={entry['plain_ms']:.5f} library_ms=none "
          f"launches_on_path={entry['launches']}")
    print(json.dumps({"kernels": summary}))
    print(f"total: {time.time() - t0:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cpu-side"]:
        raise SystemExit(cpu_side(Path(sys.argv[2]), Path(sys.argv[3])))
    if sys.argv[1:2] == ["--cpu-side-moe"]:
        raise SystemExit(cpu_side_moe(Path(sys.argv[2]), Path(sys.argv[3])))
    if sys.argv[1:2] == ["--cpu-side-vlm"]:
        raise SystemExit(cpu_side_vlm(Path(sys.argv[2])))
    raise SystemExit(main())
