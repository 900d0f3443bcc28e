#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

It builds every kernel of the port from ``src/repro_torch/csrc`` (one nvcc
per source, in parallel) and drives the port's paths: dense BLAS-3 and
blocked LAPACK through ``repro_torch.linalg`` at n = 8192, QR, least
squares, the batched drivers and level 1, the tuning loop (sweep,
registry, tuned dispatch, calibration), the model zoo serving
hymba-1.5b, internvl2-1b and whisper-small at full width and qwen3-moe
at full width with 4 of its 94 layers, the trainer taking hymba-1.5b's
steps at full width, the paper's own apparatus (figs 12-13 on the PE
scoreboard kernel, the quickstart's codesigned kernels), and the
paper's workload on a mesh of SPMD ranks (SUMMA and the batch-sharded
drivers through ``linalg.use(mesh=...)``), and the trainer on a mesh
(ZeRO-sharded state, elastic restore, a pipeline, sharded decode). Phases,
each printing JSON lines with its wall time:

1. ``probe``: the card, its power limit, capability 9.0, TF32 off, the
   kernel build.
2. ``kernels``: each CUDA kernel against its plain PyTorch version on the
   card, at ragged shapes and at the main path's shapes, each with its
   stated tolerance (B5 and B6 elementwise and normwise, scaled by each
   value and the output's rms); every compiled CTA tile of B1's tiled
   variants and B3, handed over in an ``h100`` plan, at an aligned shape,
   a ragged one and the tune phase's 4096^3; the FPU-chain probe bitwise,
   per op class, at the calibration's chain length; B6's three
   passes' f32 scratch against ``ssd_scan_passes``, B4 on contiguous,
   offset-by-one and strided views, and two calls of each bitwise equal;
   B5 in bf16 at the model families' own forms (``FAMILY_ATTN_CHECKS``).
3. ``main``: under the card's machine (``h100``; the phase prints it and
   the plans it resolves: panel widths, GEMM tiles, the TRSM block, fused
   or not per trailing update) ``gemm`` (8192^3 f32 and bf16, 4096^3
   f64), ``gemm_bias_act`` (8192^3, gelu), ``cholesky`` / ``lu`` /
   ``solve`` at 8192 f32 and ``cholesky`` at 4096 f64 under
   ``policy="model"``, then a cold-start ``policy="tuned"`` leg that must
   equal the model results bitwise. Every trailing update must fuse onto
   B2. The kernels' launch counts are zeroed just before and read just
   after; each kernel must have launched, B2 once per trailing update and
   B1's "gemv" once per TRSM update, both counts derived from the plans. Residuals are checked. Then one
   device-only profile each of cholesky, lu and solve at 8192 under
   ``h100`` and again under ``linalg.use(machine="tpu-like")``, the two
   pricings side by side (device-busy ms, wall s).
4. ``lapack``: under ``h100`` and ``policy="model"``, each call with the
   launch counts zeroed just before and read just after, against the
   counts its plan implies: ``linalg.qr`` at 8192 f32 and 4096 f64 (B1
   twice per panel with trailing columns, all on the tiled variant; Q's
   orthogonality and A - QR checked in f64), one device-only profile of the
   8192 call, a cold-start ``tuned`` QR at 4096 f32 bitwise the model's;
   ``linalg.lstsq`` 8192 x 4096 f32 with 16 right-hand sides against the
   f64 solution; ``batched_cholesky`` / ``batched_lu`` of 64 x 512 f32,
   ``batched_qr`` of 64 x 512 x 256 and their ``batched_solve`` with 8
   right-hand sides, each in lockstep: B2 three times for the whole batch,
   B1 twice per QR step, B1 ``gemv`` once per TRSM update (the per-item
   loop launched 64 times as many), each call's seconds and device-busy ms
   beside the loop's (``BATCHED_LOOP_S``); before them each batched
   kernel launch held bitwise, item by item, to the 2-D launch on that
   item (B1 ``ffma`` at the first QR step's V^T C, ``dmma`` f64 at a
   ragged m read through a row window, ``gemv`` at a solve's TRSM update,
   B2 ``syrk`` and ``lu`` at the first trailing updates), the first two
   timed beside their bound, ``torch.bmm`` and the per-item loop of 2-D
   launches (``batched_rows``); the level-1 routines at n = 2^26 f32
   against f64 (none
   launches a kernel of the port), ms per call beside the bytes bound; and
   a traced 4096 f32 QR written by both exporters and read back.
   Then ``linalg3d``, a short phase of its own: the 3-D ``linalg`` BLAS
   calls at 64 items (``LINALG3D_CALLS``: ``gemm`` f32 512^3, bf16
   1024^3, f64 256^3, ``gemm_bias_act`` f32 512^3 gelu + bias, ``syrk``
   512 x 512, ``trsm`` 512 x 128, ``gemv`` 512 x 512), each counted on its
   own against its plan (one B1 or B3 launch per GEMM-shaped step for the
   whole batch), each item bitwise the 2-D call on it (``trsm`` within the
   f32 tolerance: its diagonal blocks are eager PyTorch), its seconds (the
   median of 3 warm calls) beside the per-item loop of 2-D calls; the
   batched ``wgmma`` (64 x 1024^3 bf16) and B3 (64 x 512^3 f32) rows
   against their plain versions, ``torch.bmm`` / ``torch.baddbmm`` +
   ``gelu`` and their bounds; and ``examples/torch/quickstart.py`` and
   ``factorization_demo.py`` run on the card at their default sizes, their
   exit codes checked.
5. ``tune``: with the launch counts zeroed, ``tune_gemm`` at 4096^3 in
   f32, bf16 and f64 into a temporary registry (each candidate's tile,
   median, spread, modeled seconds and residual), a ``linalg.gemm`` under
   ``policy="tuned"`` that must hit the registry and launch the winner's
   tile, ``tune_fused_gemm`` at 4096^3, and ``arch.calibrate`` on the card
   at its default sizes (``calibrated-cuda`` beside ``h100``'s datasheet
   numbers, the cycles
   per dependent op of each class from the chain kernel).
6. ``model``: hymba-1.5b (32 layers, d_model 1600) built on the card from
   seed 0, one untimed prefill of 2 x 4096 tokens (set-up), then a warm
   ``model_zoo.prefill`` of 2 x 4096 other tokens with the launch counts
   zeroed just before and read just after (B5 and B6 must launch once per
   layer), then ``serve_batch`` of 4 requests (its prefill counted the
   same way), one profiled prefill (device-busy time, the top kernels and
   B6's three ``ssd_`` kernels summed) and decode step, then a reduced
   hybrid model's ``forward`` on the card against its CPU (plain) route.
7. ``families``: internvl2-1b (vlm, 24 layers, d_model 896) and
   whisper-small (encdec, 12 + 12 layers, d_model 768) at full width, and
   qwen3-moe-235b-a22b at full width cut to 4 of its 94 layers (d_model
   4096, 128 experts top 8; 44.8 GB of f32 parameters), one at a time,
   each built on the card from seed 0 (init s, parameters, bytes, peak
   memory after its prefill), an untimed set-up prefill, then a warm
   ``model_zoo.prefill`` with the launch counts zeroed just before and
   read just after: B5 24 / 36 / 4 times, all ``wgmma``, and no other
   kernel (internvl2: 2 x (256 patches + 3840 tokens); whisper: 4 x (1500
   frames, 448 tokens); qwen3-moe: 2 x 4096 tokens), one device-only
   profile of each, then ``serve_batch`` of 4 requests (internvl2,
   qwen3-moe) or whisper's caches from the memory, 32 prompt tokens
   replayed and 32 greedy ``decode_step``s, each with its decode tokens/s.
   Then reduced moe (capacity factors 1.25 and 0.5), vlm and encdec
   models' ``forward`` on the card against the CPU, and each moe forward
   twice on the card, bitwise equal.
8. ``train``: hymba-1.5b at full width (1.64B parameters; f32 masters,
   grads, m and v: 26.3 GB) from ``train_state.init_state`` on the card,
   ``make_train_step`` (the plain oracles under autograd, as the
   reference's ``use_pallas=False``; remat ``full``; the reference
   ``main()``'s AdamW) on ``make_batch``'s 2 x 4096 tokens: one untimed
   step, ``TRAIN_TIMED`` timed ones (finite loss and grad norm above 0,
   ``lr`` equal to ``schedule``, the parameters moved), the launch counts
   zeroed before and read after (B1-B8: 0), seconds per step, tokens/s,
   peak memory and the bound; one device-only profile of a step. Then
   reduced hybrid and dense models (f32, the dense one in 2 microbatches)
   3 steps on the card against the CPU from one state, with f32 and 8-bit
   moments (``TRAIN_TOL``), the remat policies' loss and gradients on the
   card, and ``train_loop`` failed at step 7 and restarted by
   ``run_with_restarts`` from its checkpoint: the resumed losses against
   an uninterrupted run, the last checkpoint restored bitwise.
9. ``paper``: with the launch counts zeroed just before and read just
   after, figs 12-13 at the paper's n = 100 through ``core.pe``
   (``sweep_joint`` of dgemm, dgeqrf and dgetrf over the adder and
   multiplier, of dgeqrf and dgetrf over sqrt and divider, depths 2-24:
   one B8 launch each), section 5's DOT4 against scalar dgemm at mul 5 /
   add 4 (two ``simulate``), and the quickstart's steps 4-5 (B4 at n =
   4096 with U* accumulators, B1 on ``plan_gemm(2048, 2048, 2048)``'s
   tile); exactly 7 B8, 1 B4 and 1 B1 launches. Then every B8 result held
   exactly to its plain version (two depths per sweep at n = 100, all of
   fig 12's dgemm, every sweep in full at n = 48), B4 and B1 to theirs,
   and per sweep CPI, TPI, the best depth by TPI beside the eq.-7 depths
   of its section-4 profile, and B8's ms (the mean of 5 launches) with
   its cycles a step beside the bound's.
10. ``mesh``: the paper's workload on a mesh, each rank a spawned process
   (the kernels already built). A (1, 1) mesh on one NCCL rank: ``gemm``
   8192^3 f32 under ``use(mesh=(1, 1))`` is one B1 launch with zero hops,
   bitwise the single-device ``gemm``, and a cold-start ``tuned`` call
   bitwise the ``model`` one. Then four gloo ranks sharing the card (NCCL
   refuses two ranks on one card; each panel crosses through pinned host
   memory): under ``use(mesh=(2, 2))`` ``gemm`` 8192^3 f32 and 4096^3 f64
   (4 B1 launches a rank on the resolved local tile, ``collective.bytes``
   equal to ``plan_pdgemm``'s), ``syrk`` 8192, ``trsm`` 8192 with 512
   right-hand sides, the batched drivers and their solves at the lapack
   phase's sizes and ``batched_cholesky`` at a ragged 62 (one identity
   pad record), each held to the single-device result (a batched rank
   checks the next rank's slab, and its launches equal the single-device
   call's), and rank 0 holds B1 at the mesh path's own operands against
   the plain version: one SUMMA step's strided panels (f32 and f64) and
   every off-diagonal update of its trsm slab; ``compressed_grad_sync`` on one hymba-1.5b layer over a
   4-rank "pod" axis, two steps with error feedback (the ranks' means
   bitwise equal, within the int8 bound of the plain mean); and
   ``sharded_decode_attention`` at hymba-1.5b's decode shapes over a
   4-rank "model" axis with ragged per-row lengths (1e-5 of max|f64
   attention|). Every leg's seconds beside ``plan_pdgemm``'s terms, with
   ``MESH_NOTE``: not a scaling number.
11. ``shard``: the trainer on a mesh. hymba-1.5b as registered cut to
   ``SHARD_LAYERS`` layers (f32 compute), ``TRAIN_AGREE_STEPS`` steps on
   one device here; a probe of DTensor's own all-gather, reduce-scatter
   and all-to-all on card tensors over gloo (a spawned group each, since
   one may kill its ranks); then four spawned gloo ranks sharing the
   card on a (data, model) = ``SHARD_MESH`` mesh of the card's device
   type: the route's staged collectives, the state placed at
   ``state_specs`` (each rank's bytes equal to the specs'), 1 +
   ``SHARD_TIMED`` sharded steps on ``TRAIN``'s tokens (each rank its
   rows, the products tensor-parallel over "model"; 0 kernel launches),
   held after ``TRAIN_AGREE_STEPS`` to the one-device run within
   ``TRAIN_TOL`` (metrics) and ``SHARD_PARAM_TOL`` (every parameter
   block; the one-device run's last update, what a dropped one would
   leave, printed beside it), seconds a step, peak memory and the step's
   ``collective.bytes`` / ``shard.redistribute_bytes`` (by op; mamba's,
   which runs by head as its 50 SSM heads divide model 2, exactly
   ``mamba in_proj columns``: the rank's heads' columns of in_proj
   gathered in the forward and remat's recompute, reduce-scattered back)
   and the TP all-reduces' share (``shard.tp_all_reduce_bytes``); the (2, 2)
   checkpoint restored onto (4, 1) and onto one device, bitwise, at the
   new specs; ``train_loop`` on the debug mesh failed at step 7 and
   restarted (within 1e-4 of the uninterrupted run); four pipeline stages
   of blocks 0-3 (bf16, the kernels on) over ``SHARD_MICRO``
   microbatches, 8 B5 and 8 B6 launches a rank, bitwise the blocks in
   order; and ``sharding.decode_step`` with parameters at
   ``params_specs`` and f32 caches at ``cache_specs`` within
   ``SHARD_DECODE_TOL`` of one device: flash-decoding on each rank's
   block of the caches' sequence and mamba on each rank's 25 SSM heads
   against its block of the state, each cache leaf the spec's block on
   each rank, a step's ``collective.bytes`` and each decode op's bytes
   (``decode q``, ``decode kv token``, ``decode combine``: obs events, to
   the byte), no cache leaf gathered (``decode caches`` and ``decode ssm
   state`` at 0 bytes), mamba's one redistribution its ``in_proj``
   output of one token (``mamba in_proj output``, to the byte); then
   ``sharding.prefill`` of ``TRAIN``'s tokens on the 4-layer model (f32,
   the kernels on), each SSM layer's scan B6 on the rank's 25 heads (4
   launches a rank) and attention's core whole (25 heads: 4 B5 ``ffma``
   launches a rank), each rank's logits within ``SHARD_MOE_TOL`` of the
   one-device prefill, the first layer's B6 output bitwise heads [lo, hi)
   of a 50-head launch on the same inputs, and on rank 0 B6's and B5's
   times at the leg's shapes beside their plain versions and bounds, the
   leg's seconds printed. The first sharded
   step runs inside ``record_transport()`` and an obs trace (its backward on
   autograd's device thread): its "model" all-reduces are TP's, equal to
   ``shard.tp_all_reduce_bytes``, and the grad norm's scalar, its gathers
   over "data" each block's leaves twice (remat's recompute) and the
   root's once, and its ``shard.redistribute`` events, backward's and
   recompute's included, carry ``shard.redistribute_bytes``. Then the moe
   with its experts split over "model" in E, each DP rank multiplying its
   window of the capacity slots exchanged over "data": (a) the families
   phase's reduced moe at capacity factors ``SHARD_MOE_FACTORS`` (0.5
   drops assignments), ``TRAIN_AGREE_STEPS`` steps held to one device
   within ``TRAIN_TOL`` / ``SHARD_PARAM_TOL``, each step's
   ``shard.expert_exchange_bytes`` equal to the exchange's size to the
   byte; (b) qwen3-moe at full width cut to ``SHARD_MOE_LAYERS`` layers
   (f32, about 25 GB, built on the card by one rank at a time), a
   ``sharding.prefill`` of ``SHARD_MOE_PREFILL`` tokens, each rank's
   logits within ``SHARD_MOE_TOL`` of the one-device prefill of the same
   weights and its expert products' flops exactly a quarter of one
   device's. Rows carry ``SHARD_NOTE``: not a scaling number.
12. ``analysis``: ``repro_torch.analysis`` on the card. The Python
   counterparts of what a launch asks the card - the SM count, B2's
   co-resident CTAs at every shared-memory size its plans take, B4's
   resident CTAs per SM, B6's shared memory per pass - held to the card's
   and the C functions' answers, exactly. ``gemm`` 8192^3 f32, ``cholesky``
   8192 f32, ``qr`` 2048 f32, one hymba-1.5b prefill (``PREFILL``) and the
   three batched drivers at the lapack phase's sizes (``ANALYSIS_BATCHED``)
   run for real under ``record_launches`` and traced on fake CUDA tensors
   (the large fake traces in the worker pool); the records must agree
   kernel by kernel (variant, tile, grid with the batch, shared memory).
   Then the whole
   surface grid on the card route (``ANALYSIS_WORKERS`` processes for the
   fake-traced no-mesh legs, 8 gloo ranks on the card for the mesh legs
   and ``pdgemm`` / ``pdtrsm``) and the BY001 lint, with the committed
   allowlists: no unsuppressed error; its seconds and its counts of
   cases, findings and suppressions.
13. ``dryrun``: ``repro_torch.launch.dryrun`` (host only: fake tensors in
   a fake world, no launch), three spawned children at once, each held to
   what the card measured earlier in this run: (a) hymba-1.5b's
   ``train_4k`` step cut to ``TRAIN``'s tokens on a (1, 1) fake world,
   its peak within ``DRYRUN_MEM_TOL`` of the train phase's
   ``max_memory_allocated`` and its flops at or above that phase's bound;
   (b) the shard phase's cell (``shard_cfg()`` on (data 2, model 2)): rank
   0's ``collective.bytes``, ``shard.redistribute_bytes`` and
   ``shard.tp_all_reduce_bytes`` a step equal
   to the live rank 0's, its state bytes to the live ``spec_bytes``, its
   peak within ``DRYRUN_MEM_TOL`` of the live rank's; (c) hymba-1.5b
   ``train_4k`` on the ``pod`` mesh (a fake world of 256): its row and
   its trace seconds, beside the ZeRO-3 route's row (``DRYRUN_POD_ZERO3``);
   (d) the shard phase's decode step (``shard_cfg()``, ``SHARD_DECODE``'s
   batch and cache length, on a fake world of 4): its
   ``collective.bytes``, ``shard.redistribute_bytes`` and
   ``shard.decode_bytes`` equal to the live rank 0's a step.
14. ``times``: each kernel at its path's shapes against its plain version,
   a library call and its roofline bound: B1 at every compiled tile, B2
   at five trailing updates the drivers launch beside the two-call
   ``solve_triangular`` + ``addmm``, B1's "gemv" at the TRSM update in
   three dtypes (CUDA-graph replay: its wrapper's host time exceeds the
   kernels'), the FPU-chain probe per class, B4 against ``torch.dot`` in
   20 alternating turns, B6 at the prefill shape by CUDA-graph replay (its
   three launches per call) and by the profiler's device ms per call;
   B8's row comes from the paper phase; B5 at the families' forms last.

Then one ``{"kernels": [...]}`` line (the first row of each kernel's
name, then the batched ``wgmma`` and B3 rows), the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; without a CUDA card, or without the rest of the checkout,
it exits non-zero before printing any result.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

SEED = 0
N = 8192
N64 = 4096
# H100 SXM datasheet peaks (dense): FP32 non-tensor, FP64 tensor, bf16
# tensor, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12,
              torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12
# max|kernel - plain| <= TOL * max|plain|, with the reason
TOL = {torch.float32: (2e-4, "f32 sums in another order (both IEEE FFMA, "
                             "no TF32); the f32 rtol of tests/conftest.py"),
       torch.float64: (1e-12, "f64 sums in another order; the f64 rtol of "
                              "tests/conftest.py"),
       torch.bfloat16: (5e-2, "f32 accumulation rounded once to bf16 "
                              "(2^-8 relative); the bf16 rtol of "
                              "tests/conftest.py")}
# B5 and B6 outputs, elementwise |kernel_i - plain_i| <= rtol * |plain_i|
# + atol * rms(plain) and normwise |kernel - plain| <= norm * |plain|:
# (rtol, atol, norm, reason). A typical value, not the largest, sets the
# scale, so a dropped or misplaced key block fails on any row it touches.
CLOSE_TOL = {
    torch.float32: (2e-4, 2e-4, 2e-4, "f32 sums in another order; the f32 "
                                      "rtol of tests/conftest.py"),
    torch.bfloat16: (2 ** -7, 1e-2, 1e-2,
                     "both sides round one f32 value to bf16 once, so they "
                     "differ by at most one bf16 step (<= 2^-7 |plain|); "
                     "atol covers f32 reordering near zero")}
ROOT = os.path.dirname(os.path.abspath(__file__))
PREFILL = (2, 4096)            # batch x tokens of the model phase's prefill
# the model phase's hybrid agreement check: max|dlogits| / max|logits|
MODEL_TOL = (2e-4, "f32 on both sides; the card's kernels sum in another "
                   "order than the CPU oracles (the f32 rtol of "
                   "tests/conftest.py)")
# the families phase: full-width configs, each prefill's (batch, tokens)
# and the B5 launches it must make, all on wgmma; qwen3-moe is cut to 4 of
# its 94 layers (its f32 parameters: 44.8 GB for 4 layers, 1.05 TB for 94)
FAMILY_VLM = ("internvl2-1b", (2, 3840), 24)       # + 256 patches each
FAMILY_ENCDEC = ("whisper-small", (4, 448), 36)    # + 1500 frames each
FAMILY_MOE = ("qwen3-moe-235b-a22b", (2, 4096), 4)
MOE_LAYERS = 4
FAMILY_NEW = 32                # new tokens per request / decode steps
# the train phase: hymba-1.5b at full width, its steps' (batch, tokens),
# the timed steps after one untimed, and the reference main()'s AdamW
# settings at its default 100 steps (lr 3e-4, warmup max(100 // 20, 5));
# then reduced hybrid and dense models (3 layers, d_model 256, 4 heads,
# vocab 512, f32; the hybrid's window 128 so its local layers take the
# banded oracle) at 2 x TRAIN_SMALL_SEQ tokens, at the CPU tests' lr
TRAIN = (2, 4096)
TRAIN_TIMED = 4
TRAIN_OPT = dict(lr=3e-4, warmup_steps=5, decay_steps=100)
TRAIN_SMALL_SEQ = 1024
TRAIN_SMALL_OPT = dict(lr=5e-3, warmup_steps=2, decay_steps=20)
TRAIN_AGREE_STEPS = 3
# substrings of kernel names the train step's profile sums apart (they may
# overlap): cuBLAS f32 and bf16 products, elementwise, reductions, softmax
TRAIN_PROFILE_MATCH = ("gemm_f32f32", "bf16", "nvjet", "elementwise",
                       "reduce_kernel", "softmax", "Memcpy", "index")
# card against CPU after TRAIN_AGREE_STEPS steps of the same reduced state
# in f32 (TF32 off), (limit, reason):
TRAIN_TOL = {
    "loss": (1e-5, "relative; f32 sums in another order (cuBLAS against "
                   "the CPU's BLAS) over a few thousand terms"),
    "grad_norm": (1e-5, "relative; as the loss"),
    "lr": (1e-6, "relative; the same f32 formula, the card's and the CPU's "
                 "f32 cosines may differ in the last place"),
    "params": (2e-4, "absolute at lr 5e-3: where a gradient is near zero "
                     "AdamW's m / (sqrt(v) + eps) turns rounding-level "
                     "differences into a share of the step (the bound "
                     "tests/test_train_integration.py uses)"),
    "codes_off": (1e-3, "share of the 8-bit codes apart: after the first "
                        "step from one state one step apart at most (a "
                        "moment that differs in its last bit can round to "
                        "the next code); after the last, the share alone "
                        "(the parameters have moved apart by then)"),
    "scales": (1e-4, "relative, after the first step: a block's absmax "
                     "from gradients that agree to f32 rounding"),
    "params_8bit": (2 * TRAIN_AGREE_STEPS * TRAIN_SMALL_OPT["lr"],
                    "absolute: a code one step apart moves its moment by a "
                    "quantization step, up to about two learning rates of "
                    "update a step where v sits at its floor"),
    "remat": (1e-5, "max |g_policy - g_none| / max |g_none| per tensor: "
                    "the recompute repeats the same kernels on the same "
                    "inputs; the limit leaves room for a kernel that sums "
                    "in a varying order"),
    "resume": (1e-4, "relative per step; the reference's resume bound "
                     "(atomics in the backward may reorder sums)"),
}
REPLACES = {
    "gemm": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:51"),
    "gemm_bias_act": ("src/repro_torch/csrc/gemm.cu",
                      "src/repro/kernels/fused.py:96"),
    "trsm_gemm": ("src/repro_torch/csrc/trsm_gemm.cu",
                  "src/repro/kernels/fused.py:201"),
    "dotp": ("src/repro_torch/csrc/dotp.cu", "src/repro/kernels/dotp.py:45"),
    "attention": ("src/repro_torch/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:82"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:65"),
    # not a TPU kernel: the card's counterpart of the reference's jitted
    # dependent chains (repro/arch/calibrate.py, run_microbenchmarks)
    "fpu_chain": ("src/repro_torch/csrc/fpu_chain.cu",
                  "src/repro/arch/calibrate.py:131"),
    # not a TPU kernel: the card's counterpart of the reference's jitted,
    # vmapped PE scoreboard scan (repro/core/pe.py, _scoreboard)
    "pe_scoreboard": ("src/repro_torch/csrc/pe_scoreboard.cu",
                      "src/repro/core/pe.py:111"),
}
TUNE_N = 4096                  # the tune phase's sweep shape (n^3)
# the lapack phase: lstsq's rows, columns and right-hand sides; the
# batched drivers' items, n and right-hand sides (ensemble-Kalman and
# per-head-whitening sizes) and the columns of batched_qr's items; the
# level-1 vectors' length (256 MB each in f32)
LSTSQ = (8192, 4096, 16)
BATCHED = (64, 512, 8)
BATCHED_TALL = 256
# the batched calls' seconds when they looped the 2-D drivers over the items
# (PERF.md section 5, PR 18 run 1; NVIDIA H100 80GB HBM3, 700.00 W): the
# lockstep calls print theirs beside these
BATCHED_LOOP_S = {"batched_cholesky": 2.805, "batched_lu": 6.292,
                  "batched_qr": 5.478}
# the f64 "dmma" batch check: items, rows (ragged against the 128-row tile,
# read through a row window of taller items), k, n
BATCHED_DMMA = (8, 200, 96, 160)
LEVEL1_N = 2 ** 26
# the linalg3d phase: the 3-D linalg BLAS calls' items and each call's
# operands (tag -> routine, dtype, operand shapes; a 1-D operand is shared
# by every item), the warm calls whose median is each call's seconds, and
# the examples run on the card as scripts at their default sizes
LINALG3D_ITEMS = 64
LINALG3D_CALLS = {
    "gemm f32 512^3": ("gemm", torch.float32, ((512, 512), (512, 512))),
    "gemm bf16 1024^3": ("gemm", torch.bfloat16, ((1024, 1024),
                                                  (1024, 1024))),
    "gemm f64 256^3": ("gemm", torch.float64, ((256, 256), (256, 256))),
    "gemm_bias_act f32 512^3 gelu": ("gemm_bias_act", torch.float32,
                                     ((512, 512), (512, 512), None)),
    "syrk f32 512x512": ("syrk", torch.float32, ((512, 512),)),
    "trsm f32 512x128": ("trsm", torch.float32, ((512, 512), (512, 128))),
    "gemv f32 512x512": ("gemv", torch.float32, ((512, 512), (512,))),
}
LINALG3D_REPS = 3
EXAMPLES = ("quickstart.py", "factorization_demo.py")
EXAMPLES_TIMEOUT_S = 300
# QR's residuals |A - QR|/|A| and |Q^TQ - I|/sqrt(n): the Cholesky limits
LAPACK_TOL = {torch.float32: 1e-4, torch.float64: 1e-12}
# the paper phase: figs 12-13 at the paper's n = 100 (joint depths of the
# swept pair), section 5's DOT4 comparison at its depths; every sweep held
# to B8's plain version in full at n = 48; the quickstart's steps 4-5 at
# its sizes (B4 at n = 4096, B1 at plan_gemm(2048, 2048, 2048))
PAPER_N, PAPER_CHECK_N = 100, 48
PAPER_DEPTHS = [2, 4, 6, 8, 12, 16, 24]
SEC5_DEPTHS = {"mul": 5, "add": 4}
QUICK_DOT_N, QUICK_GEMM_N = 4096, 2048
# B8's least time per instruction: the recurrence's dependent chain of one
# step, issue[i] = max(issue[i-1] + a[i], m[i]), an integer add and a max:
# one VIADDMNMX (__viaddmax_s32), whose dependent chain
# src/repro_torch/tools/int_chain.cu measured at 4.0334 cycles a step, its
# loop included (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6), at
# the card's maximum SM clock (nvidia-smi clocks.max.sm, read in the run).
# It was 38 while the bound assumed a shared-memory load-to-use a step (30
# cycles; the probe reads 28.58) then a max and an add.
PE_STEP_CYCLES = 4
PE_TIMING_REPS = 5
# the mesh phase: SPMD ranks, each a spawned process. (1, 1) is one NCCL
# rank; (2, 2) is four gloo ranks sharing the one card; the gradient sync
# runs over a 4-rank "pod" axis, flash-decoding over a 4-rank "model" axis
MESH_GLOO = (2, 2)
MESH_TRSM_RHS = 512            # trsm right-hand sides: 128 a rank
MESH_RAGGED = 62               # a batch the 4 ranks pad by two identities
MESH_SYNC_STEPS = 2            # compressed_grad_sync steps (error feedback)
# hymba-1.5b's decode: batch, query heads, kv heads, head dim, cache length,
# and the rows' valid cache lengths (one full, three ragged)
MESH_DECODE = (4, 25, 5, 64, 4096)
MESH_KV_LEN = (4096, 3001, 1500, 17)
MESH_DECODE_TOL = (1e-5, "relative to max|plain|: f32 partial softmaxes "
                         "combined in another order (reading 3.3e-7 "
                         "absolute at max|plain| 1.44); a bf16 combine "
                         "errs by about 1e-4 of it and fails")
MESH_SYNC_SLACK = (1e-6, "relative to max|y|: f32 rounding of the "
                         "dequantized codes' sum on top of the int8 bound "
                         "(half a code step of each rank's block scale, "
                         "averaged)")
MESH_TIMEOUT_S = 600
MESH_NOTE = ("four ranks share one card, and the links are host loopback "
             "through gloo, not NVLink. This is not a scaling number.")
# the shard phase: hymba-1.5b at full width cut to SHARD_LAYERS layers on a
# data x model mesh of gloo ranks sharing the card, TRAIN's tokens a step
# (one untimed step, then SHARD_TIMED timed; the agreement with one device
# read after TRAIN_AGREE_STEPS), then the pipeline's microbatches of 1 x
# TRAIN[1] over 4 stages and a sharded decode (batch, tokens, cache length)
SHARD_MESH = (2, 2)
SHARD_LAYERS = 4
SHARD_TIMED = 2
SHARD_MICRO = 8
SHARD_DECODE = (4, 6, 64)       # batch, steps, cache slots
SHARD_DECODE_TOL = (2e-3, "absolute, the reference's bound "
                          "(tests/test_distributed.py:93-94): f32 on both "
                          "sides, the rows and the cache's halves summed in "
                          "another order")
# the shard leg's parameters against one device after TRAIN_AGREE_STEPS
# steps at TRAIN_OPT's warmup (lr 6e-5, 1.2e-4, 1.8e-4): TRAIN_TOL's 2e-4
# is sized for lr 5e-3 and exceeds this leg's whole last update. The
# phase also prints the planted fault's reading, the last step's update
# (what a dropped or misapplied last update would leave), and holds the
# bound a fifth of its median over the leaves
SHARD_PARAM_TOL = (2e-5, "absolute at lr 1.8e-4 (the third warmup step): "
                         "readings 1.6e-6 to 4.3e-6 on the card; a dropped "
                         "last update is off by that step's update, "
                         "printed beside it")
SHARD_TIMEOUT_S = 900
# the shard phase's moe legs on the same mesh: (a) the families phase's
# reduced moe (3 layers, d_model 256, 8 experts top 2, vocab 512, f32) at
# each of SHARD_MOE_FACTORS, TRAIN_AGREE_STEPS sharded steps of
# SHARD_MOE_TRAIN tokens held to one device (TRAIN_TOL, SHARD_PARAM_TOL);
# (b) qwen3-moe-235b-a22b at full width cut to SHARD_MOE_LAYERS layers
# (f32), sharding.prefill of SHARD_MOE_PREFILL tokens (each DP rank one
# row) held to the one-device prefill of the same weights
SHARD_MOE_FACTORS = (1.25, 0.5)
SHARD_MOE_TRAIN = (2, 1024)
SHARD_MOE_LAYERS = 2
SHARD_MOE_PREFILL = (2, 4096)
SHARD_MOE_TOL = (2e-4, "max|dlogits| / max|logits|: f32 on both sides; "
                       "the row-parallel products' partial sums and the "
                       "experts' outputs are summed over model in another "
                       "order, and each rank multiplies its window of the "
                       "capacity slots in products of other shapes (other "
                       "cuBLAS kernels)")
SHARD_MOE_WHY = ("a full-width moe train step cannot run on one card: "
                 "qwen3-moe at one layer holds 3.73e9 parameters x 16 bytes "
                 "(f32 parameter, gradient, m and v) = 59.7 GB of state "
                 "before the 4 ranks' gathered blocks")
SHARD_NOTE = ("four ranks share one card over gloo (host loopback, each "
              "buffer staged through pinned host memory, the TP all-reduces "
              "included): a route check, not a scaling number")
# the analysis phase: processes for the fake-traced no-mesh legs of the
# surface grid (and the two large fake traces; its mesh legs take as many
# gloo ranks as the largest mesh), and the calls whose real and fake
# launch records must agree (QR at 2048: its fake trace, the phase's
# longest task, took about 110 s at 4096 on a CPU core)
ANALYSIS_WORKERS = 8
ANALYSIS_TIMEOUT_S = 600
ANALYSIS_CALLS = (("gemm", N), ("cholesky", N), ("qr", 2048))
# the batched drivers whose real and fake records must agree: the lapack
# phase's batches
ANALYSIS_BATCHED = (("batched_cholesky", (64, 512, 512)),
                    ("batched_lu", (64, 512, 512)),
                    ("batched_qr", (64, 512, 256)))
# the dryrun phase: each child's deadline; a traced peak's distance from
# the card's max_memory_allocated of the same step
DRYRUN_TIMEOUT_S = 300
DRYRUN_MEM_TOL = (0.15, "relative: the trace counts the storages aten "
                        "ops allocate; the card's allocator rounds blocks "
                        "and adds library workspaces")
# hymba-1.5b train_4k on the pod mesh before TP compute (every block
# gathered whole over model): PR 24's row (PERF.md section 6)
DRYRUN_POD_ZERO3 = {"useful_flop_ratio": 0.04324, "gib_per_device": 86.3,
                    "hlo_flops": 9.33e14, "compute_s": 13.92,
                    "memory_s": 2.85, "collective_s": 0.006388}
SHARD_REDUCED = {
    "n_layers": f"32 -> {SHARD_LAYERS}: every step moves each parameter "
                f"three times over gloo's host loopback (gathered over data, "
                f"gathered again by remat, gradients reduce-scattered) and "
                f"each layer's activations through TP's all-reduces and "
                f"gathers over model; the (2, 2) SUMMA call moved 728 of its "
                f"765 ms there (PERF.md), so 32 layers would take tens of "
                f"seconds a step",
    "ranks": "4 ranks on 1 card (gloo: NCCL refuses two ranks on one card)",
    "compute_dtype": "bfloat16 -> float32 in the train, restart and decode "
                     "legs: held to one device at TRAIN_TOL (the pipeline "
                     "serves in bfloat16 on the kernels)"}


def emit(**row):
    print(json.dumps(row), flush=True)


def sync_time(fn):
    """(result, host seconds) of ``fn`` run to completion on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cuda_ms(fn, reps=5):
    """Mean device milliseconds of ``fn`` over ``reps`` launches after one
    warm-up, by CUDA events."""
    fn()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20):
    """Device milliseconds per call of ``fn``, free of host time: ``reps``
    calls captured in one CUDA graph, its replay timed by CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay) / reps


def profiled(fn, match, complete, tries=5):
    """``profile_call(fn, cpu=False, match=match, pad=32)["matched"]`` once
    ``complete(name, launches)`` holds for each name in ``match``: the
    card's CUPTI trace sometimes loses a short run's kernels, so a run
    that lost them is traced again, ``tries`` times at most, then
    raises."""
    for _ in range(tries):
        got = profile_call(fn, cpu=False, match=match, pad=32)["matched"]
        if all(complete(m, got[m]["launches"]) for m in match):
            return got
    raise AssertionError(f"the profiler saw {got} in {tries} traces")


def kernel_ms(fn, match, reps=10):
    """Device milliseconds per launch of the kernels whose name holds
    ``match``, over ``reps`` calls of ``fn`` under ``torch.profiler``
    (their summed device time over the launches it recorded)."""
    got = profiled(lambda: [fn() for _ in range(reps)], (match,),
                   lambda m, count: count > 0)[match]
    return got["device_ms"] / got["launches"]


def compare(name, got, want, scale=None, tol=None):
    """Normwise agreement of a kernel with its plain version; raises past
    the dtype's tolerance. ``scale`` defaults to max(max|want|, 1) and
    ``tol`` to ``TOL[want.dtype]`` (a (value, reason) pair)."""
    err = (got.double() - want.double()).abs().max().item()
    if scale is None:
        scale = max(want.double().abs().max().item(), 1.0)
    tol, reason = tol or TOL[want.dtype]
    ok = bool(torch.isfinite(got).all()) and err <= tol * scale
    emit(check=name, max_abs_err=err, scale=scale, tol=tol, reason=reason,
         ok=ok)
    if not ok:
        raise AssertionError(f"{name}: |kernel - plain| = {err} > "
                             f"{tol} * {scale}")
    return err


def compare_close(name, got, want):
    """Elementwise and normwise agreement of B5 / B6 with its plain
    version, scaled by each value and the output's rms; raises past
    ``CLOSE_TOL[want.dtype]``."""
    rtol, atol, norm_tol, reason = CLOSE_TOL[want.dtype]
    g, w = got.double(), want.double()
    diff = (g - w).abs()
    rms = w.square().mean().sqrt().item()
    limit = rtol * w.abs() + atol * rms
    worst = (diff / limit.clamp_min(1e-300)).max().item()
    norm_err = diff.norm().item() / max(w.norm().item(), 1e-300)
    err = diff.max().item()
    ok = bool(torch.isfinite(got).all()) and worst <= 1.0 \
        and norm_err <= norm_tol
    emit(check=name, max_abs_err=err, rms=rms, max_abs_over_rms=err / rms
         if rms else None, worst_over_limit=worst, norm_err=norm_err,
         rtol=rtol, atol_rms=atol, norm_tol=norm_tol, reason=reason, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: max |kernel - plain| / limit = "
                             f"{worst}, normwise {norm_err} > {norm_tol}")
    return err


def lower(gen, nb, dtype, unit):
    """A well-conditioned lower-triangular panel (bounded substitution)."""
    l = torch.randn(nb, nb, generator=gen, device="cuda").tril(-1) / nb
    d = torch.ones(nb, device="cuda") if unit else \
        1 + torch.rand(nb, generator=gen, device="cuda")
    return (l + torch.diag(d)).to(dtype)


def bound(flops, nbytes, dtype):
    """(least ms, what bounds it): the larger of the operations at the
    dtype's peak and the bytes at the HBM rate."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def phase_probe(build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.get_float32_matmul_precision() == "highest"
    cap = torch.cuda.get_device_capability(0)
    assert cap == (9, 0), f"expected a Hopper card (9.0), got {cap}"
    t0 = time.perf_counter()
    libs = build.build_all()
    emit(phase="probe", card=smi, capability=list(cap),
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=build.nvcc_path(), nvcc_flags=" ".join(build.NVCC_FLAGS),
         libraries=[os.path.relpath(p, ROOT) for p in libs],
         build_s=time.perf_counter() - t0,
         allow_tf32=[torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32])
    return smi


def phase_kernels(gen):
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import gemm as gk

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        tag = str(dtype).removeprefix("torch.")
        # ragged against every tile with 16-byte aligned rows (the tiled
        # variant), ragged with unaligned rows ("simt"), the main path's
        for m, n, k in ((1000, 776, 520), (1000, 777, 513), (N, N, N)):
            a, b = rnd(m, k, dtype=dtype), rnd(k, n, dtype=dtype)
            outs = gk.OUT_DTYPES[dtype] if m != N else (dtype,)
            for out in outs:
                compare(f"gemm {tag}->{str(out)[6:]} {m}x{n}x{k} "
                        f"[{gk.gemm_variant(a, b)}]",
                        gk.gemm(a, b, out_dtype=out),
                        gk.gemm_plain(a, b, out))
            if m == N:
                if dtype == torch.float32:          # the main path's B3 call
                    bias = rnd(n)
                    compare(f"gemm_bias_act {tag} {m}x{n}x{k} gelu bias=True",
                            fk.gemm_bias_act(a, b, bias, "gelu"),
                            fk.gemm_bias_act_plain(a, b, bias, "gelu"))
                continue
            # B3 with every epilogue, with and without bias, on both ragged
            # shapes: the tiled variant and "simt"
            bias = rnd(n, dtype=dtype)
            for out in gk.OUT_DTYPES[dtype]:
                for epi in fk.EPILOGUES:
                    for bb in (None, bias):
                        compare(f"gemm_bias_act {tag}->{str(out)[6:]} "
                                f"{m}x{n}x{k} {epi} bias={bb is not None} "
                                f"[{gk.gemm_variant(a, b)}]",
                                fk.gemm_bias_act(a, b, bb, epi, out_dtype=out),
                                fk.gemm_bias_act_plain(a, b, bb, epi, out))
            if n != 776:
                continue
            # transposed views and unaligned windows ("simt"), an aligned
            # window (the tiled variant), a skinny TRSM-like update ("simt")
            big = rnd(1100, 1024, dtype=dtype)
            for name, x, y in (
                    ("transposed views", b.T, a.T),
                    ("unaligned window", big[1:1001, 3:516],
                     big[7:520, 5:782]),
                    ("aligned window", big[40:1040, 64:577],
                     big[:513, 128:905]),
                    ("skinny 128x8192x1", rnd(128, N, dtype=dtype),
                     rnd(N, 1, dtype=dtype))):
                compare(f"gemm {tag} {name} [{gk.gemm_variant(x, y)}]",
                        gk.gemm(x, y), gk.gemm_plain(x, y))
            del big
        for nb, n in ((100, 1000), (128, N - 128)):
            for form in ("lu", "syrk"):
                for unit in (False, True):
                    if nb == 128 and dtype != torch.float32 and unit:
                        continue
                    m = n if form == "syrk" else n - 37
                    args = (lower(gen, nb, dtype, unit), rnd(n, nb,
                                                           dtype=dtype).T,
                            None if form == "syrk" else rnd(m, nb, dtype=dtype),
                            rnd(m, n, dtype=dtype))
                    x, c = fk.trsm_gemm(*args, form=form, unit_diag=unit)
                    xp, cp = fk.trsm_gemm_plain(*args, form=form,
                                                unit_diag=unit)
                    name = f"trsm_gemm {tag} nb={nb} n={n} {form} unit={unit}"
                    compare(name + " X", x, xp)
                    compare(name + " C", c, cp)
        # m = 0 ("lu"): X alone
        args = (lower(gen, 128, dtype, True), rnd(1000, 128, dtype=dtype).T,
                rnd(0, 128, dtype=dtype), rnd(0, 1000, dtype=dtype))
        x, c = fk.trsm_gemm(*args, form="lu", unit_diag=True)
        xp, _ = fk.trsm_gemm_plain(*args, form="lu", unit_diag=True)
        assert c.shape == (0, 1000)
        compare(f"trsm_gemm {tag} nb=128 n=1000 m=0 lu unit=True X", x, xp)
        gemv_checks(gen, dtype)
    # a panel too wide for 32-column X blocks: narrow blocks, L11 from
    # device memory
    args = (lower(gen, 2000, torch.float64, False),
            rnd(2000, 40, dtype=torch.float64), None,
            rnd(40, 40, dtype=torch.float64))
    x, c = fk.trsm_gemm(*args, form="syrk")
    xp, cp = fk.trsm_gemm_plain(*args, form="syrk")
    compare(f"trsm_gemm float64 nb=2000 n=40 syrk "
            f"{fk.trsm_gemm.last_launch} X", x, xp)
    compare("trsm_gemm float64 nb=2000 n=40 syrk C", c, cp)
    tile_checks(gen)
    chain_checks(gen)
    emit(phase="kernels", tile_of_last_trsm_gemm=fk.trsm_gemm.last_launch)


def tile_checks(gen):
    """Every compiled CTA tile of B1's tiled variants, handed over in an
    ``h100`` plan, and B3 (gelu + bias) on it, against the plain versions
    at an aligned shape, a ragged one (rows still 16-byte aligned) and the
    tune phase's sweep shape (``TUNE_N``^3, where ``tune_gemm`` launches
    every tile and ``tune_fused_gemm`` runs B3); each call must launch that
    tile (``tile_source == "plan"``)."""
    from repro_torch.core import codesign as cd
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import gemm as gk

    rnd = lambda *s, dtype: torch.randn(*s, generator=gen,
                                        device="cuda").to(dtype)
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        variant, tag = gk.TILED[dtype], str(dtype).removeprefix("torch.")
        for m, n, k in ((1024, 1024, 1024), (1000, 776, 520),
                        (TUNE_N,) * 3):
            a, b = rnd(m, k, dtype=dtype), rnd(k, n, dtype=dtype)
            bias = rnd(n, dtype=dtype)
            for tile in gk.TILE_SETS[variant]:
                plan = cd.plan_from_blocks(m, n, k, *tile, dtype=dtype,
                                           machine="h100")
                name = f"{m}x{n}x{k} [{variant} {'x'.join(map(str, tile))}]"
                for out in gk.OUT_DTYPES[dtype]:
                    got = gk.gemm(a, b, plan=plan, out_dtype=out)
                    launch = gk.gemm.last_launch
                    assert (launch["variant"], launch["tile"],
                            launch["tile_source"]) == (variant, tile,
                                                       "plan"), launch
                    compare(f"gemm {tag}->{str(out)[6:]} {name}", got,
                            gk.gemm_plain(a, b, out))
                    got = fk.gemm_bias_act(a, b, bias, "gelu", plan=plan,
                                           out_dtype=out)
                    assert fk.gemm_bias_act.last_launch["tile"] == tile
                    compare(f"gemm_bias_act {tag}->{str(out)[6:]} {name} "
                            f"gelu bias=True", got,
                            fk.gemm_bias_act_plain(a, b, bias, "gelu", out))


def chain_iters():
    """The steps of the calibration's chains on the card (the tune phase's
    ``arch.calibrate``), at which the chain checks and rows run."""
    import importlib
    return importlib.import_module(
        "repro_torch.arch.calibrate").SUITE_SIZES["cuda"]["chain_iters"]


def chain_input(gen):
    """8 float32 lanes: the calibration's start value 2.0 in lane 0, the
    others random in [1.5, 2.5)."""
    from repro_torch.kernels import fpu_chain as fc

    v0 = 1.5 + torch.rand(fc.LANES, generator=gen, device="cuda")
    v0[0] = 2.0
    return v0


def chain_checks(gen):
    """The FPU-chain probe of each op class against its plain loop on the
    card, bitwise (IEEE float32 mul, add, div and sqrt round alike), at the
    calibration's chain length."""
    from repro_torch.kernels import fpu_chain as fc

    v0, it = chain_input(gen), chain_iters()
    for op in fc.OP_CLASSES:
        got, cycles = fc.fpu_chain(op, v0, it)
        want = fc.fpu_chain_plain(op, v0, it)
        ok = torch.equal(got, want)
        emit(check=f"fpu_chain {op} {it} steps bitwise",
             cycles_per_op=int(cycles) / it,
             max_abs_err=(got - want).abs().max().item(), ok=ok)
        assert ok, f"fpu_chain {op}: kernel and plain loop differ"


def gemv_checks(gen, dtype):
    """B1's "gemv" variant (and B3 on it) against the plain version: k =
    1, 7 and the solve's 8064, n = 1, 3, 16, 16-byte aligned rows (a window
    of the factor, as the blocked TRSM passes it) and unaligned ones,
    strided B; every epilogue and out dtype at the solve's shape."""
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import gemm as gk

    tag = str(dtype).removeprefix("torch.")
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    for k in (1, 7, N - 128):
        big = rnd(129, k + 8)
        for rows, a in (("aligned", big[1:, 8:]),
                        ("unaligned", big[:37, 1:k + 1])):
            for n in (1, 3, 16):
                b = rnd(k, 2 * n)[:, ::2]
                assert gk.gemm_variant(a, b) == "gemv", (a.stride(), n)
                for out in gk.OUT_DTYPES[dtype]:
                    compare(f"gemm {tag}->{str(out)[6:]} {a.shape[0]}x{n}x{k}"
                            f" {rows} rows, strided B [gemv]",
                            gk.gemm(a, b, out_dtype=out),
                            gk.gemm_plain(a, b, out))
                if k != N - 128 or n != 3:
                    continue
                bias = rnd(n)
                for out in gk.OUT_DTYPES[dtype]:
                    for epi in fk.EPILOGUES:
                        for bb in (None, bias):
                            compare(f"gemm_bias_act {tag}->{str(out)[6:]} "
                                    f"{a.shape[0]}x{n}x{k} {rows} rows {epi} "
                                    f"bias={bb is not None} [gemv]",
                                    fk.gemm_bias_act(a, b, bb, epi,
                                                     out_dtype=out),
                                    fk.gemm_bias_act_plain(a, b, bb, epi, out))


def small_agreement():
    """The port's model path on the card against its reference path on the
    CPU, on one small numpy input."""
    import numpy as np
    from repro_torch import linalg
    rng = np.random.default_rng(SEED)
    g = rng.normal(size=(96, 96))
    spd, gen = g @ g.T + 96 * np.eye(96), g + 4 * np.eye(96)
    rhs = rng.normal(size=(96, 3))
    out = {}
    for dev, pol in (("cuda", "model"), ("cpu", "reference")):
        with linalg.use(device=dev, policy=pol):
            out[dev] = [linalg.gemm(g, gen), linalg.cholesky(spd, block=32),
                        linalg.lu(gen, block=32)[0],
                        linalg.solve(gen, rhs, block=32)]
    for name, a, b in zip(("gemm", "cholesky", "lu", "solve"), out["cuda"],
                          out["cpu"]):
        err = (a.cpu() - b).abs().max().item()
        emit(check=f"small {name}: cuda model vs cpu reference (f64)",
             max_abs_err=err, tol=1e-9, ok=err <= 1e-9)
        assert err <= 1e-9, name


def rel(x):
    return x.double().norm().item()


def factorization_plan(tag, kind, n, dtype, form):
    """The panel width and the trailing updates a blocked factorization
    resolves under the ambient machine of the card (as the driver walks
    its panels): each update's n' and whether the chain planner fuses it
    onto B2."""
    from repro_torch.lapack.cholesky import default_block
    from repro_torch.tune import dispatch as td

    block = default_block(n, kind, dtype, "cuda")
    updates = []
    for j0 in range(0, n, block):
        nb = min(block, n - j0)
        if j0 + nb < n:
            r = n - j0 - nb
            updates.append((r, td.resolve("trsm+gemm", (r, r, nb), dtype,
                                          policy="model", backend="cuda",
                                          form=form).fused))
    return {"call": tag, "block": block, "updates": len(updates),
            "fused": sum(f for _, f in updates),
            "staged_at": [r for r, f in updates if not f]}


def main_plans():
    """The plans the main path resolves on the card under its machine:
    GEMM tiles, the fused B3 decision, the factorizations' panel widths
    and fused trailing updates, the solve's TRSM block; and the launch
    counts they imply (B2 once per fused update, "gemv" once per TRSM
    off-diagonal update of the solve's two triangular solves)."""
    from repro_torch import arch
    from repro_torch.tune import dispatch as td

    def tile(op, shape, dtype, **kw):
        p = td.resolve(op, shape, dtype, policy="model", backend="cuda",
                       **kw).gemm_plan
        return [p.bm, p.bn, p.bk]

    gba = td.resolve("gemm+epilogue", (N, N, N), torch.float32,
                     policy="model", backend="cuda", epilogue="gelu")
    facts = [factorization_plan(*f) for f in (
        ("cholesky f32", "potrf", N, torch.float32, "syrk"),
        ("lu f32", "getrf", N, torch.float32, "lu"),
        ("solve f32 (its lu)", "getrf", N, torch.float32, "lu"),
        ("cholesky f64", "potrf", N64, torch.float64, "syrk"),
        ("tuned cholesky f32 (cold start)", "potrf", N, torch.float32,
         "syrk"))]
    trsm_block = td.resolve("trsm", (N, 1), torch.float32, policy="model",
                            backend="cuda").block
    return {"machine": arch.current_machine("cuda").name,
            "gemm_tiles": {"f32 8192^3": tile("gemm", (N, N, N),
                                              torch.float32),
                           "bf16 8192^3": tile("gemm", (N, N, N),
                                               torch.bfloat16),
                           "f64 4096^3": tile("gemm", (N64, N64, N64),
                                              torch.float64)},
            "gemm_bias_act": {"fused": gba.fused, "tile": [
                gba.gemm_plan.bm, gba.gemm_plan.bn, gba.gemm_plan.bk]},
            "factorizations": facts, "trsm_block": trsm_block,
            "expect_trsm_gemm": sum(f["fused"] for f in facts),
            "expect_gemv": 2 * (-(-N // trsm_block) - 1)}


def phase_main(gen, build_dir):
    from repro_torch import linalg
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import gemm as gk
    from repro_torch.lapack.lu import lu_reconstruct

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def spd(n, dtype):
        g = rnd(n, n, dtype=dtype)
        return g @ g.T / n + torch.eye(n, device="cuda", dtype=dtype)

    a32, b32 = rnd(N, N), rnd(N, N)
    a16, b16 = a32.bfloat16(), b32.bfloat16()
    a64, b64 = rnd(N64, N64, dtype=torch.float64), rnd(N64, N64,
                                                      dtype=torch.float64)
    bias = rnd(N)
    s32, s64 = spd(N, torch.float32), spd(N64, torch.float64)
    g32, rhs = rnd(N, N), rnd(N)
    cold = os.path.join(build_dir, "cold-start-registry.json")
    assert not os.path.exists(cold)
    plans = main_plans()
    assert plans["machine"] == "h100", plans["machine"]
    emit(phase="main plans", **plans)
    # every trailing update of the drivers must stay on B2 under h100: a
    # planner that moved some onto the staged pair would lower the B2
    # count derived below with it
    staged = {f["call"]: f["staged_at"] for f in plans["factorizations"]
              if f["staged_at"]}
    assert not staged, f"h100 stages trailing updates off B2: {staged}"
    assert plans["expect_trsm_gemm"] == sum(
        f["updates"] for f in plans["factorizations"]), plans
    results = {}
    gk.reset_launches(gk.gemm)
    gk.reset_launches(fk.gemm_bias_act)
    fk.trsm_gemm.launches = 0
    t_main = time.perf_counter()
    with linalg.use(policy="model", device="cuda"):
        for tag, a, b in (("gemm f32 8192^3", a32, b32),
                          ("gemm bf16 8192^3", a16, b16),
                          ("gemm f64 4096^3", a64, b64)):
            results[tag], secs = sync_time(lambda: linalg.gemm(a, b))
            emit(call=tag, wall_s=secs, shape=list(results[tag].shape))
        results["gba"], secs = sync_time(
            lambda: linalg.gemm_bias_act(a32, b32, bias, "gelu"))
        emit(call="gemm_bias_act f32 8192^3 gelu+bias", wall_s=secs)
        results["chol"], secs = sync_time(lambda: linalg.cholesky(s32))
        emit(call="cholesky f32 8192", wall_s=secs)
        results["lu"], secs = sync_time(lambda: linalg.lu(g32))
        emit(call="lu f32 8192", wall_s=secs)
        results["solve"], secs = sync_time(lambda: linalg.solve(g32, rhs))
        emit(call="solve f32 8192", wall_s=secs)
        results["chol64"], secs = sync_time(lambda: linalg.cholesky(s64))
        emit(call="cholesky f64 4096", wall_s=secs)
    with linalg.use(policy="tuned", device="cuda", registry=cold):
        tuned_gemm, secs = sync_time(lambda: linalg.gemm(a32, b32))
        emit(call="tuned (cold start) gemm f32 8192^3", wall_s=secs)
        tuned_chol, secs = sync_time(lambda: linalg.cholesky(s32))
        emit(call="tuned (cold start) cholesky f32 8192", wall_s=secs)
    main_s = time.perf_counter() - t_main
    launches = {"gemm": gk.gemm.launches,
                "gemm_bias_act": fk.gemm_bias_act.launches,
                "trsm_gemm": fk.trsm_gemm.launches}
    assert all(v > 0 for v in launches.values()), launches
    variants = {f"{name}_variants": dict(w.variant_launches)
                for name, w in (("gemm", gk.gemm),
                                ("gemm_bias_act", fk.gemm_bias_act))}
    # one B2 launch per fused trailing update, one "gemv" per TRSM update
    # of the solve, as the plans say (h100 at n = 8192: 63 + 63 + 63 + 31
    # + the tuned Cholesky's 63 = 283, and 126)
    assert launches["trsm_gemm"] == plans["expect_trsm_gemm"], (launches,
                                                                plans)
    assert variants["gemm_variants"]["gemv"] == plans["expect_gemv"], \
        (variants, plans)
    assert variants["gemm_variants"]["simt"] == 0, variants

    # correctness of what came out (not part of the main path's counts)
    for tag, a, b in (("gemm f32 8192^3", a32, b32),
                      ("gemm bf16 8192^3", a16, b16),
                      ("gemm f64 4096^3", a64, b64)):
        out = results[tag]
        assert out.shape == (a.shape[0], b.shape[1]) and out.dtype == a.dtype
        compare(f"main {tag} vs torch.matmul", out, a @ b)
    compare("main gemm_bias_act vs addmm+gelu", results["gba"],
            F.gelu(torch.addmm(bias, a32, b32), approximate="tanh"))
    l32, l64 = results["chol"], results["chol64"]
    packed, piv = results["lu"]
    x = results["solve"]
    res = {
        "cholesky f32 |LL^T-S|/|S|": (rel(l32 @ l32.T - s32) / rel(s32), 1e-4),
        "cholesky f64 |LL^T-S|/|S|": (rel(l64 @ l64.T - s64) / rel(s64),
                                      1e-12),
        "lu f32 |P^T L U - A|/|A|":
            (rel(lu_reconstruct(packed, piv) - g32) / rel(g32), 1e-4),
        "solve f32 |Ax-b|/(|A||x|+|b|)":
            (rel(g32 @ x - rhs) / (rel(g32) * rel(x) + rel(rhs)), 1e-5),
    }
    for name, (value, limit) in res.items():
        emit(residual=name, value=value, limit=limit, ok=value <= limit)
        assert value <= limit, (name, value)
    assert piv.dtype == torch.int32 and all(
        bool(torch.isfinite(t).all()) for t in (l32, l64, packed, x))
    assert torch.equal(tuned_gemm, results["gemm f32 8192^3"])
    assert torch.equal(tuned_chol, l32)
    emit(phase="main", wall_s=main_s, launches=launches, **variants,
         cold_start_tuned_equals_model=True)
    # where the factorizations' time goes (not part of the counted run):
    # device-busy against wall time, B2's and B1's share; under the card's
    # machine, then the same calls priced for the TPU, side by side
    pricing = {}
    for machine in ("h100", "tpu-like"):
        with linalg.use(policy="model", device="cuda", machine=machine):
            for tag, fn in (("cholesky f32 8192",
                             lambda: linalg.cholesky(s32)),
                            ("lu f32 8192", lambda: linalg.lu(g32)),
                            ("solve f32 8192",
                             lambda: linalg.solve(g32, rhs))):
                # the first trace read by both readers
                prof = profile_call(fn, cpu=False, match=(
                    "trsm_gemm", "gemm_simt", "gemm_gemv"),
                    readers=not pricing)
                emit(profile=tag, machine=machine, **prof)
                pricing.setdefault(tag, {})[machine] = {
                    "device_busy_ms": prof["device_busy_ms"],
                    "wall_s": prof["wall_ms_profiled"] / 1e3,
                    "kernel_launches": prof["kernel_launches"],
                    "b2_launches": prof["matched"]["trsm_gemm"]["launches"]}
    emit(pricings="h100 vs tpu-like on one card (device-only profiles)",
         **pricing)
    return {**launches, **variants, "plans": plans}


def counted(tag, fn):
    """``fn()`` run to completion with every kernel's launch count zeroed
    just before and read just after; prints its wall seconds and counts."""
    from repro_torch.kernels import gemm as gk

    wrappers = zero_launches()
    out, secs = sync_time(fn)
    launches = {name: w.launches for name, w in wrappers.items()}
    launches["gemm_variants"] = {v: c for v, c in
                                 gk.gemm.variant_launches.items() if c}
    emit(call=tag, wall_s=secs, launches=launches)
    return out, launches


def lapack_plans():
    """The launch counts the lapack phase's calls imply under the card's
    machine: B1 twice per QR panel with trailing columns (V^T C and V W),
    "gemv" once per off-diagonal update of a TRSM with <= 16 right-hand
    sides, B2 once per fused trailing update; a batched call launches
    each of these once for the whole batch (lockstep)."""
    from repro_torch.lapack.cholesky import default_block
    from repro_torch.tune import dispatch as td

    def qr(m, n, dtype):
        kmax = min(m, n)
        block = default_block(kmax, "geqrf", dtype, "cuda")
        return {"block": block, "b1": 2 * sum(
            j0 + min(block, kmax - j0) < n for j0 in range(0, kmax, block))}

    def trsm_updates(n, nrhs, dtype):
        block = td.resolve("trsm", (n, nrhs), dtype, policy="model",
                           backend="cuda").block
        return -(-n // block) - 1

    _, n, nrhs = BATCHED
    m, k, lrhs = LSTSQ
    facts = [factorization_plan(f"batched {kind} item", kind, n,
                                torch.float32, form)
             for kind, form in (("potrf", "syrk"), ("getrf", "lu"))]
    return {f"qr f32 {N}": qr(N, N, torch.float32),
            f"qr f64 {N64}": qr(N64, N64, torch.float64),
            f"qr f32 {N64}": qr(N64, N64, torch.float32),
            "lstsq": {**qr(m, k, torch.float32),
                      "gemv": trsm_updates(k, lrhs, torch.float32)},
            "batched items": facts,
            "batched_qr item": qr(n, BATCHED_TALL, torch.float32),
            # lower + upper solve of potrf / getrf, one of geqrf: the
            # launches of one item's solve, and of the whole batch's
            "batched_solve gemv per item": {
                "potrf": 2 * trsm_updates(n, nrhs, torch.float32),
                "getrf": 2 * trsm_updates(n, nrhs, torch.float32),
                "geqrf": trsm_updates(BATCHED_TALL, nrhs, torch.float32)}}


def only(launches, trsm_gemm=0, **variants):
    """Assert that a counted call launched exactly these B1 variants and
    this many B2, and no other kernel."""
    others = {k: v for k, v in launches.items()
              if k not in ("gemm", "gemm_variants", "trsm_gemm") and v}
    assert launches["gemm_variants"] == variants and launches["gemm"] == sum(
        variants.values()) and launches["trsm_gemm"] == trsm_gemm \
        and not others, (launches, variants, trsm_gemm)


def phase_lapack():
    """QR, least squares, the batched drivers, level 1 and the trace
    exporters on the card under ``h100`` and ``policy="model"``, each call
    counted on its own (:func:`counted`) against the counts its plan
    implies (:func:`lapack_plans`). Before each driver call, every kernel
    it runs is held to its plain version at the operands the driver hands
    it (:func:`qr_update_checks`, :func:`b2_walk`,
    :func:`trsm_gemv_checks`), and each batched launch item by item to
    the 2-D launches (:func:`batched_rows`). Its inputs come from a
    generator of its own, seeded with ``SEED``, so the later phases draw
    what they drew without it. Returns the batched kernels' times rows."""
    import math
    import tempfile

    from repro_torch import linalg, obs
    from repro_torch.lapack import batched as lb

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.float64).to(dtype)

    plans = lapack_plans()
    emit(phase="lapack plans", **plans)
    unfused = [f for f in plans["batched items"]
               if f["fused"] != f["updates"]]
    assert not unfused, f"h100 stages batched trailing updates: {unfused}"
    t_phase = time.perf_counter()
    checks = {}

    def check(name, value, limit):
        emit(residual=name, value=value, limit=limit, ok=value <= limit)
        assert value <= limit, (name, value, limit)
        checks[name] = value

    # ---- QR: 8192 f32, 4096 f64 (B1 tiled twice per trailing update)
    for n, dtype, tiled in ((N, torch.float32, "ffma"),
                            (N64, torch.float64, "dmma")):
        tag = f"qr {str(dtype)[6:].replace('float', 'f')} {n}"
        a = rnd(n, n, dtype=dtype)
        qr_update_checks(a, plans[tag]["block"], tiled)
        with linalg.use(policy="model", device="cuda"):
            (q, r), launches = counted(tag, lambda: linalg.qr(a))
        only(launches, **{tiled: plans[tag]["b1"]})
        a64, q64 = a.double(), q.double()
        eye = torch.eye(n, device="cuda", dtype=torch.float64)
        check(f"{tag} |A-QR|/|A|", rel(a64 - q64 @ r.double()) / rel(a64),
              LAPACK_TOL[dtype])
        check(f"{tag} |Q^TQ-I|/sqrt(n)", rel(q64.T @ q64 - eye)
              / math.sqrt(n), LAPACK_TOL[dtype])
        del q, r, a64, q64, eye
        if dtype == torch.float32:
            with linalg.use(policy="model", device="cuda"):
                prof = profile_call(lambda: linalg.qr(a), cpu=False,
                                    match=("gemm_ffma", "gemm_simt"))
            emit(profile=f"{tag} (device only)", **prof)
            assert prof["matched"]["gemm_ffma"]["launches"] <= \
                plans[tag]["b1"] and prof["matched"]["gemm_simt"][
                    "launches"] == 0, prof["matched"]
        del a

    # ---- a cold-start tuned QR equals the model's bitwise; then traced
    small = f"qr f32 {N64}"
    a = rnd(N64, N64)
    qr_update_checks(a, plans[small]["block"], "ffma")
    with tempfile.TemporaryDirectory(prefix="repro_torch_lapack_") as tmp:
        cold = os.path.join(tmp, "cold-start-registry.json")
        with linalg.use(policy="model", device="cuda"):
            (qm, rm), launches = counted(small, lambda: linalg.qr(a))
        only(launches, ffma=plans[small]["b1"])
        with linalg.use(policy="tuned", device="cuda", registry=cold):
            (qt, rt), launches = counted(f"tuned (cold start) {small}",
                                         lambda: linalg.qr(a))
        only(launches, ffma=plans[small]["b1"])
        assert torch.equal(qm, qt) and torch.equal(rm, rt)
        assert not os.path.exists(cold)
        tr = obs.Trace(small)
        with linalg.use(policy="model", device="cuda", obs=tr):
            sync_time(lambda: linalg.qr(a))
        tr.finish()
        export_checks(tr, tmp, plans[small])
    del a, qm, rm, qt, rt

    # ---- least squares: 8192 x 4096 f32, 16 right-hand sides
    m, k, lrhs = LSTSQ
    a, b = rnd(m, k), rnd(m, lrhs)
    qr_update_checks(a, plans["lstsq"]["block"], "ffma")
    # the final solve's factor R = triu(packed)[:k, :k]: a (k, k) window of
    # an (m, k) tensor, row stride k; triu(A) has its layout
    trsm_gemv_checks(gen, torch.triu(a)[:k, :k], False, lrhs, "lstsq R")
    with linalg.use(policy="model", device="cuda"):
        x, launches = counted(f"lstsq f32 {m}x{k} nrhs={lrhs}",
                              lambda: linalg.lstsq(a, b))
    only(launches, ffma=plans["lstsq"]["b1"], gemv=plans["lstsq"]["gemv"])
    want = torch.linalg.lstsq(a.double(), b.double()).solution
    check("lstsq f32 |x - x_f64|/|x_f64|", rel(x.double() - want) / rel(want),
          1e-4)
    del a, b, x, want

    # ---- batched drivers: 64 items of 512 (and 512 x 256 for QR)
    items, n, nrhs = BATCHED
    per_item = plans["batched_solve gemv per item"]
    fused = {f["call"].split()[1]: f["fused"] for f in plans["batched items"]}
    g = rnd(items, n, n)
    spd = g @ g.transpose(1, 2) / n + torch.eye(n, device="cuda")
    tall = rnd(items, n, BATCHED_TALL)
    rhs = rnd(items, n, nrhs)
    blocks = {f["call"].split()[1]: f["block"] for f in plans["batched items"]}
    b2_walk("potrf", spd[0], blocks["potrf"])
    b2_walk("getrf", g[0], blocks["getrf"])
    qr_update_checks(tall[0], plans["batched_qr item"]["block"], "ffma")
    rows = batched_rows(gen, spd, g, tall, blocks,
                        plans["batched_qr item"]["block"], nrhs)
    batched = {}
    for kind, routine, a in (("potrf", "batched_cholesky", spd),
                             ("getrf", "batched_lu", g),
                             ("geqrf", "batched_qr", tall)):
        with linalg.use(policy="model", device="cuda"):
            res, launches = counted(
                f"{routine} {items}x{tuple(a.shape[1:])} f32",
                lambda: getattr(linalg, routine)(a))
            batched[routine] = launches
            # lockstep: each trailing update one launch for the batch
            if kind == "geqrf":
                only(launches, ffma=plans["batched_qr item"]["b1"])
            else:
                only(launches, trsm_gemm=fused[kind])
            prof = profile_call(lambda: getattr(linalg, routine)(a),
                                cpu=False, match=("gemm_ffma", "trsm_gemm"))
            _, secs = sync_time(lambda: getattr(linalg, routine)(a))
            emit(call=f"{routine} {items}x{tuple(a.shape[1:])} f32 "
                 f"(lockstep)", wall_s=secs,
                 device_busy_ms=prof["device_busy_ms"],
                 device_idle_share=prof["device_idle_share"],
                 kernel_launches=prof["kernel_launches"],
                 # each batched B2 launch zeroes its ticket and counters
                 # first: one fill kernel among the eager ones
                 b2_workspace_fills=launches["trsm_gemm"],
                 matched=prof["matched"], loop_wall_s=BATCHED_LOOP_S[routine],
                 loop_source="the per-item loop, PERF.md section 5 (PR 18 "
                             "run 1; NVIDIA H100 80GB HBM3, 700.00 W)")
            # the solve's triangular factors of the first item, as
            # potrs / getrs / geqrs hand them to the blocked TRSM
            f0 = res.factors[0]
            factors = {"potrf": ((f0, True), (f0.T.contiguous(), False)),
                       "getrf": ((f0, True), (f0, False)),
                       "geqrf": ((torch.triu(f0)[:BATCHED_TALL,
                                                 :BATCHED_TALL], False),)}
            for t, lower in factors[kind]:
                trsm_gemv_checks(gen, t, lower, nrhs,
                                 f"batched_solve ({kind}) item 0")
            x, launches = counted(f"batched_solve ({kind}) nrhs={nrhs}",
                                  lambda: linalg.batched_solve(res, rhs))
            batched[f"batched_solve ({kind})"] = launches
        only(launches, gemv=per_item[kind])
        a64, x64, r64 = a.double(), x.double(), rhs.double()
        check(f"{routine} max_i |A_i - rebuilt|/|A_i|",
              max(rel(d) / rel(s) for d, s in
                  zip(lb.reconstruct(res).double() - a64, a64)), 1e-4)
        if kind == "geqrf":
            # least squares: the normal equations' backward residual, and
            # x against the f64 solution
            want = torch.linalg.lstsq(a64, r64).solution
            check("batched_solve (geqrf) max_i |A^T(Ax-b)|/(|A|(|A||x|+|b|))",
                  max(rel(ai.T @ (ai @ xi - bi)) / (rel(ai) * (
                      rel(ai) * rel(xi) + rel(bi)))
                      for ai, xi, bi in zip(a64, x64, r64)), 1e-5)
            check("batched_solve (geqrf) max_i |x - x_f64|/|x_f64|",
                  max(rel(xi - wi) / rel(wi) for xi, wi in zip(x64, want)),
                  1e-4)
        else:
            check(f"batched_solve ({kind}) max_i |Ax-b|/(|A||x|+|b|)",
                  max(rel(ai @ xi - bi) / (rel(ai) * rel(xi) + rel(bi))
                      for ai, xi, bi in zip(a64, x64, r64)), 1e-5)
        del res, x, a64, x64, r64
    del g, spd, tall, rhs

    # ---- level 1 at n = 2^26 f32, each against the same sums in f64
    level1_checks(gen, check)
    emit(phase="lapack", wall_s=time.perf_counter() - t_phase,
         batched_launches=batched, residuals=checks)
    for row in rows:
        row["launches"] = batched[row.pop("call")][row["name"]]
    emit(phase="times (lapack batched)", rows=rows)


def linalg3d_operands(gen, items, routine, dtype, shapes):
    """One 3-D call's operands: each shape with the batch in front (a
    triangular T for ``trsm``), a ``None`` shape the shared length-n bias,
    a 1-D shape a vector per item."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.float64).to(dtype)
    ops = []
    for shape in shapes:
        if shape is None:
            ops.append(rnd(shapes[1][-1]))
        else:
            ops.append(rnd(items, *shape))
    if routine == "trsm":
        n = shapes[0][0]
        ops[0] = (ops[0].tril() / n + 2 * torch.eye(
            n, device="cuda", dtype=dtype))
    return ops


def linalg3d_expected(routine, ops):
    """The launches a 3-D call's plan implies, {wrapper: {variant: count}}:
    one B1 or B3 launch per GEMM-shaped step for the whole batch (a
    trsm's off-diagonal block updates, the blocked solve's resolved
    block)."""
    from repro_torch.kernels import gemm as gk
    from repro_torch.tune import dispatch as td

    a = ops[0]
    if routine in ("gemm", "gemm_bias_act"):
        return {routine: {gk.gemm_variant(a, ops[1]): 1}}
    if routine == "syrk":
        return {"gemm": {gk.gemm_variant(a, a.mT): 1}}
    if routine == "gemv":
        return {"gemm": {gk.gemm_variant(a, ops[1][..., None]): 1}}
    n, nrhs = ops[1].shape[-2:]
    block = td.resolve("trsm", (n, nrhs), a.dtype, policy="model",
                       backend="cuda").block
    step = ops[1][:, :block]
    return {"gemm": {gk.gemm_variant(a[:, block:2 * block, :block], step):
                     -(-n // block) - 1}}


def phase_linalg3d():
    """The 3-D ``linalg`` BLAS calls in lockstep (``LINALG3D_CALLS``, 64
    items each, under ``h100`` and ``policy="model"``): each call counted
    on its own (:func:`counted`) against the launches its plan implies
    (:func:`linalg3d_expected`: one per GEMM-shaped step for the batch);
    the per-item loop of 2-D calls the front-end ran before (one call per
    item, stacked) computed once, each item held bitwise to it (``trsm``
    within the f32 tolerance: its eager diagonal blocks' batched products
    sum in another order); the call's seconds (the median of
    ``LINALG3D_REPS`` warm calls) beside the loop's (its second call). Then the two new batched kernel forms' times
    rows at the bf16 gemm's and the gelu gemm_bias_act's operands, and
    ``EXAMPLES`` run as scripts on the card at their default sizes.
    Returns the two rows."""
    from repro_torch import linalg
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import gemm as gk
    from repro_torch.tune import dispatch as td

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    items = LINALG3D_ITEMS
    t_phase = time.perf_counter()
    calls = {"gemm": lambda a, b: linalg.gemm(a, b),
             "gemm_bias_act": lambda a, b, bias: linalg.gemm_bias_act(
                 a, b, bias, "gelu"),
             "syrk": lambda a: linalg.syrk(a),
             "trsm": lambda t, r: linalg.trsm(t, r),
             "gemv": lambda a, x: linalg.gemv(a, x)}
    legs, kept = {}, {}
    for tag, (routine, dtype, shapes) in LINALG3D_CALLS.items():
        ops = linalg3d_operands(gen, items, routine, dtype, shapes)
        fn = calls[routine]
        per_item = lambda i: [o if o.ndim == 1 else o[i] for o in ops]
        with linalg.use(policy="model", device="cuda"):
            got, launches = counted(f"linalg3d {tag} x {items}",
                                    lambda: fn(*ops))
            seen = launches_of(launches)
            expected = linalg3d_expected(routine, ops)
            assert seen == expected, (tag, seen, expected)
            loop = lambda: torch.stack([fn(*per_item(i))
                                        for i in range(items)])
            want = loop()
            loop_s = sync_time(loop)[1]
            secs = statistics.median(sync_time(lambda: fn(*ops))[1]
                                     for _ in range(LINALG3D_REPS))
        bitwise = torch.equal(got, want)
        if routine == "trsm":
            err = compare(f"linalg3d {tag}: each item against the 2-D call",
                          got, want)
        else:
            err = 0.0
            bitwise_items(f"linalg3d {tag}", got, lambda i: want[i])
        legs[tag] = {"launches": seen, "plan": expected,
                     "bitwise_per_item": bitwise, "max_abs_diff": err,
                     "seconds": secs, "loop_seconds": loop_s,
                     "loop": "the per-item loop of 2-D calls (the "
                             "front-end's path before the lockstep)"}
        emit(leg=f"linalg3d {tag} x {items}", **legs[tag])
        if tag in ("gemm bf16 1024^3", "gemm_bias_act f32 512^3 gelu"):
            kept[tag] = ops
        del ops, got, want

    # the two new batched kernel forms, timed at those operands (these
    # comparison launches are not the main path's)
    rows = []
    a, b = kept["gemm bf16 1024^3"]
    m, k, n = a.shape[1], a.shape[2], b.shape[2]
    plan = td.resolve("gemm", (m, n, k), a.dtype, policy="model",
                      backend="cuda").gemm_plan
    got = gk.gemm(a, b, plan=plan)
    launch = dict(gk.gemm.last_launch)
    assert launch["variant"] == "wgmma", launch
    err = compare(f"gemm batched {items} x {m}x{n}x{k} bf16 [wgmma "
                  f"{launch['tile']}] vs plain", got, gk.gemm_plain(a, b))
    b_ms, b_by = bound(2.0 * items * m * n * k,
                       items * (m * k + k * n + m * n) * 2, torch.bfloat16)
    rows.append(dict(
        name="gemm [batched wgmma]", leg="gemm bf16 1024^3",
        shape=f"{items} x {m}x{n}x{k} bfloat16 (the linalg3d leg's, one "
              f"launch)",
        ms=cuda_ms(lambda: gk.gemm(a, b, plan=plan)),
        plain_ms=cuda_ms(lambda: gk.gemm_plain(a, b)),
        library_ms=cuda_ms(lambda: torch.bmm(a, b)), library="torch.bmm",
        loop_ms=cuda_ms(lambda: [gk.gemm(a[i], b[i], plan=plan)
                                 for i in range(items)]),
        loop="the per-item loop of 2-D launches",
        bound_ms=b_ms, bound_by=b_by, variant="wgmma", tile=launch["tile"],
        grid=list(gk.launch_grid("wgmma", launch["tile"], m, n, None,
                                 items)), max_abs_err=err))
    a, b, bias = kept["gemm_bias_act f32 512^3 gelu"]
    m, k, n = a.shape[1], a.shape[2], b.shape[2]
    res = td.resolve("gemm+epilogue", (m, n, k), a.dtype, policy="model",
                     backend="cuda", epilogue="gelu", has_bias=True)
    run = lambda: fk.gemm_bias_act(a, b, bias, "gelu", plan=res.gemm_plan)
    got = run()
    launch = dict(fk.gemm_bias_act.last_launch)
    err = compare(f"gemm_bias_act batched {items} x {m}x{n}x{k} f32 gelu "
                  f"[{launch['variant']} {launch['tile']}] vs plain", got,
                  fk.gemm_bias_act_plain(a, b, bias, "gelu"))
    b_ms, b_by = bound(2.0 * items * m * n * k,
                       items * (m * k + k * n + m * n) * 4 + n * 4,
                       torch.float32)
    rows.append(dict(
        name="gemm_bias_act [batched]", leg="gemm_bias_act f32 512^3 gelu",
        shape=f"{items} x {m}x{n}x{k} float32 gelu + bias (the linalg3d "
              f"leg's, one launch)",
        ms=cuda_ms(run),
        plain_ms=cuda_ms(lambda: fk.gemm_bias_act_plain(a, b, bias,
                                                        "gelu")),
        library_ms=cuda_ms(lambda: F.gelu(torch.baddbmm(bias, a, b),
                                          approximate="tanh")),
        library="torch.baddbmm + gelu",
        loop_ms=cuda_ms(lambda: [fk.gemm_bias_act(a[i], b[i], bias, "gelu",
                                                  plan=res.gemm_plan)
                                 for i in range(items)]),
        loop="the per-item loop of 2-D launches",
        bound_ms=b_ms, bound_by=b_by, variant=launch["variant"],
        tile=launch["tile"], max_abs_err=err))
    for row in rows:
        base = row["name"].split()[0]
        row.update(route="cuda", source=REPLACES[base][0],
                   replaces=REPLACES[base][1],
                   launches=sum(legs[row["leg"]]["launches"].get(base,
                                                                 {}).values()))
    del kept, a, b, bias, got
    torch.cuda.empty_cache()
    emit(phase="times (linalg3d batched)", rows=rows)

    # the examples on the card, as a user runs them (the kernels are built)
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", "torch", name)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name in EXAMPLES}
    for name, p in procs.items():
        out, err_text = p.communicate(timeout=EXAMPLES_TIMEOUT_S)
        emit(example=f"examples/torch/{name}", exit_code=p.returncode,
             seconds=time.perf_counter() - t0,
             last_lines=out.strip().splitlines()[-3:])
        assert p.returncode == 0, (name, err_text[-3000:])
    emit(phase="linalg3d", wall_s=time.perf_counter() - t_phase, legs=legs)
    return rows


def launches_of(launches):
    """A :func:`counted` call's launches as {wrapper: {variant: count}}:
    B1 and B3 by variant, the other wrappers under their own name."""
    from repro_torch.kernels import fused as fk

    out = {name: {name: c} for name, c in launches.items()
           if name not in ("gemm", "gemm_variants", "gemm_bias_act") and c}
    if launches["gemm"]:
        out["gemm"] = dict(launches["gemm_variants"])
    if launches["gemm_bias_act"]:
        out["gemm_bias_act"] = {v: c for v, c in
                                fk.gemm_bias_act.variant_launches.items()
                                if c}
    return out


def path_gemm_check(name, x, y, variant):
    """B1 at one operand pair of the lapack path, on the tile of its
    ``h100`` plan (as ``tune.dispatch`` hands it over), against the plain
    version; the call must take ``variant``."""
    from repro_torch.kernels import gemm as gk
    from repro_torch.tune import dispatch as td

    plan = td.resolve("gemm", (x.shape[0], y.shape[1], x.shape[1]), x.dtype,
                      policy="model", backend="cuda").gemm_plan
    got = gk.gemm(x, y, plan=plan)
    launch = gk.gemm.last_launch
    assert launch["variant"] == variant, (name, launch)
    compare(f"gemm {name} {tuple(x.shape)}x{tuple(y.shape)} strides "
            f"{x.stride()} {y.stride()} [{variant} {launch['tile']}]",
            got, gk.gemm_plain(x, y))


def qr_update_checks(a, block, tiled):
    """B1 at the first trailing update of the blocked QR of ``a``: the
    first panel factored, then V^T C and V W on the operands ``geqrf``
    hands over (``lapack/qr.py::wy_operands``: V^T contiguous, C a window
    of the packed matrix), both on the dtype's ``tiled`` variant."""
    from repro_torch.kernels import gemm as gk
    from repro_torch.lapack import qr as lq

    tag = f"qr {str(a.dtype)[6:]} {a.shape[0]}x{a.shape[1]} nb={block}"
    panel, tau = lq.geqrf_unblocked(a[:, :block])
    packed = torch.cat([panel, a[:, block:]], 1)
    vt, v, t, c = lq.wy_operands(packed, 0, block, tau)
    path_gemm_check(f"{tag} V^T C", vt, c, tiled)
    path_gemm_check(f"{tag} V W", v, t.T @ gk.gemm_plain(vt, c), tiled)


def b2_walk(kind, a, block):
    """B2 at every trailing update of one batched item's blocked ``potrf``
    (form "syrk") or ``getrf`` (form "lu"), on the strided views of the
    working copy that the driver hands over, against the plain version;
    the walk goes on with the plain results."""
    from repro_torch.kernels import fused as fk
    from repro_torch.lapack import cholesky as lc
    from repro_torch.lapack import lu as ll

    a, n = a.clone(), a.shape[0]
    form, unit = ("syrk", False) if kind == "potrf" else ("lu", True)
    for j0 in range(0, n - block, block):
        j1 = j0 + block
        if kind == "potrf":
            a[j0:j1, j0:j1] = lc.potrf_unblocked(a[j0:j1, j0:j1])
            args = (a[j0:j1, j0:j1], a[j1:, j0:j1].T, None, a[j1:, j1:])
        else:
            for k in range(j0, j1):
                ll._pivot_step(a, k, j1)
            args = (a[j0:j1, j0:j1], a[j0:j1, j1:], a[j1:, j0:j1],
                    a[j1:, j1:])
        x, c = fk.trsm_gemm(*args, form=form, unit_diag=unit)
        xp, cp = fk.trsm_gemm_plain(*args, form=form, unit_diag=unit)
        name = (f"trsm_gemm {str(a.dtype)[6:]} batched {kind} item "
                f"nb={block} n={n - j1} {form} unit={unit}")
        compare(name + " X", x, xp)
        compare(name + " C", c, cp)
        if kind == "potrf":
            a[j1:, j0:j1] = xp.T
        else:
            a[j0:j1, j1:] = xp
        a[j1:, j1:] = cp


def bitwise_items(name, got, launch_2d, variant=None):
    """Each item of a batched launch's output against the 2-D launch on
    that item (``launch_2d(i)``), bitwise; with ``variant``, the 2-D
    launches must take it too. One line."""
    from repro_torch.kernels import gemm as gk

    outs = got if isinstance(got, tuple) else (got,)
    worst = 0.0
    for i in range(outs[0].shape[0]):
        want = launch_2d(i)
        want = want if isinstance(want, tuple) else (want,)
        if variant is not None:
            assert gk.gemm.last_launch["variant"] == variant, \
                (name, gk.gemm.last_launch)
        for o, w in zip(outs, want):
            if not torch.equal(o[i], w):
                worst = max(worst, (o[i].double() - w.double()).abs().max()
                            .item())
    emit(check=f"{name}: each of {outs[0].shape[0]} items bitwise the 2-D "
               f"launch on it", max_abs_diff=worst, ok=worst == 0.0)
    assert worst == 0.0, (name, worst)


def batched_rows(gen, spd, g, tall, blocks, qr_block, nrhs):
    """Each batched kernel launch of the lapack phase's drivers, at the
    operands the drivers hand it, against its plain version and, item by
    item and bitwise, against the 2-D launch on that item: B1 ``ffma`` at
    the first QR step's V^T C (64 items), ``dmma`` f64 at a ragged m read
    through a row window of taller items (``BATCHED_DMMA``: the rows past
    m are the item's own, which the 3-D TMA map must read as zeros),
    ``gemv`` at a solve's last lower TRSM update, B2 ``syrk`` at
    ``batched_cholesky``'s first trailing update and ``lu`` at
    ``batched_lu``'s. Returns the times rows of the ``ffma``, ``syrk``
    and ``lu`` launches (ms beside the plain version, the bound,
    ``torch.bmm`` for B1 and the per-item loop of 2-D launches, B2's
    device ms by the profiler and the seconds its row took; ``call``
    names the lapack call whose launch count the row takes)."""
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import gemm as gk
    from repro_torch.lapack import cholesky as lc
    from repro_torch.lapack import lu as ll
    from repro_torch.lapack import qr as lq
    from repro_torch.tune import dispatch as td

    items = spd.shape[0]
    rows = []

    def plan_of(x, y):
        return td.resolve("gemm", (x.shape[-2], y.shape[-1], x.shape[-1]),
                          x.dtype, policy="model", backend="cuda").gemm_plan

    # B1 "ffma": V^T C of batched_qr's first step
    nb = qr_block
    panel, tau = lq.geqrf_unblocked(tall[..., :nb])
    vt, _, _, c = lq.wy_operands(torch.cat([panel, tall[..., nb:]], -1), 0,
                                 nb, tau)
    plan = plan_of(vt, c)
    got = gk.gemm(vt, c, plan=plan)
    launch = dict(gk.gemm.last_launch)
    assert launch["variant"] == "ffma", launch
    tag = (f"gemm batched {items} x {tuple(vt.shape[1:])}x"
           f"{tuple(c.shape[1:])} strides {vt.stride()} {c.stride()} "
           f"[ffma {launch['tile']}] batched_qr V^T C")
    err = compare(tag, got, gk.gemm_plain(vt, c))
    bitwise_items(tag, got, lambda i: gk.gemm(vt[i], c[i], plan=plan),
                  "ffma")
    m, k, n = vt.shape[1], vt.shape[2], c.shape[2]
    b_ms, b_by = bound(2.0 * items * m * n * k,
                       items * (m * k + k * n + m * n) * 4, torch.float32)
    rows.append(dict(
        name="gemm", call="batched_qr",
        shape=f"{items} x {m}x{n}x{k} float32 (batched_qr's first V^T C, "
              f"one launch)",
        ms=cuda_ms(lambda: gk.gemm(vt, c, plan=plan)),
        plain_ms=cuda_ms(lambda: gk.gemm_plain(vt, c)),
        library_ms=cuda_ms(lambda: torch.bmm(vt, c)),
        library="torch.bmm",
        kernel_ms=kernel_ms(lambda: gk.gemm(vt, c, plan=plan), "gemm_ffma"),
        loop_ms=cuda_ms(lambda: [gk.gemm(vt[i], c[i], plan=plan)
                                 for i in range(items)]),
        loop="the per-item loop of 2-D launches",
        bound_ms=b_ms, bound_by=b_by, variant="ffma", tile=launch["tile"],
        grid=list(gk.launch_grid("ffma", launch["tile"], m, n, None,
                                 items)),
        max_abs_err=err))
    del panel, tau, vt, c, got

    # B1 "dmma": f64 at a ragged m, each item a row window of a taller one
    bi, m, k, n = BATCHED_DMMA
    tall64 = torch.randn(bi, m + 64, k, generator=gen, device="cuda",
                         dtype=torch.float64)
    a = tall64[:, 32:32 + m]
    b = torch.randn(bi, k, n, generator=gen, device="cuda",
                    dtype=torch.float64)
    plan = plan_of(a, b)
    got = gk.gemm(a, b, plan=plan)
    assert gk.gemm.last_launch["variant"] == "dmma", gk.gemm.last_launch
    tag = (f"gemm batched {bi} x {m}x{n}x{k} float64 ragged m, row windows "
           f"strides {a.stride()} [dmma {gk.gemm.last_launch['tile']}]")
    compare(tag, got, gk.gemm_plain(a, b))
    bitwise_items(tag, got, lambda i: gk.gemm(a[i], b[i], plan=plan), "dmma")
    del tall64, a, b, got

    # B1 "gemv": a solve's last lower TRSM update, a row window of the
    # factors times the solved rows
    blk = td.resolve("trsm", (g.shape[-1], nrhs), torch.float32,
                     policy="model", backend="cuda").block
    i0 = (g.shape[-1] - 1) // blk * blk
    win = g[:, i0:, :i0]
    x = torch.randn(items, i0, nrhs, generator=gen, device="cuda")
    got = gk.gemm(win, x)
    assert gk.gemm.last_launch["variant"] == "gemv", gk.gemm.last_launch
    tag = (f"gemm batched {items} x {tuple(win.shape[1:])}x{nrhs} TRSM "
           f"update strides {win.stride()} [gemv split "
           f"{gk.gemm.last_launch.get('split')}]")
    compare(tag, got, gk.gemm_plain(win, x))
    bitwise_items(tag, got, lambda i: gk.gemm(win[i], x[i]), "gemv")
    del win, x, got

    # B2: the first trailing update of batched_cholesky ("syrk") and of
    # batched_lu ("lu"), on the views the drivers hand over
    nb = blocks["potrf"]
    a = spd.clone()
    a[..., :nb, :nb] = lc.potrf_unblocked(a[..., :nb, :nb])
    syrk = (a[..., :nb, :nb], a[..., nb:, :nb].mT, None, a[..., nb:, nb:])
    nb_lu = blocks["getrf"]
    lu_a = g.clone()
    for kk in range(nb_lu):
        ll._pivot_step(lu_a, kk, nb_lu)
    lu = (lu_a[..., :nb_lu, :nb_lu], lu_a[..., :nb_lu, nb_lu:],
          lu_a[..., nb_lu:, :nb_lu], lu_a[..., nb_lu:, nb_lu:])
    item = lambda args, i: [None if t is None else t[i] for t in args]
    errs, grids = {}, {}
    for form, args, unit in (("syrk", syrk, False), ("lu", lu, True)):
        got = fk.trsm_gemm(*args, form=form, unit_diag=unit)
        grids[form] = fk.trsm_gemm.last_launch.get("grid")
        want = fk.trsm_gemm_plain(*args, form=form, unit_diag=unit)
        tag = (f"trsm_gemm batched {items} x nb={args[0].shape[-1]} "
               f"n={args[3].shape[-1]} {form} unit={unit} grid "
               f"{grids[form]}")
        errs[form] = max(compare(tag + " X", got[0], want[0]),
                         compare(tag + " C", got[1], want[1]))
        bitwise_items(tag, got, lambda i: fk.trsm_gemm(
            *item(args, i), form=form, unit_diag=unit))
    for form, args, call in (("syrk", syrk, "batched_cholesky"),
                             ("lu", lu, "batched_lu")):
        unit = form == "lu"
        bnb, n = args[0].shape[-1], args[3].shape[-1]
        m = args[3].shape[-2]
        # the solve (nb^2 n), the update (2 m n nb); L11, AP, BL ("lu"),
        # X, C and C' each moved once
        b_ms, b_by = bound(
            items * (bnb * bnb * n + 2.0 * m * n * bnb),
            items * (bnb * bnb + 2 * bnb * n + (m * bnb if unit else 0)
                     + 2 * m * n) * 4, torch.float32)
        run = lambda: fk.trsm_gemm(*args, form=form, unit_diag=unit)
        loop = lambda: [fk.trsm_gemm(*item(args, i), form=form,
                                     unit_diag=unit) for i in range(items)]
        t0 = time.perf_counter()
        rows.append(dict(
            name="trsm_gemm", call=call,
            shape=f"{items} x nb={bnb} n={n} m={m} float32 {form} "
                  f"unit={unit} ({call}'s first trailing update, one "
                  f"launch)",
            ms=cuda_ms(run),
            plain_ms=cuda_ms(lambda: fk.trsm_gemm_plain(
                *args, form=form, unit_diag=unit)),
            library_ms=None, kernel_ms=kernel_ms(run, "trsm_gemm"),
            loop_ms=cuda_ms(loop),
            loop_kernel_ms=kernel_ms(loop, "trsm_gemm") * items,
            loop="the per-item loop of 2-D launches (no single PyTorch "
                 "call computes the fused function)",
            bound_ms=b_ms, bound_by=b_by, variant="ffma", grid=grids[form],
            max_abs_err=errs[form],
            seconds_to_time=time.perf_counter() - t0))
    for row in rows:
        row.update(route="cuda", source=REPLACES[row["name"]][0],
                   replaces=REPLACES[row["name"]][1])
    return rows


def trsm_gemv_checks(gen, t, lower, nrhs, tag):
    """B1's "gemv" at every off-diagonal update of the blocked TRSM that a
    solve runs on the triangular factor ``t`` with ``nrhs`` right-hand
    sides (``blas/level3.py::trsm``: a row window of T times the solved
    rows of X), each against its plain version."""
    from repro_torch.tune import dispatch as td

    n = t.shape[0]
    block = td.resolve("trsm", (n, nrhs), t.dtype, policy="model",
                       backend="cuda").block
    x = torch.randn(n, nrhs, generator=gen, device="cuda", dtype=t.dtype)
    side = "lower" if lower else "upper"
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        if lower and i0 > 0:
            path_gemm_check(f"{tag} {side} TRSM rows {i0}:{i1}",
                            t[i0:i1, :i0], x[:i0], "gemv")
        elif not lower and i1 < n:
            path_gemm_check(f"{tag} {side} TRSM rows {i0}:{i1}",
                            t[i0:i1, i1:], x[i1:], "gemv")


def export_checks(tr, tmp, plan):
    """Write ``tr`` (a traced QR f32 4096) in both exporter formats, read
    the files back and check them: the schema version and event fields,
    ``ts`` / ``t_start`` in order, and the QR's panel and trailing spans
    nested under its ``linalg.qr`` span."""
    from repro_torch import obs

    chrome = obs.save_chrome_trace(tr, os.path.join(tmp, "qr.json"))
    lines = obs.save_jsonl(tr, os.path.join(tmp, "qr.jsonl"))
    with open(chrome) as f:
        blob = json.load(f)
    with open(lines) as f:
        recs = [json.loads(line) for line in f]
    events = blob["traceEvents"]
    ts = [e["ts"] for e in events]
    body = [r for r in recs if r["kind"] == "event"]
    assert blob["otherData"]["schema_version"] == obs.SCHEMA_VERSION
    assert recs[0]["kind"] == "header" and recs[-1]["kind"] == "counters"
    assert recs[0]["schema_version"] == obs.SCHEMA_VERSION
    assert all(tuple(k for k in r if k != "kind") == obs.EVENT_FIELDS
               for r in body), body[:2]
    assert ts == sorted(ts) and len(events) == len(body) == len(tr.events)
    starts = [r["t_start"] for r in body]
    assert starts == sorted(starts)
    (top,) = [r for r in body if r["name"] == "linalg.qr"]
    nested = {name: sum(r["name"] == name and r["parent"] == top["id"]
                        for r in body)
              for name in ("geqrf.panel", "geqrf.trailing")}
    panels = -(-N64 // plan["block"])
    assert nested == {"geqrf.panel": panels,
                      "geqrf.trailing": plan["b1"] // 2}, nested
    emit(export=f"{tr.name} traced, written and read back",
         events=len(body), nested=nested,
         bytes={"chrome": os.path.getsize(chrome),
                "jsonl": os.path.getsize(lines)},
         summary=obs.summary(tr).splitlines()[:6])


def level1_checks(gen, check):
    """Each level-1 routine (``dot`` in its three schedules) at n = 2^26
    f32 through ``linalg`` on the card against the same computation in
    f64 on the card, its ms per call (CUDA events) beside the bytes it
    must move at 3.35 TB/s; none may launch B4 or any other kernel of the
    port. ``iamax`` must be exact."""
    from repro_torch import linalg

    n = LEVEL1_N
    x = torch.randn(n, generator=gen, device="cuda")
    y = torch.randn(n, generator=gen, device="cuda")
    x64, y64 = x.double(), y.double()
    xy = x64 * y64
    dot_err = lambda got: abs(got.item() - xy.sum().item()) \
        / xy.abs().sum().item()
    vec = n * 4
    # name: (call, bytes it must move, its error against f64)
    cases = {
        "dot tree": (lambda: linalg.dot(x, y), 2 * vec, dot_err),
        "dot sequential": (lambda: linalg.dot(x, y, schedule="sequential"),
                           2 * vec, dot_err),
        "dot strided U=8": (lambda: linalg.dot(x, y, schedule="strided"),
                            2 * vec, dot_err),
        "axpy": (lambda: linalg.axpy(1.5, x, y), 3 * vec,
                 lambda got: rel_max(got, 1.5 * x64 + y64)),
        "scal": (lambda: linalg.scal(-2.0, x), 2 * vec,
                 lambda got: rel_max(got, -2.0 * x64)),
        "nrm2": (lambda: linalg.nrm2(x), vec, lambda got: abs(
            got.item() - x64.norm().item()) / x64.norm().item()),
        "asum": (lambda: linalg.asum(x), vec, lambda got: abs(
            got.item() - x64.abs().sum().item()) / x64.abs().sum().item()),
        "iamax": (lambda: linalg.iamax(x), vec, lambda got: float(
            got.item() != x64.abs().argmax().item())),
        "rot": (lambda: linalg.rot(x, y, 0.6, 0.8), 4 * vec,
                lambda got: max(rel_max(got[0], 0.6 * x64 + 0.8 * y64),
                                rel_max(got[1], 0.6 * y64 - 0.8 * x64))),
    }
    rows = {}
    with linalg.use(policy="model", device="cuda"):
        for name, (fn, nbytes, err) in cases.items():
            got, launches = counted(f"{name} n=2^26 f32", fn)
            assert not any(v for k, v in launches.items()
                           if k != "gemm_variants"), launches
            check(f"{name} n=2^26 f32 vs f64",
                  err(got), 0.0 if name == "iamax" else 1e-5)
            rows[name] = {"ms": cuda_ms(fn), "bound_ms": nbytes
                          / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    emit(level1="n=2^26 f32, ms per call (CUDA events, 5 calls after one "
                "warm-up) beside the bytes bound at 3.35 TB/s", **rows)


def rel_max(got, want):
    """max|got - want| / max|want|, in f64."""
    return (got.double() - want).abs().max().item() / want.abs().max().item()


def phase_tune(gen):
    """The tuning loop on the card, with the launch counts zeroed just
    before and read just after: measured sweeps of B1's tiles into a
    temporary registry, a tuned ``linalg.gemm`` that hits it and launches
    the winner's tile, the fused-vs-staged sweep of B3, the calibration
    (GEMM ladder, stream suite, the chain kernel per op class). No staged
    trailing update is timed against B2: the main phase asserts that the
    h100 chain planner fuses them all."""
    import tempfile

    from repro_torch import arch, linalg, obs
    from repro_torch.kernels import gemm as gk
    from repro_torch.tune import dispatch as td
    from repro_torch.tune import search
    from repro_torch.tune.registry import Registry

    counts = zero_launches()
    with tempfile.TemporaryDirectory(prefix="repro_torch_tune_") as tmp:
        reg = Registry(path=os.path.join(tmp, "registry.json"),
                       autoload=False)
        sweeps = {}
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            res, secs = sync_time(lambda: search.tune_gemm(
                TUNE_N, TUNE_N, TUNE_N, dtype, registry=reg, top_k=3,
                reps=3, seed=SEED))
            for row in res.measured:        # each candidate ran its tile
                assert row["tile_source"] == "plan" and tuple(row["tile"]) \
                    == (row["bm"], row["bn"], row["bk"]), row
            emit(sweep=f"tune_gemm {TUNE_N}^3 {res.dtype}", wall_s=secs,
                 **res.to_json())
            sweeps[dtype] = res
        reg.save()
        win = sweeps[torch.float32].best.params
        res = td.resolve("gemm", (TUNE_N,) * 3, torch.float32,
                         policy="tuned", registry=Registry(path=reg.path),
                         backend="cuda")
        want = (win["bm"], win["bn"], win["bk"])
        assert res.source == "registry" and (
            res.gemm_plan.bm, res.gemm_plan.bn, res.gemm_plan.bk) == want, res
        a = torch.randn(TUNE_N, TUNE_N, generator=gen, device="cuda")
        b = torch.randn(TUNE_N, TUNE_N, generator=gen, device="cuda")
        before = obs.counters_snapshot()
        with linalg.use(policy="tuned", device="cuda", registry=reg.path):
            out, secs = sync_time(lambda: linalg.gemm(a, b))
        hits = obs.counters_delta(before).get("dispatch.registry_hit", 0)
        launch = gk.gemm.last_launch
        assert hits == 1 and launch["tile"] == want \
            and launch["tile_source"] == "plan", (hits, launch)
        compare(f"linalg.gemm f32 {TUNE_N}^3 tuned (registry) vs plain", out,
                gk.gemm_plain(a, b))
        emit(call=f"linalg.gemm f32 {TUNE_N}^3 policy=tuned", wall_s=secs,
             source=res.source, registry_hits=hits, winner=want,
             tile=launch["tile"], tile_source=launch["tile_source"],
             variant=launch["variant"])
        del a, b, out
        fres, secs = sync_time(lambda: search.tune_fused_gemm(
            TUNE_N, TUNE_N, TUNE_N, "gelu", torch.float32, registry=reg,
            reps=3, seed=SEED))
        emit(sweep=f"tune_fused_gemm {TUNE_N}^3 float32 gelu", wall_s=secs,
             **fres.to_json())
    result, secs = sync_time(lambda: arch.calibrate_full("cuda"))
    fitted, h100 = result.machine, arch.get("h100")
    cycles = {r["params"]["op_class"]: r["params"]["cycles_per_op"]
              for r in result.report if r["bench"] == "chain"}
    best = {k: result.best_residual(k) for k in ("gemm", "stream")}
    emit(calibration=fitted.name, wall_s=secs,
         fitted={"peak_flops": fitted.pe.peak_flops,
                 "hbm_bw": fitted.memory.hbm_bw,
                 "depths": dict(fitted.fpu.depths)},
         h100={"peak_flops": h100.pe.peak_flops,
               "hbm_bw": h100.memory.hbm_bw,
               "depths": dict(h100.fpu.depths)},
         cycles_per_op=cycles, best_residual=best,
         tolerance=arch.CALIBRATION_TOLERANCE, report=list(result.report))
    assert all(v <= arch.CALIBRATION_TOLERANCE for v in best.values()), best
    launches = {k: w.launches for k, w in counts.items()}
    assert launches["gemm"] > 0 and launches["gemm_bias_act"] > 0 \
        and launches["fpu_chain"] > 0, launches
    emit(phase="tune", launches=launches)
    emit(chain_switch="none: the h100 chain planner fuses every trailing "
                      "update of the drivers (B2 fits its shared memory at "
                      "nb = 128 and the fused chain moves fewer bytes), so "
                      "there is no staged n' to time")
    return launches


def trsm_gemm_row(gen, nb, n, form, dtype):
    """B2 at one trailing update (m = n, the operands as the drivers pass
    them: AP a transposed view), beside its plain version, its ops bound
    and a two-call library yardstick (``solve_triangular`` then
    ``addmm``: no single PyTorch call computes the fused function)."""
    from repro_torch.kernels import fused as fk

    unit = form == "lu"
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    l11, ap, c = lower(gen, nb, dtype, unit), rnd(n, nb).T, rnd(n, n)
    bl = rnd(n, nb) if form == "lu" else None
    args = (l11, ap, bl, c)
    item = c.element_size()
    flops = nb * nb * n + 2.0 * n * n * nb
    nbytes = (nb * nb + 2 * nb * n + 2 * n * n
              + (n * nb if form == "lu" else 0)) * item
    b_ms, b_by = bound(flops, nbytes, dtype)

    def pair():
        x = torch.linalg.solve_triangular(l11, ap, upper=False,
                                          unitriangular=unit)
        return x, torch.addmm(c, x.T if bl is None else bl, x, alpha=-1)

    x, co = fk.trsm_gemm(*args, form=form, unit_diag=unit)
    launch = dict(fk.trsm_gemm.last_launch)
    # the solve phase alone: the same panel with no rows to update
    solve = (l11, ap, bl[:0] if bl is not None else c[:0, :nb], c[:0])
    xp, cp = fk.trsm_gemm_plain(*args, form=form, unit_diag=unit)
    return dict(
        name="trsm_gemm", shape=f"nb={nb} n={n} m={n} {str(dtype)[6:]} "
        f"{form} unit={unit}",
        ms=cuda_ms(lambda: fk.trsm_gemm(*args, form=form, unit_diag=unit)),
        plain_ms=cuda_ms(lambda: fk.trsm_gemm_plain(*args, form=form,
                                                    unit_diag=unit)),
        kernel_ms=kernel_ms(lambda: fk.trsm_gemm(*args, form=form,
                                                 unit_diag=unit), "trsm_gemm"),
        solve_only_kernel_ms=kernel_ms(lambda: fk.trsm_gemm(
            *solve, form="lu", unit_diag=unit), "trsm_gemm"),
        library_ms=None, library_pair_ms=cuda_ms(pair),
        library_pair="torch.linalg.solve_triangular then torch.addmm "
                     "(a two-call yardstick)",
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=max((x.double() - xp.double()).abs().max().item(),
                        (co.double() - cp.double()).abs().max().item()),
        launch={k: v for k, v in launch.items() if k != "row_block"})


def phase_times(gen, launches):
    from repro_torch.core.codesign import plan_factorization, plan_from_blocks
    from repro_torch.kernels import fpu_chain as fc
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import gemm as gk

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    rows = []
    # B1 at each of the main path's dtypes, at every compiled tile of the
    # dtype's tiled variant (the default, which the main path's plan names,
    # first): bf16 priced at the bf16 tensor peak, f32 at the FP32 peak,
    # f64 at the FP64 (tensor) peak
    for dtype, n in ((torch.float32, N), (torch.bfloat16, N),
                     (torch.float64, N64)):
        a, b = rnd(n, n).to(dtype), rnd(n, n).to(dtype)
        b_ms, b_by = bound(2.0 * n ** 3, 3 * n * n * a.element_size(), dtype)
        plain = gk.gemm_plain(a, b)
        plain_ms = cuda_ms(lambda: gk.gemm_plain(a, b))
        library_ms = cuda_ms(lambda: torch.matmul(a, b))
        for tile in gk.TILE_SETS[gk.TILED[dtype]]:
            plan = plan_from_blocks(n, n, n, *tile, dtype=dtype,
                                    machine="h100")
            got = gk.gemm(a, b, plan=plan)
            assert gk.gemm.last_launch["tile"] == tile
            rows.append(dict(
                name="gemm", shape=f"{n}x{n}x{n} {str(dtype)[6:]}",
                ms=cuda_ms(lambda: gk.gemm(a, b, plan=plan)),
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by, variant=gk.gemm.last_launch["variant"],
                tile=tile, max_abs_err=(got.double() - plain.double())
                .abs().max().item(), equals_library_bitwise=bool(
                    torch.equal(got, torch.matmul(a, b)))))
        del a, b, got, plain
    # the solve's blocked-TRSM updates, 128 x k x 1 (k up to N - 128, a
    # window of the factor), on "gemv": its wrapper's host time per call
    # exceeds the kernels' device time, so ms and library_ms are timed as
    # CUDA-graph replays (back-to-back CUDA-event times beside them)
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        a = rnd(N, N).to(dtype)[128:256, :N - 128]
        b = rnd(N - 128, 1).to(dtype)
        item = a.element_size()
        b_ms, b_by = bound(2.0 * 128 * (N - 128),
                           (128 * (N - 128) + (N - 128) + 128) * item, dtype)
        got = gk.gemm(a, b)
        rows.append(dict(
            name="gemm", shape=f"128x1x{N - 128} {str(dtype)[6:]} "
            f"(TRSM update)", ms=graph_ms(lambda: gk.gemm(a, b)),
            plain_ms=cuda_ms(lambda: gk.gemm_plain(a, b)),
            library_ms=graph_ms(lambda: torch.matmul(a, b)),
            ms_back_to_back=cuda_ms(lambda: gk.gemm(a, b)),
            library_ms_back_to_back=cuda_ms(lambda: torch.matmul(a, b)),
            timing="ms, library_ms: 20 calls in one CUDA graph, replayed",
            bound_ms=b_ms, bound_by=b_by,
            variant=gk.gemm.last_launch["variant"],
            tile=gk.gemm.last_launch["tile"],
            split=gk.gemm.last_launch.get("split"),
            max_abs_err=(got.double() - gk.gemm_plain(a, b).double())
            .abs().max().item()))
        del a, b, got
    a, b, bias = rnd(N, N), rnd(N, N), rnd(N)
    f32 = 4
    gemm_flops, gemm_bytes = 2.0 * N ** 3, 3 * N * N * f32
    # bias add + tanh-gelu priced as 9 operations per output
    b_ms, b_by = bound(gemm_flops + 9.0 * N * N, gemm_bytes + N * f32,
                       torch.float32)
    plain_ms = cuda_ms(lambda: fk.gemm_bias_act_plain(a, b, bias, "gelu"))
    library_ms = cuda_ms(lambda: F.gelu(torch.addmm(bias, a, b),
                                        approximate="tanh"))
    for tile in gk.TILE_SETS["ffma"]:
        plan = plan_from_blocks(N, N, N, *tile, dtype=torch.float32,
                                machine="h100")
        rows.append(dict(
            name="gemm_bias_act", shape=f"{N}x{N}x{N} float32 gelu+bias",
            ms=cuda_ms(lambda: fk.gemm_bias_act(a, b, bias, "gelu",
                                                plan=plan)),
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
            bound_by=b_by,
            max_abs_err=(fk.gemm_bias_act(a, b, bias, "gelu", plan=plan)
                         - fk.gemm_bias_act_plain(a, b, bias, "gelu"))
            .abs().max().item(),
            variant=fk.gemm_bias_act.last_launch["variant"],
            tile=fk.gemm_bias_act.last_launch["tile"]))
    del a, b, bias
    # the FPU-chain probe per op class at the calibration's chain length:
    # one warp's dependent chain (bound by its latency; the roofline bound
    # below is the flops and bytes it does, far under it). Its launches
    # come from the tune phase. The plain loop is one launch per step (two
    # for sqrt), so it is timed over one call after its warm-up.
    v0, it = chain_input(gen), chain_iters()
    for op in fc.OP_CLASSES:
        b_ms, b_by = bound((2.0 if op == "sqrt" else 1.0) * fc.LANES * it,
                           2 * fc.LANES * 4 + 8, torch.float32)
        got, cycles = fc.fpu_chain(op, v0, it)
        rows.append(dict(
            name="fpu_chain", shape=f"{fc.LANES} lanes x {it} steps, {op}",
            ms=graph_ms(lambda: fc.fpu_chain(op, v0, it)),
            plain_ms=cuda_ms(lambda: fc.fpu_chain_plain(op, v0, it), reps=1),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            timing="ms: 20 launches in one CUDA graph, replayed; plain_ms: "
                   "one call after one warm-up",
            cycles_per_op=int(cycles) / it,
            max_abs_err=(got - fc.fpu_chain_plain(op, v0, it)).abs().max()
            .item()))
    # B2 at the trailing updates the drivers launch: the first of the 8192
    # Cholesky (syrk, n' = 8064), two later ones (4096, 1024), the first of
    # the 8192 LU (lu, m = n' = 8064, unit diagonal) and the first of the
    # 4096 f64 Cholesky (n' = 3968); the first row is the kernels line's
    nb = plan_factorization(N, "potrf", dtype=torch.float32,
                            machine="h100").block
    for form, n, dtype in (("syrk", N - nb, torch.float32),
                           ("syrk", 4096, torch.float32),
                           ("syrk", 1024, torch.float32),
                           ("lu", N - nb, torch.float32),
                           ("syrk", N64 - nb, torch.float64)):
        rows.append(trsm_gemm_row(gen, nb, n, form, dtype))
    for row in rows:
        source, replaces = REPLACES[row["name"]]
        row.update(route="cuda", source=source, replaces=replaces,
                   launches=launches[row["name"]])
        if "variant" in row:
            row["variant_launches"] = launches[row["name"] + "_variants"][
                row["variant"]]
    emit(phase="times", rows=rows)
    return rows


# (b, hq, hkv, sq, sk, d, causal, window, q_offset, kv_len) checked against
# the plain version: GQA 8/2 and 25/5; causal, full, windows 40 and 1024;
# decode (q_offset = Sk - 1); a kv_len mask; ragged Sq / Sk
ATTN_CHECKS = [
    (2, 8, 2, 96, 96, 64, True, None, 0, None),
    (2, 8, 2, 96, 96, 64, False, None, 0, None),
    (2, 8, 2, 200, 200, 64, True, 40, 0, None),
    (1, 25, 5, 1500, 1500, 64, True, 1024, 0, None),
    (2, 25, 5, 1, 777, 64, True, None, 776, None),
    (1, 8, 2, 1, 300, 64, False, None, 0, 170),
    (1, 25, 5, 131, 1029, 64, True, 1024, 898, None),
]
# B5 at the families' own forms, bf16 on wgmma at their own head dim:
# whisper-small's encoder (non-causal over 1500 frames), its cross-attention
# (448 tokens against 1500 frames) and decoder self-attention, qwen3-moe's
# 16:1 GQA at D = 128, internvl2-1b's 7:1 GQA over 256 + 3840 positions
FAMILY_ATTN_CHECKS = [
    (4, 12, 12, 1500, 1500, 64, False),
    (4, 12, 12, 448, 1500, 64, False),
    (4, 12, 12, 448, 448, 64, True),
    (2, 64, 4, 4096, 4096, 128, True),
    (2, 14, 2, 4096, 4096, 64, True),
]
# (b, h, L, p, n, chunk) for the SSD scan: ragged L, chunks 16 / 64 / 256
SSD_CHECKS = [(2, 3, 100, 64, 16, 16), (2, 3, 300, 64, 16, 64),
              (1, 4, 1000, 64, 16, 256), (1, 2, 257, 64, 128, 256)]


def attention_inputs(gen, b, hq, hkv, sq, sk, d, dtype):
    """q, k, v as the model hands them over: (B, S, H, D) storage read
    through (B, H, S, D) views."""
    def view(s_, h_):
        return torch.randn(b, s_, h_, d, generator=gen, device="cuda") \
            .to(dtype).movedim(2, 1)
    return view(sq, hq), view(sk, hkv), view(sk, hkv)


def ssd_inputs(gen, b, h, L, p, n, dtype):
    """x, a_log, B, C in the kernel layout (B, H, L, .) as views of the
    model layout (B, L, H, .); a_log <= 0 in f32, as the model makes it."""
    def rnd(*shape):
        return 0.5 * torch.randn(*shape, generator=gen, device="cuda")
    x, bm, cm = (rnd(b, L, h, e).to(dtype) for e in (p, n, n))
    a = -0.3 * torch.randn(b, L, h, generator=gen, device="cuda").abs()
    return tuple(t.movedim(2, 1) for t in (x, a, bm, cm))


def phase_model_kernels(gen):
    """B4, B5 and B6 against their plain versions on the card, at ragged
    shapes and at the hymba prefill's own shapes."""
    from repro_torch.kernels import dotp as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk

    dot_tol = (1e-5, "f32 partial sums in another order; relative to "
                     "sum |x_i y_i|, the condition of the sum")
    for n, dtype in ((1, torch.float32), (131, torch.float32),
                     (10 ** 6 + 7, torch.float32),
                     (10 ** 6 + 7, torch.bfloat16), (2 ** 26, torch.float32)):
        x = torch.randn(n + 1, generator=gen, device="cuda").to(dtype)
        y = torch.randn(2 * n + 1, generator=gen, device="cuda").to(dtype)
        # contiguous (16-byte loads), offset by one element (unaligned:
        # scalar loads), strided (scalar loads)
        views = [("contiguous", x[:n], y[:n]), ("offset by one", x[1:],
                                                y[1:n + 1])]
        if n < 2 ** 26:
            views.append(("stride 2", x[:n], y[::2][:n]))
        for tag, xv, yv in views:
            got = dk.dotp(xv, yv)
            vec = dk.dotp.last_launch["vector_loads"]
            assert vec == (tag == "contiguous"), (tag, vec)
            mag = (xv.float() * yv.float()).abs().sum().item()
            compare(f"dotp {dtype} n={n} {tag} "
                    f"[{dk.dotp.last_launch['blocks']} CTAs, vector={vec}]",
                    got, dk.dotp_plain(xv, yv), scale=max(mag, 1.0),
                    tol=dot_tol)
            assert torch.equal(got, dk.dotp(xv, yv)), "dotp not repeatable"
        del x, y, views
    # f32 runs the FFMA variant, bf16 the tensor-core one (D <= 128), bf16
    # at D = 256 the FFMA one again
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 64),
                     (torch.bfloat16, 128), (torch.bfloat16, 256)):
        for b, hq, hkv, sq, sk_, _, causal, window, off, kv_len in \
                ATTN_CHECKS:
            q, k, v = attention_inputs(gen, b, hq, hkv, sq, sk_, d, dtype)
            kw = dict(causal=causal, window=window, q_offset=off,
                      kv_len=kv_len)
            variant = fa.attention_variant(q, k, v)
            assert variant == ("wgmma" if dtype == torch.bfloat16 and d <= 128
                               else "ffma"), (dtype, d, variant)
            compare_close(f"attention {dtype} q{tuple(q.shape)} "
                          f"k{tuple(k.shape)} {kw} [{variant}]",
                          fa.attention(q, k, v, **kw),
                          fa.attention_plain(q, k, v, **kw))
    for b, hq, hkv, sq, sk_, d, causal in FAMILY_ATTN_CHECKS:
        q, k, v = attention_inputs(gen, b, hq, hkv, sq, sk_, d,
                                   torch.bfloat16)
        variant = fa.attention_variant(q, k, v)
        assert variant == "wgmma", (q.shape, k.shape, variant)
        compare_close(f"attention family form bf16 q{tuple(q.shape)} "
                      f"k{tuple(k.shape)} causal={causal} [{variant}]",
                      fa.attention(q, k, v, causal=causal),
                      fa.attention_plain(q, k, v, causal=causal))
        del q, k, v
    pb, ps = PREFILL
    q, k, v = attention_inputs(gen, pb, 25, 5, ps, ps, 64, torch.bfloat16)
    for window in (None, 1024):     # the prefill's global / windowed layers
        compare_close(f"attention prefill bf16 q{tuple(q.shape)} "
                      f"window={window} [{fa.attention_variant(q, k, v)}]",
                      fa.attention(q, k, v, window=window),
                      fa.attention_plain(q, k, v, window=window))
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, L, p, n, chunk in SSD_CHECKS:
            ssd_check(sk, ssd_inputs(gen, b, h, L, p, n, dtype), chunk)
    launch = ssd_check(sk, ssd_inputs(gen, pb, 50, ps, 64, 16,
                                      torch.bfloat16), 256, "prefill ")
    assert launch.ctas[0] >= 1600, launch
    emit(phase="kernels (model)", last_attention=str(fa.attention.last_launch),
         last_ssd_scan=str(sk.ssd_scan.last_launch),
         last_dotp=dk.dotp.last_launch)


def ssd_check(sk, args, chunk, tag=""):
    """B6 against its plain version (y, elementwise and normwise), its
    three passes' scratch against :func:`ssd_scan_passes` (f32), two
    calls bitwise equal, and the plan's shared memory equal to the C
    side's; returns the launch plan."""
    from repro_torch.kernels import _build

    x = args[0]
    name = (f"ssd_scan {tag}{x.dtype} x{tuple(x.shape)} n={args[2].shape[-1]}"
            f" chunk={chunk}")
    y, scratch = sk.ssd_scan_kernel(*args, chunk=chunk)
    launch = sk.ssd_scan.last_launch["launch"]
    compare_close(name, y, sk.ssd_scan_plain(*args, chunk=chunk))
    _, want = sk.ssd_scan_passes(*args, chunk=chunk)
    for key in ("cum", "states", "decay", "carried"):
        compare_close(f"{name} pass {key}", scratch[key], want[key])
    again, _ = sk.ssd_scan_kernel(*args, chunk=chunk)
    assert torch.equal(y, again), f"{name}: two calls differ"
    lib = _build.library("ssd_scan")
    code = sk.DTYPE_CODES[x.dtype]
    p, n = x.shape[-1], args[2].shape[-1]
    c_side = tuple(lib.repro_ssd_scan_smem_bytes(code, p, n, launch.chunk, k)
                   for k in (1, 2, 3))
    assert c_side == launch.smem_bytes, (c_side, launch)
    emit(check=f"{name}: two calls bitwise equal, plan {launch}", ok=True)
    return launch


def zero_launches():
    from repro_torch.kernels import dotp as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fpu_chain as fc
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import gemm as gk
    from repro_torch.kernels import pe_scoreboard as ps
    from repro_torch.kernels import ssd_scan as sk
    wrappers = {"gemm": gk.gemm, "gemm_bias_act": fk.gemm_bias_act,
                "trsm_gemm": fk.trsm_gemm, "dotp": dk.dotp,
                "attention": fa.attention, "ssd_scan": sk.ssd_scan,
                "fpu_chain": fc.fpu_chain, "pe_scoreboard": ps.pe_scoreboard}
    for w in wrappers.values():
        w.launches = 0
    gk.reset_launches(gk.gemm)
    gk.reset_launches(fk.gemm_bias_act)
    fa.reset_launches()
    return wrappers


def model_agreement():
    """A reduced hybrid (3 layers, d_model 256, 4 heads, vocab 512, f32,
    window 1024) on the card against the same weights on the CPU's plain
    routes, at 2 x 2560 tokens."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.launch.train import reduce_config
    from repro_torch.models import model_zoo

    cfg = dataclasses.replace(reduce_config(
        registry.get_config("hymba-1.5b"), layers=3, d_model=256, vocab=512,
        heads=4), dtype="float32")
    cpu = model_zoo.init(cfg, torch.Generator().manual_seed(SEED), "cpu")
    card = model_zoo.init(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, size=(2, 2560)))
    counts = zero_launches()
    got = model_zoo.forward(card, {"tokens": toks.cuda()}, cfg)[0]
    launches = {k: w.launches for k, w in counts.items()}
    want = model_zoo.forward(cpu, {"tokens": toks}, cfg)[0]
    err = (got.cpu().double() - want.double()).abs().max().item()
    rel = err / want.double().abs().max().item()
    tol, reason = MODEL_TOL
    ok = rel <= tol and bool(torch.isfinite(got).all())
    emit(check="hybrid 3x256 forward 2x2560: cuda vs cpu (plain routes), "
               "max|dlogits|/max|logits|", value=rel, max_abs_err=err,
         tol=tol, reason=reason, launches=launches, ok=ok)
    assert ok and launches["attention"] == launches["ssd_scan"] == 3, \
        (rel, launches)


def profile_call(fn, top=10, match=(), cpu=True, pad=0, readers=False):
    """One run of ``fn`` under ``torch.profiler``: wall ms (profiler on),
    device-busy ms summed over the kernels it launched, their count, the
    ``top`` kernels by device time, and for each substring in ``match``
    the device ms and launches of the kernels whose name holds it.
    ``cpu=False`` traces the device alone (far fewer events to sort).
    ``pad`` tiny kernels run and are waited for inside the trace before
    ``fn``: the first kernel records of a trace on the card can be lost
    or skewed, and these take their place (they are counted in the busy
    time and launches, and match nothing of the kernels here). The device
    records are read straight from the trace's kineto events, summed by
    name (the profiler's own ``key_averages`` builds a Python object per
    event first: tens of seconds for the 214k kernels of a solve).
    ``readers=True`` also sums the device kernels' self time as
    ``key_averages`` reports it on the same trace, and the seconds that
    took, so the two readers can be compared."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    filler = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]
                 + ([ProfilerActivity.CPU] if cpu else [])) as prof:
        for _ in range(pad):
            filler.add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}                                # name -> [device ns, count]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            acc = by_name.setdefault(e.name(), [0, 0])
            acc[0] += e.duration_ns()
            acc[1] += 1
    busy_ms = sum(ns for ns, _ in by_name.values()) / 1e6
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    both = {}
    if readers:
        t0 = time.perf_counter()
        avgs = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        both = {"key_averages": {
            "device_busy_ms": sum(e.self_device_time_total
                                  for e in avgs) / 1e3,
            "kernel_launches": sum(e.count for e in avgs),
            "seconds": time.perf_counter() - t0}}
    return {**both, "wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "kernel_launches": sum(c for _, c in by_name.values()),
            "top": [[k[:80], ns / 1e6, c] for k, (ns, c) in kernels[:top]],
            "matched": {m: {"device_ms": sum(
                ns for k, (ns, _) in by_name.items() if m in k) / 1e6,
                "launches": sum(c for k, (_, c) in by_name.items()
                                if m in k)} for m in match}}


def phase_model(gen):
    """hymba-1.5b at full width on the card: prefill 2 x 4096 with the
    launch counts zeroed just before, then serve 4 requests."""
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.launch.serve import Request, serve_batch
    from repro_torch.models import model_zoo

    cfg = registry.get_config("hymba-1.5b")
    model, secs = sync_time(lambda: model_zoo.init(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda"))
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == model_zoo.param_count(cfg)
    emit(call="model_zoo.init hymba-1.5b", wall_s=secs, params=n_params,
         config_param_count=cfg.param_count(), n_layers=cfg.n_layers,
         d_model=cfg.d_model, compute_dtype=cfg.dtype,
         param_bytes=sum(p.numel() * p.element_size()
                         for p in model.parameters()))
    # one untimed prefill at the same shape on other tokens first, so the
    # counted one is warm (allocator growth and cuBLAS heuristics are
    # set-up, reported apart)
    warm = torch.randint(0, cfg.vocab, PREFILL, generator=gen, device="cuda")
    _, secs = sync_time(lambda: model_zoo.prefill(model, {"tokens": warm},
                                                  cfg))
    emit(call=f"model_zoo.prefill hymba-1.5b {PREFILL[0]}x{PREFILL[1]} "
              f"(cold, set-up; not counted)", wall_s=secs)
    del warm, _
    tokens = torch.randint(0, cfg.vocab, PREFILL, generator=gen,
                           device="cuda")
    counts = zero_launches()
    (logits, _, _), secs = sync_time(
        lambda: model_zoo.prefill(model, {"tokens": tokens}, cfg))
    launches = {k: w.launches for k, w in counts.items()}
    attention_variants = dict(counts["attention"].variant_launches)
    assert launches["attention"] == cfg.n_layers, launches
    assert attention_variants["wgmma"] == cfg.n_layers, attention_variants
    assert launches["ssd_scan"] == cfg.n_layers, launches
    assert logits.shape == (*PREFILL, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    launches["attention_variants"] = attention_variants
    emit(call=f"model_zoo.prefill hymba-1.5b {PREFILL[0]}x{PREFILL[1]} "
              f"(warm, counted)", wall_s=secs, tokens_per_s=PREFILL[0] * PREFILL[1] / secs,
         launches=launches, logits=[list(logits.shape), str(logits.dtype)],
         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del logits

    rng = np.random.default_rng(SEED)
    reqs = [Request(rng.integers(0, cfg.vocab, size=int(rng.integers(
        32, 129))).astype(np.int32), 32) for _ in range(4)]
    counts = zero_launches()
    (outs, stats), secs = sync_time(
        lambda: serve_batch(model, cfg, reqs, max_len=256))
    serve_launches = {k: w.launches for k, w in counts.items()}
    assert serve_launches["attention"] == serve_launches["ssd_scan"] \
        == cfg.n_layers, serve_launches
    lengths = []
    for r, o in zip(reqs, outs):
        new = o[len(r.prompt):]
        assert len(new) == r.max_new and all(0 <= t < cfg.vocab for t in new)
        lengths.append({"prompt": len(r.prompt), "new": len(new)})
    emit(call="serve_batch hymba-1.5b 4 requests greedy max_len=256",
         wall_s=secs, decode_tokens_per_s=stats["decode_tokens_per_s"],
         steps=stats["steps"], requests=lengths, launches=serve_launches)
    # where the time goes: one profiled prefill and one decode step (not
    # part of the counted runs above)
    emit(profile=f"model_zoo.prefill {PREFILL[0]}x{PREFILL[1]}",
         **profile_call(lambda: model_zoo.prefill(
             model, {"tokens": tokens}, cfg), match=("ssd_",)))
    caches = model_zoo.init_caches(model, cfg, 4, 256)
    emit(profile="model_zoo.decode_step batch 4", **profile_call(
        lambda: model_zoo.decode_step(model, tokens[:1, :1].repeat(4, 1),
                                      cfg, caches, 0)))
    del model, caches
    torch.cuda.empty_cache()
    model_agreement()
    return launches


def counted_prefill(name, cfg, model, batch, want_b5):
    """``model_zoo.prefill`` with the launch counts zeroed just before and
    read just after: B5 exactly ``want_b5`` times, all on ``wgmma``, and no
    other kernel (the projections and expert products are library
    matmuls, as the reference's jnp ones). Returns (outputs, seconds,
    launches)."""
    from repro_torch.models import model_zoo

    counts = zero_launches()
    out, secs = sync_time(lambda: model_zoo.prefill(model, batch, cfg))
    launches = {k: w.launches for k, w in counts.items()}
    variants = dict(counts["attention"].variant_launches)
    assert launches["attention"] == want_b5 == variants["wgmma"], \
        (name, launches, variants)
    assert not any(n for k, n in launches.items() if k != "attention"), \
        (name, launches)
    logits = out[0]
    assert bool(torch.isfinite(logits).all()), name
    launches["attention_variants"] = variants
    return out, secs, launches


def family_build(cfg, note=None):
    """``model_zoo.init`` of ``cfg`` on the card from ``SEED``, after the
    peak-memory counter is reset; the parameter count must equal
    ``model_zoo.param_count``."""
    from repro_torch.models import model_zoo

    torch.cuda.reset_peak_memory_stats()
    model, secs = sync_time(lambda: model_zoo.init(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda"))
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == model_zoo.param_count(cfg), cfg.name
    emit(call=f"model_zoo.init {cfg.name}", wall_s=secs, params=n_params,
         param_bytes=sum(p.numel() * p.element_size()
                         for p in model.parameters()),
         n_layers=cfg.n_layers, encoder_layers=cfg.encoder_layers,
         d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv, cfg.hd],
         vocab=cfg.vocab, compute_dtype=cfg.dtype, reduced=note)
    return model


def family_serve(cfg, model, rng, want_b5):
    """``serve_batch`` of 4 requests (prompts of 16-64 tokens, greedy,
    ``FAMILY_NEW`` new tokens each), counted: B5 ``want_b5`` times in its
    prefill and nowhere else."""
    import numpy as np
    from repro_torch.launch.serve import Request, serve_batch

    reqs = [Request(rng.integers(0, cfg.vocab, size=int(rng.integers(
        16, 65))).astype(np.int32), FAMILY_NEW) for _ in range(4)]
    counts = zero_launches()
    (outs, stats), secs = sync_time(
        lambda: serve_batch(model, cfg, reqs, max_len=128))
    launches = {k: w.launches for k, w in counts.items()}
    assert launches["attention"] == want_b5, launches
    assert not any(n for k, n in launches.items() if k != "attention"), \
        launches
    for r, o in zip(reqs, outs):
        new = o[len(r.prompt):]
        assert len(new) == r.max_new and all(0 <= t < cfg.vocab for t in new)
    emit(call=f"serve_batch {cfg.name} 4 requests greedy max_len=128",
         wall_s=secs, decode_tokens_per_s=stats["decode_tokens_per_s"],
         steps=stats["steps"], prompts=[len(r.prompt) for r in reqs],
         launches=launches)
    return stats["decode_tokens_per_s"]


def phase_families(gen):
    """internvl2-1b and whisper-small at full width, qwen3-moe at full
    width with 4 of its 94 layers: each built from ``SEED`` on the card,
    a set-up prefill, a counted warm prefill (B5 once per attention layer,
    all ``wgmma``), and serving (``serve_batch``; whisper through
    ``model_zoo``'s caches and ``decode_step``); each model freed before
    the next is built. Then the reduced moe, vlm and encdec models on the
    card against the CPU. Returns B5's launches per prefill."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.models import model_zoo
    from repro_torch.models.frontends import synthetic_frontend

    rng = np.random.default_rng(SEED)
    b5 = {}

    def tokens(cfg, shape):
        return torch.randint(0, cfg.vocab, shape, generator=gen,
                             device="cuda")

    def prefill_row(cfg, launches, secs, positions, **extra):
        emit(call=f"model_zoo.prefill {cfg.name} (warm, counted)",
             wall_s=secs, positions=positions,
             tokens_per_s=positions / secs, launches=launches,
             peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, **extra)

    # ---- vlm: internvl2-1b, 256 patches + 3840 tokens per row ----
    arch, (b, s), want = FAMILY_VLM
    cfg = registry.get_config(arch)
    model = family_build(cfg)

    def batch():
        return {"tokens": tokens(cfg, (b, s)),
                "patches": synthetic_frontend(gen, cfg, b)}
    warm = batch()
    _, secs = sync_time(lambda: model_zoo.prefill(model, warm, cfg))
    emit(call=f"model_zoo.prefill {arch} (cold, set-up; not counted)",
         wall_s=secs)
    del warm
    counted = batch()
    (logits, aux, kv), secs, launches = counted_prefill(
        arch, cfg, model, counted, want)
    n = cfg.num_prefix_tokens
    assert logits.shape == (b, n + s, cfg.vocab) and float(aux) == 0.0
    assert kv["k"].shape == (cfg.n_layers, b, n + s, cfg.n_kv, cfg.hd)
    prefill_row(cfg, launches, secs, b * (n + s), patches=n, tokens=s,
                batch=b)
    b5[arch] = launches["attention"]
    del logits, kv, counted
    emit(profile=f"model_zoo.prefill {arch}", **profile_call(
        lambda: model_zoo.prefill(model, batch(), cfg), cpu=False,
        match=("attn_",)))
    family_serve(cfg, model, rng, want)
    del model
    torch.cuda.empty_cache()

    # ---- encdec: whisper-small, 1500 frames and 448 tokens per row ----
    arch, (b, s), want = FAMILY_ENCDEC
    cfg = registry.get_config(arch)
    model = family_build(cfg)

    def batch():
        return {"frames": synthetic_frontend(gen, cfg, b),
                "tokens": tokens(cfg, (b, s))}
    _, secs = sync_time(lambda: model_zoo.prefill(model, batch(), cfg))
    emit(call=f"model_zoo.prefill {arch} (cold, set-up; not counted)",
         wall_s=secs)
    counted = batch()
    (logits, aux, memory), secs, launches = counted_prefill(
        arch, cfg, model, counted, want)
    assert logits.shape == (b, s, cfg.vocab) and float(aux) == 0.0
    assert memory.shape == (b, cfg.encoder_seq, cfg.d_model)
    prefill_row(cfg, launches, secs, b * s, frames=cfg.encoder_seq,
                batch=b, frames_per_s=b * cfg.encoder_seq / secs)
    b5[arch] = launches["attention"]
    emit(profile=f"model_zoo.prefill {arch}", **profile_call(
        lambda: model_zoo.prefill(model, batch(), cfg), cpu=False,
        match=("attn_",)))
    # serving through the caches: the first FAMILY_NEW tokens of the
    # counted prompt replayed, then FAMILY_NEW greedy steps
    prompt = counted["tokens"][:, :FAMILY_NEW]
    counts = zero_launches()

    def serve():
        caches = model_zoo.init_caches(model, cfg, b, 2 * FAMILY_NEW,
                                       memory=memory)
        replay = []
        for t in range(FAMILY_NEW):
            lg, caches = model_zoo.decode_step(model, prompt[:, t:t + 1],
                                               cfg, caches, t)
            replay.append(lg[:, 0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = []
        for t in range(FAMILY_NEW, 2 * FAMILY_NEW):
            nxt = lg[:, -1].float().argmax(-1)
            out.append(nxt)
            lg, caches = model_zoo.decode_step(model, nxt[:, None], cfg,
                                               caches, t)
        torch.cuda.synchronize()
        return torch.stack(replay, 1), torch.stack(out, 1), \
            time.perf_counter() - t0
    (replay, new, dec_s), secs = sync_time(serve)
    assert not any(w.launches for w in counts.values()), "decode launched"
    assert new.shape == (b, FAMILY_NEW) and bool(
        ((new >= 0) & (new < cfg.vocab)).all())
    assert bool(torch.isfinite(replay).all())
    # the replayed prompt's logits beside the teacher-forced pass's (bf16,
    # plain decode attention against B5): reported, not a check
    drift = (replay.float() - logits[:, :FAMILY_NEW].float()).abs().max()
    emit(call=f"{arch} init_caches(memory) + {FAMILY_NEW} replayed + "
              f"{FAMILY_NEW} greedy decode_steps, batch {b}",
         wall_s=secs, decode_s=dec_s,
         decode_tokens_per_s=b * FAMILY_NEW / dec_s,
         replay_vs_prefill_max_abs=drift.item(),
         prefill_logits_max_abs=logits[:, :FAMILY_NEW].float().abs().max()
         .item())
    del model, memory, logits, counted, prompt, replay
    torch.cuda.empty_cache()

    # ---- moe: qwen3-moe-235b-a22b at full width, 4 of its 94 layers ----
    arch, (b, s), want = FAMILY_MOE
    cfg = dataclasses.replace(registry.get_config(arch), n_layers=MOE_LAYERS)
    model = family_build(cfg, note=f"n_layers 94 -> {MOE_LAYERS}, memory of "
                                   f"one card")
    warm = tokens(cfg, (b, s))
    _, secs = sync_time(lambda: model_zoo.prefill(model, {"tokens": warm},
                                                  cfg))
    emit(call=f"model_zoo.prefill {arch} (cold, set-up; not counted)",
         wall_s=secs)
    del warm, _
    counted = {"tokens": tokens(cfg, (b, s))}
    (logits, aux, kv), secs, launches = counted_prefill(
        arch, cfg, model, counted, want)
    assert logits.shape == (b, s, cfg.vocab) and float(aux) > 0
    prefill_row(cfg, launches, secs, b * s, aux=aux.item(), batch=b)
    b5[arch] = launches["attention"]
    del logits, kv
    emit(profile=f"model_zoo.prefill {arch}", **profile_call(
        lambda: model_zoo.prefill(model, counted, cfg), cpu=False,
        match=("attn_",)))
    family_serve(cfg, model, rng, want)
    del model, counted
    torch.cuda.empty_cache()
    family_agreement()
    return b5


def family_agreement():
    """Reduced moe, vlm and encdec models (3 layers, d_model 256, 4 heads,
    vocab 512, f32; the moe 8 experts, top 2) on the card against the same
    weights on the CPU's plain routes; the moe also at capacity factor 0.5
    (it drops assignments: the card must drop the same ones), and each moe
    forward twice on the card, bitwise equal."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.launch.train import reduce_config
    from repro_torch.models import model_zoo
    from repro_torch.models.frontends import synthetic_frontend

    tol, reason = MODEL_TOL
    for arch, over, want_b5 in (
            ("qwen3-moe-235b-a22b", {}, 3),
            ("qwen3-moe-235b-a22b", {"capacity_factor": 0.5}, 3),
            ("internvl2-1b", {}, 3), ("whisper-small", {}, 2 + 3 + 3)):
        cfg = dataclasses.replace(reduce_config(
            registry.get_config(arch), layers=3, d_model=256, vocab=512,
            heads=4), dtype="float32", **over)
        cpu = model_zoo.init(cfg, torch.Generator().manual_seed(SEED), "cpu")
        card = model_zoo.init(cfg, device="cuda")
        card.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(SEED)
        gen = torch.Generator().manual_seed(SEED)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, size=(2, {"encdec": 448, "vlm": 768}.get(
                cfg.family, 1024))))}
        if cfg.frontend:
            key = "frames" if cfg.family == "encdec" else "patches"
            batch[key] = synthetic_frontend(gen, cfg, 2, torch.float32)
        on_card = {k: v.cuda() for k, v in batch.items()}
        counts = zero_launches()
        got, got_aux = model_zoo.forward(card, on_card, cfg)
        launches = {k: w.launches for k, w in counts.items()}
        want, want_aux = model_zoo.forward(cpu, batch, cfg)
        err = (got.cpu().double() - want.double()).abs().max().item()
        rel_err = err / want.double().abs().max().item()
        aux_err = abs(got_aux.item() - want_aux.item())
        ok = rel_err <= tol and bool(torch.isfinite(got).all()) \
            and aux_err <= tol * abs(want_aux.item())
        extra = "".join(f", {k} {v}" for k, v in over.items())
        tag = f"{cfg.family} 3x256 ({arch} reduced{extra})"
        emit(check=f"{tag} forward 2x{got.shape[1]}: cuda vs cpu (plain "
                   f"routes), max|dlogits|/max|logits|", value=rel_err,
             max_abs_err=err, aux=[got_aux.item(), want_aux.item()],
             tol=tol, reason=reason, launches=launches, ok=ok)
        assert ok and launches["attention"] == want_b5, \
            (tag, rel_err, aux_err, launches)
        if cfg.family == "moe":
            again, again_aux = model_zoo.forward(card, on_card, cfg)
            assert torch.equal(got, again) and torch.equal(
                got_aux, again_aux), f"{tag}: two card calls differ"
            emit(check=f"{tag} forward: two card calls bitwise equal",
                 ok=True)
        del cpu, card


def train_attention_flops(cfg, b, s):
    """Attention's matmul flops in one remat training step of ``cfg`` at
    (b, s): QK^T and PV over the unmasked (causal, windowed) pairs, 4
    flops a pair per head dimension, taken four times (the forward, its
    recompute under remat, and the backward's two)."""
    w = cfg.window or s
    local = w * (w + 1) // 2 + (s - w) * w if s > w else s * (s + 1) // 2
    pairs = sum(s * (s + 1) // 2 if i in cfg.global_layers else local
                for i in range(cfg.n_layers))
    return 4 * (4 * b * cfg.n_heads * cfg.hd * pairs)


def train_steps(cfg, opt_cfg, step_fn, state, seq):
    """One untimed step, then ``TRAIN_TIMED`` timed ones, at (TRAIN[0],
    seq) tokens from ``make_batch``; the launch counts zeroed before the
    first and read after the last. Returns (state, per-step records,
    launches, the last batch)."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.train import optimizer

    data = DataConfig(vocab=cfg.vocab, global_batch=TRAIN[0], seq_len=seq,
                      seed=SEED)
    steps = []
    counts = zero_launches()
    for i in range(1 + TRAIN_TIMED):
        batch = make_batch(cfg, data, i, accum=max(cfg.accum_steps, 1),
                           device="cuda")
        (state, m), secs = sync_time(lambda: step_fn(state, batch))
        want_lr = optimizer.schedule(opt_cfg, torch.tensor(i + 1,
                                                           device="cuda"))
        rec = {"step": i, "wall_s": secs, "loss": m["loss"].item(),
               "grad_norm": m["grad_norm"].item(), "lr": m["lr"].item()}
        assert torch.isfinite(m["loss"]) and torch.isfinite(
            m["grad_norm"]) and rec["grad_norm"] > 0, rec
        assert torch.equal(m["lr"], want_lr), (rec, want_lr.item())
        steps.append(rec)
    launches = {k: w.launches for k, w in counts.items()}
    return state, steps, launches, batch


def phase_train():
    """hymba-1.5b trained at full width on the card (``init_state``, then
    ``make_train_step``: the plain oracles under autograd with per-layer
    remat, f32 masters, grads and moments), then reduced models' steps on
    the card against the CPU (f32, 8-bit moments, the remat policies) and
    a restart of ``train_loop`` from its checkpoint."""
    from repro_torch.configs import registry
    from repro_torch.train import train_state as ts
    from repro_torch.train.optimizer import AdamWConfig

    cfg = registry.get_config("hymba-1.5b")
    assert cfg.remat and cfg.remat_policy == "full" and not cfg.opt_8bit
    opt_cfg = AdamWConfig(eight_bit=cfg.opt_8bit, **TRAIN_OPT)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, secs = sync_time(lambda: ts.init_state(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, opt_cfg,
        "cuda"))
    model = state["params"]
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    moment_bytes = sum(t.numel() * t.element_size()
                       for k in ("m", "v") for t in state["opt"][k].values())
    emit(call="train_state.init_state hymba-1.5b", wall_s=secs,
         params=n_params, param_bytes=param_bytes,
         moment_bytes=moment_bytes,
         state_bytes_with_grads=2 * param_bytes + moment_bytes,
         n_layers=cfg.n_layers, d_model=cfg.d_model, compute_dtype=cfg.dtype,
         remat=cfg.remat_policy, eight_bit=opt_cfg.eight_bit, opt=TRAIN_OPT)
    watch = {n: p.detach().reshape(-1)[:1024].clone() for n, p in
             list(model.named_parameters())[:: 40]}
    step_fn = ts.make_train_step(cfg, opt_cfg)
    seq, cut = TRAIN[1], None
    while True:
        torch.cuda.empty_cache()
        try:
            state, steps, launches, batch = train_steps(
                cfg, opt_cfg, step_fn, state, seq)
            break
        except torch.cuda.OutOfMemoryError:
            # a cut of the sequence, never of remat; printed beside the peak
            cut = f"seq {TRAIN[1]} -> {seq // 2}: out of memory at {seq}"
            emit(note=f"train step out of memory at 2 x {seq}",
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            seq //= 2
            assert seq >= 512, "the train step does not fit at 2 x 1024"
    assert not any(launches.values()), launches
    assert all(not torch.equal(p.detach().reshape(-1)[:1024], watch[n])
               for n, p in model.named_parameters() if n in watch), \
        "a parameter did not change"
    timed = [r["wall_s"] for r in steps[1:]]
    step_s = statistics.median(timed)
    tokens = TRAIN[0] * seq
    flops = 8 * n_params * tokens + train_attention_flops(cfg, TRAIN[0],
                                                          seq)
    bound_s = flops / PEAK_FLOPS[torch.bfloat16]
    peak = torch.cuda.max_memory_allocated()
    emit(call=f"train step hymba-1.5b {TRAIN[0]}x{seq} (1 untimed + "
              f"{TRAIN_TIMED} timed)", cut=cut, steps=steps,
         step_s=step_s, step_s_all=timed, tokens_per_s=tokens / step_s,
         peak_gib=peak / 2 ** 30, peak_bytes=peak,
         launches=launches, bound_s=bound_s,
         bound="8 x params x tokens + attention's unmasked pairs (forward, "
               "remat recompute, backward) at 989 TFLOP/s bf16",
         bound_flops=flops)
    for _ in range(3):
        prof = profile_call(lambda: step_fn(state, batch), cpu=False,
                            pad=32, top=12, match=TRAIN_PROFILE_MATCH)
        if prof["kernel_launches"] > 1000:
            break
    emit(profile=f"train step hymba-1.5b {TRAIN[0]}x{seq}", **prof)
    del state, model, batch, step_fn, watch
    torch.cuda.empty_cache()
    train_agreement()
    train_restart()
    return {"peak_bytes": peak, "bound_flops": flops, "seq": seq}


def train_small_cfg(arch):
    """The reduced f32 config of ``arch`` the agreement and restart checks
    train (the hybrid's window 128: its local layers take the banded
    oracle at TRAIN_SMALL_SEQ)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch.train import reduce_config

    cfg = dataclasses.replace(reduce_config(
        registry.get_config(arch), layers=3, d_model=256, vocab=512,
        heads=4), dtype="float32")
    return dataclasses.replace(cfg, window=128) if cfg.window else cfg


def train_agreement():
    """Reduced hybrid and dense models: one state copied to the card and
    to the CPU, ``TRAIN_AGREE_STEPS`` steps on each with f32 and with
    8-bit moments (loss and grad norm each step, then the parameters; the
    codes and scales), and on the card the 'full', 'dots' and 'none'
    remat policies' loss and gradients."""
    import dataclasses

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import model_zoo
    from repro_torch.train import optimizer
    from repro_torch.train import train_state as ts

    for arch in ("hymba-1.5b", "granite-3-8b"):
        cfg = train_small_cfg(arch)
        accum = max(cfg.accum_steps, 1)        # granite-3-8b's is 2
        data = DataConfig(vocab=cfg.vocab, global_batch=2,
                          seq_len=TRAIN_SMALL_SEQ, seed=SEED)
        for eight_bit in (False, True):
            opt = optimizer.AdamWConfig(eight_bit=eight_bit,
                                        **TRAIN_SMALL_OPT)
            cpu = ts.init_state(torch.Generator().manual_seed(SEED), cfg,
                                opt, "cpu")
            card_model = model_zoo.build(cfg, "cuda")
            card_model.load_state_dict(cpu["params"].state_dict())
            card = ts.state_for(card_model, opt)
            step = ts.make_train_step(cfg, opt)
            per_step, codes = [], {}
            counts = zero_launches()
            for i in range(TRAIN_AGREE_STEPS):
                batch = make_batch(cfg, data, i, accum=accum, device="cpu")
                card, got = step(card, {k: v.cuda() for k, v in
                                        batch.items()})
                cpu, want = step(cpu, batch)
                per_step.append({k: abs(got[k].item() - want[k].item())
                                 / abs(want[k].item())
                                 for k in ("loss", "grad_norm", "lr")})
                if eight_bit and i in (0, TRAIN_AGREE_STEPS - 1):
                    codes[f"after step {i + 1}"] = code_stats(card["opt"],
                                                              cpu["opt"])
            launches = {k: w.launches for k, w in counts.items()}
            p_err = max((a.detach().cpu() - b.detach()).abs().max().item()
                        for a, b in zip(card["params"].parameters(),
                                        cpu["params"].parameters()))
            first, last = codes.get("after step 1"), codes.get(
                f"after step {TRAIN_AGREE_STEPS}")
            ok = (all(r["loss"] <= TRAIN_TOL["loss"][0]
                      and r["grad_norm"] <= TRAIN_TOL["grad_norm"][0]
                      and r["lr"] <= TRAIN_TOL["lr"][0] for r in per_step)
                  and p_err <= TRAIN_TOL["params_8bit" if eight_bit
                                         else "params"][0]
                  and not any(launches.values())
                  and (not eight_bit or (
                      first["codes_off_share"] <= TRAIN_TOL["codes_off"][0]
                      and first["codes_max_off"] <= 1
                      and first["scale_max_rel"] <= TRAIN_TOL["scales"][0]
                      and last["codes_off_share"]
                      <= TRAIN_TOL["codes_off"][0])))
            emit(check=f"{cfg.family} 3x256 ({arch} reduced) "
                       f"{TRAIN_AGREE_STEPS} train steps 2x"
                       f"{TRAIN_SMALL_SEQ}, {'8-bit' if eight_bit else 'f32'}"
                       f" moments, {accum} microbatches: cuda vs cpu",
                 per_step_rel=per_step,
                 params_max_abs=p_err, codes=codes, launches=launches,
                 tol={k: v[0] for k, v in TRAIN_TOL.items()},
                 reasons={k: v[1] for k, v in TRAIN_TOL.items()}, ok=ok)
            assert ok, (arch, eight_bit, per_step, p_err, codes, launches)
            del cpu, card, card_model
        # the remat policies on the card: one batch, the same parameters
        batch = {k: v.cuda() for k, v in
                 make_batch(cfg, data, 0, device="cpu").items()}
        model = model_zoo.init(cfg, torch.Generator(device="cuda")
                               .manual_seed(SEED), "cuda")
        model.requires_grad_(True)
        params = optimizer.named_parameters(model)
        out = {}
        for policy in ("none", "full", "dots"):
            pcfg = dataclasses.replace(cfg, remat_policy=policy)
            torch.cuda.reset_peak_memory_stats()
            out[policy] = ts.value_and_grad(model, params, batch, pcfg)
            out[policy] += (torch.cuda.max_memory_allocated(),)
        loss0, g0, _ = out["none"]
        worst = {p: max(((g[k] - g0[k]).abs().max()
                         / g0[k].abs().max().clamp_min(1e-30)).item()
                        for k in g0) for p, (_, g, _) in out.items()}
        ok = all(torch.equal(l, loss0) or abs(l.item() - loss0.item())
                 <= TRAIN_TOL["remat"][0] * abs(loss0.item())
                 for l, _, _ in out.values()) \
            and max(worst.values()) <= TRAIN_TOL["remat"][0]
        emit(check=f"{cfg.family} 3x256 remat full / dots / none on the "
                   f"card: loss and grads", loss={p: o[0].item() for p, o in
                                                  out.items()},
             grads_max_rel=worst,
             peak_bytes={p: o[2] for p, o in out.items()},
             tol=TRAIN_TOL["remat"][0], reason=TRAIN_TOL["remat"][1], ok=ok)
        assert ok, worst
        del model, params, out, g0


def code_stats(card_opt, cpu_opt):
    """The card's 8-bit moments against the CPU's: the share of codes
    apart, the largest distance, the largest relative scale difference."""
    off, n, worst, s_err = 0, 0, 0, 0.0
    for mom in ("m", "v"):
        for k, g in card_opt[mom].items():
            w = cpu_opt[mom][k]
            d = (g.q.cpu().int() - w.q.int()).abs()
            off += int((d > 0).sum())
            n += d.numel()
            worst = max(worst, int(d.max()))
            s_err = max(s_err, ((g.scale.cpu() - w.scale).abs()
                                / w.scale.abs().clamp_min(1e-30)).max()
                        .item())
    return {"codes_off_share": off / n, "codes_max_off": worst,
            "scale_max_rel": s_err}


def train_restart():
    """``train_loop`` on the reduced hybrid on the card: 12 steps
    uninterrupted, then with checkpoints every 3 and a failure injected at
    step 7 under ``run_with_restarts`` (one restart, resumed at 7); the
    resumed losses against the uninterrupted run's, and the last
    checkpoint restored bitwise into a fresh model."""
    import tempfile

    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import train_loop
    from repro_torch.models import model_zoo
    from repro_torch.runtime.fault_tolerance import run_with_restarts
    from repro_torch.train import optimizer
    from repro_torch.train import train_state as ts

    cfg = train_small_cfg("hymba-1.5b")
    opt = optimizer.AdamWConfig(**TRAIN_SMALL_OPT)
    data = DataConfig(vocab=cfg.vocab, global_batch=2,
                      seq_len=TRAIN_SMALL_SEQ, seed=SEED)
    with tempfile.TemporaryDirectory(prefix="repro_torch_train_") as tmp:
        (_, ref_hist), ref_s = sync_time(lambda: train_loop(
            cfg, opt, data, None, steps=12, ckpt_dir=os.path.join(tmp, "a"),
            save_interval=1000, log_every=100, device="cuda"))
        ckpt = os.path.join(tmp, "b")
        calls, done = [], {}

        def loop(resume):
            calls.append(resume)
            done["run"] = train_loop(
                cfg, opt, data, None, steps=12, ckpt_dir=ckpt,
                save_interval=3, log_every=100, device="cuda",
                fail_at_step=7 if len(calls) == 1 else -1)
            return 12

        report, secs = sync_time(lambda: run_with_restarts(loop,
                                                           max_restarts=2))
        state, hist = done["run"]
        like = ts.state_for(model_zoo.build(cfg, "cuda"), opt)
        back, step = ck.restore(ckpt, like)
        bitwise = all(torch.equal(a, b) for a, b in zip(
            state["params"].parameters(), back["params"].parameters())) \
            and all(torch.equal(state["opt"][k][n], back["opt"][k][n])
                    for k in ("m", "v") for n in state["opt"][k]) \
            and torch.equal(state["opt"]["step"], back["opt"]["step"])
        steps_saved = ck.all_steps(ckpt)
    rel_err = [abs(a - b) / abs(b) for a, b in zip(hist, ref_hist[7:])]
    ok = (report.completed and report.restarts == 1 and len(hist) == 5
          and step == 11 and bitwise and steps_saved == [6, 9, 11]
          and max(rel_err) <= TRAIN_TOL["resume"][0])
    emit(check="train_loop restart on the card: hybrid 3x256, 12 steps, "
               "checkpoints every 3, failure at step 7",
         restarts=report.restarts, completed=report.completed,
         resumed_losses=hist, uninterrupted_losses=ref_hist[7:],
         rel_err=rel_err, restored_step=step, restored_bitwise=bitwise,
         checkpoints=steps_saved, uninterrupted_s=ref_s, restarted_s=secs,
         tol=TRAIN_TOL["resume"][0], reason=TRAIN_TOL["resume"][1], ok=ok)
    assert ok, (report, rel_err, bitwise, steps_saved)


def attention_work(b, hq, hkv, sq, sk, d, itemsize, causal=True, window=None,
                   q_offset=0):
    """(flops, bytes) the masks leave: 4 D per live (query, key) pair for
    the two products; q, k, v read and o written once."""
    pos = torch.arange(sq, dtype=torch.float64) + q_offset
    hi = torch.clamp(pos + 1, max=sk) if causal else torch.full_like(pos, sk)
    lo = torch.clamp(pos - window + 1, min=0) if window is not None \
        else torch.zeros_like(pos)
    pairs = torch.clamp(hi - lo, min=0).sum().item()
    return (4.0 * d * pairs * b * hq,
            (2 * b * hq * sq * d + 2 * b * hkv * sk * d) * itemsize)


def ssd_work(b, h, L, p, n, chunk, itemsize):
    """(flops, bytes) of the chunked scan: the t >= s within-chunk products
    (C B^T and its product with x), the state's term in y and the state
    update; x, B, C read and y written once in their dtype, a_log in f32."""
    flops = 0.0
    for l0 in range(0, L, chunk):
        c = min(chunk, L - l0)
        flops += c * (c + 1) * (n + p) + 4.0 * c * n * p
    return flops * b * h, b * L * h * (2 * p + 2 * n) * itemsize + b * L * h * 4


def model_rows(gen, launches):
    """Times of B4-B6 at their paths' shapes: dotp at n = 2^26 f32 (the
    kernels phase; its launches are the paper path's, the model path
    launches none), attention and the SSD scan at the hymba prefill's
    shapes (bf16)."""
    from repro_torch.kernels import dotp as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk

    rows = []
    n = 2 ** 26
    x = torch.randn(n, generator=gen, device="cuda")
    y = torch.randn(n, generator=gen, device="cuda")
    b_ms, b_by = bound(2.0 * n, 2 * n * 4, torch.float32)
    rows.append(dict(
        name="dotp", shape=f"n={n} float32", ms=cuda_ms(lambda: dk.dotp(x, y)),
        plain_ms=cuda_ms(lambda: dk.dotp_plain(x, y)),
        library_ms=cuda_ms(lambda: torch.dot(x, y)), bound_ms=b_ms,
        bound_by=b_by, max_abs_err=abs(dk.dotp(x, y).item()
                                       - dk.dotp_plain(x, y).item()),
        ms_graph=graph_ms(lambda: dk.dotp(x, y)),
        library_ms_graph=graph_ms(lambda: torch.dot(x, y)),
        timing="ms, library_ms: 5 calls back to back (host time shows); "
               "*_graph: 20 calls in one CUDA graph, replayed",
        launch=dk.dotp.last_launch,
        launches_note="the paper path's (the quickstart's step 5); the "
                      "model path launches no dotp"))
    # B4 against torch.dot in turns (kernel, library, library, kernel, ...),
    # 20 repetitions each, so the gap is read against the spread
    times = {"dotp": [], "torch.dot": []}
    fns = {"dotp": lambda: dk.dotp(x, y), "torch.dot": lambda: torch.dot(x, y)}
    for i in range(20):
        for name in (("dotp", "torch.dot") if i % 2 == 0
                     else ("torch.dot", "dotp")):
            times[name].append(cuda_ms(fns[name]))
    emit(interleaved="dotp vs torch.dot, n=2^26 f32, 20 alternating "
                     "repetitions of cuda_ms (5 launches each)",
         **{name: {"median_ms": statistics.median(t),
                   "min_ms": min(t), "max_ms": max(t), "ms": t}
            for name, t in times.items()})
    del x, y
    b, s = PREFILL
    q, k, v = attention_inputs(gen, b, 25, 5, s, s, 64, torch.bfloat16)
    band = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    band &= ~torch.ones_like(band).tril(-1024)
    for window, tag in ((1024, "windowed"), (None, "global")):
        flops, nbytes = attention_work(b, 25, 5, s, s, 64, 2, window=window)
        b_ms, b_by = bound(flops, nbytes, torch.bfloat16)
        lib = (lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)) if window is None \
            else (lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=band, enable_gqa=True))
        got = fa.attention(q, k, v, window=window)
        rows.append(dict(
            name="attention", shape=f"q{tuple(q.shape)} k/v{tuple(k.shape)} "
            f"bfloat16 causal {tag} (window={window})",
            ms=cuda_ms(lambda: fa.attention(q, k, v, window=window)),
            plain_ms=cuda_ms(lambda: fa.attention_plain(q, k, v,
                                                        window=window)),
            library_ms=cuda_ms(lib), bound_ms=b_ms, bound_by=b_by,
            max_abs_err=(got.float() - fa.attention_plain(
                q, k, v, window=window).float()).abs().max().item(),
            library_max_abs_err=(got.float() - lib().float()).abs().max()
            .item(), variant=fa.attention.last_launch["variant"],
            tile=fa.attention.last_launch["tile"]))
    # the FFMA variant at the windowed layers' shape, in f32
    qf, kf, vf = (t.float() for t in (q, k, v))
    flops, nbytes = attention_work(b, 25, 5, s, s, 64, 4, window=1024)
    b_ms, b_by = bound(flops, nbytes, torch.float32)
    got = fa.attention(qf, kf, vf, window=1024)
    rows.append(dict(
        name="attention", shape=f"q{tuple(q.shape)} k/v{tuple(k.shape)} "
        f"float32 causal windowed (window=1024)",
        ms=cuda_ms(lambda: fa.attention(qf, kf, vf, window=1024)),
        plain_ms=cuda_ms(lambda: fa.attention_plain(qf, kf, vf,
                                                    window=1024)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qf, kf, vf, attn_mask=band, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=(got - fa.attention_plain(qf, kf, vf, window=1024))
        .abs().max().item(), variant=fa.attention.last_launch["variant"],
        tile=fa.attention.last_launch["tile"]))
    del q, k, v, band, qf, kf, vf, got
    # B6 issues three launches per call, so its ms is a CUDA-graph replay
    # (host time between the launches shows back to back); the profiler's
    # device ms of the three kernels per call beside it. The card's trace
    # may drop some of a short run's kernels, so each pass's time per call
    # is its device ms over the launches the trace holds, and a call's is
    # the sum of its three passes'.
    args = ssd_inputs(gen, b, 50, s, 64, 16, torch.bfloat16)
    flops, nbytes = ssd_work(b, 50, s, 64, 16, 256, 2)
    b_ms, b_by = bound(flops, nbytes, torch.bfloat16)
    reps = 10
    passes = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")
    matched = profiled(lambda: [sk.ssd_scan(*args, chunk=256)
                                for _ in range(reps)], passes,
                       lambda m, count: 0 < count <= reps)
    per_pass = {k: matched[k]["device_ms"] / matched[k]["launches"]
                for k in passes}
    rows.append(dict(
        name="ssd_scan", shape=f"x{tuple(args[0].shape)} n=16 chunk=256 "
        f"bfloat16", ms=graph_ms(lambda: sk.ssd_scan(*args, chunk=256)),
        ms_back_to_back=cuda_ms(lambda: sk.ssd_scan(*args, chunk=256)),
        device_ms_per_call=sum(per_pass.values()),
        pass_device_ms_per_call=per_pass,
        pass_launches_traced={k: matched[k]["launches"] for k in passes},
        timing="ms: 20 calls in one CUDA graph, replayed; device_ms_per_call:"
               " torch.profiler over 10 calls, the sum over the three ssd_ "
               "kernels of each one's device ms per traced launch",
        plain_ms=cuda_ms(lambda: sk.ssd_scan_plain(*args, chunk=256)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        max_abs_err=(sk.ssd_scan(*args, chunk=256).float()
                     - sk.ssd_scan_plain(*args, chunk=256).float()).abs()
        .max().item(), grids=sk.ssd_scan.last_launch["grids"],
        smem_bytes=sk.ssd_scan.last_launch["smem_bytes"],
        scratch_bytes=sk.ssd_scan.last_launch["scratch_bytes"]))
    for row in rows:
        source, replaces = REPLACES[row["name"]]
        row.update(route="cuda", source=source, replaces=replaces,
                   launches=launches[row["name"]])
        if "variant" in row:
            row["variant_launches"] = launches["attention_variants"][
                row["variant"]]
    emit(phase="times (model)", rows=rows,
         peaks="bf16 rows priced at the bf16 tensor peak (989 TFLOP/s), "
               "f32 at the FP32 peak (67 TFLOP/s); HBM 3.35 TB/s")
    return rows


def family_rows(gen, b5):
    """B5's times at the families' forms (bf16, ``wgmma``) beside its
    plain version, SDPA and the bound; each row's launches are those of
    its family's counted prefill (``b5``: whisper-small's 36 split into
    its encoder, decoder self- and cross-attention layers)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import flash_attention as fa

    w = registry.get_config(FAMILY_ENCDEC[0])
    per_row = [w.encoder_layers, w.n_layers, w.n_layers,
               b5[FAMILY_MOE[0]], b5[FAMILY_VLM[0]]]
    assert sum(per_row[:3]) == b5[FAMILY_ENCDEC[0]], (per_row, b5)
    names = ["whisper-small encoder", "whisper-small cross",
             "whisper-small decoder self", "qwen3-moe", "internvl2-1b"]
    rows = []
    for (b, hq, hkv, sq, sk, d, causal), n, name in zip(
            FAMILY_ATTN_CHECKS, per_row, names):
        q, k, v = attention_inputs(gen, b, hq, hkv, sq, sk, d,
                                   torch.bfloat16)
        flops, nbytes = attention_work(b, hq, hkv, sq, sk, d, 2,
                                       causal=causal)
        b_ms, b_by = bound(flops, nbytes, torch.bfloat16)
        got = fa.attention(q, k, v, causal=causal)
        rows.append(dict(
            name="attention", shape=f"{name}: q{tuple(q.shape)} "
            f"k/v{tuple(k.shape)} bfloat16 causal={causal}",
            ms=cuda_ms(lambda: fa.attention(q, k, v, causal=causal)),
            plain_ms=cuda_ms(lambda: fa.attention_plain(q, k, v,
                                                        causal=causal)),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)),
            bound_ms=b_ms, bound_by=b_by,
            max_abs_err=(got.float() - fa.attention_plain(
                q, k, v, causal=causal).float()).abs().max().item(),
            variant=fa.attention.last_launch["variant"],
            tile=fa.attention.last_launch["tile"], route="cuda",
            source=REPLACES["attention"][0],
            replaces=REPLACES["attention"][1], launches=n,
            launches_note=f"per {name.split()[0]} prefill (families phase)"))
        del q, k, v, got
    emit(phase="times (families)", rows=rows,
         peaks="bf16 at the tensor peak (989 TFLOP/s); HBM 3.35 TB/s")
    return rows


def paper_sweeps(n):
    """Figs 12-13 at size n: (tag, stream, the units swept jointly, the
    matching section-4 profile)."""
    from repro_torch.core import characterization as ch
    from repro_torch.core import isa

    qr, lu = isa.compile_dgeqrf(n), isa.compile_dgetrf(n)
    return [("fig12 dgemm", isa.compile_dgemm(n, n, n, unroll=4),
             ("add", "mul"), ch.characterize_dgemm(n, n, n, unroll=4)),
            ("fig12 dgeqrf", qr, ("add", "mul"), ch.characterize_dgeqrf(n)),
            ("fig12 dgetrf", lu, ("add", "mul"), ch.characterize_dgetrf(n)),
            ("fig13 dgeqrf", qr, ("sqrt", "div"), ch.characterize_dgeqrf(n)),
            ("fig13 dgetrf", lu, ("sqrt", "div"), ch.characterize_dgetrf(n))]


def pe_args(stream, results, device="cuda"):
    """B8's operands (opcode, src1, src2, lat) for the depth
    configurations of ``results``."""
    import numpy as np
    from repro_torch.core import pe

    lat = np.stack([pe._latency_vector(r.depths) for r in results])
    return [torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(device)
            for v in (stream.opcode, stream.src1, stream.src2, lat)]


def pe_exact(tag, stream, results):
    """Hold the (cycles, stalls) of ``results`` (the entry point's, from
    B8 on the card) to B8's plain version on the same stream and depths;
    raises on any difference. Returns the plain version's seconds and the
    largest |kernel - plain| over cycles and stalls (0)."""
    from repro_torch.kernels import pe_scoreboard as ps

    args = pe_args(stream, results, "cpu")
    t0 = time.perf_counter()
    cycles, stalls = ps.pe_scoreboard_plain(*args)
    secs = time.perf_counter() - t0
    got = [(r.cycles, r.stalls) for r in results]
    want = list(zip(cycles.tolist(), stalls.tolist()))
    err = max(max(abs(g[0] - w[0]), abs(g[1] - w[1]))
              for g, w in zip(got, want))
    emit(check=f"B8 {tag}: {stream.n_instructions} instructions x "
               f"{len(results)} configurations vs plain", max_abs_err=err,
         tol=0, reason="integer recurrence: exact", plain_s=secs,
         ok=err == 0)
    if err:
        raise AssertionError(f"B8 {tag}: kernel {got} != plain {want}")
    for r in results:
        assert r.cycles >= r.n_instructions and r.stalls >= 0, r
    return secs, err


def pe_bound(n, configs, clock_mhz):
    """(least ms, what bounds it) of B8 on n instructions at ``configs``
    depth configurations: n dependent steps of PE_STEP_CYCLES at the
    card's clock (the configurations run side by side), or reading 12 B of
    stream per instruction per configuration at the HBM rate."""
    t_ops = n * PE_STEP_CYCLES / (clock_mhz * 1e6)
    t_bytes = 12.0 * n * configs / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def phase_paper():
    """The paper's own apparatus on the card, through the entry points a
    user calls (``repro_torch.core.pe``, ``codesign``, ``kernels``), with
    the launch counts zeroed just before and read just after: figs 12-13
    at n = 100 (five joint sweeps, one B8 launch each), section 5's DOT4
    against scalar dgemm (two), then the quickstart's steps 4-5 (B4 with
    U* accumulators, B1 on plan_gemm's tile). Then every B8 result is held
    to the plain version (two depths per sweep at n = 100, all seven of
    fig 12's dgemm; every sweep in full at n = 48), B4 and B1 to theirs,
    and each sweep prints CPI, TPI, the best depth by TPI beside the eq.-7
    depths of its section-4 profile, and the kernel's ms. Returns B8's
    row of the kernels line and the path's launch counts. Draws from a
    generator of its own."""
    from repro_torch.core import codesign, isa, pe
    from repro_torch.kernels import dotp as dk
    from repro_torch.kernels import gemm as gk
    from repro_torch.kernels import pe_scoreboard as ps

    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    sweeps = paper_sweeps(PAPER_N)
    # fig 12's dgemm stream (unroll 4, the compiler's default) is section
    # 5's scalar dgemm
    sec5 = (("dot4", isa.compile_dgemm(PAPER_N, PAPER_N, PAPER_N,
                                       dot4=True)), ("scalar", sweeps[0][1]))
    x = torch.randn(QUICK_DOT_N, generator=gen, device="cuda")
    y = torch.randn(QUICK_DOT_N, generator=gen, device="cuda")
    a = torch.randn(QUICK_GEMM_N, QUICK_GEMM_N, generator=gen, device="cuda")
    b = torch.randn(QUICK_GEMM_N, QUICK_GEMM_N, generator=gen, device="cuda")
    emit(paper_streams={tag: s.n_instructions for tag, s, _, _ in sweeps}
         | {f"section 5 {tag}": s.n_instructions for tag, s in sec5},
         n=PAPER_N, compile_s=time.perf_counter() - t0,
         sm_clock_max_mhz=clock_mhz)

    counts = zero_launches()
    t0 = time.perf_counter()
    results, walls = {}, {}
    for tag, stream, units, _ in sweeps:
        results[tag], walls[tag] = sync_time(lambda: pe.sweep_joint(
            stream, list(units), PAPER_DEPTHS))
    for tag, stream in sec5:
        results[tag], walls[tag] = sync_time(lambda: pe.simulate(
            stream, SEC5_DEPTHS))
    u = codesign.optimal_accumulators(QUICK_DOT_N)
    plan = codesign.plan_gemm(QUICK_GEMM_N, QUICK_GEMM_N, QUICK_GEMM_N,
                              dtype=torch.float32, machine="h100")
    dot = dk.dotp(x, y, accumulators=u)
    c = gk.gemm(a, b, plan=plan)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in counts.items()}
    expect = {"pe_scoreboard": len(sweeps) + len(sec5), "dotp": 1, "gemm": 1}
    assert {k: v for k, v in launches.items() if v} == expect, launches
    launch = gk.gemm.last_launch
    assert launch["tile"] == (plan.bm, plan.bn, plan.bk) \
        and launch["tile_source"] == "plan", (launch, plan)
    emit(phase="paper", wall_s=path_s, launches=launches,
         quickstart={"accumulators": u, "dotp": dk.dotp.last_launch,
                     "plan": [plan.bm, plan.bn, plan.bk],
                     "gemm_variant": launch["variant"],
                     "gemm_tile": launch["tile"]})

    # correctness (not part of the counted run)
    compare(f"quickstart dotp n={QUICK_DOT_N} f32 (U*={u}) vs plain", dot,
            dk.dotp_plain(x, y))
    compare(f"quickstart gemm {QUICK_GEMM_N}^3 f32 plan_gemm tile vs plain",
            c, gk.gemm_plain(a, b))
    plain = {}
    for tag, stream, _, _ in sweeps:
        res = results[tag]
        plain[tag] = pe_exact(f"{tag} n={PAPER_N}", stream,
                              res if tag == "fig12 dgemm"
                              else [res[0], res[-1]])
    for tag, stream in sec5:
        pe_exact(f"section 5 {tag} n={PAPER_N}", stream, [results[tag]])
    t1 = time.perf_counter()
    for tag, stream, units, _ in paper_sweeps(PAPER_CHECK_N):
        pe_exact(f"{tag} n={PAPER_CHECK_N}", stream, pe.sweep_joint(
            stream, list(units), PAPER_DEPTHS))
    for tag, stream in (("dot4", isa.compile_dgemm(
            PAPER_CHECK_N, PAPER_CHECK_N, PAPER_CHECK_N, dot4=True)),
            ("scalar", isa.compile_dgemm(PAPER_CHECK_N, PAPER_CHECK_N,
                                         PAPER_CHECK_N))):
        pe_exact(f"section 5 {tag} n={PAPER_CHECK_N}", stream,
                 [pe.simulate(stream, SEC5_DEPTHS)])
    emit(paper_checks_n48_s=time.perf_counter() - t1)

    # the figures, each sweep's kernel timed on its own inputs (the mean of
    # PE_TIMING_REPS launches after one), its cycles a step beside the
    # bound's
    kernel_ms = {}
    for tag, stream, units, prof in sweeps:
        res = results[tag]
        args = pe_args(stream, res)
        kernel_ms[tag] = cuda_ms(lambda: ps.pe_scoreboard(*args),
                                 reps=PE_TIMING_REPS)
        emit(paper=tag, n=PAPER_N, instructions=stream.n_instructions,
             units=list(units), depths=PAPER_DEPTHS,
             cycles=[r.cycles for r in res], stalls=[r.stalls for r in res],
             cpi=[r.cpi for r in res], tpi=[r.tpi for r in res],
             best_depth_by_tpi=pe.best_depth(res, units[0]),
             eq7_optimal_depths=prof.optimal_depths(),
             eq7_popt_closed_form=prof.popt_closed_form(),
             hazard_ratios=prof.hazard_ratios(), kernel_ms=kernel_ms[tag],
             kernel_cycles_per_step=kernel_ms[tag] * 1e-3 * clock_mhz * 1e6
             / stream.n_instructions, bound_cycles_per_step=PE_STEP_CYCLES,
             entry_point_wall_s=walls[tag])
    r4, r1 = results["dot4"], results["scalar"]
    emit(paper="section 5: DOT4 vs scalar dgemm", n=PAPER_N,
         depths=SEC5_DEPTHS, dot4_cycles=r4.cycles, scalar_cycles=r1.cycles,
         scalar_over_dot4_cycles=r1.cycles / r4.cycles,
         dot4_instructions=r4.n_instructions,
         scalar_instructions=r1.n_instructions,
         flops_per_cycle={"dot4": r4.flops / r4.cycles,
                          "scalar": r1.flops / r1.cycles},
         tpi={"dot4": r4.tpi, "scalar": r1.tpi},
         entry_point_wall_s={k: walls[k] for k in ("dot4", "scalar")})
    tag, stream = sweeps[0][0], sweeps[0][1]
    b_ms, b_by = pe_bound(stream.n_instructions, len(PAPER_DEPTHS),
                          clock_mhz)
    source, replaces = REPLACES["pe_scoreboard"]
    row = dict(name="pe_scoreboard", route="cuda", source=source,
               replaces=replaces, launches=launches["pe_scoreboard"],
               shape=f"{tag} n={PAPER_N}: {stream.n_instructions} "
                     f"instructions x {len(PAPER_DEPTHS)} configurations",
               ms=kernel_ms[tag], plain_ms=plain[tag][0] * 1e3,
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               max_abs_err=plain[tag][1],
               timing=f"ms: CUDA events, the mean of {PE_TIMING_REPS} "
                      f"launches after one warm-up; plain_ms: the plain "
                      f"version on the CPU, once",
               bound=f"{PE_STEP_CYCLES} cycles per dependent step (one "
                     f"VIADDMNMX, src/repro_torch/tools/int_chain.cu) at "
                     f"{clock_mhz} MHz")
    emit(phase="times (paper)", rows=[row])
    return row, launches


def mesh_counted(fn):
    """``fn()`` run to completion with the kernels' launch counts and the
    obs counters zeroed just before and read just after: (result, wall s,
    launches, counter deltas, collective records)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.kernels import gemm as gk
    from repro_torch.obs import counters

    wrappers = zero_launches()
    before = counters.snapshot()
    mesh_barrier()
    with coll.record_collectives() as rec:
        out, secs = sync_time(fn)
    launches = {name: w.launches for name, w in wrappers.items()
                if w.launches}
    launches["gemm_variants"] = {v: c for v, c in
                                 gk.gemm.variant_launches.items() if c}
    return out, secs, launches, counters.delta(before), rec


def mesh_barrier():
    """Line the ranks up (after the card's queue drains), so a leg's wall
    time is its own and not a wait for a slower rank's checks."""
    import torch.distributed as dist
    torch.cuda.synchronize()
    dist.barrier()


def mesh_held(rows, name, got, want, tol=None):
    """``compare`` of a mesh leg with its single-device result, as a row
    of the rank's output; raises past the tolerance."""
    tol, reason = tol or TOL[want.dtype]
    err = (got.double() - want.double()).abs().max().item()
    scale = max(want.double().abs().max().item(), 1.0)
    ok = bool(torch.isfinite(got).all()) and err <= tol * scale
    rows.append({"check": name, "max_abs_err": err, "scale": scale,
                 "tol": tol, "reason": reason, "bitwise": bool(
                     torch.equal(got, want)), "ok": ok})
    if not ok:
        raise AssertionError(f"{name}: |mesh - single device| = {err} > "
                             f"{tol} * {scale}")


def mesh_leg(rows, leg, secs, launches, counters, plan=None):
    row = {"leg": leg, "wall_s": secs, "launches": launches,
           "collective_bytes": counters.get("collective.bytes", 0),
           "collective_hops": counters.get("collective.hops", 0)}
    if plan is not None:
        row.update(plan_compute_s=plan.compute_s,
                   plan_collective_s=plan.collective_s,
                   plan_collective_bytes=plan.collective_bytes)
    rows.append(row)


def mesh_one_rank(tmp):
    """The (1, 1) mesh on one NCCL rank: pdgemm 8192^3 f32 under "model"
    through ``linalg.gemm`` is one B1 launch with zero hops, bitwise the
    single-device gemm; a cold-start "tuned" call bitwise the "model"
    one."""
    from repro_torch import linalg
    from repro_torch.core import codesign as cd

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    a = torch.randn(N, N, generator=gen, device="cuda")
    b = torch.randn(N, N, generator=gen, device="cuda")
    rows = []
    with linalg.use(policy="model"):
        want = linalg.gemm(a, b)
    with linalg.use(policy="model", mesh=(1, 1)):
        got, secs, launches, ctr, rec = mesh_counted(
            lambda: linalg.gemm(a, b))
    plan = cd.plan_pdgemm(N, N, N, 1, 1, dtype=torch.float32,
                          machine="h100")
    mesh_leg(rows, "pdgemm (1, 1) nccl f32 8192^3", secs, launches, ctr,
             plan)
    assert launches == {"gemm": 1, "gemm_variants": {"ffma": 1}}, launches
    assert [r.kind for r in rec] == ["pdgemm", "ring_bcast", "ring_bcast"]
    assert sum(r.hops for r in rec) == 0 and not ctr.get("collective.bytes")
    assert torch.equal(got, want), "(1, 1) pdgemm is not the gemm bitwise"
    with linalg.use(policy="tuned", mesh=(1, 1),
                    registry=os.path.join(tmp, "cold-registry.json")):
        tuned, secs = sync_time(lambda: linalg.gemm(a, b))
    assert torch.equal(tuned, got), "cold-start tuned != model"
    rows.append({"leg": "pdgemm (1, 1) nccl tuned (cold start)",
                 "wall_s": secs, "bitwise_gemm": True,
                 "bitwise_tuned_model": True})
    return rows


def mesh_gemm_legs(rows, rnd, lower_t):
    """gemm f32 8192^3 and f64 4096^3, syrk 8192 f32 and trsm 8192 f32
    with MESH_TRSM_RHS right-hand sides under ``use(mesh=MESH_GLOO)``; one
    more f32 gemm call with rank 0 under a device-only profile."""
    import torch.distributed as dist

    from repro_torch import linalg
    from repro_torch.core import codesign as cd
    from repro_torch.kernels import gemm as gk
    from repro_torch.tune import dispatch as td

    px, py = MESH_GLOO
    for tag, n, dtype in (("gemm f32 8192^3", N, torch.float32),
                          ("gemm f64 4096^3", N64, torch.float64)):
        a, b = rnd(n, n, dtype=dtype), rnd(n, n, dtype=dtype)
        plan = cd.plan_pdgemm(n, n, n, px, py, dtype=dtype, machine="h100")
        res = td.resolve("pdgemm", (n, n, n), dtype, policy="model",
                         backend="cuda", mesh=MESH_GLOO)
        with linalg.use(policy="model", mesh=MESH_GLOO):
            got, secs, launches, ctr, rec = mesh_counted(
                lambda: linalg.gemm(a, b))
        mesh_leg(rows, f"{tag} (2, 2) gloo", secs, launches, ctr, plan)
        variant = gk.TILED[dtype]
        assert launches == {"gemm": px * py,
                            "gemm_variants": {variant: px * py}}, launches
        tile = (res.gemm_plan.bm, res.gemm_plan.bn, res.gemm_plan.bk)
        assert gk.gemm.last_launch["tile"] == tile and \
            gk.gemm.last_launch["tile_source"] == "plan", gk.gemm.last_launch
        assert ctr["collective.bytes"] == plan.collective_bytes, (ctr, plan)
        assert len(rec) == 1 + 2 * px * py
        with linalg.use(policy="model"):
            mesh_held(rows, f"mesh {tag}", got, linalg.gemm(a, b))
        rows[-1]["tile"] = list(tile)
        if dist.get_rank() == 0:
            mesh_summa_panel_check(rows, tag, a, b, res, variant)
        if dtype == torch.float32:
            # where a SUMMA call's time goes: rank 0's device records (its
            # B1 launches and staging copies) against its wall time
            mesh_barrier()
            with linalg.use(policy="model", mesh=MESH_GLOO):
                if dist.get_rank() == 0:
                    rows.append({"profile": f"{tag} (2, 2) gloo, rank 0, "
                                            f"device only", **profile_call(
                                 lambda: linalg.gemm(a, b), cpu=False,
                                 match=("gemm_ffma", "Memcpy"), pad=32)})
                else:
                    linalg.gemm(a, b)
        del a, b, got
    a = rnd(N, N)
    plan = cd.plan_pdgemm(N, N, N, px, py, dtype=torch.float32,
                          machine="h100")
    with linalg.use(policy="model", mesh=MESH_GLOO):
        got, secs, launches, ctr, _ = mesh_counted(lambda: linalg.syrk(a))
    mesh_leg(rows, "syrk f32 8192 (2, 2) gloo", secs, launches, ctr, plan)
    assert launches == {"gemm": px * py,
                        "gemm_variants": {"ffma": px * py}}, launches
    with linalg.use(policy="model"):
        mesh_held(rows, "mesh syrk f32 8192", got, linalg.syrk(a))
    del a, got
    t = lower_t(N)
    rhs = rnd(N, MESH_TRSM_RHS)
    with linalg.use(policy="model", mesh=MESH_GLOO):
        got, secs, launches, ctr, rec = mesh_counted(
            lambda: linalg.trsm(t, rhs))
    mesh_leg(rows, f"trsm f32 8192 x {MESH_TRSM_RHS} (2, 2) gloo", secs,
             launches, ctr)
    assert launches["gemm"] > 0 and set(launches["gemm_variants"]) == \
        {"ffma"}, launches
    assert not rec and not ctr.get("collective.bytes")
    with linalg.use(policy="model"):
        mesh_held(rows, "mesh trsm f32 8192", got, linalg.trsm(t, rhs))
    if dist.get_rank() == 0:
        mesh_trsm_slab_check(rows, t, got[:, :MESH_TRSM_RHS // (px * py)])


def mesh_summa_panel_check(rows, tag, a, b, res, variant):
    """B1 at rank 0's first SUMMA step (mesh coordinates (0, 0), the
    owner of both panels) on the operands ``_summa_inner`` hands
    ``_local_update``: a column panel of its A shard (a strided view) and
    a row panel of its B shard, against the plain version."""
    from repro_torch.blas import distributed as bd
    from repro_torch.kernels import gemm as gk

    px, py = MESH_GLOO
    steps = px * py
    kf = -(-a.shape[1] // steps)
    ap = bd._block(bd._pad2(a, px, steps * kf), 0, 0, px, py)[:, :kf]
    bp = bd._block(bd._pad2(b, steps * kf, py), 0, 0, px, py)[:kf, :]
    got = bd._local_update(ap, bp, res)
    launch = gk.gemm.last_launch
    assert launch["variant"] == variant, launch
    mesh_held(rows, f"mesh {tag} SUMMA step 0 panel {tuple(ap.shape)} x "
                    f"{tuple(bp.shape)} strides {ap.stride()} {bp.stride()} "
                    f"[{variant} {launch['tile']}] against the plain "
                    f"version", got, gk.gemm_plain(ap, bp))


def mesh_trsm_slab_check(rows, t, x):
    """B1 at every off-diagonal update of the blocked TRSM that rank 0
    runs on its slab of right-hand sides (``pdtrsm``: T replicated, the
    slab's solution ``x``), on the operands ``level3.trsm`` hands over (a
    row window of T, the solved rows of X), each against the plain
    version; one row with the worst."""
    from repro_torch.blas import level3
    from repro_torch.kernels import gemm as gk
    from repro_torch.tune import dispatch as td

    n, nrhs = x.shape
    x = x.contiguous()
    block = td.resolve("trsm", (n, nrhs), t.dtype, policy="model",
                       backend="cuda").block
    tol, reason = TOL[t.dtype]
    worst, variants = None, set()
    for i0 in range(block, n, block):
        tw, xs = t[i0:i0 + block, :i0], x[:i0]
        got = level3.gemm(tw, xs, policy="model")
        variants.add(gk.gemm.last_launch["variant"])
        want = gk.gemm_plain(tw, xs)
        err = (got.double() - want.double()).abs().max().item()
        scale = max(want.double().abs().max().item(), 1.0)
        if worst is None or err / scale > worst[0] / worst[1]:
            worst = (err, scale, i0)
    ok = worst[0] <= tol * worst[1] and variants == {"ffma"}
    rows.append({"check": f"mesh trsm f32 {n} rank 0 slab {nrhs} rhs: B1 at "
                          f"its {len(range(block, n, block))} off-diagonal "
                          f"updates (block {block}) against the plain "
                          f"version", "variants": sorted(variants),
                 "max_abs_err": worst[0], "scale": worst[1],
                 "worst_rows": worst[2], "tol": tol, "reason": reason,
                 "ok": ok})
    assert ok, rows[-1]


def mesh_batched_legs(rows, rnd, rank, world):
    """The batched drivers at the lapack phase's sizes under
    ``use(mesh=MESH_GLOO)``, then ``batched_cholesky`` at a ragged batch.
    Each rank holds the gathered result's slab of the next rank to the
    single-device driver on that slab (so the four ranks check every
    item), and its own launches to that single-device call's count."""
    from repro_torch import linalg
    from repro_torch.lapack import batched as lb

    items, n, nrhs = BATCHED
    g = rnd(items, n, n)
    spd = g @ g.transpose(1, 2) / n + torch.eye(n, device="cuda")
    tall = rnd(items, n, BATCHED_TALL)
    rhs = rnd(items, n, nrhs)
    per = items // world
    sl = slice(((rank + 1) % world) * per, ((rank + 1) % world + 1) * per)
    for tag, fn, x in (("batched_cholesky", linalg.batched_cholesky, spd),
                       ("batched_lu", linalg.batched_lu, g),
                       ("batched_qr", linalg.batched_qr, tall)):
        with linalg.use(policy="model", mesh=MESH_GLOO):
            res, secs, launches, ctr, rec = mesh_counted(lambda: fn(x))
            sol, s_secs, s_launches, _, _ = mesh_counted(
                lambda: linalg.batched_solve(res, rhs))
        mesh_leg(rows, f"{tag} {items} x {n} (2, 2) gloo", secs, launches,
                 ctr)
        mesh_leg(rows, f"{tag} solve {nrhs} rhs (2, 2) gloo", s_secs,
                 s_launches, {})
        assert [r.info for r in rec] == [{"batch": items, "pad": 0,
                                          "identity": True}]
        with linalg.use(policy="model"):
            want, _, w_launches, _, _ = mesh_counted(lambda: fn(x[sl]))
            w_sol, _, ws_launches, _, _ = mesh_counted(
                lambda: linalg.batched_solve(want, rhs[sl]))
        assert launches == w_launches, (tag, launches, w_launches)
        assert s_launches == ws_launches, (tag, s_launches, ws_launches)
        mesh_held(rows, f"mesh {tag} factors", res.factors[sl], want.factors)
        mesh_held(rows, f"mesh {tag} solve", sol[sl], w_sol)
        if res.pivots is not None:
            assert torch.equal(res.pivots[sl], want.pivots)
        if res.tau is not None:
            mesh_held(rows, f"mesh {tag} tau", res.tau[sl], want.tau)
    spd = spd[:MESH_RAGGED]
    with linalg.use(policy="model", mesh=MESH_GLOO):
        res, secs, launches, ctr, rec = mesh_counted(
            lambda: linalg.batched_cholesky(spd))
    mesh_leg(rows, f"batched_cholesky {MESH_RAGGED} x {n} (2, 2) gloo",
             secs, launches, ctr)
    pad = -MESH_RAGGED % world
    assert [(r.kind, r.size, r.info) for r in rec] == [
        ("pad_batch", world, {"batch": MESH_RAGGED, "pad": pad,
                              "identity": True})], rec
    assert res.factors.shape[0] == MESH_RAGGED
    lo, hi = sl.start, min(sl.stop, MESH_RAGGED)
    with linalg.use(policy="model"):
        want = linalg.batched_cholesky(spd[lo:hi])
    mesh_held(rows, f"mesh batched_cholesky ragged {MESH_RAGGED}",
              res.factors[lo:hi], want.factors)


def mesh_sync_leg(rows, rank, world):
    """compressed_grad_sync over a 4-rank "pod" axis on one hymba-1.5b
    layer's parameter shapes, MESH_SYNC_STEPS steps with error feedback:
    every rank's means bitwise equal (all-reduced MAX and MIN of their
    bits), and rank 0 holds them to the plain mean of the ranks'
    error-fed gradients within the int8 bound."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import registry
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model_zoo

    pod = make_debug_mesh(data=1, model=1, pod=world)
    cfg = dataclasses.replace(registry.get_config("hymba-1.5b"), n_layers=1)
    shapes = {k: p.shape for k, p in
              model_zoo.build(cfg, "meta").blocks[0].named_parameters()}

    def grads(step, r):
        gen = torch.Generator(device="cuda").manual_seed(
            SEED + 1000 * step + r)
        return {k: 1e-3 * torch.randn(s, generator=gen, device="cuda")
                for k, s in shapes.items()}

    def q_err(y):
        q, sc = coll._quantize(y)
        return y - coll._dequantize(q, sc, y.shape), \
            0.5 * sc.expand(-1, coll.Q_BLOCK).reshape(-1)[:y.numel()] \
            .reshape(y.shape)

    sync = coll.compressed_grad_sync(pod, "pod")
    errs = {k: torch.zeros(s, device="cuda") for k, s in shapes.items()}
    steps = []
    for step in range(MESH_SYNC_STEPS):
        mine = grads(step, rank)
        mesh_barrier()
        (means, errs), secs = sync_time(lambda: sync(mine, errs))
        bits = torch.cat([m.reshape(-1).view(torch.int32)
                          for m in means.values()])
        hi = coll.all_reduce(bits, pod, "pod", dist.ReduceOp.MAX)
        lo = coll.all_reduce(bits, pod, "pod", dist.ReduceOp.MIN)
        agree = bool(torch.equal(hi, lo))
        steps.append(means)
        rows.append({"leg": f"compressed_grad_sync step {step} hymba-1.5b "
                            f"layer ({sum(s.numel() for s in shapes.values())}"
                            f" values) pod={world} gloo", "wall_s": secs,
                     "ranks_bitwise_equal": agree})
        assert agree, "the ranks' compressed means differ"
    if rank != 0:
        return
    feed = [dict.fromkeys(shapes, 0.0) for _ in range(world)]
    for step, means in enumerate(steps):
        worst = -float("inf")
        for k in shapes:
            ys, bound = [], 0.0
            for r in range(world):
                y = grads(step, r)[k] + feed[r][k]
                feed[r][k], half = q_err(y)
                ys.append(y)
                bound = bound + half / world
            slack = MESH_SYNC_SLACK[0] * max(
                max(y.abs().max().item() for y in ys), 1e-30)
            excess = ((means[k] - sum(ys) / world).abs() - bound).max().item()
            worst = max(worst, excess / slack)   # <= 0: inside the int8 bound
        rows.append({"check": f"compressed_grad_sync step {step} against "
                              f"the plain mean of the error-fed gradients",
                     "worst_excess_over_slack": worst,
                     "slack": MESH_SYNC_SLACK, "ok": worst <= 1.0})
        assert worst <= 1.0, f"compressed mean past the int8 bound: {worst}"


def mesh_decode_leg(rows, rank, world):
    """sharded_decode_attention at hymba-1.5b's decode shapes, the cache
    sharded over a 4-rank "model" axis, ragged per-row lengths; rank 0
    holds it to plain attention over each row's valid positions in f64."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch.mesh import make_debug_mesh

    dec = make_debug_mesh(data=1, model=world)
    b, hq, hkv, d, s = MESH_DECODE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    q = torch.randn(b, hq, d, generator=gen, device="cuda")
    k = torch.randn(b, s, hkv, d, generator=gen, device="cuda")
    v = torch.randn(b, s, hkv, d, generator=gen, device="cuda")
    lens = torch.tensor(MESH_KV_LEN, device="cuda")
    attn = coll.sharded_decode_attention(dec, ("data",))
    mesh_barrier()
    out, secs = sync_time(lambda: attn(q, k, v, lens))
    row = {"leg": f"sharded_decode_attention B {b} heads {hq}/{hkv} D {d} "
                  f"S {s} kv_len {list(MESH_KV_LEN)} model={world} gloo",
           "wall_s": secs}
    if rank == 0:
        g = hq // hkv
        qd = q.double().reshape(b, hkv, g, d)
        sc = torch.einsum("bhgd,bshd->bhgs", qd, k.double()) / d ** 0.5
        mask = torch.arange(s, device="cuda")[None, :] < lens[:, None]
        sc = sc.masked_fill(~mask[:, None, None, :], float("-inf"))
        want = torch.einsum("bhgs,bshd->bhgd", sc.softmax(-1),
                            v.double()).reshape(b, hq, d)
        err = (out.double() - want).abs().max().item()
        scale = want.abs().max().item()
        row.update(max_abs_err=err, scale=scale, tol=MESH_DECODE_TOL)
        assert out.shape == (b, hq, d) and \
            err <= MESH_DECODE_TOL[0] * scale, (err, scale)
    rows.append(row)


def mesh_rank(rank, world, backend, directory):
    """One rank of the mesh phase, in a spawned process: joins the
    ``backend`` process group of ``world`` ranks (rendezvous through a
    file in ``directory``), runs its legs and writes its rows to
    ``directory/rank<R>.json``."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // world))
    dist.init_process_group(
        backend, init_method=f"file://{directory}/rdv", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        if world == 1:
            rows = mesh_one_rank(directory)
        else:
            from repro_torch.linalg import context as lctx
            # every rank makes the meshes, in one order (collectively)
            lctx.resolved_mesh(lctx.ExecutionContext(mesh=MESH_GLOO))
            gen = torch.Generator(device="cuda").manual_seed(SEED)

            def rnd(*shape, dtype=torch.float32):
                return torch.randn(*shape, generator=gen, device="cuda",
                                   dtype=torch.float64).to(dtype)

            rows = []
            mesh_gemm_legs(rows, rnd, lambda n: lower(gen, n, torch.float32,
                                                      False))
            mesh_batched_legs(rows, rnd, rank, world)
            mesh_sync_leg(rows, rank, world)
            mesh_decode_leg(rows, rank, world)
        with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
            json.dump(rows, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(world, backend, directory, target, timeout_s):
    """Start ``world`` spawned ranks of ``target`` and wait for them (a
    failed rank stops the others: they would wait on it); returns their
    exit codes, None for one stopped at the deadline."""
    import multiprocessing

    os.makedirs(directory)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, backend, directory))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline \
                and not any(p.exitcode for p in procs):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
    return [p.exitcode for p in procs]


def run_ranks(world, backend, directory, target=None,
              timeout_s=MESH_TIMEOUT_S):
    """:func:`spawn_ranks` of ``target`` (default :func:`mesh_rank`), then
    their rows; raises if any rank failed or the phase timed out."""
    codes = spawn_ranks(world, backend, directory, target or mesh_rank,
                        timeout_s)
    bad = {r: c for r, c in enumerate(codes) if c != 0}
    if bad:
        raise AssertionError(f"mesh ranks {backend} x {world} failed "
                             f"(exit codes {bad})")
    out = []
    for r in range(world):
        with open(os.path.join(directory, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def phase_mesh(smi):
    """The paper's workload on a mesh: SUMMA pdgemm / pdtrsm and the
    batch-sharded drivers through ``linalg.use(mesh=...)``, the gradient
    sync and flash-decoding, as SPMD ranks in spawned processes (the
    kernels already built). First a (1, 1) mesh on one NCCL rank, then
    four gloo ranks sharing the card (NCCL refuses two ranks on one
    card). Every leg is held to the single-device result; the rows name
    the card, its power limit and, beside every time, MESH_NOTE."""
    import shutil
    import tempfile

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    top = tempfile.mkdtemp(prefix="mesh-")
    try:
        results = {"nccl x 1": run_ranks(1, "nccl",
                                         os.path.join(top, "nccl1"))}
        results[f"gloo x {MESH_GLOO[0] * MESH_GLOO[1]}"] = run_ranks(
            MESH_GLOO[0] * MESH_GLOO[1], "gloo", os.path.join(top, "gloo4"))
    finally:
        shutil.rmtree(top, ignore_errors=True)
    launches = {}
    for group, ranks in results.items():
        for rank, rows in enumerate(ranks):
            for row in rows:
                emit(phase="mesh", ranks=group, rank=rank, card=smi,
                     **({"note": MESH_NOTE} if "wall_s" in row else {}),
                     **row)
                for name, count in row.get("launches", {}).items():
                    if name != "gemm_variants" and group.startswith("gloo"):
                        launches[name] = launches.get(name, 0) + count
    emit(phase="mesh", wall_s=time.perf_counter() - t0, card=smi,
         launches_all_gloo_ranks=launches)
    return launches


def shard_cfg():
    """hymba-1.5b as registered, cut to SHARD_LAYERS layers, f32 compute."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch.train import reduce_config

    cfg = reduce_config(registry.get_config("hymba-1.5b"),
                        layers=SHARD_LAYERS)
    return dataclasses.replace(cfg, dtype="float32")


def shard_one_device(cfg, opt_cfg, path):
    """TRAIN_AGREE_STEPS steps of ``cfg`` on one device from SEED (what the
    ranks are held to): per-step metrics, and the parameters saved to
    ``path``."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.distributed import sharding as sh
    from repro_torch.train import optimizer
    from repro_torch.train import train_state as ts

    torch.cuda.empty_cache()
    state = ts.init_state(torch.Generator(device="cuda").manual_seed(SEED),
                          cfg, opt_cfg, "cuda")
    state_bytes = sh.local_bytes(state)
    data = DataConfig(vocab=cfg.vocab, global_batch=TRAIN[0],
                      seq_len=TRAIN[1], seed=SEED)
    step_fn = ts.make_train_step(cfg, opt_cfg)
    metrics = []
    for i in range(TRAIN_AGREE_STEPS):
        if i == TRAIN_AGREE_STEPS - 1:
            prev = {k: p.detach().clone() for k, p in
                    optimizer.named_parameters(state["params"]).items()}
        (state, m), secs = sync_time(lambda: step_fn(state, make_batch(
            cfg, data, i, device="cuda")))
        metrics.append({"wall_s": secs, **{k: m[k].item() for k in
                                           ("loss", "grad_norm", "lr")}})
    params = optimizer.named_parameters(state["params"])
    # the planted fault: each leaf's error if its last update were dropped
    last = sorted((p.detach() - prev[k]).abs().max().item()
                  for k, p in params.items())
    del prev
    torch.save({k: p.detach().cpu() for k, p in params.items()}, path)
    n_params = sum(p.numel() for p in state["params"].parameters())
    del state
    torch.cuda.empty_cache()
    return {"metrics": metrics, "state_bytes": state_bytes,
            "params": n_params,
            "last_update_max_abs": {"min_over_leaves": last[0],
                                    "median_over_leaves":
                                        last[len(last) // 2]}}


def shard_moe_cfg(factor):
    """The families phase's reduced moe at capacity factor ``factor``, a
    step in one microbatch."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch.train import reduce_config

    return dataclasses.replace(reduce_config(
        registry.get_config("qwen3-moe-235b-a22b"), layers=3, d_model=256,
        vocab=512, heads=4), dtype="float32", capacity_factor=factor,
        accum_steps=1)


def shard_moe_full_cfg():
    """qwen3-moe-235b-a22b at full width, SHARD_MOE_LAYERS layers, f32."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch.train import reduce_config

    return dataclasses.replace(reduce_config(
        registry.get_config("qwen3-moe-235b-a22b"),
        layers=SHARD_MOE_LAYERS), dtype="float32")


def moe_dropped(layer, x):
    """How many of a flat-dispatch moe layer's (token, k) assignments on
    ``x`` (B, S, d) land past their expert's capacity."""
    from repro_torch.models.moe import capacity

    cfg = layer.cfg
    with torch.no_grad():
        xt = x.reshape(-1, x.shape[-1]).float()
        ids = torch.topk(torch.softmax(xt @ layer.router.float(), -1),
                         cfg.top_k, -1).indices
        counts = torch.bincount(ids.reshape(-1), minlength=cfg.n_experts)
        return int((counts - capacity(xt.shape[0], cfg)).clamp(min=0).sum())


def moe_exchange_bytes(cfg, tokens, ndp, nmodel):
    """The bytes one slot exchange brings a rank over the DP axes: (ndp -
    1) windows of E / model experts x capacity / ndp slots x d x 4."""
    from repro_torch.models.moe import capacity, padded_capacity

    window = padded_capacity(capacity(tokens, cfg), ndp) // ndp
    return (ndp - 1) * cfg.n_experts // nmodel * window * cfg.d_model * 4


def moe_prefill_tokens(cfg):
    """The (b) leg's SHARD_MOE_PREFILL tokens, the same on every process."""
    return torch.randint(0, cfg.vocab, SHARD_MOE_PREFILL,
                         generator=torch.Generator(device="cuda").manual_seed(
                             SEED + 2), device="cuda")


def expert_flops(fn, dims):
    """``fn()``'s result and the flops of its expert products: every bmm
    whose second operand is (E', d, d_expert) with ``dims`` = (d,
    d_expert)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    total = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.bmm.default \
                    and tuple(args[1].shape[1:]) == dims:
                e, m, k = args[0].shape
                total[0] += 2 * e * m * k * args[1].shape[2]
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, total[0]


def shard_moe_one_device(top):
    """The moe legs' one-device runs, in this process: (a) each capacity
    factor's TRAIN_AGREE_STEPS steps (metrics, the parameters saved, the
    first step's dropped assignments, the last update), (b) the full-width
    cut's prefill (its logits saved, its expert flops)."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import model_zoo
    from repro_torch.train import optimizer
    from repro_torch.train import train_state as ts

    out = {"train": {}}
    for factor in SHARD_MOE_FACTORS:
        cfg = shard_moe_cfg(factor)
        opt_cfg = optimizer.AdamWConfig(**TRAIN_OPT)
        state = ts.init_state(torch.Generator(device="cuda").manual_seed(
            SEED), cfg, opt_cfg, "cuda")
        data = DataConfig(vocab=cfg.vocab, global_batch=SHARD_MOE_TRAIN[0],
                          seq_len=SHARD_MOE_TRAIN[1], seed=SEED)
        dropped = []
        hooks = [b.moe.register_forward_hook(
            lambda mod, args, _o: dropped.append(moe_dropped(mod, args[0])))
            for b in state["params"].blocks]
        step_fn = ts.make_train_step(cfg, opt_cfg)
        metrics = []
        for i in range(TRAIN_AGREE_STEPS):
            if i == TRAIN_AGREE_STEPS - 1:
                prev = {k: p.detach().clone() for k, p in
                        optimizer.named_parameters(state["params"]).items()}
            (state, m), secs = sync_time(lambda: step_fn(state, make_batch(
                cfg, data, i, device="cuda")))
            metrics.append({"wall_s": secs, **{k: m[k].item() for k in
                                               ("loss", "grad_norm", "lr")}})
            if i == 0:
                for h in hooks:
                    h.remove()
        params = optimizer.named_parameters(state["params"])
        last = sorted((p.detach() - prev[k]).abs().max().item()
                      for k, p in params.items())
        torch.save({k: p.detach().cpu() for k, p in params.items()},
                   os.path.join(top, f"moe_{factor}.pt"))
        out["train"][factor] = {
            "metrics": metrics, "dropped_step0": sum(dropped[:cfg.n_layers]),
            "last_update_median": last[len(last) // 2]}
        del state, prev, params
        torch.cuda.empty_cache()
    cfg = shard_moe_full_cfg()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = sync_time(lambda: model_zoo.init(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda"))
    n_params = sum(p.numel() for p in model.parameters())
    tokens = moe_prefill_tokens(cfg)
    with torch.no_grad():           # the first call counts the expert flops
        _, flops = expert_flops(lambda: model_zoo.prefill(
            model, {"tokens": tokens}, cfg), (cfg.d_model, cfg.d_expert))
        counts = zero_launches()
        (logits, _, _), secs = sync_time(lambda: model_zoo.prefill(
            model, {"tokens": tokens}, cfg))
    launches = {k: w.launches for k, w in counts.items() if w.launches}
    assert launches == {"attention": cfg.n_layers}, launches
    assert bool(torch.isfinite(logits).all())
    torch.save(logits.cpu(), os.path.join(top, "moe_prefill_logits.pt"))
    out["prefill"] = {"params": n_params, "init_s": init_s, "wall_s": secs,
                      "expert_flops": flops, "launches": launches,
                      "param_bytes": 4 * n_params,
                      "peak_bytes": torch.cuda.max_memory_allocated()}
    del model, logits
    torch.cuda.empty_cache()
    return out


def shard_probe_rank(rank, world, backend, directory):
    """One rank of a probe group (spawned, a group per op: a collective
    that kills its processes stops only its group): DTensor's own
    redistribution named by ``directory``'s suffix (``all_gather``,
    ``reduce_scatter``, ``all_to_all``) on card tensors over a gloo mesh
    of the card's type; its result or error to ``directory/probe<R>.json``.
    The route does not depend on the probe."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.mesh import make_debug_mesh

    torch.cuda.set_device(0)
    dist.init_process_group(
        backend, init_method=f"file://{directory}/rdv", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_debug_mesh(*SHARD_MESH, device_type="cuda")
        full = torch.arange(64.0, device="cuda").reshape(8, 8)
        half = full.chunk(2)[mesh.get_local_rank("data")]
        src, local, dst, want = {
            "all_gather": ([Shard(0), Replicate()], half,
                           [Replicate(), Replicate()], full),
            "reduce_scatter": ([Partial(), Replicate()], full,
                               [Shard(0), Replicate()], 2 * half),
            "all_to_all": ([Shard(0), Replicate()], half,
                           [Shard(1), Replicate()], full.chunk(2, 1)[
                               mesh.get_local_rank("data")]),
        }[os.path.basename(directory).split("-", 1)[1]]
        try:     # a probe: its outcome is reported, the route is fixed
            got = DTensor.from_local(local.contiguous(), mesh, src,
                                     run_check=False).redistribute(
                mesh, dst).to_local()
            torch.cuda.synchronize()
            res = "ok" if torch.equal(got, want) else "wrong values"
        except Exception as e:                   # noqa: BLE001
            res = f"{type(e).__name__}: {str(e)[:160]}"
        with open(os.path.join(directory, f"probe{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def shard_probe(world, top):
    """DTensor's all-gather, reduce-scatter and all-to-all on card
    tensors over gloo, a spawned group each: {op: result}, or the exit
    codes of ranks that died (-11: a segmentation fault)."""
    import concurrent.futures as cf

    ops = ("all_gather", "reduce_scatter", "all_to_all")
    dirs = {op: os.path.join(top, f"probe-{op}") for op in ops}
    with cf.ThreadPoolExecutor(len(ops)) as ex:       # the groups at once
        codes = dict(zip(ops, ex.map(lambda op: spawn_ranks(
            world, "gloo", dirs[op], shard_probe_rank, 120), ops)))
    out = {}
    for op in ops:
        path = os.path.join(dirs[op], "probe0.json")
        if os.path.exists(path):
            with open(path) as f:
                out[f"dtensor.{op}"] = json.load(f)
        else:
            out[f"dtensor.{op}"] = f"the ranks died: exit codes {codes[op]}"
    return out


def shard_staged(mesh):
    """The route's transport (collectives.py, staged through pinned host
    memory for gloo) on card tensors: {op: result}."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives as coll

    full = torch.arange(64.0, device="cuda").reshape(8, 8)
    half = full.chunk(2)[mesh.get_local_rank("data")]
    got = {"all_gather": (coll.all_gather_cat(half.contiguous(), mesh,
                                              "data", 0), full),
           "reduce_scatter": (coll.reduce_scatter_chunk(full, mesh, "data",
                                                        0), 2 * half),
           "all_reduce": (coll.all_reduce(full, mesh, "model",
                                          dist.ReduceOp.SUM), 2 * full)}
    out = {f"staged.{k}": "ok" if torch.equal(g, w) else "wrong values"
           for k, (g, w) in got.items()}
    assert all(v == "ok" for v in out.values()), out
    return out


def shard_rank(rank, world, backend, directory):
    """One rank of the shard phase (spawned; rows to
    ``directory/rank<R>.json``)."""
    import datetime
    import faulthandler

    import torch.distributed as dist

    faulthandler.enable()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // world))
    dist.init_process_group(
        backend, init_method=f"file://{directory}/rdv", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        rows = shard_legs(rank, directory)
        with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
            json.dump(rows, f)
    finally:
        dist.destroy_process_group()


def shard_legs(rank, directory):
    """The shard phase's legs on this rank, in order (module docstring,
    phase 11); every rank runs every leg (each holds collectives)."""
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(*SHARD_MESH, device_type="cuda")
    rows = [{"probe": shard_staged(mesh)}]
    state = shard_train(rows, mesh, rank, directory)
    shard_elastic(rows, state, rank, directory)
    del state
    torch.cuda.empty_cache()
    shard_restart(rows, directory)
    shard_pipeline(rows, rank)
    shard_decode(rows, mesh)
    shard_ssm_prefill(rows, mesh, rank, directory)
    shard_moe_train(rows, mesh, directory)
    shard_moe_prefill(rows, mesh, rank, int(mesh.size()), directory)
    return rows


def shard_train(rows, mesh, rank, directory):
    """The 4-layer model's state placed at state_specs (bytes against the
    specs), then 1 + SHARD_TIMED steps on TRAIN's tokens (each rank its
    rows), the agreement read after TRAIN_AGREE_STEPS: this rank's
    parameter blocks against the one-device run's."""
    from repro_torch import obs
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as sh
    from repro_torch.obs import counters
    from repro_torch.train import optimizer
    from repro_torch.train import train_state as ts

    cfg = shard_cfg()
    opt_cfg = optimizer.AdamWConfig(eight_bit=cfg.opt_8bit, **TRAIN_OPT)
    state = ts.init_state(torch.Generator(device="cuda").manual_seed(SEED),
                          cfg, opt_cfg, "cuda")
    state = sh.place_state(state, mesh)
    torch.cuda.empty_cache()
    local, want = sh.local_bytes(state), sh.spec_bytes(state, mesh)
    rows.append({"leg": "state on the mesh", "local_bytes": local,
                 "spec_bytes": want, "bitwise_spec": local == want})
    assert local == want, (local, want)
    data = DataConfig(vocab=cfg.vocab, global_batch=TRAIN[0],
                      seq_len=TRAIN[1], seed=SEED)
    bsh = sh.NamedSharding(mesh, sh.batch_specs({"tokens": TRAIN},
                                                mesh)["tokens"])
    step_fn = ts.make_train_step(cfg, opt_cfg, sh.make_shard_fn(mesh))
    # mamba by head (its 50 heads divide model 2): each rank's heads'
    # in_proj columns from in_proj gathered over model where the rank's
    # tokens outweigh d_model (4096 over 1600), else from its output, in
    # the forward and remat's recompute, the gradient reduce-scattered
    # back; nothing else of mamba's moves
    nmodel = dict(zip(mesh.mesh_dim_names, map(int, mesh.shape)))["model"]
    width = 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state \
        + cfg.n_ssm_heads
    tokens = TRAIN[0] // SHARD_MESH[0] * TRAIN[1]
    want_mamba = {"mamba in_proj columns" if tokens > cfg.d_model else
                  "mamba in_proj output": 3 * cfg.n_layers * (nmodel - 1)
                  * min(tokens, cfg.d_model) * width // nmodel * 4}
    counts = zero_launches()
    torch.cuda.reset_peak_memory_stats()
    steps, p_err = [], None
    for i in range(1 + SHARD_TIMED):
        batch = make_batch(cfg, data, i, device="cuda", sharding=bsh)
        mesh_barrier()
        before = counters.snapshot()
        with coll.record_transport() as moved, obs.trace() as tr:
            (state, m), secs = sync_time(lambda: step_fn(state, batch))
        ctr = counters.delta(before)
        if i == 0:                      # the untimed step's records
            transport = shard_transport(moved, ctr, state, mesh, tr)
        by_op = {}
        for e in tr.spans("shard.redistribute"):
            by_op[e.attrs["op"]] = by_op.get(e.attrs["op"], 0) + \
                e.attrs["bytes"]
        steps.append({"step": i, "wall_s": secs, "redistributed": by_op,
                      **{k: m[k].item() for k in ("loss", "grad_norm", "lr")},
                      "collective_bytes": ctr.get("collective.bytes", 0),
                      "redistribute_bytes": ctr.get(
                          "shard.redistribute_bytes", 0),
                      "tp_all_reduce_bytes": ctr.get(
                          "shard.tp_all_reduce_bytes", 0)})
        if i == TRAIN_AGREE_STEPS - 1:
            one = torch.load(os.path.join(directory, "..", "one_device.pt"),
                             mmap=True)
            p_err = max(
                (sh.local(p).detach() - one[k][sh.local_index(
                    p.shape, p.placements, mesh)].cuda()).abs().max().item()
                for k, p in optimizer.named_parameters(
                    state["params"]).items())
            del one
    launches = {k: w.launches for k, w in counts.items()}
    rows.append({"leg": f"train step hymba-1.5b {SHARD_LAYERS} layers "
                        f"{TRAIN[0]}x{TRAIN[1]} on data x model "
                        f"{SHARD_MESH}, {TRAIN[1]} tokens x "
                        f"{TRAIN[0] // SHARD_MESH[0]} rows a rank",
                 "steps": steps, "params_max_abs_after_agree": p_err,
                 "step_s": statistics.median(r["wall_s"] for r in steps[1:]),
                 "peak_bytes": torch.cuda.max_memory_allocated(),
                 "launches": launches, "want_mamba": want_mamba})
    assert not any(launches.values()), launches
    for st in steps:
        mamba = {k: v for k, v in st["redistributed"].items()
                 if k.startswith("mamba")}
        assert mamba == want_mamba, (st["step"], mamba, want_mamba)
    rows.append(transport)
    assert transport["ok"], transport
    return state


def shard_transport(moved, ctr, state, mesh, tr):
    """A sharded step's ``record_transport()`` records and obs trace
    ``tr`` (its backward and remat's recompute on autograd's device
    thread) against its counters: the "model" all-reduces are TP's,
    equal to ``shard.tp_all_reduce_bytes``, and the grad norm's one f32
    scalar; the gathers over "data" each block's leaves twice (forward
    and remat's recompute) and the root's once; one reduce-scatter a
    leaf; the ``shard.redistribute`` events' bytes (the backward's gather
    of ``attention wo input`` and reduce-scatter of ``mamba in_proj
    columns`` among them) equal to ``shard.redistribute_bytes``."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.train import optimizer

    model = state["params"]
    params = optimizer.named_parameters(model).values()
    names = mesh.mesh_dim_names

    def over_data(p):
        return any(isinstance(pl, sh.Shard) and n == "data"
                   for pl, n in zip(p.placements, names))

    inner = {id(p) for b in model.blocks for p in b.parameters()}
    blocks = sum(1 for p in params if over_data(p) and id(p) in inner)
    root = sum(1 for p in params if over_data(p) and id(p) not in inner)
    nmodel = dict(zip(names, map(int, mesh.shape)))["model"]
    reduces = [t.bytes for t in moved if t.kind == "all_reduce"
               and t.axis == "model"]
    norm = 2 * (nmodel - 1) * 4 // nmodel          # the grad norm's scalar
    recorded = sum(2 * (nmodel - 1) * b // nmodel for b in reduces)
    gathers = sum(1 for t in moved if t.kind == "all_gather"
                  and t.axis == "data")
    scatters = sum(1 for t in moved if t.kind == "reduce_scatter"
                   and t.axis == "data")
    events = sum(e.attrs["bytes"] for e in tr.spans("shard.redistribute"))
    row = {"leg": "transport records and obs events of the first sharded "
                  "step (its backward on autograd's device thread)",
           "model_all_reduces": len(reduces),
           "recorded_tp_bytes": recorded - norm,
           "tp_all_reduce_bytes": ctr.get("shard.tp_all_reduce_bytes", 0),
           "data_all_gathers": gathers, "data_reduce_scatters": scatters,
           "want_gathers": 2 * blocks + root,
           "want_reduce_scatters": blocks + root,
           "redistribute_event_bytes": events,
           "redistribute_bytes": ctr.get("shard.redistribute_bytes", 0),
           "redistribute_events": len(tr.spans("shard.redistribute"))}
    row["ok"] = (recorded - norm == row["tp_all_reduce_bytes"] > 0
                 and gathers == 2 * blocks + root
                 and scatters == blocks + root
                 and events == row["redistribute_bytes"] > 0)
    return row


def shard_moe_train(rows, mesh, directory):
    """Leg (a): the reduced moe at each of SHARD_MOE_FACTORS placed at
    state_specs, TRAIN_AGREE_STEPS steps of SHARD_MOE_TRAIN tokens (each
    DP rank its rows, its experts' window of the capacity slots), each
    step's slot exchange to the byte, this rank's parameter blocks
    against the one-device run's after the last."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.distributed import sharding as sh
    from repro_torch.obs import counters
    from repro_torch.train import optimizer
    from repro_torch.train import train_state as ts

    shape = dict(zip(mesh.mesh_dim_names, map(int, mesh.shape)))
    for factor in SHARD_MOE_FACTORS:
        cfg = shard_moe_cfg(factor)
        opt_cfg = optimizer.AdamWConfig(**TRAIN_OPT)
        state = sh.place_state(ts.init_state(torch.Generator(
            device="cuda").manual_seed(SEED), cfg, opt_cfg, "cuda"), mesh)
        data = DataConfig(vocab=cfg.vocab, global_batch=SHARD_MOE_TRAIN[0],
                          seq_len=SHARD_MOE_TRAIN[1], seed=SEED)
        bsh = sh.NamedSharding(mesh, sh.batch_specs(
            {"tokens": SHARD_MOE_TRAIN}, mesh)["tokens"])
        step_fn = ts.make_train_step(cfg, opt_cfg, sh.make_shard_fn(mesh))
        want_x = 6 * cfg.n_layers * moe_exchange_bytes(
            cfg, SHARD_MOE_TRAIN[0] * SHARD_MOE_TRAIN[1], shape["data"],
            shape["model"])
        counts = zero_launches()
        steps = []
        for i in range(TRAIN_AGREE_STEPS):
            batch = make_batch(cfg, data, i, device="cuda", sharding=bsh)
            mesh_barrier()
            before = counters.snapshot()
            (state, m), secs = sync_time(lambda: step_fn(state, batch))
            ctr = counters.delta(before)
            steps.append({"step": i, "wall_s": secs,
                          **{k: m[k].item() for k in
                             ("loss", "grad_norm", "lr")},
                          **{k: ctr.get(k, 0) for k in (
                              "collective.bytes", "shard.redistribute_bytes",
                              "shard.tp_all_reduce_bytes",
                              "shard.expert_exchange_bytes")}})
        one = torch.load(os.path.join(directory, "..", f"moe_{factor}.pt"),
                         mmap=True)
        p_err = max(
            (sh.local(p).detach() - one[k][sh.local_index(
                p.shape, p.placements, mesh)].cuda()).abs().max().item()
            for k, p in optimizer.named_parameters(state["params"]).items())
        launches = {k: w.launches for k, w in counts.items() if w.launches}
        row = {"leg": f"moe train (a): qwen3-moe reduced 3x256, 8 experts "
                      f"top 2, capacity factor {factor}, "
                      f"{SHARD_MOE_TRAIN[0]}x{SHARD_MOE_TRAIN[1]} on data x "
                      f"model {SHARD_MESH}", "factor": factor,
               "steps": steps, "params_max_abs_after_agree": p_err,
               "wall_s": sum(r["wall_s"] for r in steps),
               "expert_exchange_bytes_want": want_x, "launches": launches,
               "why_reduced": SHARD_MOE_WHY}
        rows.append(row)
        assert all(r["shard.expert_exchange_bytes"] == want_x
                   for r in steps), row
        assert not launches, launches
        del state, one
        torch.cuda.empty_cache()


def shard_moe_prefill(rows, mesh, rank, world, directory):
    """Leg (b): qwen3-moe-235b-a22b at full width cut to SHARD_MOE_LAYERS
    layers (f32), built from SEED on the card by one rank at a time (each
    keeps its blocks at params_specs), then ``sharding.prefill`` of
    SHARD_MOE_PREFILL tokens (each DP rank one row): this rank's logits
    (its row, its block of the vocabulary) against the one-device
    prefill's; the expert products' flops a rank beside one device's."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import vocab_split
    from repro_torch.obs import counters

    cfg = shard_moe_full_cfg()
    t0 = time.perf_counter()
    for r in range(world):                # one full build on the card at once
        if r == rank:
            model = sh.shard_model(model_zoo.init(
                cfg, torch.Generator(device="cuda").manual_seed(SEED),
                "cuda"), mesh)
            torch.cuda.empty_cache()
        mesh_barrier()
    build_s = time.perf_counter() - t0
    tokens = moe_prefill_tokens(cfg)
    placed = sh.distribute(tokens, sh.NamedSharding(mesh, sh.batch_specs(
        {"tokens": tokens}, mesh)["tokens"]))
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        mesh_barrier()
        counts = zero_launches()
        before = counters.snapshot()
        ((logits, aux, _), flops), secs = sync_time(lambda: expert_flops(
            lambda: sh.prefill(model, {"tokens": placed}, cfg),
            (cfg.d_model, cfg.d_expert)))
        ctr = counters.delta(before)
    launches = {k: w.launches for k, w in counts.items() if w.launches}
    split = vocab_split(logits)
    v0, v1 = split.span(cfg.vocab) if split is not None else (0, cfg.vocab)
    rows_ = sh.dp_rows(SHARD_MOE_PREFILL[0], mesh)
    got = logits.float().cpu()
    del logits
    want = torch.load(os.path.join(directory, "..", "moe_prefill_logits.pt"),
                      mmap=True)[rows_, :, v0:v1]
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    ok = err <= SHARD_MOE_TOL[0] * scale and bool(torch.isfinite(got).all())
    row = {"leg": f"moe prefill (b): qwen3-moe-235b-a22b full width, "
                  f"{SHARD_MOE_LAYERS} of 94 layers (f32), "
                  f"{SHARD_MOE_PREFILL[0]}x{SHARD_MOE_PREFILL[1]} tokens on "
                  f"data x model {SHARD_MESH}, sharding.prefill",
           "build_s": build_s, "wall_s": secs,
           "local_param_bytes": sh.local_bytes(model),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "logits_local": list(got.shape), "vocab_block": [v0, v1],
           "max_abs_err": err, "max_abs_logit": scale,
           "tol": SHARD_MOE_TOL[0], "reason": SHARD_MOE_TOL[1],
           "expert_flops": flops, "launches": launches,
           **{k: ctr.get(k, 0) for k in (
               "collective.bytes", "shard.redistribute_bytes",
               "shard.tp_all_reduce_bytes", "shard.expert_exchange_bytes")},
           "ok": ok}
    rows.append(row)
    assert ok, row
    assert launches == {"attention": cfg.n_layers}, launches
    del model, got, want
    torch.cuda.empty_cache()


def shard_elastic(rows, state, rank, directory):
    """The (2, 2) state's checkpoint (saved by all ranks, written by rank
    0) restored onto data = 4 x model = 1 (each rank reading its blocks)
    and onto one device (rank 0): every leaf bitwise the saved one, at
    the new mesh's specs."""
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.distributed import elastic
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model_zoo
    from repro_torch.train import optimizer
    from repro_torch.train import train_state as ts

    cfg = shard_cfg()
    opt_cfg = optimizer.AdamWConfig(eight_bit=cfg.opt_8bit, **TRAIN_OPT)
    path = os.path.join(directory, "ckpt")
    mesh_barrier()
    _, save_s = sync_time(lambda: ck.save(path, 1 + SHARD_TIMED, state))
    saved = {}
    for k, v in ck._flatten(state).items():
        full = sh.full_tensor(v)
        if rank == 0:
            saved[k] = full
    mesh41 = make_debug_mesh(4, 1, device_type="cuda")
    like = ts.state_for(model_zoo.build(cfg, "meta"), opt_cfg)
    mesh_barrier()
    (new, step), restore_s = sync_time(lambda: elastic.elastic_restore(
        path, like, mesh41))
    want = ck._flatten(sh.to_shardings(sh.state_specs(
        sh.state_shapes(new), mesh41), mesh41))
    got = ck._flatten(new)
    placed = sorted(want) == sorted(got) and all(
        tuple(got[k].placements) == want[k].placements for k in want)
    bitwise41 = True
    for k, v in got.items():
        full = sh.full_tensor(v)
        if rank == 0:
            bitwise41 = bitwise41 and torch.equal(full, saved[k])
    del new, got
    row = {"leg": "elastic: the (2, 2) checkpoint onto data 4 x model 1 "
                  "and onto one device", "step": step, "save_s": save_s,
           "restore_4x1_s": restore_s, "placements_4x1": placed}
    if rank == 0:
        back, _ = elastic.elastic_restore(path, ts.state_for(
            model_zoo.build(cfg, "cuda"), opt_cfg), None)
        bitwise1 = all(torch.equal(v, saved[k]) for k, v in
                       ck._flatten(back).items())
        del back
        row.update(bitwise_4x1=bitwise41, bitwise_one_device=bitwise1,
                   leaves=len(saved))
        assert bitwise41 and bitwise1
    assert placed and step == 1 + SHARD_TIMED
    rows.append(row)
    del saved
    torch.cuda.empty_cache()


def shard_restart(rows, directory):
    """train_loop on the debug mesh over the world's ranks, the reduced
    hybrid of the train phase's restart: 12 steps uninterrupted, then
    with checkpoints every 3 and a failure at step 7 under
    run_with_restarts (resumed from step 6, on the mesh)."""
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import make_mesh, train_loop
    from repro_torch.runtime.fault_tolerance import run_with_restarts
    from repro_torch.train import optimizer

    cfg = train_small_cfg("hymba-1.5b")
    opt = optimizer.AdamWConfig(**TRAIN_SMALL_OPT)
    data = DataConfig(vocab=cfg.vocab, global_batch=2,
                      seq_len=TRAIN_SMALL_SEQ, seed=SEED)
    dmesh = make_mesh("debug", "cuda")
    mesh_barrier()
    (_, ref_hist), ref_s = sync_time(lambda: train_loop(
        cfg, opt, data, dmesh, steps=12,
        ckpt_dir=os.path.join(directory, "loop_a"), save_interval=1000,
        log_every=100))
    ckpt = os.path.join(directory, "loop_b")
    calls, done = [], {}

    def loop(resume):
        calls.append(resume)
        done["run"] = train_loop(
            cfg, opt, data, dmesh, steps=12, ckpt_dir=ckpt, save_interval=3,
            log_every=100, fail_at_step=7 if len(calls) == 1 else -1)
        return 12

    report, secs = sync_time(lambda: run_with_restarts(loop,
                                                       max_restarts=2))
    hist = done["run"][1]
    rel_err = [abs(a - b) / abs(b) for a, b in zip(hist, ref_hist[7:])]
    saved = ck.all_steps(ckpt)
    ok = (report.completed and report.restarts == 1 and len(hist) == 5
          and saved == [6, 9, 11] and max(rel_err) <= TRAIN_TOL["resume"][0])
    shape = dict(zip(dmesh.mesh_dim_names, map(int, dmesh.shape)))
    rows.append({"leg": f"train_loop(mesh=debug {shape}) restart: hybrid "
                        f"3x256, 12 steps, checkpoints every 3, failure at "
                        f"step 7",
                 "restarts": report.restarts, "resumed_losses": hist,
                 "uninterrupted_losses": ref_hist[7:], "rel_err": rel_err,
                 "checkpoints": saved, "uninterrupted_s": ref_s,
                 "restarted_s": secs, "tol": TRAIN_TOL["resume"][0],
                 "ok": ok})
    assert ok, rows[-1]


def shard_pipeline(rows, rank):
    """Four stages, each one of hymba-1.5b's first four blocks at full
    width (bf16, as served, the kernels on), over SHARD_MICRO microbatches
    of 1 x TRAIN[1]: B5 and B6 launch SHARD_MICRO times a rank; rank 0
    holds the output bitwise to the four blocks run in order."""
    import torch.func

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.distributed.pipeline_parallel import (
        pipeline_forward, stack_stage_params)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import reduce_config
    from repro_torch.models import model_zoo

    cfg = reduce_config(registry.get_config("hymba-1.5b"),
                        layers=SHARD_LAYERS)
    pmesh = make_mesh((SHARD_LAYERS,), ("stage",), device_type="cuda")
    sid = pmesh.get_local_rank("stage")
    model = model_zoo.init(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), "cuda")
    tokens = make_batch(cfg, DataConfig(vocab=cfg.vocab,
                                        global_batch=SHARD_MICRO,
                                        seq_len=TRAIN[1], seed=SEED), 0,
                        device="cuda")["tokens"]
    with torch.no_grad():
        x = model._embed(tokens)[:, None]            # (M, 1, S, d)
        positions = model._positions(x[0])
        blk = model.blocks[sid]
        stacked = stack_stage_params([
            {n: p.detach() for n, p in b.named_parameters()}
            for b in model.blocks])
        run = pipeline_forward(lambda p, h: torch.func.functional_call(
            blk, p, (h, positions), {"use_kernels": True})[0], pmesh)
        counts = zero_launches()
        mesh_barrier()
        y, secs = sync_time(lambda: run(stacked, x))
        launches = {k: w.launches for k, w in counts.items() if w.launches}
        row = {"leg": f"pipeline: {SHARD_LAYERS} stages, hymba-1.5b blocks "
                      f"0-{SHARD_LAYERS - 1} at full width (bf16, kernels), "
                      f"{SHARD_MICRO} microbatches of 1 x {TRAIN[1]}",
               "stage": sid, "wall_s": secs, "launches": launches}
        assert launches == {"attention": SHARD_MICRO,
                            "ssd_scan": SHARD_MICRO}, launches
        if rank == 0:
            want = torch.empty_like(x)
            for mb in range(SHARD_MICRO):
                h = x[mb]
                for b in model.blocks:
                    h = b(h, positions, use_kernels=True)[0]
                want[mb] = h
            row["bitwise_in_order"] = bool(torch.equal(y, want))
            assert row["bitwise_in_order"], "the pipeline is not the blocks"
    rows.append(row)
    del model, stacked, x, y
    torch.cuda.empty_cache()


def decode_op_bytes(cfg, rows, nmodel):
    """The bytes each decode op brings a rank over "model" a step, f32
    compute (hymba's 25 heads do not divide model, so q is wq's output
    columns gathered): q's columns, the token's k and v columns, and the
    combine's three all-reduces (m, l: rows x Hq; o: rows x Hq x hd), each
    layer."""
    n = nmodel - 1
    hq, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    combine = sum(2 * n * e * 4 // nmodel
                  for e in (rows * hq, rows * hq, rows * hq * hd))
    return {"decode q": cfg.n_layers * n * rows * hq * hd // nmodel * 4,
            "decode kv token": cfg.n_layers * 2 * n * rows * hkv * hd
            // nmodel * 4,
            "decode combine": cfg.n_layers * combine}


def shard_decode(rows, mesh):
    """The 4-layer model (f32) decoding SHARD_DECODE's tokens with its
    parameters at params_specs and f32 caches at cache_specs, against the
    same model's one-device decode: flash-decoding on each rank's block
    of the k / v caches' sequence, mamba on the rank's 25 of the 50 SSM
    heads against its block of the state. Each rank's cache leaves their
    spec's blocks, each step's counters and decode ops (obs events) to
    the byte, no cache leaf gathered (``decode caches`` and ``decode ssm
    state`` at 0 bytes): mamba's one redistribution is its ``in_proj``
    output, one token's (the whole conv tail's columns), exactly."""
    from torch.utils import _pytree as pytree

    from repro_torch import obs
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import model_zoo
    from repro_torch.obs import counters

    cfg = shard_cfg()
    b, n, max_len = SHARD_DECODE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    model = model_zoo.init(cfg, gen, "cuda")
    toks = torch.randint(0, cfg.vocab, (b, n), generator=gen, device="cuda")
    caches = model_zoo.init_caches(model, cfg, b, max_len,
                                   dtype=torch.float32)
    scaches = sh.place_caches(model_zoo.init_caches(
        model, cfg, b, max_len, dtype=torch.float32), mesh)
    leaves = pytree.tree_leaves(scaches)
    specs = pytree.tree_leaves(sh.cache_specs(caches, mesh),
                               is_leaf=lambda x: isinstance(x, sh.P))
    local = sum(sh.local_bytes(t) for t in leaves)
    spec = sum(t.numel() * t.element_size() // math.prod(
        sh._axsize(mesh, e) for e in sp) for t, sp in zip(leaves, specs))
    blocks = all(list(sh.local(t).shape) == [
        ix.stop - ix.start for ix in sh.local_index(t.shape, t.placements,
                                                    mesh)] for t in leaves)
    states = [list(sh.local(c["ssm"]["state"]).shape) for c in scaches]
    whole = sum(t.numel() * t.element_size() for t in leaves)
    want = [model_zoo.decode_step(model, toks[:, i:i + 1], cfg, caches, i)[0]
            for i in range(n)]
    sh.shard_model(model, mesh)
    nmodel = dict(zip(mesh.mesh_dim_names, map(int, mesh.shape)))["model"]
    want_ops = decode_op_bytes(cfg, b // SHARD_MESH[0], nmodel)
    # mamba's in_proj output, one token of the rank's rows, gathered
    width = 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state \
        + cfg.n_ssm_heads
    want_moved = {"mamba in_proj output": cfg.n_layers * (nmodel - 1) * (
        b // SHARD_MESH[0]) * width // nmodel * 4}
    got, secs, steps = [], [], []
    for i in range(n):
        mesh_barrier()
        before = counters.snapshot()
        with obs.trace() as tr:
            (logits, _), s = sync_time(lambda: sh.decode_step(
                model, toks[:, i:i + 1], cfg, scaches, i))
        ctr = counters.delta(before)
        ops, moved = {}, {}
        for name, into in (("shard.decode", ops),
                           ("shard.redistribute", moved)):
            for e in tr.spans(name):
                op = e.attrs["op"]
                into[op] = into.get(op, 0) + e.attrs["bytes"]
        steps.append({"step": i, "wall_s": s, "ops": ops,
                      "redistributed": moved,
                      "collective_bytes": ctr.get("collective.bytes", 0),
                      "redistribute_bytes": ctr.get(
                          "shard.redistribute_bytes", 0),
                      "decode_bytes": ctr.get("shard.decode_bytes", 0)})
        got.append(logits)
        secs.append(s)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    ok_ops = all(st["ops"] == want_ops
                 and st["decode_bytes"] == sum(want_ops.values())
                 and {k: v for k, v in st["redistributed"].items()
                      if k.startswith("mamba")} == want_moved
                 and st["redistributed"].get("decode caches", 0)
                 == st["redistributed"].get("decode ssm state", 0) == 0
                 for st in steps)
    ok_states = states == [[b // SHARD_MESH[0], cfg.n_ssm_heads // nmodel,
                            cfg.ssm_head_dim, cfg.ssm_state]] * cfg.n_layers
    ok = err <= SHARD_DECODE_TOL[0] and all(
        bool(torch.isfinite(g).all()) for g in got) and local == spec \
        and blocks and ok_states and ok_ops
    rows.append({"leg": f"sharded decode hymba-1.5b {SHARD_LAYERS} layers "
                        f"(f32) batch {b}, {n} tokens, f32 caches of "
                        f"{max_len} at cache_specs: flash-decoding on each "
                        f"rank's sequence block", "max_abs_err": err,
                 "tol": SHARD_DECODE_TOL[0], "reason": SHARD_DECODE_TOL[1],
                 "cache_local_bytes": local, "cache_spec_bytes": spec,
                 "cache_whole_bytes": whole, "cache_blocks": blocks,
                 "ssm_state_local": states, "want_ops": want_ops,
                 "want_redistributed": want_moved,
                 "decode_steps": steps,
                 "step_s": statistics.median(secs[1:]), "ok": ok})
    assert ok, rows[-1]


def ssm_prefill_tokens(cfg):
    """The SSM prefill leg's TRAIN tokens, the same on every process."""
    return torch.randint(0, cfg.vocab, TRAIN, generator=torch.Generator(
        device="cuda").manual_seed(SEED + 3), device="cuda")


def shard_ssm_one_device(path):
    """The SSM prefill leg's one-device run, in this process: the
    4-layer model (f32) from SEED prefilling ``ssm_prefill_tokens`` with
    the kernels on; its logits saved to ``path``, its seconds and
    launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model_zoo

    cfg = shard_cfg()
    model = model_zoo.init(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), "cuda")
    tokens = ssm_prefill_tokens(cfg)
    with torch.no_grad():
        model_zoo.prefill(model, {"tokens": tokens}, cfg)     # warm-up
        counts = zero_launches()
        (logits, _, _), secs = sync_time(lambda: model_zoo.prefill(
            model, {"tokens": tokens}, cfg))
    launches = {k: w.launches for k, w in counts.items() if w.launches}
    variants = {k: v for k, v in fa.attention.variant_launches.items() if v}
    assert launches == {"attention": cfg.n_layers,
                        "ssd_scan": cfg.n_layers}, launches
    assert bool(torch.isfinite(logits).all())
    torch.save(logits.cpu(), path)
    del model, logits
    torch.cuda.empty_cache()
    return {"wall_s": secs, "launches": launches,
            "attention_variants": variants}


def shard_ssm_prefill(rows, mesh, rank, directory):
    """The SSM by head: the 4-layer model (f32, the kernels on) built
    from SEED on every rank at params_specs, ``sharding.prefill`` of
    TRAIN's tokens (each DP rank one row). Its 50 SSM heads divide model
    2, so each SSM layer launches B6 on the rank's 25 heads; attention's
    25 do not, so its core runs whole on B5 (``ffma``, f32). This rank's
    logits against the one-device prefill's (SHARD_MOE_TOL); the first
    SSM layer's B6 output on the rank's heads bitwise heads [lo, hi) of
    one 50-head launch on its inputs gathered over "model"; then, on rank
    0, B6's and B5's times at the leg's shapes beside their plain
    versions and bounds (the other ranks wait)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import vocab_split

    t0 = time.perf_counter()
    cfg = shard_cfg()
    model = sh.shard_model(model_zoo.init(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda"), mesh)
    tokens = ssm_prefill_tokens(cfg)
    placed = sh.distribute(tokens, sh.NamedSharding(mesh, sh.batch_specs(
        {"tokens": tokens}, mesh)["tokens"]))
    seen = {}

    def first(name, fn):                   # the first call's operands
        def run(*args, **kw):
            out = fn(*args, **kw)
            seen.setdefault(name, (args, kw, out))
            return out
        return run

    path_ops = ops.ssd, ops.attention
    ops.ssd, ops.attention = first("ssd", ops.ssd), first("attention",
                                                          ops.attention)
    try:
        with torch.no_grad():
            mesh_barrier()
            counts = zero_launches()
            (logits, _, _), secs = sync_time(lambda: sh.prefill(
                model, {"tokens": placed}, cfg))
        launches = {k: w.launches for k, w in counts.items() if w.launches}
        variants = {k: v for k, v in fa.attention.variant_launches.items()
                    if v}
    finally:
        ops.ssd, ops.attention = path_ops
    split = vocab_split(logits)
    v0, v1 = split.span(cfg.vocab) if split is not None else (0, cfg.vocab)
    got = logits.float().cpu()
    want = torch.load(os.path.join(directory, "..", "ssm_prefill_logits.pt"),
                      mmap=True)[sh.dp_rows(TRAIN[0], mesh), :, v0:v1]
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    # B6 on the rank's heads against one launch on every head
    (x, a, b, c), kw, y = seen["ssd"]
    heads = [coll.all_gather_cat(t.contiguous(), mesh, "model", 2)
             for t in (x, a, b, c)]
    size, index = sh._model_axis(mesh)
    lo, hi = index * cfg.n_ssm_heads // size, \
        (index + 1) * cfg.n_ssm_heads // size
    with torch.no_grad():
        whole = ops.ssd(*heads, chunk=kw["chunk"], use_kernels=True)
    bitwise = torch.equal(whole[:, :, lo:hi], y)
    head_err = (whole[:, :, lo:hi] - y).abs().max().item()
    ok = err <= SHARD_MOE_TOL[0] * scale and bitwise \
        and bool(torch.isfinite(got).all()) and got.shape == want.shape
    row = {"leg": f"ssm prefill: hymba-1.5b {SHARD_LAYERS} layers (f32, the "
                  f"kernels on), {TRAIN[0]}x{TRAIN[1]} tokens on data x "
                  f"model {SHARD_MESH}, sharding.prefill: B6 on the rank's "
                  f"SSM heads, B5's core whole",
           "wall_s": secs, "launches": launches,
           "attention_variants": variants,
           "b6_x_local": list(x.shape), "b6_heads": [lo, hi],
           "logits_local": list(got.shape), "vocab_block": [v0, v1],
           "max_abs_err": err, "max_abs_logit": scale,
           "tol": SHARD_MOE_TOL[0],
           "b6_bitwise_whole_launch": bitwise, "b6_max_abs_diff": head_err}
    del whole, heads, got, want, logits
    mesh_barrier()
    if rank == 0:
        row["times"] = shard_ssm_times(seen)
    mesh_barrier()
    row["leg_s"] = time.perf_counter() - t0
    row["ok"] = ok
    rows.append(row)
    assert ok, row
    assert launches == {"attention": cfg.n_layers, "ssd_scan": cfg.n_layers} \
        and variants == {"ffma": cfg.n_layers}, (launches, variants)
    assert list(x.shape) == [TRAIN[0] // SHARD_MESH[0], TRAIN[1],
                             cfg.n_ssm_heads // size, cfg.ssm_head_dim], \
        x.shape
    del model, seen
    torch.cuda.empty_cache()


def shard_ssm_times(seen):
    """B6 and B5 at the SSM prefill leg's shapes (its first launches'
    operands): ms beside the plain version, the bound and, for B5, SDPA;
    each held to its plain version (``CLOSE_TOL``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as sk

    def held(got, want):
        rtol, atol, norm_tol, _ = CLOSE_TOL[want.dtype]
        g, w = got.double(), want.double()
        diff = (g - w).abs()
        rms = w.square().mean().sqrt().item()
        ok = bool((diff <= rtol * w.abs() + atol * rms).all()) and \
            diff.norm().item() <= norm_tol * w.norm().item()
        return diff.max().item(), ok

    (x, a, b, c), kw, _ = seen["ssd"]
    args = tuple(t.movedim(2, 1) for t in (x, a, b, c))    # kernel layout
    chunk = kw["chunk"]
    bsz, h, L, p = args[0].shape
    flops, nbytes = ssd_work(bsz, h, L, p, args[2].shape[-1], chunk, 4)
    b_ms, b_by = bound(flops, nbytes, torch.float32)
    err, ok6 = held(sk.ssd_scan(*args, chunk=chunk),
                    sk.ssd_scan_plain(*args, chunk=chunk))
    b6 = {"name": "ssd_scan", "shape": f"x{tuple(args[0].shape)} n="
          f"{args[2].shape[-1]} chunk={chunk} float32 (the rank's heads)",
          "ms": graph_ms(lambda: sk.ssd_scan(*args, chunk=chunk)),
          "plain_ms": cuda_ms(lambda: sk.ssd_scan_plain(*args, chunk=chunk)),
          "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
          "max_abs_err": err, "ok": ok6,
          "timing": "ms: 20 calls in one CUDA graph, replayed"}
    (q, k, v), kw, _ = seen["attention"]
    causal, window = kw.get("causal", True), kw.get("window")
    flops, nbytes = attention_work(q.shape[0], q.shape[1], k.shape[1],
                                   q.shape[2], k.shape[2], q.shape[3], 4,
                                   causal=causal, window=window)
    b_ms, b_by = bound(flops, nbytes, torch.float32)
    err, ok5 = held(fa.attention(q, k, v, causal=causal, window=window),
                    fa.attention_plain(q, k, v, causal=causal, window=window))
    b5 = {"name": "attention", "shape": f"q{tuple(q.shape)} "
          f"k/v{tuple(k.shape)} float32 causal={causal} window={window}",
          "variant": fa.attention.last_launch["variant"],
          "ms": cuda_ms(lambda: fa.attention(q, k, v, causal=causal,
                                             window=window)),
          "plain_ms": cuda_ms(lambda: fa.attention_plain(
              q, k, v, causal=causal, window=window)),
          "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
              q, k, v, is_causal=causal, enable_gqa=True))
          if window is None else None,
          "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
          "ok": ok5}
    assert ok6 and ok5, (b6, b5)
    return [b6, b5]


def phase_shard(smi):
    """The trainer on a mesh (phase 11): hymba-1.5b cut to SHARD_LAYERS
    layers at full width, first TRAIN_AGREE_STEPS steps on one device in
    this process, then four spawned gloo ranks sharing the card on a
    (data, model) = SHARD_MESH mesh: the probe, the sharded steps held to
    one device, their transport records, elastic restores, a train_loop
    restart, the pipeline, a sharded decode, the SSM prefill by head and
    the moe's two legs (their one-device runs first, here). Every row
    names the card and its power limit."""
    import shutil
    import tempfile

    from repro_torch.train import optimizer

    t0 = time.perf_counter()
    cfg = shard_cfg()
    opt_cfg = optimizer.AdamWConfig(eight_bit=cfg.opt_8bit, **TRAIN_OPT)
    top = tempfile.mkdtemp(prefix="shard-")
    try:
        one = shard_one_device(cfg, opt_cfg, os.path.join(top,
                                                          "one_device.pt"))
        emit(phase="shard", card=smi, reduced=SHARD_REDUCED,
             config={"arch": "hymba-1.5b", "n_layers": cfg.n_layers,
                     "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                     "n_kv": cfg.n_kv, "vocab": cfg.vocab,
                     "dtype": cfg.dtype, "params": one["params"]},
             one_device_steps=one["metrics"],
             one_device_state_bytes=one["state_bytes"],
             one_device_last_update_max_abs=one["last_update_max_abs"],
             params_tol=SHARD_PARAM_TOL[0])
        assert SHARD_PARAM_TOL[0] <= \
            one["last_update_max_abs"]["median_over_leaves"] / 5, one
        ssm_one = shard_ssm_one_device(os.path.join(
            top, "ssm_prefill_logits.pt"))
        emit(phase="shard", card=smi, ssm_prefill_one_device=ssm_one)
        moe_one = shard_moe_one_device(top)
        emit(phase="shard", card=smi, moe_one_device=moe_one,
             moe_reduced={"train (a)": "qwen3-moe-235b-a22b: n_layers 94 -> "
                                       "3, d_model 4096 -> 256, experts "
                                       "128 -> 8, top_k 8 -> 2, vocab "
                                       "151936 -> 512, accum_steps 4 -> 1 "
                                       "(" + SHARD_MOE_WHY +
                                       ")",
                          "prefill (b)": f"qwen3-moe-235b-a22b: n_layers "
                                         f"94 -> {SHARD_MOE_LAYERS}, compute "
                                         f"dtype float32"})
        assert moe_one["train"][0.5]["dropped_step0"] > 0, moe_one
        for factor, run in moe_one["train"].items():
            assert SHARD_PARAM_TOL[0] <= run["last_update_median"] / 5, \
                (factor, run)
        world = SHARD_MESH[0] * SHARD_MESH[1]
        emit(phase="shard", card=smi, probe=shard_probe(world, top),
             route="tp x zero3: the products tensor-parallel over model "
                   "(Megatron column-parallel wq wk wv w_in w_gate in_proj, "
                   "row-parallel wo w_out out_proj with an all-reduce over "
                   "model forward and one for each column-parallel input's "
                   "gradient; hymba's 25 attention heads do not divide "
                   "model, so q, k and v are gathered over model, counted; "
                   "its 50 SSM heads do, so mamba runs by head: the conv, "
                   "the scan and the gated norm on the rank's heads, their "
                   "in_proj columns gathered, counted), each block's "
                   "leaves all-gathered over data "
                   "only before it runs (again in remat's recompute), "
                   "gradients reduce-scattered over data, on collectives.py's "
                   "transport (gloo, staged through pinned host memory); the "
                   "moe's experts split over model in E, each data rank "
                   "multiplying its window of their capacity slots (a "
                   "reduce-scatter over data, the outputs gathered back), "
                   "the router gathered whole")
        ranks = run_ranks(world, "gloo", os.path.join(top, "gloo4"),
                          target=shard_rank, timeout_s=SHARD_TIMEOUT_S)
    finally:
        shutil.rmtree(top, ignore_errors=True)
    for rank, rank_rows in enumerate(ranks):
        for row in rank_rows:
            emit(phase="shard", rank=rank, card=smi,
                 **({"note": SHARD_NOTE} if "wall_s" in row or "steps" in
                    row or "step_s" in row else {}), **row)
    # the agreement, held here: every rank's metrics and parameter blocks
    agree = []
    for rank, rank_rows in enumerate(ranks):
        train = next(r for r in rank_rows if "steps" in r)
        for i, want in enumerate(one["metrics"]):
            got = train["steps"][i]
            agree.append({k: abs(got[k] - want[k]) / abs(want[k])
                          for k in ("loss", "grad_norm", "lr")})
        agree[-1]["params_max_abs"] = train["params_max_abs_after_agree"]
    ok = all(a["loss"] <= TRAIN_TOL["loss"][0]
             and a["grad_norm"] <= TRAIN_TOL["grad_norm"][0]
             and a["lr"] <= TRAIN_TOL["lr"][0] for a in agree) and all(
        a.get("params_max_abs", 0) <= SHARD_PARAM_TOL[0] for a in agree)
    emit(phase="shard", check=f"{SHARD_MESH} mesh against one device: "
                              f"{TRAIN_AGREE_STEPS} steps, every rank",
         per_rank_step_rel=agree, card=smi,
         tol={**{k: TRAIN_TOL[k][0] for k in ("loss", "grad_norm", "lr")},
              "params": SHARD_PARAM_TOL[0]},
         params_reason=SHARD_PARAM_TOL[1], ok=ok)
    assert ok, agree
    # the moe legs: (a) every rank's steps and parameter blocks against one
    # device at each capacity factor, (b) the expert flops a rank against
    # one device's (each rank's logits are held in the rank)
    for factor, want in moe_one["train"].items():
        agree = []
        for rank_rows in ranks:
            train = next(r for r in rank_rows if r.get("factor") == factor)
            agree.append({"params_max_abs": train[
                "params_max_abs_after_agree"], **{
                k: max(abs(got[k] - w[k]) / abs(w[k]) for got, w in zip(
                    train["steps"], want["metrics"]))
                for k in ("loss", "grad_norm", "lr")}})
        ok = all(a[k] <= TRAIN_TOL[k][0] for a in agree
                 for k in ("loss", "grad_norm", "lr")) and all(
            a["params_max_abs"] <= SHARD_PARAM_TOL[0] for a in agree)
        emit(phase="shard", check=f"moe (a) capacity factor {factor} on "
                                  f"{SHARD_MESH} against one device: "
                                  f"{TRAIN_AGREE_STEPS} steps, every rank",
             per_rank=agree, dropped_step0=want["dropped_step0"], card=smi,
             ok=ok)
        assert ok, agree
    prefill = [next(r for r in rank_rows if "expert_flops" in r)
               for rank_rows in ranks]
    ratio = [r["expert_flops"] / moe_one["prefill"]["expert_flops"]
             for r in prefill]
    emit(phase="shard", check=f"moe (b) expert flops a rank over one "
                              f"device's on {SHARD_MESH}", per_rank=ratio,
         max_abs_err=[r["max_abs_err"] for r in prefill],
         one_device_expert_flops=moe_one["prefill"]["expert_flops"],
         card=smi, ok=all(q == 0.25 for q in ratio))
    assert all(q == 0.25 for q in ratio), ratio
    emit(phase="shard", wall_s=time.perf_counter() - t0, card=smi)
    return ranks[0]


def analysis_fake_keys(routine, n):
    """The launch records' keys of ``routine`` on an n x n f32 operand (n^3
    for ``gemm``; ``n`` a shape for the batched drivers) traced on fake
    CUDA tensors (a worker of the analysis phase's pool, or for ``gemm``
    this process; no value is computed, nothing launches)."""
    from repro_torch import linalg
    from repro_torch.analysis import fake_card
    from repro_torch.kernels import launch_record as lr

    def build():
        a = torch.empty((n, n) if isinstance(n, int) else n,
                        dtype=torch.float32, device="cuda")
        fn = getattr(linalg, routine)
        return fn, ((a, a) if routine == "gemm" else (a,)), {}
    with linalg.use(policy="model"):
        tr = fake_card.run(build, torch.device("cuda"))
    return [lr.key(r) for r in tr.launches]


def analysis_counterparts(smi):
    """The Python counterparts of the card's answers, exactly."""
    from repro_torch.arch import H100
    from repro_torch.kernels import _build, dotp as dk, fused as fk
    from repro_torch.kernels import ssd_scan as sk
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert sms == H100.pe.sm_count, (sms, H100.pe.sm_count)
    lib = _build.library("trsm_gemm")
    # each B2 kernel's own occupancy answer (the 2-D kernel's, and the
    # batched kernel's at each width and L11 placement that fits) against
    # its Python counterpart, at every plan of nb = 8 .. 512
    co = {}
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        code = fk.DTYPE_CODES[dtype]
        for nb in range(8, 513, 8):
            for form in ("lu", "syrk"):
                plan = fk.trsm_gemm_plan(dtype, nb, form)
                co["2d", dtype, plan.smem_bytes] = (
                    fk.co_resident_ctas(dtype, plan.smem_bytes, sms),
                    lib.repro_trsm_gemm_co_resident(code, plan.smem_bytes))
                # every batched instantiation that fits at this nb
                for width, l_smem in fk.TRSM_GEMM_BATCHED_WIDTHS:
                    smem = fk.trsm_gemm_batched_smem(
                        fk.accumulator_dtype(dtype).itemsize, nb, width,
                        l_smem)
                    if smem > fk.SMEM_LIMIT:
                        continue
                    plan = fk.TrsmGemmPlan(
                        width, l_smem, -(-nb // 16) * 16, smem,
                        "dmma" if dtype == torch.float64 else "ffma",
                        "X^T" if form == "syrk" else "BL")
                    co["batched", dtype, plan] = (
                        fk.co_resident_ctas(dtype, smem, sms, plan),
                        lib.repro_trsm_gemm_batched_co_resident(
                            code, width, int(l_smem), int(form == "syrk"),
                            smem))
    bad_co = {" ".join(map(str, k)): v for k, v in co.items()
              if v[0] != v[1]}
    # each B2 kernel's registers and local-memory bytes per thread
    # (cudaFuncGetAttributes): the batched kernel keeps no per-task copy
    # of its parameters, so its local memory is 0 in every instantiation
    attrs, bad_attrs = {}, {}
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        regs, local = fk.trsm_gemm_attributes(dtype)
        attrs[f"2d {str(dtype)[6:]}"] = [regs, local]
        if regs != fk.trsm_gemm_registers(dtype):
            bad_attrs[f"2d {dtype}"] = (regs, fk.trsm_gemm_registers(dtype))
        for width, l_smem in fk.TRSM_GEMM_BATCHED_WIDTHS:
            for a_operand in ("X^T", "BL"):
                plan = fk.TrsmGemmPlan(width, l_smem, 0, 0, "", a_operand)
                regs, local = fk.trsm_gemm_attributes(dtype, plan)
                key = (f"batched {str(dtype)[6:]} w{width} l_smem={l_smem} "
                       f"A={a_operand}")
                attrs[key] = [regs, local]
                if local != 0 or regs != fk.trsm_gemm_registers(dtype, plan):
                    bad_attrs[key] = (regs, local,
                                      fk.trsm_gemm_registers(dtype, plan))
    emit(phase="analysis", check="B2 kernels' registers and local-memory "
         "bytes per thread (cudaFuncGetAttributes)", card=smi,
         registers_local_bytes=attrs, mismatch=bad_attrs,
         ok=not bad_attrs)
    assert not bad_attrs, bad_attrs
    dl = _build.library("dotp")
    per_sm = {(d, v): dl.repro_dotp_blocks_per_sm(dk.DTYPE_CODES[d], int(v))
              for d, v in dk.BLOCKS_PER_SM}
    bad_dotp = {f"{d} {v}": (dk.BLOCKS_PER_SM[d, v], got)
                for (d, v), got in per_sm.items()
                if got != dk.BLOCKS_PER_SM[d, v]}
    sl = _build.library("ssd_scan")
    ssd, bad_ssd = 0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for p in (16, 32, 64, 96, 128):
            for n in (8, 16, 32, 64, 128):
                for chunk in (8, 64, 128, 256):
                    try:
                        plan = sk.ssd_scan_plan(1, 1, 4096, p, n, chunk,
                                                dtype)
                    except ValueError:
                        continue
                    got = tuple(sl.repro_ssd_scan_smem_bytes(
                        sk.DTYPE_CODES[dtype], p, n, chunk, q)
                        for q in (1, 3))
                    ssd += 1
                    if got != (plan.smem_bytes[0], plan.smem_bytes[2]):
                        bad_ssd[f"{dtype} {p} {n} {chunk}"] = (
                            plan.smem_bytes, got)
    emit(phase="analysis", check="python counterparts of the card's "
         "answers", card=smi, sm_count=sms, b2_co_resident_sizes=len(co),
         b2_co_resident_mismatch=bad_co, b4_blocks_per_sm=len(per_sm),
         b4_mismatch=bad_dotp, b6_smem_shapes=ssd, b6_mismatch=bad_ssd)
    assert not bad_co and not bad_dotp and not bad_ssd and ssd > 0


def analysis_real_keys(routine, n, gen):
    """The launch records' keys of one real call on the card (``n`` a
    shape for the batched drivers)."""
    from repro_torch import linalg
    from repro_torch.kernels import launch_record as lr
    shape = (n, n) if isinstance(n, int) else n
    a = torch.randn(*shape, generator=gen, device="cuda")
    if routine in ("cholesky", "batched_cholesky"):
        a = a @ a.mT / shape[-1] + torch.eye(shape[-1], device="cuda")
    counts = zero_launches()
    with linalg.use(policy="model"), lr.record_launches() as rec:
        getattr(linalg, routine)(*((a, a) if routine == "gemm" else (a,)))
    torch.cuda.synchronize()
    launched = sum(w.launches for w in counts.values())
    assert len(rec) == launched and not any(r["fake"] for r in rec), \
        (len(rec), launched)
    return [lr.key(r) for r in rec]


def analysis_prefill_keys(gen):
    """hymba-1.5b's prefill (``PREFILL``), real on the card and fake: the
    launch records' keys of both."""
    from repro_torch.analysis import fake_card
    from repro_torch.configs import registry
    from repro_torch.kernels import launch_record as lr
    from repro_torch.models import model_zoo
    cfg = registry.get_config("hymba-1.5b")
    model = model_zoo.init(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), "cuda")
    tokens = torch.randint(0, cfg.vocab, PREFILL, generator=gen,
                           device="cuda")
    with lr.record_launches() as rec:
        model_zoo.prefill(model, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    del model
    torch.cuda.empty_cache()

    def build():
        m = model_zoo.build(cfg, device="cuda")
        t = torch.empty(PREFILL, dtype=torch.int64, device="cuda")
        return (lambda m_, t_: model_zoo.prefill(m_, {"tokens": t_}, cfg)), \
            (m, t), {}
    fake = fake_card.run(build, torch.device("cuda"))
    return [lr.key(r) for r in rec], [lr.key(r) for r in fake.launches]


def analysis_agree(name, real, fake):
    """Hold a real call's launch records to its fake trace's, kernel by
    kernel; one line."""
    kinds = {}
    for k in real:
        kinds[f"{k[0]}/{k[1]}"] = kinds.get(f"{k[0]}/{k[1]}", 0) + 1
    first = next((i for i, (r, f) in enumerate(zip(real, fake)) if r != f),
                 None)
    ok = real == fake
    emit(phase="analysis", check=f"{name}: real launch records against the "
         f"fake trace's (variant, tile, grid, shared memory)",
         launches=len(real), fake_launches=len(fake), kinds=kinds, ok=ok,
         first_difference=None if first is None else
         {"real": list(map(str, real[first])),
          "fake": list(map(str, fake[first]))})
    assert ok and real, name


def phase_analysis(smi):
    """repro_torch.analysis on the card (phase 12): the Python counterparts
    of the card's answers, real launch records against fake traces, then
    the whole surface grid on the card route with no unsuppressed error."""
    import concurrent.futures as cf
    import multiprocessing as mp

    from repro_torch.analysis import bypass_lint, report, sweep

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    analysis_counterparts(smi)
    # each worker pins one intra-op thread (the traces are CPU-bound and
    # the pool fills the cores); this process keeps its own count
    pool = cf.ProcessPoolExecutor(ANALYSIS_WORKERS,
                                  mp_context=mp.get_context("spawn"),
                                  initializer=torch.set_num_threads,
                                  initargs=(1,))
    try:
        # the two large fake traces first (the longest tasks), then the
        # surface's no-mesh legs, one (routine, dtype) a task
        big = {r: pool.submit(analysis_fake_keys, r, n)
               for r, n in ANALYSIS_CALLS + ANALYSIS_BATCHED if r != "gemm"}
        t_base = time.perf_counter()
        base = sweep.submit_base_legs(pool, device="cuda")
        # meanwhile, here: the real calls on the card and the small traces
        for routine, n in ANALYSIS_CALLS + ANALYSIS_BATCHED:
            real = analysis_real_keys(routine, n, gen)
            fake = analysis_fake_keys(routine, n) if routine == "gemm" \
                else big[routine].result(timeout=ANALYSIS_TIMEOUT_S)
            analysis_agree(f"{routine} {n} f32", real, fake)
        real, fake = analysis_prefill_keys(gen)
        analysis_agree(f"hymba-1.5b prefill {PREFILL[0]}x{PREFILL[1]}",
                       real, fake)
        t_by = time.perf_counter()
        by = bypass_lint.lint_bypass()
        by_s = time.perf_counter() - t_by
        base_rep = report.merge_reports(
            [f.result(timeout=ANALYSIS_TIMEOUT_S) for f in base],
            target="linalg-surface")
        base_s = time.perf_counter() - t_base
    finally:
        pool.shutdown(cancel_futures=True)
    t_mesh = time.perf_counter()
    mesh_rep = sweep.mesh_legs(device="cuda", timeout_s=ANALYSIS_TIMEOUT_S)
    mesh_s = time.perf_counter() - t_mesh
    rep = report.merge_reports([base_rep, mesh_rep, by],
                               target="linalg-surface")
    rules = {}
    for f in rep.suppressed:
        key = f"{f.rule} {f.location or f.routine}"
        rules[key] = rules.get(key, 0) + 1
    emit(phase="analysis", check="check_surface() on the card route, full "
         "grid, and the BY001 lint, with the committed allowlists",
         card=smi, cases=len(rep.cases),
         skipped=sum("skipped" in c for c in rep.cases),
         base_cases=len(base_rep.cases), mesh_cases=len(mesh_rep.cases),
         errors=len(rep.errors), warnings=len(rep.warnings),
         findings=len(rep.findings), suppressed=len(rep.suppressed),
         suppressed_by_rule=rules, base_s=base_s, mesh_s=mesh_s,
         bypass_s=by_s, workers=ANALYSIS_WORKERS,
         ranks=max(px * py for px, py in report.SURFACE_MESHES),
         ok=rep.ok, summary=rep.summary().splitlines()[0])
    assert rep.ok and not any("skipped" in c for c in rep.cases), \
        rep.summary()
    emit(phase="analysis", wall_s=time.perf_counter() - t0, card=smi)


def dryrun_child(out, world, mesh_shape, overrides, global_batch,
                 shape="train_4k", seq_len=None):
    """One child of the dryrun phase (spawned): a fake world of ``world``
    ranks, hymba-1.5b's ``shape`` cell (its cache cut to ``seq_len``
    where given) on ``mesh_shape`` (None: the pod mesh) traced once, its
    row and counts to ``out``."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

    torch.set_num_threads(1)
    dryrun.init_fake_world(world)
    dev = dryrun.trace_device().type
    mesh = make_production_mesh(device_type=dev) if mesh_shape is None \
        else make_debug_mesh(*mesh_shape, device_type=dev)
    trace, row = dryrun.lower_cell("hymba-1.5b", shape, mesh,
                                   overrides=overrides,
                                   global_batch=global_batch,
                                   seq_len=seq_len)
    with open(out, "w") as f:
        json.dump({"row": row.to_dict(), "counters": trace.counters,
                   "launches": len(trace.launches),
                   "state_bytes": trace.state_bytes,
                   "trace_s": trace.trace_s}, f)


def dryrun_spawn(top, cells):
    """Every cell's :func:`dryrun_child` at once; their results by name
    (raises if one failed or passed ``DRYRUN_TIMEOUT_S``)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = {name: ctx.Process(target=dryrun_child,
                               args=(os.path.join(top, name + ".json"),
                                     *args))
             for name, args in cells.items()}
    for p in procs.values():
        p.start()
    deadline = time.monotonic() + DRYRUN_TIMEOUT_S
    try:
        for p in procs.values():
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs.values():
            if p.is_alive():
                p.terminate()
                p.join(30)
    bad = {n: p.exitcode for n, p in procs.items() if p.exitcode != 0}
    assert not bad, f"dry-run children failed (exit codes {bad})"
    out = {}
    for name in cells:
        with open(os.path.join(top, name + ".json")) as f:
            out[name] = json.load(f)
    return out


def phase_dryrun(smi, train, shard):
    """The dry run held to the card (phase 13): ``train`` is the train
    phase's reading, ``shard`` the shard phase's rank 0 rows (its train
    step's and its decode step's)."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.configs import registry

    t0 = time.perf_counter()
    base, cfg = registry.get_config("hymba-1.5b"), shard_cfg()
    overrides = {f.name: getattr(cfg, f.name)
                 for f in dataclasses.fields(cfg)
                 if getattr(cfg, f.name) != getattr(base, f.name)}
    assert train["seq"] == TRAIN[1], train
    top = tempfile.mkdtemp(prefix="dryrun-")
    try:
        got = dryrun_spawn(top, {
            "one": (1, (1, 1), None, TRAIN[0]),
            "shard": (SHARD_MESH[0] * SHARD_MESH[1], SHARD_MESH, overrides,
                      TRAIN[0]),
            "pod": (256, None, None, None),
            "decode": (SHARD_MESH[0] * SHARD_MESH[1], SHARD_MESH, overrides,
                       SHARD_DECODE[0], "decode_32k", SHARD_DECODE[2])})
    finally:
        shutil.rmtree(top, ignore_errors=True)
    tol = DRYRUN_MEM_TOL[0]
    # (a) one device: the train phase's step
    one = got["one"]["row"]
    mem = one["bytes_per_device"] / train["peak_bytes"]
    flops = one["hlo_flops"] / train["bound_flops"]
    ok_a = abs(mem - 1) <= tol and flops >= 1 and not got["one"]["launches"]
    emit(phase="dryrun", check=f"(a) hymba-1.5b train_4k cut to "
         f"{TRAIN[0]}x{TRAIN[1]} on a (1, 1) fake world against the train "
         f"phase's step", card=smi, bytes_per_device=one["bytes_per_device"],
         card_peak_bytes=train["peak_bytes"], peak_ratio=mem,
         hlo_flops=one["hlo_flops"], bound_flops=train["bound_flops"],
         flops_over_bound=flops, launches=got["one"]["launches"],
         trace_s=got["one"]["trace_s"], mem_tol=DRYRUN_MEM_TOL, ok=ok_a)
    # (b) the shard cell: rank 0's counters, state and peak
    state = next(r for r in shard if r.get("leg") == "state on the mesh")
    step = next(r for r in shard if "steps" in r)
    live = {(s["collective_bytes"], s["redistribute_bytes"],
             s["tp_all_reduce_bytes"]) for s in step["steps"]}
    dry = got["shard"]
    ctr = (dry["counters"].get("collective.bytes", 0),
           dry["counters"].get("shard.redistribute_bytes", 0),
           dry["counters"].get("shard.tp_all_reduce_bytes", 0))
    peak = dry["row"]["bytes_per_device"] / step["peak_bytes"]
    ok_b = live == {ctr} and dry["state_bytes"] == state["spec_bytes"] \
        and abs(peak - 1) <= tol and not dry["launches"]
    emit(phase="dryrun", check=f"(b) the shard cell ({SHARD_LAYERS} "
         f"layers, f32, data x model {SHARD_MESH}, {TRAIN[0]}x{TRAIN[1]}) "
         f"against the live rank 0", card=smi,
         collective_bytes=ctr[0], redistribute_bytes=ctr[1],
         tp_all_reduce_bytes=ctr[2], live_per_step=sorted(live),
         state_bytes=dry["state_bytes"],
         live_spec_bytes=state["spec_bytes"],
         bytes_per_device=dry["row"]["bytes_per_device"],
         live_peak_bytes=step["peak_bytes"], peak_ratio=peak,
         trace_s=dry["trace_s"], ok=ok_b)
    # (c) one production cell, beside the ZeRO-3 route's reading
    pod = got["pod"]
    row = pod["row"]
    emit(phase="dryrun", check="(c) hymba-1.5b train_4k on the pod mesh "
         "(a fake world of 256)", card=smi, row=row,
         trace_s=pod["trace_s"], launches=pod["launches"],
         beside_zero3=DRYRUN_POD_ZERO3, now={
             "useful_flop_ratio": row["useful_flop_ratio"],
             "gib_per_device": row["bytes_per_device"] / 2 ** 30,
             "hlo_flops": row["hlo_flops"], "compute_s": row["compute_s"],
             "memory_s": row["memory_s"],
             "collective_s": row["collective_s"]})
    # (d) the shard phase's decode step: rank 0's counters a step
    leg = next(r for r in shard if "decode_steps" in r)
    live = {(s["collective_bytes"], s["redistribute_bytes"],
             s["decode_bytes"]) for s in leg["decode_steps"]}
    dry = got["decode"]
    ctr = (dry["counters"].get("collective.bytes", 0),
           dry["counters"].get("shard.redistribute_bytes", 0),
           dry["counters"].get("shard.decode_bytes", 0))
    ok_d = live == {ctr} and not dry["launches"]
    emit(phase="dryrun", check=f"(d) the shard phase's decode step "
         f"({SHARD_LAYERS} layers, f32, data x model {SHARD_MESH}, batch "
         f"{SHARD_DECODE[0]}, caches of {SHARD_DECODE[2]} slots) against "
         f"the live rank 0", card=smi, collective_bytes=ctr[0],
         redistribute_bytes=ctr[1], decode_bytes=ctr[2],
         live_per_step=sorted(live),
         bytes_per_device=dry["row"]["bytes_per_device"],
         trace_s=dry["trace_s"], ok=ok_d)
    assert ok_a and ok_b and ok_d and not pod["launches"], (ok_a, ok_b,
                                                            ok_d)
    emit(phase="dryrun", wall_s=time.perf_counter() - t0, card=smi)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    smi = phase_probe(_build)
    emit(phase_done="probe", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_kernels(gen)
    small_agreement()
    phase_model_kernels(gen)
    emit(phase_done="kernels", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    launches = phase_main(gen, _build.BUILD_DIR)
    emit(phase_done="main", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_lapack()
    emit(phase_done="lapack", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    batched_rows_3d = phase_linalg3d()
    emit(phase_done="linalg3d", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    launches["fpu_chain"] = phase_tune(gen)["fpu_chain"]
    emit(phase_done="tune", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    model_launches = phase_model(gen)
    emit(phase_done="model", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    family_b5 = phase_families(gen)
    emit(phase_done="families", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    train = phase_train()
    emit(phase_done="train", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    paper_row, paper_launches = phase_paper()
    model_launches["dotp"] = paper_launches["dotp"]
    emit(phase_done="paper", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_mesh(smi)
    emit(phase_done="mesh", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    shard = phase_shard(smi)
    emit(phase_done="shard", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_analysis(smi)
    emit(phase_done="analysis", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_dryrun(smi, train, shard)
    emit(phase_done="dryrun", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    rows = phase_times(gen, launches) + model_rows(gen, model_launches) \
        + [paper_row] + family_rows(gen, family_b5)
    emit(phase_done="times", wall_s=time.perf_counter() - t0)
    # the kernels line holds one row per kernel, the first of its name:
    # gemm at 8192^3 f32 on the main path's tile, attention on the
    # windowed layers (29 of 32), fpu_chain's mul class; the other dtypes',
    # tiles', classes' and the global layers' rows are in the times lines;
    # then the batched forms of B1 on "wgmma" and of B3 (linalg3d)
    first = {}
    for r in rows:
        first.setdefault(r["name"], r)
    rows = list(first.values()) + batched_rows_3d
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
