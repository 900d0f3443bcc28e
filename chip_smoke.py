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
steps at full width, and the paper's own apparatus (figs 12-13 on
the PE scoreboard kernel, the quickstart's codesigned kernels). Phases,
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
   f64 solution; ``batched_cholesky`` / ``batched_lu`` of 64 x 512 f32
   (B2 three times per item), ``batched_qr`` of 64 x 512 x 256 and their
   ``batched_solve`` with 8 right-hand sides (B1 ``gemv`` per TRSM
   update); the level-1 routines at n = 2^26 f32 against f64 (none
   launches a kernel of the port), ms per call beside the bytes bound; and
   a traced 4096 f32 QR written by both exporters and read back.
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
   of its section-4 profile, and B8's ms.
10. ``times``: each kernel at its path's shapes against its plain version,
   a library call and its roofline bound: B1 at every compiled tile, B2
   at five trailing updates the drivers launch beside the two-call
   ``solve_triangular`` + ``addmm``, B1's "gemv" at the TRSM update in
   three dtypes (CUDA-graph replay: its wrapper's host time exceeds the
   kernels'), the FPU-chain probe per class, B4 against ``torch.dot`` in
   20 alternating turns, B6 at the prefill shape by CUDA-graph replay (its
   three launches per call) and by the profiler's device ms per call;
   B8's row comes from the paper phase; B5 at the families' forms last.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; without a CUDA card, or without the rest of the checkout,
it exits non-zero before printing any result.
"""
import json
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
LEVEL1_N = 2 ** 26
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
# step with ready[] on chip, a shared-memory load-to-use (assumed 30
# cycles, the Hopper microbenchmark literature's figure) then a max and an
# add on the integer pipe (assumed 4 cycles each, as the FPU-chain probe
# reads for FADD / FMUL), at the card's maximum SM clock (nvidia-smi
# clocks.max.sm, read in the run)
PE_STEP_CYCLES = 30 + 2 * 4


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
    sides, B2 once per fused trailing update of a batched item."""
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
            # lower + upper solve per item of potrf / getrf, one of geqrf
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
    :func:`trsm_gemv_checks`). Its inputs come from a generator of its own,
    seeded with ``SEED``, so the later phases draw what they drew without
    it."""
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
    batched = {}
    for kind, routine, a in (("potrf", "batched_cholesky", spd),
                             ("getrf", "batched_lu", g),
                             ("geqrf", "batched_qr", tall)):
        with linalg.use(policy="model", device="cuda"):
            res, launches = counted(
                f"{routine} {items}x{tuple(a.shape[1:])} f32",
                lambda: getattr(linalg, routine)(a))
            batched[routine] = launches
            if kind == "geqrf":
                only(launches, ffma=items * plans["batched_qr item"]["b1"])
            else:
                only(launches, trsm_gemm=items * fused[kind])
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
        only(launches, gemv=items * per_item[kind])
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
    emit(call=f"train step hymba-1.5b {TRAIN[0]}x{seq} (1 untimed + "
              f"{TRAIN_TIMED} timed)", cut=cut, steps=steps,
         step_s=step_s, step_s_all=timed, tokens_per_s=tokens / step_s,
         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         peak_bytes=torch.cuda.max_memory_allocated(),
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

    # the figures, each sweep's kernel timed on its own inputs
    kernel_ms = {}
    for tag, stream, units, prof in sweeps:
        res = results[tag]
        args = pe_args(stream, res)
        kernel_ms[tag] = cuda_ms(lambda: ps.pe_scoreboard(*args), reps=1)
        emit(paper=tag, n=PAPER_N, instructions=stream.n_instructions,
             units=list(units), depths=PAPER_DEPTHS,
             cycles=[r.cycles for r in res], stalls=[r.stalls for r in res],
             cpi=[r.cpi for r in res], tpi=[r.tpi for r in res],
             best_depth_by_tpi=pe.best_depth(res, units[0]),
             eq7_optimal_depths=prof.optimal_depths(),
             eq7_popt_closed_form=prof.popt_closed_form(),
             hazard_ratios=prof.hazard_ratios(), kernel_ms=kernel_ms[tag],
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
               timing="ms: CUDA events over one launch after one warm-up "
                      "(the wrapper's zeroed ready[] scratch included); "
                      "plain_ms: the plain version on the CPU, once",
               bound=f"{PE_STEP_CYCLES} cycles per dependent step at "
                     f"{clock_mhz} MHz")
    emit(phase="times (paper)", rows=[row])
    return row, launches


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
    launches["fpu_chain"] = phase_tune(gen)["fpu_chain"]
    emit(phase_done="tune", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    model_launches = phase_model(gen)
    emit(phase_done="model", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    family_b5 = phase_families(gen)
    emit(phase_done="families", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_train()
    emit(phase_done="train", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    paper_row, paper_launches = phase_paper()
    model_launches["dotp"] = paper_launches["dotp"]
    emit(phase_done="paper", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    rows = phase_times(gen, launches) + model_rows(gen, model_launches) \
        + [paper_row] + family_rows(gen, family_b5)
    emit(phase_done="times", wall_s=time.perf_counter() - t0)
    # the kernels line holds one row per kernel, the first of its name:
    # gemm at 8192^3 f32 on the main path's tile, attention on the
    # windowed layers (29 of 32), fpu_chain's mul class; the other dtypes',
    # tiles', classes' and the global layers' rows are in the times lines
    first = {}
    for r in rows:
        first.setdefault(r["name"], r)
    rows = list(first.values())
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
