#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

It builds every kernel of the port from ``src/repro_torch/csrc`` (one nvcc
per source, in parallel) and drives the port's three paths: dense BLAS-3
and blocked LAPACK through ``repro_torch.linalg`` at n = 8192, the tuning
loop (sweep, registry, tuned dispatch, calibration), and the model zoo
serving hymba-1.5b at full width. Phases, each printing JSON lines with
its wall time:

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
   offset-by-one and strided views, and two calls of each bitwise equal.
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
4. ``tune``: with the launch counts zeroed, ``tune_gemm`` at 4096^3 in
   f32, bf16 and f64 into a temporary registry (each candidate's tile,
   median, spread, modeled seconds and residual), a ``linalg.gemm`` under
   ``policy="tuned"`` that must hit the registry and launch the winner's
   tile, ``tune_fused_gemm`` at 4096^3, and ``arch.calibrate`` on the card
   at its default sizes (``calibrated-cuda`` beside ``h100``'s datasheet
   numbers, the cycles
   per dependent op of each class from the chain kernel).
5. ``model``: hymba-1.5b (32 layers, d_model 1600) built on the card from
   seed 0, one untimed prefill of 2 x 4096 tokens (set-up), then a warm
   ``model_zoo.prefill`` of 2 x 4096 other tokens with the launch counts
   zeroed just before and read just after (B5 and B6 must launch once per
   layer), then ``serve_batch`` of 4 requests (its prefill counted the
   same way), one profiled prefill (device-busy time, the top kernels and
   B6's three ``ssd_`` kernels summed) and decode step, then a reduced
   hybrid model's ``forward`` on the card against its CPU (plain) route.
6. ``times``: each kernel at its path's shapes against its plain version,
   a library call and its roofline bound: B1 at every compiled tile, B2
   at five trailing updates the drivers launch beside the two-call
   ``solve_triangular`` + ``addmm``, B1's "gemv" at the TRSM update in
   three dtypes (CUDA-graph replay: its wrapper's host time exceeds the
   kernels'), the FPU-chain probe per class, B4 against ``torch.dot`` in
   20 alternating turns, B6 at the prefill shape by CUDA-graph replay (its
   three launches per call) and by the profiler's device ms per call.

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
}
TUNE_N = 4096                  # the tune phase's sweep shape (n^3)


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
    from repro_torch.kernels import ssd_scan as sk
    wrappers = {"gemm": gk.gemm, "gemm_bias_act": fk.gemm_bias_act,
                "trsm_gemm": fk.trsm_gemm, "dotp": dk.dotp,
                "attention": fa.attention, "ssd_scan": sk.ssd_scan,
                "fpu_chain": fc.fpu_chain}
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
    kernels phase; the model path launches no dotp), attention and the SSD
    scan at the hymba prefill's shapes (bf16)."""
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
        launches_note="the model path launches no dotp; its launches come "
                      "from the kernels phase"))
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
    launches["fpu_chain"] = phase_tune(gen)["fpu_chain"]
    emit(phase_done="tune", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    model_launches = phase_model(gen)
    emit(phase_done="model", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    rows = phase_times(gen, launches) + model_rows(gen, model_launches)
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
