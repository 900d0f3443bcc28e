#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

It builds every kernel of the port from ``src/repro_torch/csrc`` (one nvcc
per source, in parallel) and drives the port's main path - dense BLAS-3
and blocked LAPACK through ``repro_torch.linalg`` - at n = 8192. Phases,
each printing one JSON line with its wall time:

1. ``probe``: the card, its power limit, capability 9.0, TF32 off, the
   kernel build.
2. ``kernels``: each CUDA kernel against its plain PyTorch version on the
   card, at ragged shapes and at the main path's shapes, each with its
   stated tolerance.
3. ``main``: ``gemm`` (8192^3 f32 and bf16, 4096^3 f64), ``gemm_bias_act``
   (8192^3, gelu), ``cholesky`` / ``lu`` / ``solve`` at 8192 f32 and
   ``cholesky`` at 4096 f64 under ``policy="model"``, then a cold-start
   ``policy="tuned"`` leg that must equal the model results bitwise. The
   kernels' launch counts are zeroed just before and read just after;
   each kernel must have launched. Residuals are checked.
4. ``times``: each kernel at the main path's shapes against its plain
   version, a library call and its roofline bound.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; without a CUDA card, or without the rest of the checkout,
it exits non-zero before printing any result.
"""
import json
import os
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
ROOT = os.path.dirname(os.path.abspath(__file__))
REPLACES = {
    "gemm": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:51"),
    "gemm_bias_act": ("src/repro_torch/csrc/gemm.cu",
                      "src/repro/kernels/fused.py:96"),
    "trsm_gemm": ("src/repro_torch/csrc/trsm_gemm.cu",
                  "src/repro/kernels/fused.py:201"),
}


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


def compare(name, got, want):
    """Normwise agreement of a kernel with its plain version; raises past
    the dtype's tolerance."""
    err = (got.double() - want.double()).abs().max().item()
    scale = max(want.double().abs().max().item(), 1.0)
    tol, reason = TOL[want.dtype]
    ok = bool(torch.isfinite(got).all()) and err <= tol * scale
    emit(check=name, max_abs_err=err, scale=scale, tol=tol, reason=reason,
         ok=ok)
    if not ok:
        raise AssertionError(f"{name}: |kernel - plain| = {err} > "
                             f"{tol} * {scale}")
    return err


def lower(gen, nb, dtype, unit):
    """A well-conditioned lower-triangular panel (bounded substitution)."""
    l = torch.randn(nb, nb, generator=gen, device="cuda").tril(-1) / nb
    d = torch.ones(nb, device="cuda") if unit else \
        1 + torch.rand(nb, generator=gen, device="cuda")
    return (l + torch.diag(d)).to(dtype)


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
        for m, n, k in ((1000, 777, 513), (N, N, N)):
            a, b = rnd(m, k, dtype=dtype), rnd(k, n, dtype=dtype)
            compare(f"gemm {tag} {m}x{n}x{k}", gk.gemm(a, b),
                    gk.gemm_plain(a, b))
            if m == N:
                if dtype == torch.float32:          # the main path's B3 call
                    bias = rnd(n)
                    compare(f"gemm_bias_act {tag} {m}x{n}x{k} gelu bias=True",
                            fk.gemm_bias_act(a, b, bias, "gelu"),
                            fk.gemm_bias_act_plain(a, b, bias, "gelu"))
                continue
            compare(f"gemm {tag} transposed views", gk.gemm(b.T, a.T),
                    gk.gemm_plain(b.T, a.T))
            bias = rnd(n, dtype=dtype)
            for epi in fk.EPILOGUES:
                for bb in (None, bias):
                    compare(f"gemm_bias_act {tag} {epi} bias={bb is not None}",
                            fk.gemm_bias_act(a, b, bb, epi),
                            fk.gemm_bias_act_plain(a, b, bb, epi))
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
    # a panel too wide for 64-column X blocks: narrow tile, L11 from
    # device memory
    args = (lower(gen, 2000, torch.float64, False),
            rnd(2000, 40, dtype=torch.float64), None,
            rnd(40, 40, dtype=torch.float64))
    x, c = fk.trsm_gemm(*args, form="syrk")
    xp, cp = fk.trsm_gemm_plain(*args, form="syrk")
    compare(f"trsm_gemm float64 nb=2000 n=40 syrk "
            f"{fk.trsm_gemm.last_launch} X", x, xp)
    compare("trsm_gemm float64 nb=2000 n=40 syrk C", c, cp)
    emit(phase="kernels", tile_of_last_trsm_gemm=fk.trsm_gemm.last_launch)


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
    results = {}
    gk.gemm.launches = fk.gemm_bias_act.launches = fk.trsm_gemm.launches = 0
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
    emit(phase="main", wall_s=main_s, launches=launches,
         cold_start_tuned_equals_model=True)
    return launches


def phase_times(gen, launches):
    from repro_torch.core.codesign import plan_factorization
    from repro_torch.kernels import fused as fk
    from repro_torch.kernels import gemm as gk

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def bound(flops, nbytes, dtype):
        t_ops = flops / PEAK_FLOPS[dtype]
        t_bytes = nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, \
            "operations" if t_ops >= t_bytes else "bytes"

    rows = []
    a, b, bias = rnd(N, N), rnd(N, N), rnd(N)
    f32 = 4
    gemm_flops, gemm_bytes = 2.0 * N ** 3, 3 * N * N * f32
    b_ms, b_by = bound(gemm_flops, gemm_bytes, torch.float32)
    rows.append(dict(
        name="gemm", shape=f"{N}x{N}x{N} float32",
        ms=cuda_ms(lambda: gk.gemm(a, b)),
        plain_ms=cuda_ms(lambda: gk.gemm_plain(a, b)),
        library_ms=cuda_ms(lambda: torch.matmul(a, b)), bound_ms=b_ms,
        bound_by=b_by, max_abs_err=(gk.gemm(a, b) - gk.gemm_plain(a, b))
        .abs().max().item()))
    # bias add + tanh-gelu priced as 9 operations per output
    b_ms, b_by = bound(gemm_flops + 9.0 * N * N, gemm_bytes + N * f32,
                       torch.float32)
    rows.append(dict(
        name="gemm_bias_act", shape=f"{N}x{N}x{N} float32 gelu+bias",
        ms=cuda_ms(lambda: fk.gemm_bias_act(a, b, bias, "gelu")),
        plain_ms=cuda_ms(lambda: fk.gemm_bias_act_plain(a, b, bias, "gelu")),
        library_ms=cuda_ms(lambda: F.gelu(torch.addmm(bias, a, b),
                                          approximate="tanh")),
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=(fk.gemm_bias_act(a, b, bias, "gelu")
                     - fk.gemm_bias_act_plain(a, b, bias, "gelu"))
        .abs().max().item()))
    # the first trailing update of the 8192 Cholesky: nb x nb panel, an
    # n x n trailing block (syrk form)
    nb = plan_factorization(N, "potrf", dtype=torch.float32).block
    n = N - nb
    args = (lower(gen, nb, torch.float32, False), rnd(n, nb).T, None,
            rnd(n, n))
    b_ms, b_by = bound(nb * nb * n + 2.0 * n * n * nb,
                       (nb * nb + 2 * nb * n + 2 * n * n) * f32,
                       torch.float32)
    x, c = fk.trsm_gemm(*args, form="syrk")
    xp, cp = fk.trsm_gemm_plain(*args, form="syrk")
    rows.append(dict(
        name="trsm_gemm", shape=f"nb={nb} n={n} float32 syrk",
        ms=cuda_ms(lambda: fk.trsm_gemm(*args, form="syrk")),
        plain_ms=cuda_ms(lambda: fk.trsm_gemm_plain(*args, form="syrk")),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        max_abs_err=max((x - xp).abs().max().item(),
                        (c - cp).abs().max().item())))
    for row in rows:
        source, replaces = REPLACES[row["name"]]
        row.update(route="cuda", source=source, replaces=replaces,
                   launches=launches[row["name"]])
    emit(phase="times", rows=rows)
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
    emit(phase_done="kernels", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    launches = phase_main(gen, _build.BUILD_DIR)
    emit(phase_done="main", wall_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    rows = phase_times(gen, launches)
    emit(phase_done="times", wall_s=time.perf_counter() - t0)
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
