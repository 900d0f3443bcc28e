"""Device time of B1 and B2 at the main path's 2-D shapes and of B8 at the
paper's sweeps, to set two checkouts of the port side by side on one card.

    PYTHONPATH=<checkout>/src python3 src/repro_torch/tools/kernel_ab.py \
        NAME [--only gemm,trsm_gemm,pe_scoreboard]

prints one JSON line: the name, the card's name and power limit
(``nvidia-smi``), and the milliseconds per call (CUDA events over 10 calls
after one warm-up; 5 for the large products and for B8; B2 also as device
ms per launch from ``torch.profiler``, free of the wrapper's host time) of
B1 ``ffma`` at 8192^3 f32, ``wgmma`` at 8192^3 bf16 and ``dmma`` at
4096^3 f64, of B1 ``gemv`` at
the TRSM update's 128 x 1 x 8064 f32 (20 calls in one CUDA graph,
replayed: its host time exceeds the kernel's), of B2 at the drivers'
trailing updates (nb 128: syrk and lu at n' = 8064, syrk at 1024 f32,
syrk at 3968 f64), of the batched B2 at the batched drivers' trailing
updates (64 items of nb 128 on the views ``batched_cholesky`` /
``batched_lu`` hand over: syrk and lu at n' = 384, 256 and 128 f32 and
at 384 f64, and the solve alone, lu at m = 0, n' = 384 f32), on inputs
drawn from seed 0, and of B8 at the five depth sweeps of figs 12-13
(chip_smoke.py's paper phase: n = 100, the joint depths 2-24, seven
configurations a launch) with each sweep's instructions; with ``--only
batched``, of the batched ``wgmma`` at 64 x 1024^3 bf16 on each compiled
tile and the batched B3 at 64 x 512^3 f32 gelu (the ``linalg3d`` phase's
shapes; a checkout before the batched ``wgmma`` refuses them). Run it with the
``src`` of each checkout in turn in one machine session (A, B, B, A):
hosts differ.
"""
import json
import subprocess
import sys

import torch

from repro_torch.core.codesign import plan_from_blocks
from repro_torch.kernels import fused as fk
from repro_torch.kernels import gemm as gk


def cuda_ms(fn, reps=10):
    """Milliseconds per call of ``fn`` by CUDA events, after one call."""
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
    """Milliseconds per call of ``fn`` with ``reps`` calls captured in
    one CUDA graph, its replay timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 5) / reps


def device_ms(fn, match, reps=10):
    """Device milliseconds per launch of the kernels whose name holds
    ``match`` over ``reps`` calls of ``fn`` under ``torch.profiler``,
    after 32 tiny kernels that take the place of the records a trace on
    the card can lose first; None when the trace holds none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    filler = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(32):
            filler.add_(1)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ns = count = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and match in e.name():
            ns += e.duration_ns()
            count += 1
    return ns / 1e6 / count if count else None


BATCH, BATCH_NB = 64, 128


def batched_trsm_gemm(out: dict, rnd) -> None:
    """The batched B2 on the views the batched drivers hand over: 64
    items of nb 128, syrk (``batched_cholesky``) and lu (``batched_lu``)
    at n' = 384, 256, 128 f32 and 384 f64, and lu at m = 0 (the solve
    alone) at n' = 384 f32."""
    nb = BATCH_NB
    for n, dtype, forms in ((384, torch.float32, ("syrk", "lu", "solve")),
                            (256, torch.float32, ("syrk", "lu")),
                            (128, torch.float32, ("syrk", "lu")),
                            (384, torch.float64, ("syrk", "lu"))):
        a = rnd(BATCH, nb + n, nb + n, dtype=dtype)
        a[:, :nb, :nb] = (torch.tril(a[:, :nb, :nb], -1) / nb
                          + 1.5 * torch.eye(nb, device="cuda", dtype=dtype))
        for form in forms:
            if form == "syrk":
                args = (a[:, :nb, :nb], a[:, nb:, :nb].mT, None,
                        a[:, nb:, nb:])
            elif form == "lu":
                args = (a[:, :nb, :nb], a[:, :nb, nb:], a[:, nb:, :nb],
                        a[:, nb:, nb:])
            else:                              # lu at m = 0: X alone
                args = (a[:, :nb, :nb], a[:, :nb, nb:], a[:, nb:nb, :nb],
                        a[:, nb:nb, nb:])
            kind = "syrk" if form == "syrk" else "lu"
            call = lambda: fk.trsm_gemm(*args, form=kind,
                                        unit_diag=kind == "lu")
            tag = (f"trsm_gemm batched {BATCH}x nb={nb} n={n} "
                   f"{'lu m=0' if form == 'solve' else form} "
                   f"{str(dtype)[6:]}")
            out[tag] = cuda_ms(call)
            out[tag + " device"] = device_ms(call, "trsm_gemm")
        del a


PAPER_N, PAPER_DEPTHS = 100, [2, 4, 6, 8, 12, 16, 24]


def pe_sweeps(out: dict) -> None:
    """B8 at figs 12-13's five sweeps (fig 12: add and mul jointly; fig 13:
    sqrt and div) at n = 100, seven depth configurations a launch."""
    import numpy as np

    from repro_torch.core import isa, pe
    from repro_torch.kernels import pe_scoreboard as ps

    qr, lu = isa.compile_dgeqrf(PAPER_N), isa.compile_dgetrf(PAPER_N)
    for tag, stream, units in (
            ("fig12 dgemm", isa.compile_dgemm(PAPER_N, PAPER_N, PAPER_N,
                                              unroll=4), ("add", "mul")),
            ("fig12 dgeqrf", qr, ("add", "mul")),
            ("fig12 dgetrf", lu, ("add", "mul")),
            ("fig13 dgeqrf", qr, ("sqrt", "div")),
            ("fig13 dgetrf", lu, ("sqrt", "div"))):
        lat = np.stack([pe._latency_vector({u: d for u in units})
                        for d in PAPER_DEPTHS])
        args = [torch.from_numpy(np.ascontiguousarray(v, np.int32)).cuda()
                for v in (stream.opcode, stream.src1, stream.src2, lat)]
        out[f"pe_scoreboard {tag}"] = cuda_ms(
            lambda: ps.pe_scoreboard(*args), 5)
        out[f"pe_scoreboard {tag} instructions"] = stream.n_instructions


def main(label: str, only=("gemm", "trsm_gemm", "pe_scoreboard")) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    out = {"label": label, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()}
    if "gemm" in only:
        a, b = rnd(8192, 8192), rnd(8192, 8192)
        out["ffma 8192^3"] = cuda_ms(lambda: gk.gemm(a, b), 5)
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
        out["wgmma 8192^3 bf16"] = cuda_ms(lambda: gk.gemm(a, b), 5)
        a, b = rnd(4096, 4096, dtype=torch.float64), \
            rnd(4096, 4096, dtype=torch.float64)
        out["dmma 4096^3 f64"] = cuda_ms(lambda: gk.gemm(a, b), 5)
        a, b = rnd(8192, 8192)[128:256, :8064], rnd(8064, 1)
        out["gemv 128x1x8064 graph"] = graph_ms(lambda: gk.gemm(a, b))
        del a, b
    for form, n, dtype in (("syrk", 8064, torch.float32),
                           ("lu", 8064, torch.float32),
                           ("syrk", 1024, torch.float32),
                           ("syrk", 3968, torch.float64)):
        if "trsm_gemm" not in only:
            break
        nb = 128
        l11 = (torch.tril(rnd(nb, nb), -1) / nb
               + 1.5 * torch.eye(nb, device="cuda")).to(dtype)
        args = (l11, rnd(n, nb, dtype=dtype).T,
                rnd(n, nb, dtype=dtype) if form == "lu" else None,
                rnd(n, n, dtype=dtype))
        call = lambda: fk.trsm_gemm(*args, form=form, unit_diag=form == "lu")
        out[f"trsm_gemm {form} n={n} {str(dtype)[6:]}"] = cuda_ms(call)
        out[f"trsm_gemm {form} n={n} {str(dtype)[6:]} device"] = device_ms(
            call, "trsm_gemm")
        del l11, args
    if "trsm_gemm" in only:
        batched_trsm_gemm(out, rnd)
    if "batched" in only:
        a, b = (rnd(64, 1024, 1024, dtype=torch.bfloat16) for _ in range(2))
        for tile in gk.TILE_SETS["wgmma"]:
            plan = plan_from_blocks(1024, 1024, 1024, *tile,
                                    dtype=torch.bfloat16, machine="h100")
            out[f"wgmma batched 64x1024^3 bf16 {tile}"] = cuda_ms(
                lambda: gk.gemm(a, b, plan=plan))
        a, b, bias = rnd(64, 512, 512), rnd(64, 512, 512), rnd(512)
        out["gemm_bias_act batched 64x512^3 f32 gelu"] = cuda_ms(
            lambda: fk.gemm_bias_act(a, b, bias, "gelu"))
        del a, b, bias
    if "pe_scoreboard" in only:
        pe_sweeps(out)
    return out


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("label", nargs="?", default="run")
    p.add_argument("--only", default="gemm,trsm_gemm,pe_scoreboard",
                   help="comma-separated kernels to time")
    args = p.parse_args()
    print(json.dumps(main(args.label, tuple(args.only.split(",")))))
