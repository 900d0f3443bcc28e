"""Device time of B1 and B2 at the main path's 2-D shapes and of B8 at the
paper's sweeps, to set two checkouts of the port side by side on one card.

    PYTHONPATH=<checkout>/src python3 src/repro_torch/tools/kernel_ab.py \
        NAME [--only gemm,trsm_gemm,pe_scoreboard]

prints one JSON line: the name, the card's name and power limit
(``nvidia-smi``), and the milliseconds per call (CUDA events over 10 calls
after one warm-up; 5 for the large products and for B8) of B1 ``ffma`` at
8192^3 f32 and ``dmma`` at 4096^3 f64, of B1 ``gemv`` at the TRSM update's
128 x 1 x 8064 f32 (20 calls in one CUDA graph, replayed: its host time
exceeds the kernel's), of B2 at the drivers' trailing updates (nb 128:
syrk and lu at n' = 8064, syrk at 1024 f32, syrk at 3968 f64), on inputs
drawn from seed 0, and of B8 at the five depth sweeps of figs 12-13
(chip_smoke.py's paper phase: n = 100, the joint depths 2-24, seven
configurations a launch) with each sweep's instructions. Run it with the
``src`` of each checkout in turn in one machine session (A, B, B, A):
hosts differ.
"""
import json
import subprocess
import sys

import torch

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
        out[f"trsm_gemm {form} n={n} {str(dtype)[6:]}"] = cuda_ms(
            lambda: fk.trsm_gemm(*args, form=form, unit_diag=form == "lu"))
        del l11, args
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
