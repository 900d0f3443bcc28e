"""Quickstart on the PyTorch/CUDA port: the paper's codesign loop in five
steps (the port of ``examples/quickstart.py``).

1. characterize a BLAS workload (section 4),
2. get the optimal pipeline depths (eq. 7),
3. confirm on the cycle-level PE simulator (section 5: the scoreboard
   kernel on the card),
4. map the optimum to the device's knobs (accumulator count, GEMM tiles
   priced for the device's machine: ``h100`` on the card, ``tpu-like`` on
   the CPU),
5. run the codesigned kernels (the dot product and the GEMM) against
   their oracles.

Runs on the card; ``--device cpu`` runs every step on the CPU (the PE
recurrence in Python, the kernels' plain versions).

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np
import torch

from repro_torch import arch
from repro_torch.core import characterization as ch
from repro_torch.core import codesign, isa, pe
from repro_torch.kernels import ops


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = torch.device(ap.parse_args(argv).device)

    print("=" * 70)
    print("1) Characterize ddot(4096) - the paper's fig. 5 DAG")
    prof = ch.characterize_ddot(4096, schedule="sequential")
    print(f"   hazard ratios: "
          f"{ {k: round(v, 3) for k, v in prof.hazard_ratios().items()} }")

    print("2) Optimal pipeline depths (eq. 7)")
    print(f"   p_opt = {prof.optimal_depths()} (mul unbounded: hazard-free)")

    print(f"3) Cycle-level PE simulation (depth sweep on the adder, "
          f"{dev.type})")
    stream = isa.compile_ddot(4096, schedule="sequential")
    results = pe.sweep(stream, "add", [1, 2, 4, 8, 16, 32], device=dev)
    for r in results:
        print(f"   depth {r.depths['add']:3d}: CPI {r.cpi:6.3f}  "
              f"TPI {r.tpi:8.3f}")
    print(f"   best simulated depth: {pe.best_depth(results, 'add')}")

    machine = arch.resolve_machine(None, dev)
    print(f"4) {machine.name} adaptation: eq. 3 -> accumulator count / GEMM "
          f"tiling")
    u = codesign.optimal_accumulators(4096)
    plan = codesign.plan_gemm(2048, 2048, 2048, machine=machine)
    print(f"   U* = {u} accumulators (add-latency window)")
    print(f"   GEMM blocks ({plan.bm},{plan.bn},{plan.bk}), on-chip "
          f"{plan.vmem_bytes / 2**20:.1f} MiB, AI "
          f"{plan.arithmetic_intensity:.0f} flops/byte, "
          f"compute_bound={plan.compute_bound}")

    print(f"5) Codesigned kernels vs oracles ({dev.type})")
    rng = np.random.default_rng(0)
    on = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)
    x, y = on(rng.normal(size=4096)), on(rng.normal(size=4096))
    got = float(ops.dotp(x, y, accumulators=u))
    want = float(np.dot(x.cpu().numpy(), y.cpu().numpy()))
    print(f"   dotp kernel: {got:.4f} vs oracle {want:.4f} "
          f"(err {abs(got - want):.2e})")
    a, b = on(rng.normal(size=(256, 384))), on(rng.normal(size=(384, 128)))
    c = ops.gemm(a, b)
    err = float((c.double() - a.double() @ b.double()).abs().max())
    print(f"   gemm kernel max err vs oracle: {err:.2e}")
    print("=" * 70)
    print("OK")


if __name__ == "__main__":
    main()
