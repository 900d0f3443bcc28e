"""LAPACK on the PyTorch/CUDA port: blocked QR / LU / Cholesky and solver
accuracy, the batched drivers in lockstep, and the section-4 census run
over the factorization itself (the port of
``examples/factorization_demo.py``; ``core.fx_census`` takes the place of
``core.jaxpr_census``).

Runs on the card; ``--device cpu`` runs on the CPU (the kernels' plain
versions).

  PYTHONPATH=src python examples/torch/factorization_demo.py [n] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np
import torch

from repro_torch import lapack
from repro_torch.core import fx_census as fc
from repro_torch.core.codesign import plan_factorization


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=96)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    n, dev = args.n, torch.device(args.device)
    rng = np.random.default_rng(0)
    on = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)
    amax = lambda t: float(t.abs().max())
    a = on(rng.normal(size=(n, n)))
    eye = torch.eye(n, device=dev)

    print(f"=== blocked QR ({n}x{n}, {dev.type}) ===")
    q, r = lapack.qr.qr(a, block=32)
    print(f"  ||QR - A||_max = {amax(q @ r - a):.2e}")
    print(f"  ||Q'Q - I||_max = {amax(q.T @ q - eye):.2e}")

    print("=== blocked LU w/ partial pivoting ===")
    packed, piv = lapack.getrf(a, block=32)
    rec = lapack.lu_reconstruct(packed, piv)
    print(f"  ||PtLU - A||_max = {amax(rec - a):.2e}")

    print("=== blocked Cholesky ===")
    s = a @ a.T + n * eye
    c = lapack.potrf(s, block=32)
    print(f"  ||LL' - S||_max = {amax(c @ c.T - s):.2e}")

    print("=== solve (LU) + least squares (QR) ===")
    b = on(rng.normal(size=n))
    x = lapack.gesv(a, b)
    print(f"  ||Ax - b||_max = {amax(a @ x - b):.2e}")

    print("=== batched blocked LAPACK (lockstep over the GEMM hot path) ===")
    items = 8
    batch = on(rng.normal(size=(items, n, n)))
    spd = batch @ batch.transpose(1, 2) + n * eye
    plan = plan_factorization(n, kind="potrf", batch=items)
    print(f"  plan_factorization(n={n}, potrf): NB={plan.block}, "
          f"panel_fraction={plan.panel_fraction:.2f}")
    res = lapack.batched_potrf(spd)      # NB defaults to the plan's choice
    err = amax(lapack.reconstruct(res) - spd)
    print(f"  batched_potrf({items}x{n}x{n}): ||LL' - S||_max = {err:.2e}")
    rhs = on(rng.normal(size=(items, n)))
    x = lapack.batched_solve(lapack.batched_getrf(batch), rhs)
    resid = amax(torch.einsum("bij,bj->bi", batch, x) - rhs)
    print(f"  batched_solve (LU, {items} systems): ||Ax - b||_max = "
          f"{resid:.2e}")

    print("=== section-4 census of the real DGEQRF implementation ===")
    # traced on a meta tensor: the aten graph of the factorization, the
    # kernels' plain versions standing in for their launches
    cen = fc.census_of(lambda m: lapack.qr.geqrf(m, block=32),
                       a.to("meta"), name="dgeqrf")
    print(fc.report(cen))
    print("-> the sqrt pipe is fully serial (hazard ratio 1.0) while the "
          "GEMM-dominated mul/add volume dwarfs the O(n^2) div stream - the "
          "paper's fig. 9/10 structure, measured on the port's own "
          "factorization (its aten graph: loops unrolled, see "
          "core/fx_census.py).")


if __name__ == "__main__":
    main()
