"""GESV - dense solve by LU with partial pivoting (port of
``repro.lapack.solve.gesv``; the QR least-squares driver is later work).

The policy is threaded through the factorization and both triangular
solves, so every GEMM-shaped step resolves through
:mod:`repro_torch.tune.dispatch`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.blas.level3 import trsm
from repro_torch.lapack.lu import apply_ipiv, getrf
from repro_torch.tune.policy import resolve_policy


def gesv(a: torch.Tensor, b: torch.Tensor, block: Optional[int] = None,
         policy: Optional[str] = None, registry=None) -> torch.Tensor:
    """Solve A X = B via LU with partial pivoting (LAPACK DGESV); b is
    (n,) or (n, k) and X has its shape."""
    pol = resolve_policy(policy)
    packed, piv = getrf(a, block=block, policy=pol, registry=registry)
    rhs = b if b.ndim == 2 else b[:, None]
    rhs = apply_ipiv(rhs, piv)
    y = trsm(packed, rhs, lower=True, unit_diag=True, left=True,
             policy=pol, registry=registry)
    x = trsm(packed, y, lower=False, unit_diag=False, left=True,
             policy=pol, registry=registry)
    return x if b.ndim == 2 else x[:, 0]
