"""Dense solvers built on the factorizations (port of
``repro.lapack.solve``): GESV by LU with partial pivoting, least squares
by QR, and the solve halves (``getrs``, ``potrs``, ``geqrs``) that these
and the batched drivers share.

The policy is threaded through every factorization and triangular solve,
so every GEMM-shaped step resolves through :mod:`repro_torch.tune.dispatch`.
The solve halves also take a batch, factors (B, n, n) and right-hand sides
(B, n, k), solved in lockstep (each TRSM update one launch for all items).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.blas.level3 import trsm
from repro_torch.lapack.lu import apply_ipiv, getrf
from repro_torch.lapack.qr import geqrf, q_from_geqrf
from repro_torch.tune.policy import resolve_policy


def getrs(packed: torch.Tensor, piv: torch.Tensor, rhs: torch.Tensor,
          policy: Optional[str] = None, registry=None) -> torch.Tensor:
    """Solve L U X = P B from a square packed :func:`getrf` result; rhs is
    (n, k)."""
    y = trsm(packed, apply_ipiv(rhs, piv), lower=True, unit_diag=True,
             left=True, policy=policy, registry=registry)
    return trsm(packed, y, lower=False, unit_diag=False, left=True,
                policy=policy, registry=registry)


def potrs(l: torch.Tensor, rhs: torch.Tensor, policy: Optional[str] = None,
          registry=None) -> torch.Tensor:
    """Solve L L^T X = B from a Cholesky factor L; rhs is (n, k). L^T is
    made contiguous so that the upper solve's GEMM updates read rows of
    unit stride (the ``gemv`` variant, not ``simt``)."""
    y = trsm(l, rhs, lower=True, unit_diag=False, left=True, policy=policy,
             registry=registry)
    return trsm(l.mT.contiguous(), y, lower=False, unit_diag=False,
                left=True, policy=policy, registry=registry)


def geqrs(packed: torch.Tensor, tau: torch.Tensor, rhs: torch.Tensor,
          policy: Optional[str] = None, registry=None) -> torch.Tensor:
    """Least-squares X = R^{-1} (Q^T B)[:n] from a packed :func:`geqrf`
    result of an (m, n) matrix with m >= n; rhs is (m, k). Only Q's first
    n columns are formed: the rest meet rows of Q^T B that the solve
    drops."""
    n = packed.shape[-1]
    q = q_from_geqrf(packed, tau, n)
    qtb = q.mT @ rhs                # plain PyTorch, as the reference's jnp
    r = torch.triu(packed)[..., :n, :n]
    return trsm(r, qtb, lower=False, unit_diag=False, left=True,
                policy=policy, registry=registry)


def gesv(a: torch.Tensor, b: torch.Tensor, block: Optional[int] = None,
         policy: Optional[str] = None, registry=None) -> torch.Tensor:
    """Solve A X = B via LU with partial pivoting (LAPACK DGESV); b is
    (n,) or (n, k) and X has its shape."""
    pol = resolve_policy(policy)
    packed, piv = getrf(a, block=block, policy=pol, registry=registry)
    rhs = b if b.ndim == 2 else b[:, None]
    x = getrs(packed, piv, rhs, policy=pol, registry=registry)
    return x if b.ndim == 2 else x[:, 0]


def lstsq_qr(a: torch.Tensor, b: torch.Tensor, block: Optional[int] = None,
             policy: Optional[str] = None, registry=None) -> torch.Tensor:
    """Least squares min ||A x - b|| via QR, x = R^{-1} Q^T b, for an
    (m, n) A with m >= n and full column rank; b is (m,) or (m, k) and x
    is (n,) or (n, k)."""
    pol = resolve_policy(policy)
    packed, tau = geqrf(a, block=block, policy=pol, registry=registry)
    rhs = b if b.ndim == 2 else b[:, None]
    x = geqrs(packed, tau, rhs, policy=pol, registry=registry)
    return x if b.ndim == 2 else x[:, 0]
