"""Level-2 BLAS cores (port of ``repro.blas.level2``).

``gemv`` shares the BLAS-3 policy mechanism: its matvec core resolves
through :mod:`repro_torch.tune.dispatch` (``reference`` = plain PyTorch;
``model`` / ``tuned`` run op(A) x on the GEMM kernel as an (m, n) x
(n, 1) product). ``ger`` and ``trsv`` are plain PyTorch, as in the
reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.blas._deprecated import compat, warn_once
from repro_torch.blas.level3 import _trsm_unblocked
from repro_torch.tune import dispatch as _tune


def gemv(a: torch.Tensor, x: torch.Tensor, beta=0.0, y=None,
         alpha=1.0, trans: bool = False, policy: Optional[str] = None,
         registry=None) -> torch.Tensor:
    """y <- alpha*op(A) x + beta*y (BLAS GEMV core)."""
    ax = _tune.dispatch("gemv", a, x, trans=trans, policy=policy,
                        registry=registry)
    out = alpha * ax
    if y is not None:
        out = out + beta * y
    return out


def ger(alpha, x: torch.Tensor, y: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """A <- alpha * x y^T + A (BLAS GER rank-1 update)."""
    return a + alpha * torch.outer(x, y)


def trsv(a: torch.Tensor, b: torch.Tensor, lower: bool = True,
         unit_diag: bool = False) -> torch.Tensor:
    """Solve op(T) x = b for triangular T by row-sequential substitution
    (the divider-pipe hazard chain); b is (n,) or (n, k)."""
    return _trsm_unblocked(a, b, lower=lower, unit_diag=unit_diag)


# -------------------------- deprecated d-prefixed shims ----------------------
# Old kwargs map to a per-call compat context (no ``interpret``: the
# operands' device decides where the port runs).

def dgemv(a, x, beta=0.0, y=None, alpha=1.0, trans: bool = False,
          policy: Optional[str] = None, use_kernel: Optional[bool] = None,
          registry=None, use_pallas: Optional[bool] = None):
    """Deprecated alias of :func:`repro_torch.linalg.gemv`."""
    warn_once("dgemv", "gemv")
    linalg, ctx = compat(policy, use_kernel, registry, use_pallas)
    return linalg.gemv(a, x, y=y, alpha=alpha, beta=beta, trans=trans,
                       context=ctx)


def dger(alpha, x, y, a):
    """Deprecated alias of :func:`repro_torch.linalg.ger`."""
    warn_once("dger", "ger")
    linalg, ctx = compat()
    return linalg.ger(alpha, x, y, a, context=ctx)


def dtrsv(a, b, lower: bool = True, unit_diag: bool = False):
    """Deprecated alias of :func:`repro_torch.linalg.trsv`."""
    warn_once("dtrsv", "trsv")
    linalg, ctx = compat()
    return linalg.trsv(a, b, lower=lower, unit_diag=unit_diag, context=ctx)
