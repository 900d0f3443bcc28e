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
