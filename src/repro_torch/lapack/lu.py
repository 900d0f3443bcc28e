"""GETRF - LU with partial pivoting, unblocked and blocked.

Port of ``repro.lapack.lu``: the column-scaling divisions are the serial
divider stream; the trailing update is the ``"trsm+gemm"`` chain (B2
fused, or the staged TRSM + B1 GEMM). Pivots are int32, LAPACK ipiv
semantics, 0-based.

Two differences of form from the reference, neither of which changes the
result for finite input:

* The drivers update one private copy of the input in place, where the
  reference builds a new array per block update.
* The panel's rank-1 update touches only the rows below the pivot and the
  panel's own columns. The reference subtracts an update masked to those
  columns from the whole ``n x nc`` matrix, i.e. exact zeros elsewhere;
  restricting it spares eager PyTorch about n^3 element operations.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch import obs as _obs
from repro_torch.lapack.cholesky import default_block
from repro_torch.tune import dispatch as _tune
from repro_torch.tune.policy import resolve_policy


def _pivot_step(a: torch.Tensor, k: int, col_end: int) -> torch.Tensor:
    """One column of partial-pivoting elimination on ``a`` in place:
    pick the largest |a[k:, k]|, swap that row with row k across the full
    width, scale the column below the pivot and subtract the rank-1 update
    from columns (k, col_end). Returns the pivot row as a 0-d int64
    tensor (no host synchronisation)."""
    p = k + torch.argmax(a[k:, k].abs())
    rows = torch.stack([torch.full_like(p, k), p])
    a.index_copy_(0, rows, a.index_select(0, rows.flip(0)))
    pivval = a[k, k]
    safe = torch.where(pivval.abs() > 0, pivval, torch.ones_like(pivval))
    l = a[k + 1:, k] / safe
    a[k + 1:, k] = l
    a[k + 1:, k + 1:col_end] -= torch.outer(l, a[k, k + 1:col_end])
    return p


def getrf_unblocked(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unblocked LU with partial pivoting of one (n, m) matrix: (packed
    L\\U, int32 piv of length min(n, m))."""
    a = a.clone()
    kmax = min(a.shape)
    piv = torch.zeros((kmax,), dtype=torch.int32, device=a.device)
    for k in range(kmax):
        piv[k] = _pivot_step(a, k, a.shape[1])
    return a, piv


def getrf(a: torch.Tensor, block: Optional[int] = None,
          policy: Optional[str] = None, registry=None,
          fuse: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked right-looking LU with partial pivoting (LAPACK DGETRF).

    ``fuse`` as in :func:`repro_torch.lapack.cholesky.potrf`. Returns
    (packed, piv) with the same contract as :func:`getrf_unblocked`.
    """
    pol = resolve_policy(policy)
    n, nc = a.shape
    kmax = min(n, nc)
    if block is None:
        block = default_block(kmax, "getrf", a.dtype, a.device)
    if kmax <= block:
        return getrf_unblocked(a)
    a = a.clone()
    pivs: List[torch.Tensor] = []
    for j0 in range(0, kmax, block):
        nb = min(block, kmax - j0)
        piv = torch.zeros((nb,), dtype=torch.int32, device=a.device)
        with _obs.span("getrf.panel", cat="panel", j0=j0, nb=nb,
                       flops=(n - j0) * nb * nb):
            for kk in range(nb):
                piv[kk] = _pivot_step(a, j0 + kk, j0 + nb)
        pivs.append(piv)
        if j0 + nb < nc:
            mr, ncr = n - j0 - nb, nc - j0 - nb     # trailing block dims
            with _obs.span("getrf.trailing", cat="trailing", j0=j0, nb=nb,
                           flops=nb * nb * ncr + 2 * mr * ncr * nb):
                # U12 = L11^{-1} A12 ; A22 -= L21 U12
                u12, c_out = _tune.dispatch(
                    "trsm+gemm", a[j0:j0 + nb, j0:j0 + nb],
                    a[j0:j0 + nb, j0 + nb:], a[j0 + nb:, j0:j0 + nb],
                    a[j0 + nb:, j0 + nb:], form="lu", unit_diag=True,
                    fuse=fuse, policy=pol, registry=registry)
                a[j0:j0 + nb, j0 + nb:] = u12
                a[j0 + nb:, j0 + nb:] = c_out
    return a, torch.cat(pivs)


def _permutation(piv: torch.Tensor, n: int) -> List[int]:
    """Row order after applying the swaps of ``piv`` in sequence (one host
    read of the pivots, then plain Python)."""
    perm = list(range(n))
    for k, p in enumerate(piv.tolist()):
        perm[k], perm[p] = perm[p], perm[k]
    return perm


def apply_ipiv(b: torch.Tensor, piv: torch.Tensor) -> torch.Tensor:
    """Apply the pivot sequence (forward) to the rows of b: b <- P b."""
    perm = _permutation(piv, b.shape[0])
    return b[torch.tensor(perm, device=b.device)]


def lu_reconstruct(packed: torch.Tensor, piv: torch.Tensor) -> torch.Tensor:
    """P^T L U from a packed :func:`getrf` result (square layout) - the
    testing oracle: it should equal the factored matrix."""
    n = packed.shape[0]
    lu = (torch.tril(packed, -1) + torch.eye(n, dtype=packed.dtype,
                                             device=packed.device)) \
        @ torch.triu(packed)
    perm = _permutation(piv, n)
    inv = [0] * n
    for i, p in enumerate(perm):
        inv[p] = i
    return lu[torch.tensor(inv, device=packed.device)]
