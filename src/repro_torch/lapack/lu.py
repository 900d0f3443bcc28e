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

Every function here takes one matrix or a batch (B, n, m) with (B, k)
pivots: the batch runs in lockstep (the reference ``vmap``s the 2-D
driver), the pivot search and the row swaps per item on the device, each
trailing update one B2 launch, a zero pivot kept in its item.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch import obs as _obs
from repro_torch.lapack.cholesky import default_block
from repro_torch.tune import dispatch as _tune
from repro_torch.tune.policy import resolve_policy


def _pivot_step(a: torch.Tensor, k: int, col_end: int) -> torch.Tensor:
    """One column of partial-pivoting elimination on ``a`` (one matrix or
    each item of a batch) in place: pick the largest |a[k:, k]|, swap that
    row with row k across the full width, scale the column below the pivot
    and subtract the rank-1 update from columns (k, col_end). Returns the
    pivot row as an int64 tensor, 0-d or (B,) (no host
    synchronisation)."""
    p = k + torch.argmax(a[..., k:, k].abs(), dim=-1)
    rows = torch.stack([torch.full_like(p, k), p], -1)
    if a.ndim == 2:
        a.index_copy_(0, rows, a.index_select(0, rows.flip(0)))
    else:
        # each item's two rows, gathered and written back swapped
        idx = rows.unsqueeze(-1).expand(-1, -1, a.shape[-1])
        a.scatter_(-2, idx, torch.gather(a, -2, idx.flip(-2)))
    pivval = a[..., k, k]
    safe = torch.where(pivval.abs() > 0, pivval, torch.ones_like(pivval))
    l = a[..., k + 1:, k] / safe.unsqueeze(-1)
    a[..., k + 1:, k] = l
    a[..., k + 1:, k + 1:col_end] -= \
        l.unsqueeze(-1) * a[..., k, None, k + 1:col_end]
    return p


def getrf_unblocked(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unblocked LU with partial pivoting of one (n, m) matrix (or a batch
    (B, n, m)): (packed L\\U, int32 piv of length min(n, m), per item)."""
    a = a.clone()
    kmax = min(a.shape[-2:])
    piv = torch.zeros((*a.shape[:-2], kmax), dtype=torch.int32,
                      device=a.device)
    for k in range(kmax):
        piv[..., k] = _pivot_step(a, k, a.shape[-1])
    return a, piv


def getrf(a: torch.Tensor, block: Optional[int] = None,
          policy: Optional[str] = None, registry=None,
          fuse: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked right-looking LU with partial pivoting (LAPACK DGETRF).

    ``fuse`` as in :func:`repro_torch.lapack.cholesky.potrf`. Returns
    (packed, piv) with the same contract as :func:`getrf_unblocked`.
    """
    pol = resolve_policy(policy)
    n, nc = a.shape[-2:]
    kmax = min(n, nc)
    if block is None:
        block = default_block(kmax, "getrf", a.dtype, a.device)
    if kmax <= block:
        return getrf_unblocked(a)
    a = a.clone()
    lead = a.shape[:-2]
    items = a.shape[0] if a.ndim == 3 else 1
    pivs: List[torch.Tensor] = []
    for j0 in range(0, kmax, block):
        nb = min(block, kmax - j0)
        piv = torch.zeros((*lead, nb), dtype=torch.int32, device=a.device)
        with _obs.span("getrf.panel", cat="panel", j0=j0, nb=nb,
                       flops=items * (n - j0) * nb * nb):
            for kk in range(nb):
                piv[..., kk] = _pivot_step(a, j0 + kk, j0 + nb)
        pivs.append(piv)
        if j0 + nb < nc:
            mr, ncr = n - j0 - nb, nc - j0 - nb     # trailing block dims
            with _obs.span("getrf.trailing", cat="trailing", j0=j0, nb=nb,
                           flops=items * (nb * nb * ncr + 2 * mr * ncr * nb)):
                # U12 = L11^{-1} A12 ; A22 -= L21 U12
                u12, c_out = _tune.dispatch(
                    "trsm+gemm", a[..., j0:j0 + nb, j0:j0 + nb],
                    a[..., j0:j0 + nb, j0 + nb:], a[..., j0 + nb:, j0:j0 + nb],
                    a[..., j0 + nb:, j0 + nb:], form="lu", unit_diag=True,
                    fuse=fuse, policy=pol, registry=registry)
                a[..., j0:j0 + nb, j0 + nb:] = u12
                a[..., j0 + nb:, j0 + nb:] = c_out
    return a, torch.cat(pivs, -1)


def _permutation(piv: torch.Tensor, n: int) -> List:
    """Row order after applying the swaps of ``piv`` in sequence: one list
    for (k,) pivots, one per item for (B, k) (one host read of all the
    pivots, then plain Python)."""
    def order(swaps):
        perm = list(range(n))
        for k, p in enumerate(swaps):
            perm[k], perm[p] = perm[p], perm[k]
        return perm
    got = piv.tolist()
    return order(got) if piv.ndim == 1 else [order(s) for s in got]


def _rows(t: torch.Tensor, order: List) -> torch.Tensor:
    """The rows of ``t`` (or of each item) in ``order`` (a list, or one
    list per item)."""
    idx = torch.tensor(order, device=t.device)
    if idx.ndim == 1:
        return t[idx]
    return torch.gather(t, 1, idx.unsqueeze(-1).expand(-1, -1, t.shape[-1]))


def apply_ipiv(b: torch.Tensor, piv: torch.Tensor) -> torch.Tensor:
    """Apply the pivot sequence (forward) to the rows of b: b <- P b (for
    a batch, b (B, n, k) and piv (B, k))."""
    return _rows(b, _permutation(piv, b.shape[piv.ndim - 1]))


def lu_reconstruct(packed: torch.Tensor, piv: torch.Tensor) -> torch.Tensor:
    """P^T L U from a packed :func:`getrf` result (square layout; one
    matrix or a batch) - the testing oracle: it should equal the factored
    matrix."""
    n = packed.shape[-2]
    lu = (torch.tril(packed, -1) + torch.eye(n, dtype=packed.dtype,
                                             device=packed.device)) \
        @ torch.triu(packed)
    perm = _permutation(piv, n)
    inv = []
    for order in (perm if piv.ndim == 2 else [perm]):
        inv.append([0] * n)
        for i, p in enumerate(order):
            inv[-1][p] = i
    return _rows(lu, inv if piv.ndim == 2 else inv[0])
