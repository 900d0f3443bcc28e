"""GEQRF - Householder QR, unblocked and blocked (compact WY).

Port of ``repro.lapack.qr``, the paper's section-4.2 workload: the panel
carries the serial sqrt (column norm) -> div (vector scale) hazard chain,
the trailing update is GEMM. The blocked form makes that split explicit:
the panels run eagerly, column by column, in plain PyTorch (as the
reference's are plain jnp), and the two large products of each trailing
update go through :func:`repro_torch.blas.level3.gemm` onto B1.

Differences of form from the reference, none of which changes the result
for finite input:

* The drivers update one private copy of the input in place, where the
  reference builds a new array per update.
* The reference masks its Householder arithmetic to rows >= row0 at full
  height; here every column step slices rows >= row0 instead (the masked
  rows hold exact zeros of v and are left unchanged). Sums then run over
  fewer terms, so values agree up to reassociation.
* The trailing update reads V and C from row j0 down: V's rows above its
  panel are exact zeros, so the rows of C above j0 are unchanged. V^T is
  built as its own contiguous (nb x rows) tensor, so both products take
  the dtype's tiled B1 variant (a transposed view would go to ``simt``).
* :func:`q_from_geqrf` applies reflector k to ``Q[k:, k:]`` only (as
  LAPACK's DORG2R does): while the reflectors are applied in reverse, the
  columns of Q left of k are still unit vectors on rows >= k, so the rest
  of the reference's full-size update adds exact zeros. It can stop at the
  first ``ncols`` columns, which left-multiplication leaves independent.

Every function here takes one matrix or a batch (B, m, n) with (B, k)
taus: the batch runs in lockstep (the reference ``vmap``s the 2-D
driver), each Householder column one set of launches for all items (the
rank-1 updates batched with ``baddbmm_``) and each trailing product one
B1 launch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import obs as _obs
from repro_torch.blas.level3 import gemm
from repro_torch.lapack.cholesky import default_block
from repro_torch.tune.policy import resolve_policy


def _house_column(a: torch.Tensor, k: int,
                  row0: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Householder reflector for column ``k`` of ``a`` (or of each item),
    rows >= row0.

    Returns (v, tau) with v the reflector's rows row0.. (v[0] = 1; the
    reference returns it at full height, zeros above) and tau a 0-d
    tensor, (B,) for a batch: H = I - tau v v^T maps the column to
    -sign(x0) ||x|| e_row0. No host synchronisation: every scalar stays on
    a's device.
    """
    x = a[..., row0:, k]
    # not vector_norm: it rescales
    normx = torch.sqrt(torch.sum(x * x) if x.ndim == 1
                       else torch.sum(x * x, -1))
    x0 = x[..., 0]
    alpha = x0 + torch.where(x0 >= 0, normx, -normx)   # sign +1 at x0 == 0
    safe = alpha.abs() > torch.finfo(a.dtype).tiny
    alpha = torch.where(safe, alpha, torch.ones_like(alpha))
    v = torch.cat([torch.ones_like(x[..., :1]),
                   x[..., 1:] / alpha.unsqueeze(-1)], -1)
    vv = torch.sum(v * v) if v.ndim == 1 else torch.sum(v * v, -1)
    tau = torch.where(safe & (normx > 0), 2.0 / vv, torch.zeros_like(alpha))
    return v, tau


def _reflect(block: torch.Tensor, v: torch.Tensor,
             tau: torch.Tensor) -> None:
    """block <- (I - tau v v^T) block in place, for one block or each item
    of a batch (v (B, rows), tau (B,)): the rank-1 update ``addr_``, or
    its batched form ``baddbmm_``."""
    if v.ndim == 1:
        block.addr_(v, tau * (v @ block), alpha=-1)
    else:
        w = tau.unsqueeze(-1) * (v.unsqueeze(-2) @ block).squeeze(-2)
        block.baddbmm_(v.unsqueeze(-1), w.unsqueeze(-2), alpha=-1)


def _factor_columns(a: torch.Tensor, j0: int, nb: int,
                    col_end: int) -> torch.Tensor:
    """Householder steps for columns j0 .. j0+nb-1 of ``a`` (or of each
    item) in place, each reflector applied to the columns from its own up
    to ``col_end``; the reflector tails are stored below the diagonal.
    Returns the nb taus ((B, nb) for a batch)."""
    tau = torch.zeros((*a.shape[:-2], nb), dtype=a.dtype, device=a.device)
    for k in range(nb):
        c = j0 + k
        v, tk = _house_column(a, c, c)
        _reflect(a[..., c:, c:col_end], v, tk)
        a[..., c + 1:, c] = v[..., 1:]
        tau[..., k] = tk
    return tau


def geqrf_unblocked(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unblocked Householder QR of one (m, n) matrix (or a batch) in
    LAPACK packed layout: (packed, tau) with R on and above the diagonal,
    the reflector tails below it, and tau the min(m, n) reflector
    scales."""
    a = a.clone()
    return a, _factor_columns(a, 0, min(a.shape[-2:]), a.shape[-1])


def _larft(v: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Forward compact-WY T factor: Q = I - V T V^T (T upper triangular;
    one per item of a batch).

    Column k of V^T V is the reference's per-step ``v.T @ v[:, k]``; it is
    formed once (plain PyTorch, as the reference's is plain jnp)."""
    nb = tau.shape[-1]
    g = v.mT @ v
    t = torch.zeros((*v.shape[:-2], nb, nb), dtype=v.dtype, device=v.device)
    for k in range(nb):
        if v.ndim == 2:
            t[:k, k] = -tau[k] * (t[:k, :k] @ g[:k, k])
        else:
            t[:, :k, k] = -tau[:, k, None] * (t[:, :k, :k]
                                              @ g[:, :k, k, None])[..., 0]
        t[..., k, k] = tau[..., k]
    return t


def wy_operands(a: torch.Tensor, j0: int, nb: int, tau: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """The trailing update's operands after the panel at column j0 of the
    packed ``a`` (one matrix or a batch), as :func:`geqrf` hands them
    over: (V^T as its own contiguous (nb, m - j0) tensor, V, the
    compact-WY T, the window C = a[j0:, j0 + nb:] of ``a``), each with the
    batch axis for a batch."""
    v = torch.tril(a[..., j0:, j0:j0 + nb], -1)
    v.diagonal(dim1=-2, dim2=-1).fill_(1)
    return v.mT.contiguous(), v, _larft(v, tau), a[..., j0:, j0 + nb:]


def geqrf(a: torch.Tensor, block: Optional[int] = None,
          policy: Optional[str] = None,
          registry=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked Householder QR, compact WY (LAPACK DGEQRF).

    ``block=None`` takes the model's panel width for the ambient machine
    of a's device. Each trailing update C <- C - V T^T (V^T C) runs its
    two large products on the GEMM path under ``policy`` (the small
    T^T W in plain PyTorch, as the reference). Returns (packed, tau) with
    the contract of :func:`geqrf_unblocked`. A batch (B, m, n) runs in
    lockstep, two B1 launches per trailing update for all its items.
    """
    pol = resolve_policy(policy)
    m, n = a.shape[-2:]
    kmax = min(m, n)
    if block is None:
        block = default_block(kmax, "geqrf", a.dtype, a.device)
    if kmax <= block:
        return geqrf_unblocked(a)
    a = a.clone()
    items = a.shape[0] if a.ndim == 3 else 1
    taus = []
    for j0 in range(0, kmax, block):
        nb = min(block, kmax - j0)
        with _obs.span("geqrf.panel", cat="panel", j0=j0, nb=nb,
                       flops=items * 2 * (m - j0) * nb * nb):
            tau = _factor_columns(a, j0, nb, j0 + nb)
        taus.append(tau)
        if j0 + nb < n:
            rest = n - j0 - nb              # trailing columns
            with _obs.span("geqrf.trailing", cat="trailing", j0=j0, nb=nb,
                           flops=items * (4 * m * nb * rest
                                          + 2 * nb * nb * rest)):
                vt, v, t, c = wy_operands(a, j0, nb, tau)
                w = gemm(vt, c, policy=pol,
                         registry=registry)       # (nb, rest)    GEMM
                w = t.mT @ w                      # small (nb x nb) GEMM
                c -= gemm(v, w, policy=pol, registry=registry)   # GEMM
    return a, torch.cat(taus, -1)


def q_from_geqrf(packed: torch.Tensor, tau: torch.Tensor,
                 ncols: Optional[int] = None) -> torch.Tensor:
    """The orthogonal Q of a packed :func:`geqrf` result (one, or each
    item of a batch), reflectors applied in reverse (LAPACK DORGQR): all m
    columns by default (the reference's (m, m) Q), or the first
    ``ncols``."""
    m = packed.shape[-2]
    ncols = m if ncols is None else ncols
    q = torch.eye(m, ncols, dtype=packed.dtype, device=packed.device)
    q = q.repeat(*packed.shape[:-2], 1, 1)
    one = torch.ones((*packed.shape[:-2], 1), dtype=packed.dtype,
                     device=packed.device)
    for k in reversed(range(min(tau.shape[-1], ncols))):
        v = torch.cat([one, packed[..., k + 1:, k]], -1)
        _reflect(q[..., k:, k:], v, tau[..., k])
    return q


def qr(a: torch.Tensor, block: Optional[int] = None,
       policy: Optional[str] = None,
       registry=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Thin QR: (Q (m, min(m, n)), R (min(m, n), n)) from :func:`geqrf` +
    :func:`q_from_geqrf`; same block/policy contract as :func:`geqrf`."""
    packed, tau = geqrf(a, block=block, policy=policy, registry=registry)
    kmin = min(a.shape)
    return q_from_geqrf(packed, tau, kmin), torch.triu(packed)[:kmin, :]
