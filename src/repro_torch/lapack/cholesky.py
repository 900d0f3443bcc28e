"""POTRF - Cholesky factorization (lower), unblocked and blocked.

Port of ``repro.lapack.cholesky``. Blocked right-looking form:
POTRF(diagonal block) + the TRSM->SYRK trailing pair, which resolves as
the ``"trsm+gemm"`` chain in :mod:`repro_torch.tune.dispatch` - the fused
B2 kernel when the chain plan (or ``fuse=True``) says so, else the staged
TRSM + GEMM kernel. The default panel width comes from
:func:`repro_torch.core.codesign.plan_factorization`.

The reference's arrays are immutable and every block update builds a new
array; here the drivers work on one private copy of the input and write
each factored block back into it in place.

Every function here takes one (n, n) matrix or a batch (B, n, n): the
batch runs in lockstep (the reference ``vmap``s the 2-D driver), each
panel column one set of launches for all items and each trailing update
one B2 launch, with the NaNs of a non-SPD item kept in that item.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import arch as _arch
from repro_torch import obs as _obs
from repro_torch.core.codesign import plan_factorization
from repro_torch.tune import dispatch as _tune
from repro_torch.tune.policy import resolve_policy


def default_block(n: int, kind: str, dtype=None, device=None) -> int:
    """Model-picked panel width NB for a size-n factorization, priced for
    the ambient machine of ``device``."""
    return plan_factorization(n, kind=kind, dtype=dtype,
                              machine=_arch.resolve_machine(None, device)).block


def potrf_unblocked(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Cholesky of one SPD matrix (or of each item of a
    batch), column by column (the serial sqrt-then-div chain). Non-SPD
    input produces NaNs, LAPACK-style."""
    a = a.clone()
    for k in range(a.shape[-1]):
        d = torch.sqrt(a[..., k, k])
        col = a[..., k + 1:, k] / d.unsqueeze(-1)
        a[..., k, k] = d
        a[..., k + 1:, k] = col
        # trailing rank-1 update (both triangles, as the reference)
        a[..., k + 1:, k + 1:] -= col.unsqueeze(-1) * col.unsqueeze(-2)
    return torch.tril(a)


def potrf(a: torch.Tensor, block: Optional[int] = None,
          policy: Optional[str] = None, registry=None,
          fuse: Optional[bool] = None) -> torch.Tensor:
    """Blocked right-looking POTRF: panel = hazards, trailing = kernels.

    ``fuse``: ``None`` defers to the ``trsm+gemm`` chain plan under the
    kernel policies, ``False`` forces the staged TRSM + GEMM, ``True``
    forces the fused kernel whenever the policy reaches the kernels.
    Returns the (n, n) lower-triangular L with A = L L^T (a batch (B, n, n)
    gives (B, n, n), the items in lockstep).
    """
    pol = resolve_policy(policy)
    n = a.shape[-1]
    if block is None:
        block = default_block(n, "potrf", a.dtype, a.device)
    if n <= block:
        return potrf_unblocked(a)
    a = a.clone()
    items = a.shape[0] if a.ndim == 3 else 1
    for j0 in range(0, n, block):
        nb = min(block, n - j0)
        with _obs.span("potrf.panel", cat="panel", j0=j0, nb=nb,
                       flops=items * (nb ** 3 // 3)):
            a[..., j0:j0 + nb, j0:j0 + nb] = potrf_unblocked(
                a[..., j0:j0 + nb, j0:j0 + nb])
        if j0 + nb < n:
            r = n - j0 - nb                 # trailing-block side length
            with _obs.span("potrf.trailing", cat="trailing", j0=j0, nb=nb,
                           flops=items * (nb * nb * r + 2 * r * r * nb)):
                # X = L11^{-1} A21^T then A22 -= X^T X (L21 = X^T); the
                # kernels read the strided views in place
                x, c_out = _tune.dispatch(
                    "trsm+gemm", a[..., j0:j0 + nb, j0:j0 + nb],
                    a[..., j0 + nb:, j0:j0 + nb].mT, None,
                    a[..., j0 + nb:, j0 + nb:], form="syrk",
                    unit_diag=False, fuse=fuse, policy=pol,
                    registry=registry)
                a[..., j0 + nb:, j0:j0 + nb] = x.mT
                a[..., j0 + nb:, j0 + nb:] = c_out
    return torch.tril(a)
