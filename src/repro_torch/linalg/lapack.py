"""dtype-generic LAPACK front-end, routed by the active ExecutionContext.

Port of ``repro.linalg.lapack`` for ``cholesky``, ``lu`` and ``solve``:
one matrix (2-D) or a leading batch axis (3-D, a loop over the 2-D
driver). QR, least squares and the batched drivers are later work.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.lapack import cholesky as _chol
from repro_torch.lapack import lu as _lu
from repro_torch.lapack import solve as _solve
from repro_torch.linalg.blas import (_batched, _cast, _dtype_name, _kw,
                                     _nbytes, _operands, _routine, _shape)
from repro_torch.linalg.context import current


# Leading-order LAPACK flop counts (the reference's accounting).

def _potrf_flops(n):
    return n ** 3 // 3


def _getrf_flops(m, n):
    k = min(m, n)
    return m * n * k - (m + n) * k * k // 2 + k ** 3 // 3


def _factor_info(flops_fn):
    """Factorization info factory; ``flops_fn(m, n)`` prices one item."""
    def info(a, *args, **kw):
        s = _shape(a)
        batch = s[0] if len(s) == 3 else 1
        return {"shape": list(s), "dtype": _dtype_name(a),
                "flops": batch * flops_fn(s[-2], s[-1]),
                "bytes": _nbytes(a)}
    return info


def _solve_info(a, b, *args, **kw):
    sa, sb = _shape(a), _shape(b)
    batch = sa[0] if len(sa) == 3 else 1
    n = sa[-1]
    nrhs = sb[-1] if len(sb) - (len(sa) - 2) >= 2 else 1
    flops = _getrf_flops(sa[-2], n) + 2 * n * n * nrhs
    return {"shape": list(sa), "dtype": _dtype_name(a, b),
            "flops": batch * flops, "bytes": _nbytes(a, b)}


@_routine("cholesky", _factor_info(lambda m, n: _potrf_flops(n)))
def cholesky(a, block: Optional[int] = None, dtype=None,
             context=None, fuse: Optional[bool] = None) -> torch.Tensor:
    """Lower-triangular Cholesky factor L (A = L L^T) of an SPD matrix, or
    of each matrix of a (B, n, n) batch. ``fuse`` controls the trsm+gemm
    trailing chain: ``None`` defers to the chain plan under the kernel
    policies, ``False`` forces the staged path, ``True`` forces fusion.
    Non-SPD input produces NaNs, LAPACK-style."""
    ctx = current(context)
    store, (a_,) = _operands(ctx, dtype, a)
    core = lambda m: _chol.potrf(m, block=block, fuse=fuse, **_kw(ctx))
    out = _batched(core, a_) if a_.ndim == 3 else core(a_)
    return _cast(out, store)


@_routine("lu", _factor_info(_getrf_flops))
def lu(a, block: Optional[int] = None, dtype=None, context=None,
       fuse: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """LU with partial pivoting: (packed L\\U, int32 ipiv); a 3-D input
    returns ((B, m, n) packed, (B, k) ipiv). ``fuse`` as in
    :func:`cholesky`."""
    ctx = current(context)
    store, (a_,) = _operands(ctx, dtype, a)
    core = lambda m: _lu.getrf(m, block=block, fuse=fuse, **_kw(ctx))
    if a_.ndim == 3:
        packed, piv = zip(*(core(m) for m in a_))
        return _cast(torch.stack(packed), store), torch.stack(piv)
    packed, piv = core(a_)
    return _cast(packed, store), piv


@_routine("solve", _solve_info)
def solve(a, b, block: Optional[int] = None, dtype=None,
          context=None) -> torch.Tensor:
    """Solve A X = B via pivoted LU (LAPACK GESV); a 3-D ``a`` solves each
    system of the batch (``b`` (B, n) or (B, n, k))."""
    ctx = current(context)
    store, (a_, b_) = _operands(ctx, dtype, a, b)
    core = lambda m, r: _solve.gesv(m, r, block=block, **_kw(ctx))
    out = _batched(core, a_, b_) if a_.ndim == 3 else core(a_, b_)
    return _cast(out, store)
