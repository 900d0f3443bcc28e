"""dtype-generic LAPACK front-end, routed by the active ExecutionContext.

Port of ``repro.linalg.lapack``. ``cholesky`` / ``lu`` / ``qr`` /
``solve`` / ``lstsq`` accept one matrix (2-D) or a leading batch axis
(3-D, delegated to the batched drivers as in the reference); the explicit
``batched_*`` forms return the shared
:class:`repro_torch.lapack.batched.FactorizationResult`. When the context
carries a mesh, the batched forms (and so the 3-D forms of ``cholesky`` /
``lu`` / ``qr`` / ``solve`` / ``lstsq``) route to the batch-sharded drivers
of :mod:`repro_torch.lapack.distributed`; single-matrix factorizations run
locally under any context, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.lapack import batched as _batched
from repro_torch.lapack import cholesky as _chol
from repro_torch.lapack import lu as _lu
from repro_torch.lapack import qr as _qr
from repro_torch.lapack import solve as _solve
from repro_torch.lapack.batched import FactorizationResult
from repro_torch.linalg.blas import (_cast, _dtype_name, _kw, _nbytes,
                                     _operands, _routine, _shape)
from repro_torch.linalg.context import current, resolved_mesh


def _batched_route(ctx, kind: str, a, **kw):
    """The batched driver ``kind`` ("potrf" / "getrf" / "geqrf"), on the
    context's mesh when it carries one."""
    mesh = resolved_mesh(ctx)
    if mesh is not None:
        from repro_torch.lapack import distributed as _dist
        return getattr(_dist, "batched_" + kind)(a, mesh, **kw)
    return getattr(_batched, "batched_" + kind)(a, **kw)


# Leading-order LAPACK flop counts (the reference's accounting).

def _potrf_flops(n):
    return n ** 3 // 3


def _getrf_flops(m, n):
    k = min(m, n)
    return m * n * k - (m + n) * k * k // 2 + k ** 3 // 3


def _geqrf_flops(m, n):
    k = min(m, n)
    return 2 * m * n * k - k * k * (m + n) + 2 * k ** 3 // 3


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


def _lstsq_info(a, b, *args, **kw):
    sa, sb = _shape(a), _shape(b)
    batch = sa[0] if len(sa) == 3 else 1
    m, n = sa[-2], sa[-1]
    nrhs = sb[-1] if len(sb) - (len(sa) - 2) >= 2 else 1
    flops = _geqrf_flops(m, n) + 2 * n * n * nrhs
    return {"shape": list(sa), "dtype": _dtype_name(a, b),
            "flops": batch * flops, "bytes": _nbytes(a, b)}


def _batched_solve_info(res, b, *args, **kw):
    sf, sb = _shape(res.factors), _shape(b)
    batch = sf[0] if len(sf) == 3 else 1
    n = sf[-1]
    nrhs = sb[-1] if len(sb) >= 3 else 1
    return {"shape": list(sf), "dtype": _dtype_name(res.factors, b),
            "flops": batch * 2 * n * n * nrhs,
            "bytes": _nbytes(res.factors, b)}


def _cast_result(res: FactorizationResult, to) -> FactorizationResult:
    return dataclasses.replace(res, factors=_cast(res.factors, to),
                               tau=_cast(res.tau, to))


# ------------------------------ factorizations ------------------------------

@_routine("cholesky", _factor_info(lambda m, n: _potrf_flops(n)))
def cholesky(a, block: Optional[int] = None, dtype=None,
             context=None, fuse: Optional[bool] = None) -> torch.Tensor:
    """Lower-triangular Cholesky factor L (A = L L^T) of an SPD matrix; a
    (B, n, n) batch returns the factor batch (via
    :func:`batched_cholesky`; ``fuse`` applies to the 2-D driver only).
    ``fuse`` controls the trsm+gemm trailing chain: ``None`` defers to the
    chain plan under the kernel policies, ``False`` forces the staged
    path, ``True`` forces fusion. Non-SPD input produces NaNs,
    LAPACK-style."""
    ctx = current(context)
    store, (a_,) = _operands(ctx, dtype, a)
    if a_.ndim == 3:
        return _cast(batched_cholesky(a_, block=block, context=ctx).factors,
                     store)
    return _cast(_chol.potrf(a_, block=block, fuse=fuse, **_kw(ctx)), store)


@_routine("lu", _factor_info(_getrf_flops))
def lu(a, block: Optional[int] = None, dtype=None, context=None,
       fuse: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """LU with partial pivoting: (packed L\\U, int32 ipiv); a 3-D input
    returns ((B, m, n) packed, (B, k) ipiv) via :func:`batched_lu`.
    ``fuse`` as in :func:`cholesky` (2-D only)."""
    ctx = current(context)
    store, (a_,) = _operands(ctx, dtype, a)
    if a_.ndim == 3:
        res = batched_lu(a_, block=block, context=ctx)
        return _cast(res.factors, store), res.pivots
    packed, piv = _lu.getrf(a_, block=block, fuse=fuse, **_kw(ctx))
    return _cast(packed, store), piv


@_routine("qr", _factor_info(
    lambda m, n: _geqrf_flops(m, n) + 2 * m * m * min(m, n)))
def qr(a, block: Optional[int] = None, dtype=None,
       context=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Thin QR: (Q (m, min(m, n)), R (min(m, n), n)); a 3-D input returns
    the batched (Q, R) via :func:`batched_qr`, Q formed for the batch in
    lockstep."""
    ctx = current(context)
    store, (a_,) = _operands(ctx, dtype, a)
    if a_.ndim == 3:
        res = batched_qr(a_, block=block, context=ctx)
        kmin = min(a_.shape[1:])
        q = _qr.q_from_geqrf(res.factors, res.tau, kmin)
        r = torch.triu(res.factors)[:, :kmin, :]
        return _cast(q, store), _cast(r, store)
    q, r = _qr.qr(a_, block=block, **_kw(ctx))
    return _cast(q, store), _cast(r, store)


@_routine("solve", _solve_info)
def solve(a, b, block: Optional[int] = None, dtype=None,
          context=None) -> torch.Tensor:
    """Solve A X = B via pivoted LU (LAPACK GESV); a 3-D ``a`` factorizes
    and solves the batch (``b`` (B, n) or (B, n, k)) through
    :func:`batched_lu` + :func:`batched_solve`."""
    ctx = current(context)
    store, (a_, b_) = _operands(ctx, dtype, a, b)
    if a_.ndim == 3:
        res = batched_lu(a_, block=block, context=ctx)
        return _cast(batched_solve(res, b_, context=ctx), store)
    return _cast(_solve.gesv(a_, b_, block=block, **_kw(ctx)), store)


@_routine("lstsq", _lstsq_info)
def lstsq(a, b, block: Optional[int] = None, dtype=None,
          context=None) -> torch.Tensor:
    """Least squares min ||A x - b|| via QR (m >= n, full column rank); a
    3-D ``a`` solves the batch through :func:`batched_qr` +
    :func:`batched_solve`."""
    ctx = current(context)
    store, (a_, b_) = _operands(ctx, dtype, a, b)
    if a_.ndim == 3:
        res = batched_qr(a_, block=block, context=ctx)
        return _cast(batched_solve(res, b_, context=ctx), store)
    return _cast(_solve.lstsq_qr(a_, b_, block=block, **_kw(ctx)), store)


# ------------------------------ batched drivers -----------------------------

@_routine("batched_cholesky", _factor_info(lambda m, n: _potrf_flops(n)))
def batched_cholesky(a, block: Optional[int] = None, dtype=None,
                     context=None) -> FactorizationResult:
    """Cholesky of a (B, n, n) SPD batch -> FactorizationResult("potrf")."""
    ctx = current(context)
    store, (a_,) = _operands(ctx, dtype, a)
    res = _batched_route(ctx, "potrf", a_, block=block, **_kw(ctx))
    return _cast_result(res, store)


@_routine("batched_lu", _factor_info(_getrf_flops))
def batched_lu(a, block: Optional[int] = None, dtype=None,
               context=None) -> FactorizationResult:
    """Pivoted LU of a (B, m, n) batch -> FactorizationResult("getrf")."""
    ctx = current(context)
    store, (a_,) = _operands(ctx, dtype, a)
    res = _batched_route(ctx, "getrf", a_, block=block, **_kw(ctx))
    return _cast_result(res, store)


@_routine("batched_qr", _factor_info(_geqrf_flops))
def batched_qr(a, block: Optional[int] = None, dtype=None,
               context=None) -> FactorizationResult:
    """Householder QR of a (B, m, n) batch -> FactorizationResult("geqrf")."""
    ctx = current(context)
    store, (a_,) = _operands(ctx, dtype, a)
    res = _batched_route(ctx, "geqrf", a_, block=block, **_kw(ctx))
    return _cast_result(res, store)


@_routine("batched_solve", _batched_solve_info)
def batched_solve(res: FactorizationResult, b, dtype=None,
                  context=None) -> torch.Tensor:
    """Solve A_i x_i = b_i from any FactorizationResult (batch-sharded
    under a mesh)."""
    ctx = current(context)
    store, (factors, b_) = _operands(ctx, dtype, res.factors, b)
    res_ = _cast_result(dataclasses.replace(res, factors=factors),
                        factors.dtype)
    mesh = resolved_mesh(ctx)
    if mesh is not None:
        from repro_torch.lapack import distributed as _dist
        return _cast(_dist.batched_solve(res_, b_, mesh, **_kw(ctx)), store)
    return _cast(_batched.batched_solve(res_, b_, **_kw(ctx)), store)
