"""dtype-generic BLAS front-end, routed by the active ExecutionContext.

Port of ``repro.linalg.blas`` (levels 2 and 3). Every routine here:

* places numpy inputs on the context's device and raises on a tensor
  that lies elsewhere (:func:`_place`);
* accepts float32/float64 operands (bfloat16 storage on the kernel paths)
  and an explicit ``dtype=`` cast;
* resolves policy / registry / accumulation dtype / machine from the
  active :class:`repro_torch.linalg.ExecutionContext` (``context=``
  overrides per call);
* takes a leading batch axis on the matrix routines (3-D operands loop
  over the 2-D path - no vmap).

The numeric cores live in :mod:`repro_torch.blas.level2` / ``level3``.
Level 1 and the mesh-routed paths are later work.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch import _dtype
from repro_torch import arch as _arch
from repro_torch import obs as _obs
from repro_torch.blas import level2 as _l2
from repro_torch.blas import level3 as _l3
from repro_torch.linalg.context import (current, resolved_accum_dtype,
                                        resolved_device, resolved_machine,
                                        resolved_obs, resolved_policy,
                                        resolved_registry)


def _routine(op, info=None):
    """Routine wrapper: machine scoping + one obs span per public call.

    The resolved machine (``ctx.machine``, else the ambient machine of the
    context's device: :func:`repro_torch.linalg.context.resolved_machine`)
    becomes the :func:`repro_torch.arch.machine_scope` for the whole call,
    so every nested planner/registry resolution - the trailing updates
    inside a blocked factorization included - sees it. When a trace is
    capturing, the body runs under a ``linalg.<op>`` span annotated by
    ``info(*args, **kw)`` (shapes, dtype, flop/byte counts); with no
    capture active the wrapper goes straight to the body.
    """
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, context=None, **kw):
            ctx = current(context)
            mach = resolved_machine(ctx)
            tr = resolved_obs(ctx)
            if tr is None and not _obs.enabled():
                with _arch.machine_scope(mach):
                    return fn(*args, context=ctx, **kw)
            with contextlib.ExitStack() as st:
                st.enter_context(_arch.machine_scope(mach))
                if tr is None:
                    # ctx.obs=False under an ambient trace: mask capture
                    # for the whole body (nested spans included)
                    st.enter_context(_obs.capture(None))
                    return fn(*args, context=ctx, **kw)
                if tr is not _obs.current_trace():
                    st.enter_context(_obs.capture(tr))
                sp = st.enter_context(_obs.span("linalg." + op,
                                                cat="routine"))
                if info is not None:
                    sp.annotate(**info(*args, **kw))
                return fn(*args, context=ctx, **kw)
        return wrapper
    return deco


# --------------------- span annotation (traced calls only) ------------------

def _shape(x):
    return tuple(int(d) for d in getattr(x, "shape", ()))


def _nbytes(*arrays) -> int:
    """Total operand bytes (operands without shape/dtype count 0)."""
    total = 0
    for x in arrays:
        shp = getattr(x, "shape", None)
        dt = getattr(x, "dtype", None)
        if shp is None or dt is None:
            continue
        total += int(np.prod(shp, dtype=np.int64)) * _dtype.itemsize(dt)
    return total


def _result_dtype(*arrays) -> torch.dtype:
    dts = [_dtype.to_torch(a.dtype) for a in arrays if a is not None]
    return functools.reduce(torch.promote_types, dts)


def _dtype_name(*arrays) -> str:
    return _dtype.name(_result_dtype(*arrays))


def _gemm_info(a, b, c=None, alpha=1.0, beta=0.0, transa=False, transb=False,
               **kw):
    sa, sb = _shape(a), _shape(b)
    batch = sa[0] if len(sa) == 3 else 1
    m = sa[-1] if transa else sa[-2]
    k = sa[-2] if transa else sa[-1]
    n = sb[-2] if transb else sb[-1]
    out_itemsize = _result_dtype(a, b, c).itemsize
    return {"shape": ([m, n, k] if batch == 1 else [batch, m, n, k]),
            "dtype": _dtype_name(a, b, c),
            "flops": 2 * batch * m * n * k,
            "bytes": _nbytes(a, b, c) + batch * m * n * out_itemsize}


def _gemm_bias_act_info(a, b, bias=None, epilogue="none", **kw):
    sa, sb = _shape(a), _shape(b)
    batch = sa[0] if len(sa) == 3 else 1
    m, k, n = sa[-2], sa[-1], sb[-1]
    out_itemsize = _result_dtype(a, b).itemsize
    return {"shape": ([m, n, k] if batch == 1 else [batch, m, n, k]),
            "dtype": _dtype_name(a, b), "epilogue": epilogue,
            "flops": 2 * batch * m * n * k + batch * m * n,
            "bytes": _nbytes(a, b, bias) + batch * m * n * out_itemsize}


def _syrk_info(a, c=None, alpha=1.0, beta=0.0, lower=True, trans=False, **kw):
    sa = _shape(a)
    batch = sa[0] if len(sa) == 3 else 1
    n = sa[-1] if trans else sa[-2]
    k = sa[-2] if trans else sa[-1]
    return {"shape": ([n, k] if batch == 1 else [batch, n, k]),
            "dtype": _dtype_name(a, c), "flops": 2 * batch * n * n * k,
            "bytes": _nbytes(a, c)}


def _trsm_info(a, b, lower=True, unit_diag=False, left=True, block=None,
               **kw):
    sa, sb = _shape(a), _shape(b)
    batch = sa[0] if len(sa) == 3 else 1
    n = sa[-1]
    nrhs = sb[-1] if len(sb) >= 2 else 1
    return {"shape": ([n, nrhs] if batch == 1 else [batch, n, nrhs]),
            "dtype": _dtype_name(a, b), "flops": batch * n * n * nrhs,
            "bytes": _nbytes(a, b)}


def _gemv_info(a, x, y=None, alpha=1.0, beta=0.0, trans=False, **kw):
    sa = _shape(a)
    batch = sa[0] if len(sa) == 3 else 1
    m, n = sa[-2], sa[-1]
    return {"shape": ([m, n] if batch == 1 else [batch, m, n]),
            "dtype": _dtype_name(a, x, y), "flops": 2 * batch * m * n,
            "bytes": _nbytes(a, x, y)}


def _ger_info(alpha, x, y, a, **kw):
    m, n = _shape(a)[-2:]
    return {"shape": [m, n], "dtype": _dtype_name(x, y, a),
            "flops": 2 * m * n, "bytes": _nbytes(x, y, a)}


def _trsv_info(a, b, **kw):
    n = _shape(a)[-1]
    return {"shape": [n], "dtype": _dtype_name(a, b), "flops": n * n,
            "bytes": _nbytes(a, b)}


# ------------------------- operands: device and dtype -----------------------

def _as_tensor(x) -> torch.Tensor:
    """A numpy array (or nested list) as a new CPU tensor; bfloat16 arrays
    cross by their bits."""
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.tensor(arr)


def _place(ctx, *arrays):
    """Operands on the context's device: numpy inputs are copied there, a
    tensor already there passes, a tensor on another device raises."""
    dev = resolved_device(ctx)
    out = []
    for x in arrays:
        if x is None:
            out.append(None)
        elif isinstance(x, torch.Tensor):
            if x.device.type != dev.type or (
                    dev.index is not None and x.device.index != dev.index):
                raise ValueError(
                    f"operand lies on {x.device} but the context runs on "
                    f"{dev}; move it explicitly or set linalg.use(device=...)")
            out.append(x)
        else:
            out.append(_as_tensor(x).to(dev))
    return out


def _dtypes(ctx, dtype, *arrays):
    """(storage dtype, compute dtype) for this call, or (None, None) - the
    passthrough path: no explicit ``dtype`` and no context accumulation
    dtype, so operands reach the core untouched. Otherwise storage = the
    explicit ``dtype`` or the promoted type of all operands; compute = the
    context's accumulation dtype or the storage dtype."""
    acc = resolved_accum_dtype(ctx)
    if dtype is None and acc is None:
        return None, None
    store = _dtype.to_torch(dtype) if dtype is not None \
        else _result_dtype(*arrays)
    comp = _dtype.to_torch(acc) if acc is not None else store
    return store, comp


def _cast(x, to):
    if x is None or to is None or x.dtype == to:
        return x
    return x.to(to)


def _operands(ctx, dtype, *arrays):
    """Place and cast a routine's operands: (storage dtype, [operands at
    the compute dtype])."""
    placed = _place(ctx, *arrays)
    store, comp = _dtypes(ctx, dtype, *placed)
    return store, [_cast(x, comp) for x in placed]


def _kw(ctx):
    """Context fields -> the kwargs every numeric core takes."""
    return dict(policy=resolved_policy(ctx), registry=resolved_registry(ctx))


def _batched(fn, *arrays):
    """Loop a 2-D core over the leading axis of 3-D operands (``None``
    operands pass through)."""
    n = next(x for x in arrays if x is not None).shape[0]
    return torch.stack([fn(*(None if x is None else x[i] for x in arrays))
                        for i in range(n)])


# -------------------------------- level 3 -----------------------------------

@_routine("gemm", _gemm_info)
def gemm(a, b, c=None, alpha=1.0, beta=0.0, transa: bool = False,
         transb: bool = False, dtype=None, context=None) -> torch.Tensor:
    """C <- alpha * op(A) op(B) + beta * C, any supported dtype; 3-D
    operands loop the local path over the leading axis."""
    ctx = current(context)
    store, (a_, b_, c_) = _operands(ctx, dtype, a, b, c)
    kw = _kw(ctx)
    if a_.ndim == 3:
        out = alpha * _batched(
            lambda x, y: _l3.gemm(x, y, transa=transa, transb=transb, **kw),
            a_, b_)
        if c_ is not None:
            out = out + beta * c_
        return _cast(out, store)
    out = _l3.gemm(a_, b_, c=c_, alpha=alpha, beta=beta, transa=transa,
                   transb=transb, **kw)
    return _cast(out, store)


@_routine("gemm_bias_act", _gemm_bias_act_info)
def gemm_bias_act(a, b, bias=None, epilogue: str = "none", dtype=None,
                  context=None) -> torch.Tensor:
    """C = act(A B + bias): the ``"gemm+epilogue"`` chain (one fused B3
    launch when the chain plan says streaming wins, else the B1 kernel
    and an epilogue pass); 3-D operands share ``bias``."""
    ctx = current(context)
    store, (a_, b_, bias_) = _operands(ctx, dtype, a, b, bias)
    kw = _kw(ctx)
    core = lambda x, y: _l3.gemm_bias_act(x, y, bias=bias_, epilogue=epilogue,
                                          **kw)
    out = _batched(core, a_, b_) if a_.ndim == 3 else core(a_, b_)
    return _cast(out, store)


@_routine("syrk", _syrk_info)
def syrk(a, c=None, alpha=1.0, beta=0.0, lower: bool = True,
         trans: bool = False, dtype=None, context=None) -> torch.Tensor:
    """C <- alpha op(A) op(A)^T + beta C, symmetric output, on the GEMM
    kernel path (and its registry entries)."""
    ctx = current(context)
    store, (a_, c_) = _operands(ctx, dtype, a, c)
    kw = _kw(ctx)
    core = lambda x, y: _l3.syrk(x, c=y, alpha=alpha, beta=beta, lower=lower,
                                 trans=trans, **kw)
    out = _batched(core, a_, c_) if a_.ndim == 3 else core(a_, c_)
    return _cast(out, store)


@_routine("trsm", _trsm_info)
def trsm(a, b, lower: bool = True, unit_diag: bool = False,
         left: bool = True, block: Optional[int] = None, dtype=None,
         context=None) -> torch.Tensor:
    """Solve op(T) X = B (or X op(T) = B), blocked; the off-diagonal GEMM
    updates follow the context policy onto the kernel."""
    ctx = current(context)
    store, (a_, b_) = _operands(ctx, dtype, a, b)
    kw = _kw(ctx)
    core = lambda t, r: _l3.trsm(t, r, lower=lower, unit_diag=unit_diag,
                                 left=left, block=block, **kw)
    out = _batched(core, a_, b_) if a_.ndim == 3 else core(a_, b_)
    return _cast(out, store)


# -------------------------------- level 2 -----------------------------------

@_routine("gemv", _gemv_info)
def gemv(a, x, y=None, alpha=1.0, beta=0.0, trans: bool = False,
         dtype=None, context=None) -> torch.Tensor:
    """y <- alpha*op(A) x + beta*y; kernel policies run op(A) x on the GEMM
    kernel (shared registry entries). 3-D a / 2-D x loop over the batch."""
    ctx = current(context)
    store, (a_, x_, y_) = _operands(ctx, dtype, a, x, y)
    kw = _kw(ctx)
    if a_.ndim == 3:
        out = alpha * _batched(lambda m, v: _l2.gemv(m, v, trans=trans, **kw),
                               a_, x_)
        if y_ is not None:
            out = out + beta * y_
        return _cast(out, store)
    out = _l2.gemv(a_, x_, y=y_, alpha=alpha, beta=beta, trans=trans, **kw)
    return _cast(out, store)


@_routine("ger", _ger_info)
def ger(alpha, x, y, a, dtype=None, context=None) -> torch.Tensor:
    """A <- alpha * x y^T + A (rank-1 update, plain PyTorch)."""
    ctx = current(context)
    store, (x_, y_, a_) = _operands(ctx, dtype, x, y, a)
    return _cast(_l2.ger(alpha, x_, y_, a_), store)


@_routine("trsv", _trsv_info)
def trsv(a, b, lower: bool = True, unit_diag: bool = False, dtype=None,
         context=None) -> torch.Tensor:
    """Solve op(T) x = b by row-sequential substitution; the blocked,
    policy-dispatched form is :func:`trsm`."""
    ctx = current(context)
    store, (a_, b_) = _operands(ctx, dtype, a, b)
    return _cast(_l2.trsv(a_, b_, lower=lower, unit_diag=unit_diag), store)
