"""Level-3 BLAS cores (port of ``repro.blas.level3``).

Every kernel-shaped core resolves through :mod:`repro_torch.tune.dispatch`:
``policy="reference"`` is plain PyTorch, ``"model"`` the hand-written GEMM
kernel at the planned config, ``"tuned"`` the registry's config (cold
start == model). ``syrk`` and ``trsm`` thread the same policy through
their internal GEMMs, so a blocked factorization dispatches every
trailing flop onto the kernels. ``gemm``, ``trsm`` and
``mirror_triangle`` also take a batch, operands with a leading (B,) axis
(the reference ``vmap``s them): one blocked computation over the batch,
each GEMM-shaped step one launch for all its items. The public,
context-scoped front-end is :mod:`repro_torch.linalg`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.blas._deprecated import compat, warn_once
from repro_torch.tune import dispatch as _tune
from repro_torch.tune.policy import resolve_policy


def gemm(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None,
         alpha=1.0, beta=0.0, transa: bool = False, transb: bool = False,
         policy: Optional[str] = None, registry=None) -> torch.Tensor:
    """C <- alpha * op(A) op(B) + beta * C (BLAS GEMM core); ``transa`` /
    ``transb`` pass transposed views, which the kernel reads in place. A
    batch (B, m, k) @ (B, k, n) is one launch."""
    op_a = a.mT if transa else a
    op_b = b.mT if transb else b
    out = alpha * _tune.dispatch("gemm", op_a, op_b, policy=policy,
                                 registry=registry)
    if c is not None:
        out = out + beta * c
    return out


def gemm_bias_act(a: torch.Tensor, b: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, epilogue: str = "none",
                  policy: Optional[str] = None, registry=None) -> torch.Tensor:
    """C = act(A @ B + bias), resolved as the ``"gemm+epilogue"`` chain:
    one fused launch when the chain plan says fusing wins, else the GEMM
    kernel and an epilogue pass."""
    return _tune.dispatch("gemm+epilogue", a, b, bias=bias,
                          epilogue=epilogue, policy=policy, registry=registry)


def syrk(a: torch.Tensor, c: Optional[torch.Tensor] = None, alpha=1.0,
         beta=0.0, lower: bool = True, trans: bool = False,
         policy: Optional[str] = None, registry=None) -> torch.Tensor:
    """C <- alpha op(A) op(A)^T + beta C, symmetric output (the product
    runs on the GEMM path; ``lower`` picks the authoritative triangle)."""
    full = alpha * _tune.dispatch("syrk", a, trans=trans, policy=policy,
                                  registry=registry)
    if c is not None:
        full = full + beta * c
    return mirror_triangle(full, lower)


def mirror_triangle(full: torch.Tensor, lower: bool) -> torch.Tensor:
    """Keep the authoritative triangle of ``full`` (or of each item of a
    batch), mirror it across the diagonal."""
    keep = torch.ones(full.shape[-2:], dtype=torch.bool, device=full.device)
    keep = keep.tril() if lower else keep.triu()
    return torch.where(keep, full, full.mT)


def trsm(a: torch.Tensor, b: torch.Tensor, lower: bool = True,
         unit_diag: bool = False, left: bool = True,
         block: Optional[int] = None, policy: Optional[str] = None,
         registry=None) -> torch.Tensor:
    """Solve op(T) X = B (left=True) or X op(T) = B, T triangular, blocked.

    Diagonal blocks use the row-sequential substitution (the serial
    divider chain, plain PyTorch: it has no kernel in the reference
    either); off-diagonal updates are GEMMs that follow the policy onto
    the kernel. ``block=None`` resolves the width through
    :func:`repro_torch.tune.dispatch.resolve` (64 under ``reference``).
    The solution blocks are written into one output tensor in place. A
    batch, T (B, n, n) and B (B, n, k), runs the row loop once for all
    items, each off-diagonal update one launch.
    """
    if not left:
        # X T = B  <=>  T^T X^T = B^T
        return _t(trsm(_t(a), _t(b), lower=not lower, unit_diag=unit_diag,
                       left=True, block=block, policy=policy,
                       registry=registry))
    n = a.shape[-1]
    if block is None:
        nrhs = b.shape[-1] if b.ndim == a.ndim else 1
        res = _tune.resolve("trsm", (n, nrhs), a.dtype, policy=policy,
                            registry=registry, backend=a.device.type)
        pol, block = res.policy, res.block
    else:
        pol = resolve_policy(policy)
    if n <= block:
        return _trsm_unblocked(a, b, lower=lower, unit_diag=unit_diag)
    blocks = list(range(0, n, block))
    two_d = a.ndim == 2
    rows = lambda t, i0, i1: t[i0:i1] if two_d else t[:, i0:i1]
    x = torch.zeros_like(b)
    for i0 in (blocks if lower else blocks[::-1]):
        i1 = min(i0 + block, n)
        rhs = rows(b, i0, i1)
        if lower and i0 > 0:
            rhs = rhs - gemm(a[..., i0:i1, :i0], rows(x, 0, i0), policy=pol,
                             registry=registry)
        elif not lower and i1 < n:
            rhs = rhs - gemm(a[..., i0:i1, i1:], rows(x, i1, n), policy=pol,
                             registry=registry)
        sol = _trsm_unblocked(a[..., i0:i1, i0:i1], rhs, lower=lower,
                              unit_diag=unit_diag)
        if two_d:
            x[i0:i1] = sol
        else:
            x[:, i0:i1] = sol
    return x


def _t(x: torch.Tensor) -> torch.Tensor:
    """The transpose of a matrix or of each item of a batch; a vector as
    it is."""
    return x if x.ndim < 2 else x.mT


def _trsm_unblocked(a: torch.Tensor, b: torch.Tensor, lower: bool,
                    unit_diag: bool) -> torch.Tensor:
    """Row-sequential substitution (the reference's ``lax.scan``), on one
    system or a batch, T (B, n, n) and B (B, n, k)."""
    n = a.shape[-1]
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    strict = a - torch.diag_embed(diag)
    x = torch.zeros_like(b)
    for i in (range(n) if lower else range(n - 1, -1, -1)):
        if a.ndim == 2:
            s = b[i] - strict[i] @ x
            x[i] = s if unit_diag else s / diag[i]
        else:
            s = b[:, i] - (strict[:, i, None] @ x)[:, 0]
            x[:, i] = s if unit_diag else s / diag[:, i, None]
    return x


# -------------------------- deprecated d-prefixed shims ----------------------
# Old kwargs map to a per-call compat context (no ``interpret``: the
# operands' device decides where the port runs).

def dgemm(a, b, c=None, alpha=1.0, beta=0.0, transa: bool = False,
          transb: bool = False, policy: Optional[str] = None,
          use_kernel: Optional[bool] = None, registry=None,
          use_pallas: Optional[bool] = None):
    """Deprecated alias of :func:`repro_torch.linalg.gemm`."""
    warn_once("dgemm", "gemm")
    linalg, ctx = compat(policy, use_kernel, registry, use_pallas)
    return linalg.gemm(a, b, c=c, alpha=alpha, beta=beta, transa=transa,
                       transb=transb, context=ctx)


def dsyrk(a, c=None, alpha=1.0, beta=0.0, lower: bool = True,
          trans: bool = False, policy: Optional[str] = None,
          use_kernel: Optional[bool] = None, registry=None,
          use_pallas: Optional[bool] = None):
    """Deprecated alias of :func:`repro_torch.linalg.syrk`."""
    warn_once("dsyrk", "syrk")
    linalg, ctx = compat(policy, use_kernel, registry, use_pallas)
    return linalg.syrk(a, c=c, alpha=alpha, beta=beta, lower=lower,
                       trans=trans, context=ctx)


def dtrsm(a, b, lower: bool = True, unit_diag: bool = False,
          left: bool = True, block: Optional[int] = None,
          policy: Optional[str] = None, use_kernel: Optional[bool] = None,
          registry=None, use_pallas: Optional[bool] = None):
    """Deprecated alias of :func:`repro_torch.linalg.trsm`."""
    warn_once("dtrsm", "trsm")
    linalg, ctx = compat(policy, use_kernel, registry, use_pallas)
    return linalg.trsm(a, b, lower=lower, unit_diag=unit_diag, left=left,
                       block=block, context=ctx)
