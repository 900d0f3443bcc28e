"""Level-1 BLAS cores (port of ``repro.blas.level1``, the paper's
section-4.1 workloads).

dtype-generic cores under their un-prefixed names (``dot``, ``axpy``, ...);
``ddot``/``daxpy``/... survive as deprecation shims that forward through
:mod:`repro_torch.linalg`. ``dot`` exposes the *schedule* knob the paper's
analysis is about: tree / sequential / strided-U reductions give the same
value up to floating-point reassociation, with very different dependence
structure. Level 1 is plain PyTorch (no policy: there is no kernel-shaped
core to dispatch; ``dot`` stays off B4, as the reference's stays off its
Pallas ``dotp``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.blas._deprecated import compat, warn_once

SCHEDULES = ("tree", "sequential", "strided")


def dot(x: torch.Tensor, y: torch.Tensor, schedule: str = "tree",
        accumulators: int = 8) -> torch.Tensor:
    """Inner product x^T y with an explicit reduction schedule.

    * ``"tree"``: ``torch.sum`` of the products.
    * ``"sequential"``: one running sum, the fully serial hazard chain
      (the last entry of ``torch.cumsum``; the reference's ``lax.scan``).
    * ``"strided"``: ``accumulators`` = U column partials of the
      zero-padded products reshaped to (-1, U), element i in column
      i mod U, then a sum of the U partials (the paper's depth-p pipeline
      as software ILP).

    Returns a 0-d tensor of x's dtype. The schedules agree with the
    reference up to reassociation, not bitwise: no Python loop runs over
    the elements, ``torch.cumsum`` on the card is a parallel scan (on the
    CPU it carries a float32 running sum in float64), and each column
    partial is a ``torch.sum`` where the reference's is a running sum
    (a running sum along dim 0 is one thread per column on the card).
    """
    if schedule not in SCHEDULES:
        raise ValueError(schedule)
    prods = x * y
    if schedule == "tree" or prods.numel() == 0:
        return torch.sum(prods)
    if schedule == "sequential":
        return torch.cumsum(prods, 0)[-1]
    u = max(1, int(accumulators))
    pad = (-prods.shape[0]) % u
    if pad:
        prods = F.pad(prods, (0, pad))
    return torch.sum(torch.sum(prods.reshape(-1, u), 0))


def axpy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y <- alpha*x + y (same-shape float tensors)."""
    return alpha * x + y


def scal(alpha, x: torch.Tensor) -> torch.Tensor:
    """x <- alpha*x."""
    return alpha * x


def nrm2(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm, overflow-safe (reference-BLAS style): scaled by
    max|x| before squaring, so it is finite whenever the inputs are."""
    amax = torch.max(torch.abs(x))
    scale = torch.where(amax > 0, amax, torch.ones_like(amax))
    return scale * torch.sqrt(torch.sum((x / scale) ** 2))


def asum(x: torch.Tensor) -> torch.Tensor:
    """Sum of absolute values (BLAS asum)."""
    return torch.sum(torch.abs(x))


def iamax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first max-|x| element (BLAS iamax, 0-based int64)."""
    return torch.argmax(torch.abs(x))


def rot(x, y, c, s):
    """Apply a Givens rotation to a vector pair: (c*x + s*y, c*y - s*x)."""
    return c * x + s * y, c * y - s * x


# -------------------------- deprecated d-prefixed shims ----------------------
# Thin forwards through repro_torch.linalg under a pinned compat context
# (accum_dtype=None, machine=None), so an active context can never change
# a deprecated call's numerics. One DeprecationWarning per routine.

def ddot(x, y, schedule: str = "tree", accumulators: int = 8):
    """Deprecated alias of :func:`repro_torch.linalg.dot`."""
    warn_once("ddot", "dot")
    linalg, ctx = compat()
    return linalg.dot(x, y, schedule=schedule, accumulators=accumulators,
                      context=ctx)


def daxpy(alpha, x, y):
    """Deprecated alias of :func:`repro_torch.linalg.axpy`."""
    warn_once("daxpy", "axpy")
    linalg, ctx = compat()
    return linalg.axpy(alpha, x, y, context=ctx)


def dscal(alpha, x):
    """Deprecated alias of :func:`repro_torch.linalg.scal`."""
    warn_once("dscal", "scal")
    linalg, ctx = compat()
    return linalg.scal(alpha, x, context=ctx)


def dnrm2(x):
    """Deprecated alias of :func:`repro_torch.linalg.nrm2`."""
    warn_once("dnrm2", "nrm2")
    linalg, ctx = compat()
    return linalg.nrm2(x, context=ctx)


def dasum(x):
    """Deprecated alias of :func:`repro_torch.linalg.asum`."""
    warn_once("dasum", "asum")
    linalg, ctx = compat()
    return linalg.asum(x, context=ctx)


def idamax(x):
    """Deprecated alias of :func:`repro_torch.linalg.iamax`."""
    warn_once("idamax", "iamax")
    linalg, ctx = compat()
    return linalg.iamax(x, context=ctx)


def drot(x, y, c, s):
    """Deprecated alias of :func:`repro_torch.linalg.rot`."""
    warn_once("drot", "rot")
    linalg, ctx = compat()
    return linalg.rot(x, y, c, s, context=ctx)
