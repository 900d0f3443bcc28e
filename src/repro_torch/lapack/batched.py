"""Batched blocked LAPACK drivers (port of ``repro.lapack.batched``).

Many independent small or medium factorizations (mixture-of-experts
solves, per-head whitening, ensemble Kalman updates) of one (B, m, n)
tensor, run as ONE blocked computation. The reference ``vmap``s the
blocked drivers; here the drivers of :mod:`repro_torch.lapack` take the
(B, m, n) tensor itself, so the panels of the whole batch run in lockstep
(each panel column one set of launches for all items) and each trailing
update is one kernel launch for the whole batch: B2 for ``potrf`` /
``getrf``, B1 twice for ``geqrf``, and B1's ``gemv`` once per TRSM update
of a solve.

All entry points share one result type, :class:`FactorizationResult`,
tagged with the factorization kind, so ``batched_solve`` and
``reconstruct`` dispatch without re-inspecting shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.lapack import cholesky, lu, qr, solve
from repro_torch.lapack.cholesky import default_block
from repro_torch.tune.policy import resolve_policy


@dataclasses.dataclass(frozen=True)
class FactorizationResult:
    """One batched factorization in LAPACK packed layout.

    factors: (B, m, n) packed factor(s) - L (potrf), L\\U (getrf), or the
             Householder-packed R/V (geqrf).
    pivots:  (B, k) int32 ipiv (getrf only, else None).
    tau:     (B, k) reflector scales (geqrf only, else None).
    kind:    "potrf" | "getrf" | "geqrf".
    block:   panel width the factorization actually used.
    """

    factors: torch.Tensor
    pivots: Optional[torch.Tensor]
    tau: Optional[torch.Tensor]
    kind: str
    block: int

    @property
    def batch(self) -> int:
        return self.factors.shape[0]


def _batch(a: torch.Tensor, kind: str, block: Optional[int],
           square: bool = False) -> int:
    """Check a (B, m, n) batch; the panel width its items use."""
    if a.ndim != 3 or (square and a.shape[1] != a.shape[2]):
        raise ValueError(f"batched {kind} needs a (B, "
                         f"{'n, n' if square else 'm, n'}) batch; got "
                         f"{tuple(a.shape)}")
    kmax = min(a.shape[1], a.shape[2])
    return default_block(kmax, kind, a.dtype, a.device) if block is None \
        else int(block)


def batched_potrf(a: torch.Tensor, block: Optional[int] = None,
                  policy: Optional[str] = None,
                  registry=None) -> FactorizationResult:
    """Cholesky of a (B, n, n) SPD batch; factors holds L (lower). NaNs
    for a non-SPD item, LAPACK-style."""
    nb = _batch(a, "potrf", block, square=True)
    factors = cholesky.potrf(a, block=nb, policy=resolve_policy(policy),
                             registry=registry)
    return FactorizationResult(factors, None, None, "potrf", nb)


def batched_getrf(a: torch.Tensor, block: Optional[int] = None,
                  policy: Optional[str] = None,
                  registry=None) -> FactorizationResult:
    """LU with partial pivoting of a (B, m, n) batch: packed L\\U factors
    and (B, min(m, n)) int32 ipiv."""
    nb = _batch(a, "getrf", block)
    packed, piv = lu.getrf(a, block=nb, policy=resolve_policy(policy),
                           registry=registry)
    return FactorizationResult(packed, piv, None, "getrf", nb)


def batched_geqrf(a: torch.Tensor, block: Optional[int] = None,
                  policy: Optional[str] = None,
                  registry=None) -> FactorizationResult:
    """Householder QR of a (B, m, n) batch (packed R/V and tau per item)."""
    nb = _batch(a, "geqrf", block)
    packed, tau = qr.geqrf(a, block=nb, policy=resolve_policy(policy),
                           registry=registry)
    return FactorizationResult(packed, None, tau, "geqrf", nb)


def batched_solve(res: FactorizationResult, b: torch.Tensor,
                  policy: Optional[str] = None,
                  registry=None) -> torch.Tensor:
    """Solve A_i x_i = b_i for every item of a FactorizationResult.

    b: (B, n) or (B, n, k) (for geqrf (B, m) or (B, m, k)). potrf solves
    the SPD system L L^T x = b, getrf the pivoted L U x = P b, geqrf the
    least-squares system R x = (Q^T b)[:n] (m >= n).
    """
    vec = b.ndim == 2
    rhs = b[:, :, None] if vec else b
    pol = resolve_policy(policy)
    m, n = res.factors.shape[1:]
    if res.kind == "potrf":
        x = solve.potrs(res.factors, rhs, policy=pol, registry=registry)
    elif res.kind == "getrf":
        if m != n:
            raise ValueError(
                f"batched_solve(getrf) needs square factors; got "
                f"{tuple(res.factors.shape)} (use geqrf for least squares)")
        x = solve.getrs(res.factors, res.pivots, rhs, policy=pol,
                        registry=registry)
    elif res.kind == "geqrf":
        if m < n:
            raise ValueError(
                f"batched_solve(geqrf) is a least-squares solve and needs "
                f"m >= n; got factors of shape {tuple(res.factors.shape)}")
        x = solve.geqrs(res.factors, res.tau, rhs, policy=pol,
                        registry=registry)
    else:
        raise ValueError(f"unknown factorization kind: {res.kind!r}")
    return x[:, :, 0] if vec else x


def reconstruct(res: FactorizationResult) -> torch.Tensor:
    """Rebuild the (B, m, n) input batch from its factors (testing
    oracle)."""
    if res.kind == "potrf":
        return res.factors @ res.factors.mT
    if res.kind == "getrf":
        return lu.lu_reconstruct(res.factors, res.pivots)
    if res.kind == "geqrf":
        return qr.q_from_geqrf(res.factors, res.tau) @ torch.triu(res.factors)
    raise ValueError(f"unknown factorization kind: {res.kind!r}")
