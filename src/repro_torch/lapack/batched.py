"""Batched blocked LAPACK drivers (port of ``repro.lapack.batched``).

Many independent small or medium factorizations (mixture-of-experts
solves, per-head whitening, ensemble Kalman updates) of one (B, m, n)
tensor. The reference ``vmap``s the blocked drivers, so the whole batch's
panels run in lockstep; here each item runs the 2-D driver in turn, which
gives the same numbers with B times the launches (the trailing updates of
``potrf`` / ``getrf`` on B2 and of ``geqrf`` on B1, per item).

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
    pol = resolve_policy(policy)
    factors = torch.stack([cholesky.potrf(x, block=nb, policy=pol,
                                          registry=registry) for x in a])
    return FactorizationResult(factors, None, None, "potrf", nb)


def batched_getrf(a: torch.Tensor, block: Optional[int] = None,
                  policy: Optional[str] = None,
                  registry=None) -> FactorizationResult:
    """LU with partial pivoting of a (B, m, n) batch: packed L\\U factors
    and (B, min(m, n)) int32 ipiv."""
    nb = _batch(a, "getrf", block)
    pol = resolve_policy(policy)
    packed, piv = zip(*(lu.getrf(x, block=nb, policy=pol, registry=registry)
                        for x in a))
    return FactorizationResult(torch.stack(packed), torch.stack(piv), None,
                               "getrf", nb)


def batched_geqrf(a: torch.Tensor, block: Optional[int] = None,
                  policy: Optional[str] = None,
                  registry=None) -> FactorizationResult:
    """Householder QR of a (B, m, n) batch (packed R/V and tau per item)."""
    nb = _batch(a, "geqrf", block)
    pol = resolve_policy(policy)
    packed, tau = zip(*(qr.geqrf(x, block=nb, policy=pol, registry=registry)
                        for x in a))
    return FactorizationResult(torch.stack(packed), None, torch.stack(tau),
                               "geqrf", nb)


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
        items = [solve.potrs(l, r, policy=pol, registry=registry)
                 for l, r in zip(res.factors, rhs)]
    elif res.kind == "getrf":
        if m != n:
            raise ValueError(
                f"batched_solve(getrf) needs square factors; got "
                f"{tuple(res.factors.shape)} (use geqrf for least squares)")
        items = [solve.getrs(p, piv, r, policy=pol, registry=registry)
                 for p, piv, r in zip(res.factors, res.pivots, rhs)]
    elif res.kind == "geqrf":
        if m < n:
            raise ValueError(
                f"batched_solve(geqrf) is a least-squares solve and needs "
                f"m >= n; got factors of shape {tuple(res.factors.shape)}")
        items = [solve.geqrs(p, t, r, policy=pol, registry=registry)
                 for p, t, r in zip(res.factors, res.tau, rhs)]
    else:
        raise ValueError(f"unknown factorization kind: {res.kind!r}")
    x = torch.stack(items)
    return x[:, :, 0] if vec else x


def reconstruct(res: FactorizationResult) -> torch.Tensor:
    """Rebuild the (B, m, n) input batch from its factors (testing
    oracle)."""
    if res.kind == "potrf":
        return res.factors @ res.factors.transpose(1, 2)
    if res.kind == "getrf":
        return torch.stack([lu.lu_reconstruct(p, piv)
                            for p, piv in zip(res.factors, res.pivots)])
    if res.kind == "geqrf":
        return torch.stack([qr.q_from_geqrf(p, t) @ torch.triu(p)
                            for p, t in zip(res.factors, res.tau)])
    raise ValueError(f"unknown factorization kind: {res.kind!r}")
