"""LAPACK xGELS for m >= n: Householder QR (DGEQRF: blocked, compact WY,
the reflectors of DGEQR2 with v[0] = 1 and R's diagonal -sign(x0) ||x||)
and the least-squares solve x = R^-1 (Q^T b)[:n].

Within a panel of ``NB`` columns each reflector is applied by vector
products; each trailing update C -= V T^T (V^T C) and each block of Q
and of Q^T b by matrix products (in TF32 for the control). R is unique
up to the signs of its rows, and where a column's leading entry lies
within rounding of zero the program and the reference may pick opposite
signs and, after it, other reflectors for the same Q. So the factors are
compared as the pair that is unique: R and the first n columns of Q,
each item's rows of R (and columns of Q) scaled so that R's diagonal is
positive. Q is formed from the reflectors and ``tau`` of each side,
which covers them as far as the solve uses them.

Items: A Gaussian m x n (full rank with probability 1)."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from bench.reference.common import matmul_precision, worst_rel

NB = 32


def flops(m: int, n: int, nrhs: int) -> float:
    """LAWN 41's leading terms for one item: geqrf 2 m n^2 - 2 n^3 / 3,
    Q^T b (ormqr) 4 m n - 2 n^2 and R x = c (trsm) n^2 per right-hand
    side."""
    return 2 * m * n ** 2 - 2 * n ** 3 / 3 + \
        (4 * m * n - 2 * n ** 2 + n ** 2) * nrhs


def items(rand: Callable, batch: int, m: int, n: int,
          traffic: Dict) -> torch.Tensor:
    """``batch`` Gaussian m x n items from the Gaussian source ``rand``."""
    if m < n:
        raise ValueError(f"gels items need m >= n; config has {m} x {n}")
    return rand(batch, m, n)


def _house(x: torch.Tensor):
    """(v, tau, beta) of the reflector H = I - tau v v^T with H x =
    beta e_1, for each item's column x (B, rows)."""
    normx = torch.linalg.vector_norm(x, dim=-1)
    x0 = x[:, 0]
    beta = -torch.where(x0 >= 0, normx, -normx)
    nonzero = normx > 0
    one = torch.ones_like(x0)
    v = x / torch.where(nonzero, x0 - beta, one).unsqueeze(-1)
    v[:, 0] = 1
    tau = torch.where(nonzero, (beta - x0) / torch.where(nonzero, beta, one),
                      torch.zeros_like(x0))
    return v, tau, torch.where(nonzero, beta, x0)


def _unit_lower(packed: torch.Tensor, j0: int, nb: int) -> torch.Tensor:
    """V: the reflectors of columns j0 .. j0+nb-1, rows j0.. (B, m-j0, nb)."""
    v = packed[:, j0:, j0:j0 + nb].tril(-1)
    v.diagonal(dim1=-2, dim2=-1).fill_(1)
    return v


def _larft(v: torch.Tensor, tau: torch.Tensor, tf32: bool) -> torch.Tensor:
    """Forward T (upper, (B, nb, nb)) with H_1 .. H_nb = I - V T V^T."""
    nb = tau.shape[-1]
    with matmul_precision(tf32):
        g = v.mT @ v
    t = torch.zeros(v.shape[0], nb, nb, dtype=v.dtype, device=v.device)
    for k in range(nb):
        if k:
            with matmul_precision(tf32):
                t[:, :k, k] = -tau[:, k, None] * (
                    t[:, :k, :k] @ g[:, :k, k, None])[..., 0]
        t[:, k, k] = tau[:, k]
    return t


def _apply(x: torch.Tensor, v: torch.Tensor, t: torch.Tensor,
           tf32: bool) -> None:
    """x <- (I - V T V^T) x in place (T^T for Q^T: pass t.mT)."""
    with matmul_precision(tf32):
        x -= v @ (t @ (v.mT @ x))


def factor(a: torch.Tensor, tf32: bool = False) -> Dict[str, torch.Tensor]:
    a = a.clone()
    batch, m, n = a.shape
    k = min(m, n)
    tau = torch.zeros(batch, k, dtype=a.dtype, device=a.device)
    for j0 in range(0, k, NB):
        nb = min(NB, k - j0)
        for j in range(j0, j0 + nb):
            v, t, beta = _house(a[:, j:, j])
            if j + 1 < j0 + nb:
                panel = a[:, j:, j + 1:j0 + nb]
                panel -= (t.unsqueeze(-1) * v).unsqueeze(-1) * \
                    (v.unsqueeze(-1) * panel).sum(1, keepdim=True)
            a[:, j, j] = beta
            a[:, j + 1:, j] = v[:, 1:]
            tau[:, j] = t
        if j0 + nb < n:
            v = _unit_lower(a, j0, nb)
            _apply(a[:, j0:, j0 + nb:], v,
                   _larft(v, tau[:, j0:j0 + nb], tf32).mT, tf32)
    return {"factors": a, "tau": tau}


def form_q(packed: torch.Tensor, tau: torch.Tensor,
           tf32: bool = False) -> torch.Tensor:
    """The first n columns of Q from packed reflectors and tau (LAPACK
    DORGQR: the blocks of reflectors applied in reverse to the first n
    columns of I)."""
    batch, m, n = packed.shape
    q = torch.eye(m, n, dtype=packed.dtype, device=packed.device)
    q = q.repeat(batch, 1, 1)
    k = tau.shape[-1]
    for j0 in reversed(range(0, k, NB)):
        nb = min(NB, k - j0)
        v = _unit_lower(packed, j0, nb)
        _apply(q[:, j0:, j0:], v, _larft(v, tau[:, j0:j0 + nb], tf32), tf32)
    return q


def solve(fact: Dict[str, torch.Tensor], b: torch.Tensor,
          tf32: bool = False) -> torch.Tensor:
    packed, tau = fact["factors"], fact["tau"]
    n, k = packed.shape[-1], tau.shape[-1]
    c = b.clone()
    for j0 in range(0, k, NB):
        nb = min(NB, k - j0)
        v = _unit_lower(packed, j0, nb)
        _apply(c[:, j0:], v, _larft(v, tau[:, j0:j0 + nb], tf32).mT, tf32)
    return torch.linalg.solve_triangular(packed[:, :n, :n].triu(), c[:, :n],
                                         upper=True)


def _normalised(packed: torch.Tensor, tau: torch.Tensor, dtype):
    n = packed.shape[-1]
    packed, tau = packed.to(dtype), tau.to(dtype)
    r = packed[:, :n, :n].triu()
    d = torch.where(r.diagonal(dim1=-2, dim2=-1) >= 0, 1.0, -1.0).to(dtype)
    return d.unsqueeze(-1) * r, form_q(packed, tau) * d.unsqueeze(-2)


def factor_numbers(ref: Dict[str, torch.Tensor],
                   got: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``r_rel`` and ``q_rel``: the worst item's relative Frobenius gaps of
    R and of Q's first n columns, both sign-normalised."""
    dtype = ref["factors"].dtype
    r_ref, q_ref = _normalised(ref["factors"], ref["tau"], dtype)
    r_got, q_got = _normalised(got["factors"], got["tau"], dtype)
    return {"r_rel": worst_rel(r_got, r_ref), "q_rel": worst_rel(q_got, q_ref)}
