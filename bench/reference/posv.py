"""LAPACK xPOSV: the Cholesky factor A = L L^T of an SPD item and its
solve, blocked right-looking.

The diagonal blocks by ``torch.linalg.cholesky``, the panel by a
triangular solve, the trailing update by a matrix product (in TF32 for
the control). The port returns L with zeros above the diagonal.

Items: A = G G^T / n + shift I with G Gaussian n x n (the Gram matrix of
ridge-regularised normal equations, lambda = ``shift``), symmetrised
exactly; its eigenvalues lie in [shift, shift + 4]."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from bench.reference.common import matmul_precision, worst_rel

NB = 128


def flops(m: int, n: int, nrhs: int) -> float:
    """LAWN 41's leading terms for one item: potrf n^3 / 3, potrs 2 n^2
    per right-hand side."""
    return n ** 3 / 3 + 2 * n ** 2 * nrhs


def items(rand: Callable, batch: int, m: int, n: int,
          traffic: Dict) -> torch.Tensor:
    """``batch`` SPD items from the Gaussian source ``rand``."""
    if m != n:
        raise ValueError(f"posv items are square; config has {m} x {n}")
    g = rand(batch, n, n)
    a = torch.bmm(g, g.mT)
    del g
    a = a.add_(a.mT.clone()).mul_(0.5 / n)
    a.diagonal(dim1=-2, dim2=-1).add_(float(traffic["shift"]))
    return a


def factor(a: torch.Tensor, tf32: bool = False) -> Dict[str, torch.Tensor]:
    a = a.clone()
    n = a.shape[-1]
    for j in range(0, n, NB):
        e = min(j + NB, n)
        l11 = torch.linalg.cholesky(a[:, j:e, j:e])
        a[:, j:e, j:e] = l11
        if e < n:
            l21 = torch.linalg.solve_triangular(
                l11, a[:, e:, j:e].mT, upper=False).mT
            a[:, e:, j:e] = l21
            with matmul_precision(tf32):
                a[:, e:, e:] -= l21 @ l21.mT
    return {"factors": a.tril()}


def solve(fact: Dict[str, torch.Tensor], b: torch.Tensor,
          tf32: bool = False) -> torch.Tensor:
    l = fact["factors"]
    y = torch.linalg.solve_triangular(l, b, upper=False)
    return torch.linalg.solve_triangular(l.mT, y, upper=True)


def factor_numbers(ref: Dict[str, torch.Tensor],
                   got: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``factor_rel``: the worst item's ||L - L_ref||_F / ||L_ref||_F."""
    return {"factor_rel": worst_rel(got["factors"].tril(), ref["factors"])}
