"""Mesh-parallel batched LAPACK: shard the batch axis, reuse the batched
drivers per rank (port of ``repro.lapack.distributed``).

Many independent factorizations have no cross-item dependence, so the
mesh mapping is pure data parallelism: the batch axis is sharded over
every mesh axis (flattened, row-major), and each rank runs
:mod:`repro_torch.lapack.batched` on its slab in lockstep - each trailing
update one B2 (``potrf`` / ``getrf``) or B1 (``geqrf``) launch for the
slab under the kernel policies, as the reference's ``vmap`` - with zero
collectives in the factorization. Batches that do not divide the
rank count are padded with identity matrices (SPD, invertible: safe for
every kind) and the pad is cut from the result.

SPMD, one process per rank, as :mod:`repro_torch.blas.distributed`: every
rank calls with the same global batch and returns the global result; the
slabs are gathered once at the end (the reference leaves them sharded).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed.collectives import (CollectiveRecord,
                                                 all_gather_cat,
                                                 emit_partition, emit_record,
                                                 flat_index)
from repro_torch.lapack import batched as _batched
from repro_torch.lapack.batched import FactorizationResult
from repro_torch.tune.policy import resolve_policy


def _ndev(mesh) -> int:
    return int(mesh.size())


def _pad_batch(a: torch.Tensor, ndev: int) -> Tuple[torch.Tensor, int]:
    """Pad the (B, m, n) batch to a multiple of the rank count with
    identities; emits the ``"pad_batch"`` record."""
    b = a.shape[0]
    pad = (-b) % ndev
    emit_record(CollectiveRecord(
        kind="pad_batch", size=ndev,
        info={"batch": b, "pad": pad, "identity": True}))
    if pad == 0:
        return a, b
    eye = torch.eye(a.shape[1], a.shape[2], dtype=a.dtype, device=a.device)
    return torch.cat([a, eye.expand(pad, -1, -1)]), b


def _slab(x: torch.Tensor, mesh, operand: str = "a") -> torch.Tensor:
    """This rank's slab of the batch axis (row-major over the mesh axes);
    records the partition (``operand`` names it)."""
    idx, n = flat_index(mesh, mesh.mesh_dim_names)
    w = x.shape[0] // n
    slab = x[idx * w:(idx + 1) * w]
    emit_partition("batched", operand, x.shape, x.shape,
                   {0: tuple(mesh.mesh_dim_names)}, slab.shape, mesh)
    return slab


def _gather(x: Optional[torch.Tensor], mesh, b0: int):
    """The rank slabs of ``x`` gathered in batch order, the pad cut."""
    if x is None:
        return None
    for ax in reversed(mesh.mesh_dim_names):
        x = all_gather_cat(x, mesh, ax, 0, tag="result")
    return x[:b0]


def batched_potrf(a: torch.Tensor, mesh, block: Optional[int] = None,
                  policy: Optional[str] = None,
                  registry=None) -> FactorizationResult:
    """Cholesky of a (B, n, n) SPD batch, batch-sharded over ``mesh`` (any
    mesh: the batch is sharded over all its axes). ``block`` / ``policy``
    are forwarded to each rank's
    :func:`repro_torch.lapack.batched.batched_potrf`; the panel width is
    resolved once for the global batch. Returns the same
    FactorizationResult as the single-device driver on every rank."""
    pol = resolve_policy(policy)
    nb = _batched._batch(a, "potrf", block, square=True)
    a_p, b0 = _pad_batch(a, _ndev(mesh))
    r = _batched.batched_potrf(_slab(a_p, mesh), block=nb, policy=pol,
                               registry=registry)
    return FactorizationResult(_gather(r.factors, mesh, b0), None, None,
                               "potrf", nb)


def batched_getrf(a: torch.Tensor, mesh, block: Optional[int] = None,
                  policy: Optional[str] = None,
                  registry=None) -> FactorizationResult:
    """LU with partial pivoting of a (B, m, n) batch, batch-sharded;
    pivots (B, k) int32 in LAPACK ipiv convention."""
    pol = resolve_policy(policy)
    nb = _batched._batch(a, "getrf", block)
    a_p, b0 = _pad_batch(a, _ndev(mesh))
    r = _batched.batched_getrf(_slab(a_p, mesh), block=nb, policy=pol,
                               registry=registry)
    return FactorizationResult(_gather(r.factors, mesh, b0),
                               _gather(r.pivots, mesh, b0), None, "getrf",
                               nb)


def batched_geqrf(a: torch.Tensor, mesh, block: Optional[int] = None,
                  policy: Optional[str] = None,
                  registry=None) -> FactorizationResult:
    """Householder QR of a (B, m, n) batch, batch-sharded (packed R/V
    factors and tau)."""
    pol = resolve_policy(policy)
    nb = _batched._batch(a, "geqrf", block)
    a_p, b0 = _pad_batch(a, _ndev(mesh))
    r = _batched.batched_geqrf(_slab(a_p, mesh), block=nb, policy=pol,
                               registry=registry)
    return FactorizationResult(_gather(r.factors, mesh, b0), None,
                               _gather(r.tau, mesh, b0), "geqrf", nb)


def batched_solve(res: FactorizationResult, b: torch.Tensor, mesh,
                  policy: Optional[str] = None,
                  registry=None) -> torch.Tensor:
    """Solve A_i x_i = b_i for a FactorizationResult of any driver (this
    module's or the single-device ones), batch-sharded: factors, pivots /
    tau and the right-hand sides ((B, n) or (B, n, k)) are padded (identity
    factors, identity pivots, zero tau, zero right-hand sides), sharded,
    solved per rank by :func:`repro_torch.lapack.batched.batched_solve`
    and gathered."""
    pol = resolve_policy(policy)
    vec = b.ndim == 2
    rhs = b[:, :, None] if vec else b
    factors, b0 = _pad_batch(res.factors, _ndev(mesh))
    pad = factors.shape[0] - b0
    piv, tau = res.pivots, res.tau
    if pad:
        rhs = torch.cat([rhs, rhs.new_zeros((pad,) + rhs.shape[1:])])
        if piv is not None:
            ident = torch.arange(piv.shape[1], dtype=piv.dtype,
                                 device=piv.device)
            piv = torch.cat([piv, ident.expand(pad, -1)])
        if tau is not None:
            tau = torch.cat([tau, tau.new_zeros((pad,) + tau.shape[1:])])
    local = FactorizationResult(
        _slab(factors, mesh), None if piv is None else _slab(piv, mesh),
        None if tau is None else _slab(tau, mesh), res.kind, res.block)
    x = _gather(_batched.batched_solve(local, _slab(rhs, mesh), policy=pol,
                                       registry=registry), mesh, b0)
    return x[:, :, 0] if vec else x
