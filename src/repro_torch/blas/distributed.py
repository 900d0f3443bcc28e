"""Sharded multi-rank BLAS: SUMMA ``pdgemm`` and ``pdtrsm`` on
torch.distributed (port of ``repro.blas.distributed``).

The paper's thesis - match the DAG's parallel operations to the
platform's compute/memory structure - applied across the device boundary:
a 2-D ``("x", "y")`` mesh turns the GEMM K reduction into ``px * py``
parallel accumulators (one partial C per rank) fed by a serial panel
stream, whose "latch overhead" is an inter-device hop.

Layout (SUMMA), as the reference's ``P("x", "y")``:

* A ``(m, k)``: rows over ``x``, the K dimension over ``y``;
* B ``(k, n)``: the K dimension over ``x``, columns over ``y``;
* each of the ``px * py`` steps broadcasts one fine k-panel of A along
  the ``y`` ring and the matching panel of B along the ``x`` ring
  (:func:`repro_torch.distributed.collectives.ring_bcast`), then runs the
  local ``(m/px, k_f) @ (k_f, n/py)`` update through the dispatcher's
  executor (``_gemm_exec``: plain PyTorch under ``reference``, B1 at the
  plan :func:`repro_torch.tune.dispatch.resolve` picks for op
  ``"pdgemm"`` under ``model`` / ``tuned``).

SPMD, one process per rank: every rank of the mesh calls :func:`pdgemm`
with the same global operands, takes its shard by its mesh coordinates
and runs the reference's schedule. Deliberate difference: the reference
leaves C sharded ``P("x", "y")``; here the blocks are gathered once at the
end (an ``all_gather`` over ``y``, then over ``x``, outside the schedule:
no ``ring_bcast``, no record, no counter), so every rank returns the
global ``(m, n)`` product, and ``alpha`` / ``beta`` apply after the
gather, as the reference applies them outside ``shard_map``.

A ``(1, 1)`` mesh is a real one-rank group: zero hops, one local update
at ``plan_gemm``'s plan, bitwise the single-device ``gemm``. A mesh call
without a process group that holds the mesh raises; nothing falls back to
the local path.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import _dtype
from repro_torch.distributed.collectives import (CollectiveRecord,
                                                 all_gather_cat, axis_group,
                                                 emit_partition, emit_record,
                                                 ring_bcast)
from repro_torch.launch.mesh import mesh_shape, sub_mesh

MESH_AXES = ("x", "y")


def make_blas_mesh(px: int, py: int):
    """A (px, py) ``("x", "y")`` mesh over the first ``px * py`` ranks of
    the world; every rank of the world calls it (the sub-groups are made
    collectively). Raises without a process group of at least ``px * py``
    ranks."""
    return sub_mesh((int(px), int(py)), MESH_AXES)


def mesh_key(mesh) -> str:
    """Registry mesh component for a BLAS mesh (e.g. ``"x2y4"``)."""
    return "".join(f"{a}{s}" for a, s in mesh_shape(mesh).items())


def _mesh_xy(mesh):
    if tuple(mesh.mesh_dim_names or ()) != MESH_AXES:
        raise ValueError(f"distributed BLAS needs a ('x', 'y') mesh; got "
                         f"axes {mesh.mesh_dim_names}")
    return tuple(int(s) for s in mesh.shape)


def _pad2(a: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """Zero-pad a 2-D tensor so dims are multiples of (r0, r1)."""
    p0 = (-a.shape[0]) % r0
    p1 = (-a.shape[1]) % r1
    if p0 == 0 and p1 == 0:
        return a
    return F.pad(a, (0, p1, 0, p0))


def _block(t: torch.Tensor, i: int, j: int, r0: int, r1: int) -> torch.Tensor:
    """Block (i, j) of ``t`` cut into r0 x r1 equal blocks, contiguous (a
    rank's shard, as shard_map hands it)."""
    h, w = t.shape[0] // r0, t.shape[1] // r1
    return t[i * h:(i + 1) * h, j * w:(j + 1) * w].contiguous()


def _local_update(ap, bp, res):
    """One SUMMA panel update on the resolved path - the executor every
    other policy-dispatched GEMM uses."""
    from repro_torch.tune.dispatch import _gemm_exec   # lazy: avoid a cycle
    return _gemm_exec(ap, bp, res)


def pdgemm(a: torch.Tensor, b: torch.Tensor, mesh,
           c: Optional[torch.Tensor] = None, alpha=1.0, beta=0.0,
           policy: Optional[str] = None, registry=None) -> torch.Tensor:
    """C <- alpha * A B + beta * C, SUMMA over a ("x", "y") mesh.

    Every rank of ``mesh`` calls it with the same global ``a`` (m, k) and
    ``b`` (k, n) (any dtype the single-device gemm takes); they are
    zero-padded so m, n, k tile the mesh, and the pad never reaches the
    output. ``policy`` / ``registry`` resolve op ``"pdgemm"`` at
    ``mesh=(px, py)`` (``tuned`` reads the mesh-keyed registry entry and
    cold-starts to ``model``). Returns the global (m, n) product on every
    rank. Emits one ``"pdgemm"`` record and two ``"ring_bcast"`` records
    per step."""
    from repro_torch.tune import dispatch as _tune
    px, py = _mesh_xy(mesh)
    i, j = (axis_group(mesh, ax)[2] for ax in MESH_AXES)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"pdgemm needs (m, k) @ (k, n); got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    steps = px * py
    res = _tune.resolve("pdgemm", (m, n, k), a.dtype, policy=policy,
                        registry=registry, backend=a.device.type,
                        mesh=(px, py))
    # pad so rows/cols tile the mesh and K splits into px*py equal fine
    # panels (k <= steps * kf, so K always pads to exactly steps * kf)
    kf = -(-max(k, 1) // steps)
    a_p = _pad2(a, px, steps * kf)
    b_p = _pad2(b, steps * kf, py)
    emit_record(CollectiveRecord(
        kind="pdgemm", size=steps,
        info={"m": m, "n": n, "k": k, "px": px, "py": py, "kf": kf,
              "itemsize": a.element_size(), "dtype": _dtype.name(a.dtype)}))
    a_s, b_s = _block(a_p, i, j, px, py), _block(b_p, i, j, px, py)
    spec = {0: ("x",), 1: ("y",)}       # the reference's P("x", "y")
    emit_partition("pdgemm", "a", a.shape, a_p.shape, spec, a_s.shape, mesh)
    emit_partition("pdgemm", "b", b.shape, b_p.shape, spec, b_s.shape, mesh)
    acc = _summa_inner(a_s, b_s, mesh, px=px, py=py, kf=kf, res=res)
    out = all_gather_cat(all_gather_cat(acc, mesh, "y", 1, tag="result"),
                         mesh, "x", 0, tag="result")
    out = alpha * out[:m, :n]
    if c is not None:
        out = out + beta * c
    return out


def _summa_inner(a, b, mesh, *, px: int, py: int, kf: int, res):
    """Per-rank SUMMA body: a (m/px, k/py) A shard holding coarse k-panel
    ``j``; b (k/px, n/py) B shard holding coarse k-panel ``i``. Fine panel
    ``g`` lives at A coarse ``g // px`` offset ``(g % px) * kf`` and B
    coarse ``g // py`` offset ``(g % py) * kf``."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=a.dtype,
                      device=a.device)
    for g in range(px * py):
        a_own, a_off = g // px, (g % px) * kf
        b_own, b_off = g // py, (g % py) * kf
        ap = ring_bcast(a[:, a_off:a_off + kf], mesh, "y", a_own)
        bp = ring_bcast(b[b_off:b_off + kf, :], mesh, "x", b_own)
        acc = acc + _local_update(ap, bp, res)
    return acc


def pdtrsm(a: torch.Tensor, b: torch.Tensor, mesh, lower: bool = True,
           unit_diag: bool = False, left: bool = True,
           block: Optional[int] = None, policy: Optional[str] = None,
           registry=None) -> torch.Tensor:
    """Solve op(T) X = B with the right-hand sides sharded over the mesh.

    The substitution chain down T's diagonal is the serial hazard; the RHS
    columns are the parallel axis. T (n, n) is replicated and B's columns
    are sharded over the flattened ("x", "y") mesh (zero-padded to a
    multiple of the rank count: zero columns solve to zero); every rank
    runs the blocked single-device :func:`repro_torch.blas.level3.trsm`
    (its off-diagonal GEMMs on B1 under the kernel policies) on its column
    slab, and the slabs are gathered. A 1-D ``b`` is one column;
    ``left=False`` solves X op(T) = B by the transpose identity. Returns X
    with B's shape on every rank."""
    if not left:
        return pdtrsm(a.T, b.T, mesh, lower=not lower, unit_diag=unit_diag,
                      left=True, block=block, policy=policy,
                      registry=registry).T
    from repro_torch.blas.level3 import trsm
    px, py = _mesh_xy(mesh)
    i, j = (axis_group(mesh, ax)[2] for ax in MESH_AXES)
    vec = b.ndim == 1
    rhs = b[:, None] if vec else b
    nrhs = rhs.shape[1]
    rhs_p = _pad2(rhs, 1, px * py)
    slab = _block(rhs_p, 0, i * py + j, 1, px * py)
    emit_partition("pdtrsm", "t", a.shape, a.shape, {}, a.shape, mesh)
    emit_partition("pdtrsm", "b", rhs.shape, rhs_p.shape, {1: ("x", "y")},
                   slab.shape, mesh)
    x = trsm(a, slab, lower=lower, unit_diag=unit_diag, left=True,
             block=block, policy=policy, registry=registry)
    x = all_gather_cat(all_gather_cat(x, mesh, "y", 1, tag="result"), mesh,
                       "x", 1, tag="result")
    x = x[:, :nrhs]
    return x[:, 0] if vec else x
