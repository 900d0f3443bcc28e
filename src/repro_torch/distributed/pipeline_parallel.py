"""Pipeline parallelism: the GPipe fill-drain microbatch schedule over a
"stage" mesh axis (port of ``repro.distributed.pipeline_parallel``).

Stage ``s`` computes microbatch ``t - s`` at tick ``t``, over ``M + S - 1``
ticks, and hands its output to stage ``s + 1`` through a point-to-point
send / receive pair on the "stage" axis's group (``P2POp`` and
``batch_isend_irecv``, as ``collectives.ring_bcast`` moves panels; through
pinned host memory for gloo on the card). The last stage collects the
outputs, which then reach every rank.

As everything on the port's meshes, it is SPMD: every rank calls ``run``
with the same stacked parameters and microbatches and takes its stage's
slice by its coordinate. Where the reference's ``shard_map`` body runs the
stage function on every tick, bubbles included, and masks what it
discards, a stage here runs only on the ticks that hold a microbatch, and
only those cross the wire: ``M`` calls of ``stage_fn`` a rank. The
outputs are broadcast from the last stage (the reference sums a masked
buffer over the axis), so every rank returns them bitwise.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

from repro_torch.distributed import collectives as coll


def _stage_slice(t, sid: int):
    """Stage ``sid``'s parameters: the leading-dim slice of a stacked
    leaf, or the local shard of one sharded over the stage axis."""
    if isinstance(t, DTensor):
        return t.to_local()[0]
    return t[sid]


def pipeline_forward(stage_fn: Callable, mesh, stage_axis: str = "stage"):
    """Builds ``run(params_stacked, x_micro) -> y_micro``.

    ``params_stacked``: a tree (mappings, lists, tuples) of tensors with a
    leading dim of ``n_stages`` (:func:`stack_stage_params`), or sharded
    over ``stage_axis`` on it. ``x_micro``: (M, B, ...) microbatches, the
    same on every rank. ``stage_fn(params, x)`` keeps ``x``'s shape and
    dtype. Returns the (M, B, ...) outputs of the last stage on every
    rank."""
    group, n_stages, sid = coll.axis_group(mesh, stage_axis)
    last = n_stages - 1
    succ = dist.get_global_rank(group, (sid + 1) % n_stages)
    pred = dist.get_global_rank(group, (sid - 1) % n_stages)

    def run(params_stacked, x_micro: torch.Tensor) -> torch.Tensor:
        params = pytree.tree_map(lambda t: _stage_slice(t, sid),
                                 params_stacked)
        m = x_micro.shape[0]
        buf = torch.zeros_like(x_micro)              # the last stage's
        wire = coll._wire_empty(group, x_micro, x_micro.shape[1:])
        for t in range(m + n_stages - 1):
            mb = t - sid
            if not 0 <= mb < m:
                continue                             # a bubble: idle
            if sid == 0:
                xin = x_micro[mb]
            else:                        # stage s - 1's, from tick t - 1
                for r in dist.batch_isend_irecv([
                        dist.P2POp(dist.irecv, wire, pred, group)]):
                    r.wait()
                xin = coll._back(wire, x_micro).clone()
            y = stage_fn(params, xin)
            if sid == last:
                buf[mb] = y
            else:
                out = coll._wire(group, y)
                for r in dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, out, succ, group)]):
                    r.wait()
        src = dist.get_global_rank(group, last)
        staged = coll._wire(group, buf)
        dist.broadcast(staged, src=src, group=group)
        return coll._back(staged, buf)

    return run


def stack_stage_params(per_stage_params):
    """[stage0_params, stage1_params, ...] -> one tree whose leaves are
    stacked on a leading stage dim."""
    leaves = [pytree.tree_flatten(p) for p in per_stage_params]
    spec = leaves[0][1]
    return pytree.tree_unflatten(
        [torch.stack(ls) for ls in zip(*(l for l, _ in leaves))], spec)
