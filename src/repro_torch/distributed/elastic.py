"""Elastic re-scaling: move a train state between meshes of different
size (port of ``repro.distributed.elastic``).

A checkpoint written on one mesh restores onto any other (more ranks,
fewer, another DP x TP split, or one device): checkpoints hold full
logical arrays (``ckpt.checkpoint``), and this module derives the
sharding rules on the new mesh and re-places every leaf. The data
pipeline is counter-based, so the token stream is the same across
re-shardings.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.ckpt import checkpoint
from repro_torch.distributed import sharding as sh


def reshard_state(state: dict, new_mesh, fsdp: bool = True) -> dict:
    """Re-place an in-memory train state onto ``new_mesh`` (every leaf
    gathered on its old mesh, then cut at ``state_specs`` on the new one;
    ``None``: one device). Every rank of the old and the new mesh calls
    it."""
    return sh.place_state(state, new_mesh, fsdp=fsdp)


def elastic_restore(directory: str, like: dict, new_mesh,
                    step: Optional[int] = None, fsdp: bool = True):
    """Restore the latest (or given) checkpoint onto ``new_mesh`` (None:
    one device, into ``like`` as ``checkpoint.restore`` does). ``like``:
    a train state of the same structure (``train_state.state_for`` of a
    model built on any device, ``meta`` included, for a mesh). Returns
    (state, step)."""
    if new_mesh is None:
        return checkpoint.restore(directory, like, step=step)
    specs = sh.state_specs(sh.state_shapes(like), new_mesh, fsdp=fsdp)
    return checkpoint.restore(directory, like, step=step,
                              shardings=sh.to_shardings(specs, new_mesh))
