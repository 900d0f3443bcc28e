"""Device meshes on torch.distributed (port of ``repro.launch.mesh``).

Defined as functions: importing this module touches no process group.
Single pod: 16 x 16 = 256 ranks ("data", "model"); multi-pod: 2 x 16 x 16
= 512 ranks with the leading "pod" axis spanning the cross-pod links. A
mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with the
reference's axis names; each axis's sub-group is ``mesh.get_group(axis)``.

Every rank runs one process and builds the same meshes in the same order
(the sub-groups are created collectively). The caller starts the ranks
and initializes the default process group itself: NCCL where every rank
has a card of its own, gloo for CPU ranks or for ranks that share one
card, named by the caller (nothing here switches backend). A mesh of
another size than the world, or a missing process group, raises.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def world_ranks(needed: int, what: str, exact: bool = True) -> int:
    """The world size, after checking that a process group is initialized
    and holds ``needed`` ranks (at least ``needed`` when not ``exact``);
    raises naming ``what`` and both numbers otherwise."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what} needs an initialized torch.distributed process group "
            f"of {needed} rank{'s' if needed != 1 else ''} and there is "
            f"none: start one process per rank and call "
            f"torch.distributed.init_process_group (nccl with a card per "
            f"rank, gloo for CPU ranks or ranks sharing a card)")
    world = dist.get_world_size()
    if world < needed or (exact and world != needed):
        raise ValueError(f"{what} needs {needed} ranks; the process group "
                         f"holds {world}")
    return world


def mesh_device_type() -> str:
    """The DeviceMesh device type of the default group's backend: "cuda"
    for NCCL, "cpu" for gloo (whose transport is host memory, wherever
    the tensors lie)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape, axes, device_type=None) -> DeviceMesh:
    """A mesh of exactly the world's ranks. ``device_type`` (default
    :func:`mesh_device_type`) is where DTensors on it live: "cuda" for a
    trainer's state on the card, also over gloo ranks sharing it."""
    world_ranks(math.prod(shape), f"a {'x'.join(map(str, shape))} {axes} "
                                  f"mesh")
    return init_device_mesh(device_type or mesh_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def sub_mesh(shape, axes) -> DeviceMesh:
    """A mesh of the first ``prod(shape)`` ranks of the world (the
    reference's meshes over the first devices); ranks past them hold no
    coordinate but still take part in creating the sub-groups."""
    n = math.prod(shape)
    world_ranks(n, f"a {'x'.join(map(str, shape))} {axes} mesh",
                exact=False)
    return DeviceMesh(mesh_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type=None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0,
                    device_type=None) -> DeviceMesh:
    """Small mesh for tests; the world must hold exactly its ranks."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"),
                         device_type)
    return make_mesh((data, model), ("data", "model"), device_type)


def mesh_shape(mesh: DeviceMesh) -> dict:
    """{axis name: size}, in axis order (jax's ``Mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_name(mesh: DeviceMesh) -> str:
    return "x".join(f"{k}{v}" for k, v in mesh_shape(mesh).items())
