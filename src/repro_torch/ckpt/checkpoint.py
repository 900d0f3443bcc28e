"""Atomic keep-N checkpointing with resume (port of
``repro.ckpt.checkpoint``).

Layout: ``<dir>/step_<N:010d>/{manifest.json, arrays.npz}``, written to a
temporary directory and renamed into place (rename is atomic on POSIX), so
a crash mid-save can never corrupt the latest checkpoint. The manifest
schema is the reference's (``step``, ``keys``, ``dtypes``, ``shapes``).

A tree is nested mappings, named tuples (the 8-bit moments), lists and
tuples, and modules, whose parameters stand under their module path; the
leaves are tensors or numpy arrays. A key joins the path with ``/``, and a
named tuple's field takes a leading ``.``, as the reference prints jax's
``GetAttrKey``: the train state's keys are ``params/<module path>``
(``params/blocks/0/mix/attn/wq``), ``opt/step``, ``opt/m/<module path>``
(8-bit: ``.../.q`` and ``.../.scale``). A flat mapping of arrays gives the
same keys on both sides, so each package reads the other's checkpoint of
one. A train state's keys differ in one more place: the reference stacks
the layers (``params/blocks/mix/attn/wq``, shape (L, ...)) where the port
keys each layer, so each package's ``restore`` raises ``KeyError`` on the
other's train state until
:func:`repro_torch.models.convert.train_state_from_jax` /
:func:`~repro_torch.models.convert.train_state_to_jax` converts it.

``restore`` fills the structure of ``like``: a module's parameters are
copied into it in place (a module cannot be rebuilt from a tree), a tensor
leaf comes back on that tensor's device with the file's dtype.

**On a mesh** (a tree holding DTensors, ``distributed.sharding``): the
files hold the full logical arrays all the same, so a checkpoint written
on one mesh restores on any other, on one device, and in the other
package (through ``models.convert``). Every rank of the mesh calls
``save``: each leaf is all-gathered in key order (a collective, not
counted under the step's counters), and only the mesh's first rank keeps
the arrays and writes them, by the same atomic rename; the other ranks
wait at a barrier over the mesh until the rename is done, so no rank can
read a step before it exists or a half-written one. ``restore(...,
shardings=)`` (the tree of ``sharding.to_shardings``) reads on each rank
only its block of each leaf, through a memory map of the leaf inside
``arrays.npz`` (stored uncompressed), and returns DTensors at those
placements; a module's parameters become ``nn.Parameter(DTensor)`` and
its blocks take the gather hooks (``sharding.shard_model``). ``like``
may then be built on the ``meta`` device.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import tempfile
import zipfile
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.distributed import sharding as sh

_SEP = "/"


def _children(tree):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(tree, nn.Module):
        return [(n.replace(".", _SEP), p) for n, p in tree.named_parameters()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [("." + f, v) for f, v in zip(tree._fields, tree)]
    if isinstance(tree, Mapping):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, object]:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat = {}
    for key, child in kids:
        flat.update(_flatten(child, f"{prefix}{_SEP}{key}" if prefix
                             else key))
    return flat


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("npz cannot hold bfloat16; the train state is "
                            "f32, int8 and int32")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree, keep: Optional[int] = None) -> str:
    """Atomically write ``tree`` as step ``step``. Returns the final path.
    A tree on a mesh is saved by every rank of it together (module
    docstring)."""
    final = os.path.join(directory, f"step_{step:010d}")
    flat = _flatten(tree)
    mesh = sh.tree_mesh(list(flat.values()))
    if mesh is None:
        return _write(directory, step, final,
                      {k: _to_numpy(v) for k, v in flat.items()}, keep)
    writer = dist.get_rank() == int(mesh.mesh.min())
    arrays = {}
    for k, v in flat.items():
        full = sh.full_tensor(v)
        if writer:
            arrays[k] = _to_numpy(full)
        del full
    if writer:
        _write(directory, step, final, arrays, keep)
    del arrays
    sh.mesh_barrier(mesh)
    return final


def _write(directory: str, step: int, final: str, flat: Dict[str, np.ndarray],
           keep: Optional[int]) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_save_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat.keys()),
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "shapes": {k: list(v.shape) for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic commit
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if keep is not None:
        for old in all_steps(directory)[:-keep]:
            shutil.rmtree(os.path.join(directory, f"step_{old:010d}"),
                          ignore_errors=True)
    return final


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_")[1]))
            except (IndexError, ValueError):
                continue
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _fill(like, data, prefix: str = "", shardings=None):
    """``like``'s structure with the arrays of ``data`` under its keys;
    the keys in ``shardings`` (flat) come back as DTensors at them, read
    from ``data`` (an :class:`_Members`) block by block."""
    if isinstance(like, nn.Module):
        placed = False
        with torch.no_grad():
            for key, p in _children(like):
                full = f"{prefix}{_SEP}{key}" if prefix else key
                if shardings and full in shardings:
                    sh.set_param(like, key, data.block(
                        full, shardings[full]))
                    placed = True
                    continue
                arr = torch.from_numpy(data[full])
                if arr.shape != p.shape or arr.dtype != p.dtype:
                    raise ValueError(f"{prefix}/{key}: checkpoint holds "
                                     f"{tuple(arr.shape)} {arr.dtype}, the "
                                     f"module {tuple(p.shape)} {p.dtype}")
                p.copy_(arr)
        if placed:
            sh.hook_model(like)
        return like
    kids = _children(like)
    if kids is None:
        if shardings and prefix in shardings:
            return data.block(prefix, shardings[prefix])
        arr = torch.from_numpy(np.array(data[prefix]))
        return arr.to(like.device) if isinstance(like, torch.Tensor) else arr
    vals = [_fill(child, data, f"{prefix}{_SEP}{key}" if prefix else key,
                  shardings)
            for key, child in kids]
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*vals)
    if isinstance(like, Mapping):
        return dict(zip(like.keys(), vals))
    return type(like)(vals)


def restore(directory: str, like, step: Optional[int] = None,
            shardings=None):
    """Restore into the structure of ``like`` (see the module docstring);
    ``shardings``: a tree of ``distributed.sharding.NamedSharding`` over
    the same keys (some or all), to restore those leaves onto a mesh.
    Returns (tree, step)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    missing = [k for k in _flatten(like) if k not in manifest["keys"]]
    if missing:
        raise KeyError(f"checkpoint at step {step} missing keys: "
                       f"{missing[:5]}")
    if shardings is not None:
        members = _Members(os.path.join(path, "arrays.npz"))
        flat = {k: v for k, v in _flatten(shardings).items()}
        return _fill(like, members, shardings=flat), step
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return _fill(like, data), step


class _Members:
    """The arrays of an uncompressed ``.npz`` as memory maps: ``m[key]``
    maps a whole leaf, ``m.block(key, sharding)`` reads this rank's block
    of it only."""

    def __init__(self, path: str):
        self.path, self.index = path, {}
        with zipfile.ZipFile(path) as z, open(path, "rb") as f:
            for info in z.infolist():
                if info.compress_type != zipfile.ZIP_STORED:
                    raise ValueError(f"{path}: {info.filename} is "
                                     f"compressed; a map needs it stored")
                f.seek(info.header_offset)
                local = f.read(30)
                name_len, extra_len = struct.unpack("<HH", local[26:30])
                f.seek(info.header_offset + 30 + name_len + extra_len)
                version = np.lib.format.read_magic(f)
                read = (np.lib.format.read_array_header_1_0
                        if version == (1, 0)
                        else np.lib.format.read_array_header_2_0)
                shape, fortran, dtype = read(f)
                self.index[info.filename[:-len(".npy")]] = (
                    f.tell(), tuple(shape), fortran, dtype)

    def __getitem__(self, key: str) -> np.ndarray:
        offset, shape, fortran, dtype = self.index[key]
        mm = np.memmap(self.path, dtype=dtype, mode="r", offset=offset,
                       shape=shape or (1,), order="F" if fortran else "C")
        return mm.reshape(shape)

    def block(self, key: str, sharding):
        """This rank's block of leaf ``key`` at ``sharding``, a DTensor."""
        leaf = self[key]
        idx = sh.local_index(leaf.shape, sharding.placements, sharding.mesh)
        return sh.wrap(torch.from_numpy(np.array(leaf[idx])), sharding,
                       leaf.shape)
