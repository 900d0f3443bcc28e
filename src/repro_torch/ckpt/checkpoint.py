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
leaf comes back on that tensor's device with the file's dtype. The
reference's ``shardings`` (elastic re-placement on a mesh) are left out
until the trainer's sharding (ROADMAP.md A.7b).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

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
    """Atomically write ``tree`` as step ``step``. Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
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


def _fill(like, data, prefix: str = ""):
    """``like``'s structure with the arrays of ``data`` under its keys."""
    if isinstance(like, nn.Module):
        with torch.no_grad():
            for key, p in _children(like):
                arr = torch.from_numpy(data[f"{prefix}{_SEP}{key}"
                                            if prefix else key])
                if arr.shape != p.shape or arr.dtype != p.dtype:
                    raise ValueError(f"{prefix}/{key}: checkpoint holds "
                                     f"{tuple(arr.shape)} {arr.dtype}, the "
                                     f"module {tuple(p.shape)} {p.dtype}")
                p.copy_(arr)
        return like
    kids = _children(like)
    if kids is None:
        arr = torch.from_numpy(np.array(data[prefix]))
        return arr.to(like.device) if isinstance(like, torch.Tensor) else arr
    vals = [_fill(child, data, f"{prefix}{_SEP}{key}" if prefix else key)
            for key, child in kids]
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*vals)
    if isinstance(like, Mapping):
        return dict(zip(like.keys(), vals))
    return type(like)(vals)


def restore(directory: str, like, step: Optional[int] = None):
    """Restore into the structure of ``like`` (see the module docstring).
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
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return _fill(like, data), step
