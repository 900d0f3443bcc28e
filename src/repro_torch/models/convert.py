"""Carry the JAX package's parameters into the port's modules.

:func:`from_jax_params` takes the parameter pytree that
``repro.models.model_zoo.init`` returns, as numpy arrays (any mapping of
mappings whose leaves ``numpy.asarray`` accepts), and returns the port's
:class:`~repro_torch.models.transformer.LM` holding the same values. The
module tree mirrors the pytree key for key (``embed/table``,
``blocks/<i>/mix/attn/wq``, ...); the reference stacks every ``blocks``
leaf on a leading ``n_layers`` axis, which is split here. Nothing of the
JAX package is imported: the caller converts the arrays.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM


def load_tree(module: torch.nn.Module, tree: Mapping, path: str = "",
              layer=None) -> int:
    """Copy a (sub)tree of numpy leaves into the same-named parameters of
    ``module`` (leaf ``[layer]`` when given); returns the leaves copied."""
    n = 0
    for key, value in tree.items():
        target = getattr(module, key, None)
        where = f"{path}/{key}"
        if target is None:
            raise KeyError(f"{where}: the port's module has no {key!r}")
        if isinstance(value, Mapping):
            n += load_tree(target, value, where, layer)
            continue
        arr = np.asarray(value, dtype=np.float32)
        if layer is not None:
            arr = arr[layer]
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{where}: shape {arr.shape} does not match the "
                             f"port's {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(torch.from_numpy(np.array(arr)))
        n += 1
    return n


def from_jax_params(params: Mapping, cfg: ModelConfig, device="cuda") -> LM:
    """The port's model of ``cfg`` on ``device`` (the card unless the
    caller asks for the CPU, as :func:`model_zoo.init`) holding
    ``params``' values; raises if a leaf is missing, extra or of another
    shape."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.models.convert.from_jax_params "
                           "builds on 'cuda' by default and no CUDA device "
                           "is available; ask for the CPU with device='cpu'")
    model = LM(cfg, device=device)
    loaded = 0
    for key, value in params.items():
        if key == "blocks":
            for i, blk in enumerate(model.blocks):
                loaded += load_tree(blk, value, f"blocks/{i}", layer=i)
        else:
            loaded += load_tree(model, {key: value})
    total = len(list(model.parameters()))
    if loaded != total:
        raise ValueError(f"loaded {loaded} of the port's {total} parameters")
    return model
