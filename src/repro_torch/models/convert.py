"""Carry the JAX package's parameters into the port's modules.

:func:`from_jax_params` takes the parameter pytree that
``repro.models.model_zoo.init`` returns, as numpy arrays (any mapping of
mappings whose leaves ``numpy.asarray`` accepts), and returns the port's model
(:class:`~repro_torch.models.transformer.LM`, or
:class:`~repro_torch.models.encdec.EncDec` for the encdec family) holding
the same values. The module tree mirrors the pytree key for key
(``embed/table``, ``blocks/<i>/mix/attn/wq``, ``blocks/<i>/moe/w_in``,
``frontend_proj``, ``enc_blocks/<i>/attn/wq``, ``dec_blocks/<i>/xattn/wk``,
...); the reference stacks every leaf of ``blocks``, ``enc_blocks`` and
``dec_blocks`` on a leading layer axis (a moe leaf: before its expert
axis), which is split here. Nothing of the JAX package is imported: the
caller converts the arrays.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.models import model_zoo
from repro_torch.models.config import ModelConfig


def load_tree(module: torch.nn.Module, tree: Mapping, path: str = "",
              layer=None, layers=None) -> int:
    """Copy a (sub)tree of numpy leaves into the same-named parameters of
    ``module`` (leaf ``[layer]`` of a stack of ``layers`` when given);
    returns the leaves copied."""
    n = 0
    for key, value in tree.items():
        target = getattr(module, key, None)
        where = f"{path}/{key}"
        if target is None:
            raise KeyError(f"{where}: the port's module has no {key!r}")
        if isinstance(value, Mapping):
            n += load_tree(target, value, where, layer, layers)
            continue
        arr = np.asarray(value, dtype=np.float32)
        if layer is not None:
            if arr.ndim == 0 or arr.shape[0] != layers:
                raise ValueError(f"{where}: shape {arr.shape} is not a stack "
                                 f"of the port's {layers} layers")
            arr = arr[layer]
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{where}: shape {arr.shape} does not match the "
                             f"port's {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(torch.from_numpy(np.array(arr)))
        n += 1
    return n


def from_jax_params(params: Mapping, cfg: ModelConfig,
                    device="cuda") -> model_zoo.Model:
    """The port's model of ``cfg`` on ``device`` (the card unless the
    caller asks for the CPU, as :func:`model_zoo.init`) holding
    ``params``' values; raises if a leaf is missing, extra or of another
    shape."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.models.convert.from_jax_params "
                           "builds on 'cuda' by default and no CUDA device "
                           "is available; ask for the CPU with device='cpu'")
    model = model_zoo.build(cfg, device)
    loaded = 0
    for key, value in params.items():
        stack = getattr(model, key, None)
        if isinstance(stack, torch.nn.ModuleList):     # a layer stack
            for i, blk in enumerate(stack):
                loaded += load_tree(blk, value, f"{key}/{i}", layer=i,
                                    layers=len(stack))
        else:
            loaded += load_tree(model, {key: value})
    total = len(list(model.parameters()))
    if loaded != total:
        raise ValueError(f"loaded {loaded} of the port's {total} parameters")
    return model
