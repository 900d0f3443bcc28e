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

:func:`train_state_from_jax` and :func:`train_state_to_jax` carry a whole
train-state checkpoint across, as the flat mapping (key -> numpy array)
that ``ckpt.checkpoint`` writes: the same key map, applied to
``params/...`` and to the moments ``opt/{m,v}/...``.
"""
from __future__ import annotations

import math
import warnings
from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.models import model_zoo
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer
from repro_torch.train.optimizer import Q_BLOCK


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


# ------------------------- train-state checkpoints --------------------------

STACKS = ("blocks", "enc_blocks", "dec_blocks")   # the reference's layer stacks
_FIELDS = ("/.q", "/.scale")                      # an 8-bit moment's keys


def _q8(x: np.ndarray):
    """The optimizer's 8-bit coding of ``x``'s values, as numpy arrays:
    (int8 codes (blocks, Q_BLOCK), f32 scales (blocks, 1))."""
    q, scale = optimizer._q8(torch.from_numpy(np.asarray(x, np.float32)))
    return q.numpy(), scale.numpy()


def _codes_value(q: np.ndarray, scale: np.ndarray, n: int) -> np.ndarray:
    """The first ``n`` values an 8-bit moment codes (the second moment's
    in its sqrt domain, where it is quantized)."""
    return (q.astype(np.float32) * scale).reshape(-1)[:n]


def _split_stack(key: str):
    """(stack prefix, layer, rest) of a port key under a layer stack
    (``params/blocks/3/attn/wq`` -> ``params/blocks``, 3, ``attn/wq``),
    or None."""
    parts = key.split("/")
    for i, p in enumerate(parts[:-1]):
        if p in STACKS and parts[i + 1].isdigit():
            return ("/".join(parts[:i + 1]), int(parts[i + 1]),
                    "/".join(parts[i + 2:]))
    return None


def _is_stacked(key: str) -> bool:
    """Is a reference key under a layer stack?"""
    return any(p in STACKS for p in key.split("/")[:-1])


def _param_key(moment_key: str) -> str:
    """``opt/m/<path>[/.q]`` -> ``params/<path>``."""
    path = moment_key.split("/", 2)[2]
    for f in _FIELDS:
        if path.endswith(f):
            path = path[:-len(f)]
    return "params/" + path


def _warn_requantized(keys, direction):
    if keys:
        warnings.warn(
            f"{direction}: {len(keys)} 8-bit moments have layers whose size "
            f"is not a multiple of {Q_BLOCK}, so the reference's blocks "
            f"straddle layers; they were dequantized, restacked and "
            f"requantized (each value within half a code step of its block "
            f"scale), e.g. {sorted(keys)[:3]}", stacklevel=3)


def train_state_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A reference train-state checkpoint (``params/...``, ``opt/step``,
    ``opt/{m,v}/...``, layers stacked on a leading axis) in the port's
    keys (one key per layer, module paths), for ``ckpt.checkpoint.restore``
    into a ``train_state`` of the port.

    Parameters and f32 moments are split bitwise. An 8-bit moment's
    blocks run over the whole stack in the reference and over one layer
    in the port: where each layer's size is a multiple of ``Q_BLOCK`` the
    stack's blocks split into the layers' exactly; otherwise a block
    straddles two layers, and those moments are dequantized, split and
    requantized per layer, each value within half a code step of its new
    block's scale (a warning names them)."""
    out: Dict[str, np.ndarray] = {}
    requant = set()
    for key, arr in flat.items():
        arr = np.asarray(arr)
        if not _is_stacked(key):
            out[key] = arr
            continue
        parts = key.split("/")
        i = next(j for j, p in enumerate(parts) if p in STACKS)
        head, rest = "/".join(parts[:i + 1]), "/".join(parts[i + 1:])
        if not key.endswith(_FIELDS):               # a parameter or f32 moment
            for layer in range(arr.shape[0]):
                out[f"{head}/{layer}/{rest}"] = arr[layer]
            continue
        if key.endswith("/.scale"):
            continue                                # handled with its codes
        base, rest = key[:-len("/.q")], rest[:-len("/.q")]
        shape = flat[_param_key(key)].shape
        layers, n = shape[0], math.prod(shape[1:])
        q, scale = arr, np.asarray(flat[base + "/.scale"])
        if n % Q_BLOCK == 0:
            qs = q.reshape(layers, n // Q_BLOCK, Q_BLOCK)
            ss = scale.reshape(layers, n // Q_BLOCK, 1)
        else:
            requant.add(base)
            vals = _codes_value(q, scale, layers * n).reshape(layers, n)
            qs, ss = zip(*(_q8(v) for v in vals))
        for layer in range(layers):
            out[f"{head}/{layer}/{rest}/.q"] = qs[layer]
            out[f"{head}/{layer}/{rest}/.scale"] = ss[layer]
    _warn_requantized(requant, "train_state_from_jax")
    return out


def train_state_to_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The port's train-state checkpoint in the reference's keys: the
    inverse of :func:`train_state_from_jax`, under the same rule (f32
    leaves and whole-block 8-bit moments stack bitwise, the others are
    requantized over the stack, with a warning)."""
    groups: Dict[str, Dict[int, np.ndarray]] = {}
    out: Dict[str, np.ndarray] = {}
    for key, arr in flat.items():
        split = _split_stack(key)
        if split is None:
            out[key] = np.asarray(arr)
            continue
        head, layer, rest = split
        groups.setdefault(f"{head}/{rest}", {})[layer] = np.asarray(arr)
    requant = set()
    for key, layers in groups.items():
        if sorted(layers) != list(range(len(layers))):
            raise KeyError(f"{key}: layers {sorted(layers)} are not 0..L-1")
        stack = [layers[i] for i in range(len(layers))]
        if not key.endswith(_FIELDS):
            out[key] = np.stack(stack)
            continue
        if key.endswith("/.scale"):
            continue
        base = key[:-len("/.q")]
        scales = groups[base + "/.scale"]
        n = math.prod(groups[_param_key(base)][0].shape)
        if n % Q_BLOCK == 0:
            out[key] = np.concatenate(stack)
            out[base + "/.scale"] = np.concatenate(
                [scales[i] for i in range(len(stack))])
        else:
            requant.add(base)
            vals = np.concatenate([_codes_value(q, scales[i], n)
                                   for i, q in enumerate(stack)])
            out[key], out[base + "/.scale"] = _q8(vals)
    _warn_requantized(requant, "train_state_to_jax")
    return out

