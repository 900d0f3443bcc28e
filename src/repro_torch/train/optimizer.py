"""AdamW from scratch, with optional 8-bit (blockwise-quantized) moments
(port of ``repro.train.optimizer``).

The 8-bit moments follow the bitsandbytes recipe: dynamic blockwise
quantization with one f32 absmax scale per 256-value block; the second
moment is coded in the sqrt domain with a half-step floor. ``jnp.round``
and ``torch.round`` both round half to even, so the codes are the
reference's.

The state is plain: ``{"step": int32 scalar, "m": {path: moment}, "v":
{path: moment}}``, a moment an f32 tensor of the parameter's shape or a
:class:`_Moment` of int8 codes and block scales, keyed by the parameter's
module path with ``/`` separators (``blocks/0/mix/attn/wq``: the
reference's pytree path with the layer index where it stacks layers).
An 8-bit moment's blocks run over one layer's parameter; the reference
quantizes the stacked (layers, ...) leaf, so where a layer's size is not
a multiple of 256 a block of its straddles two layers. :func:`update`
writes the new parameters into the parameters it is given and the new
f32 moments into the state's tensors, under ``torch.no_grad()``, where
the reference returns new trees.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

Q_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    eight_bit: bool = False
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def named_parameters(model: nn.Module) -> Dict[str, nn.Parameter]:
    """``model``'s parameters keyed by module path with ``/`` separators,
    in registration order."""
    return {n.replace(".", "/"): p for n, p in model.named_parameters()}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in f32 on ``step``'s device."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


# ---------------------------------------------------------------------------
# blockwise int8 quantization
# ---------------------------------------------------------------------------

def _q8(x: torch.Tensor):
    """f32 -> (int8 codes (blocks, Q_BLOCK), f32 block scales (blocks, 1)).
    Pads to Q_BLOCK internally."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % Q_BLOCK
    fp = F.pad(flat, (0, pad)).reshape(-1, Q_BLOCK)
    scale = fp.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(fp / safe), -127, 127).to(torch.int8)
    return q, scale.float()


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    fp = q.float() * scale
    return fp.reshape(-1)[:math.prod(shape)].reshape(shape)


def _q8_sqrt(v: torch.Tensor):
    """Non-negative second moment -> int8 in the sqrt domain (range
    compression: the linear absmax code would flush a block's small
    entries to zero and the Adam denominator would explode)."""
    return _q8(torch.sqrt(v))


def _dq8_sqrt(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    s = q.float() * scale
    floor = scale / (2.0 * 127.0)                  # half quantization step
    s = torch.maximum(s, floor.expand(s.shape))
    return (s * s).reshape(-1)[:math.prod(shape)].reshape(shape)


class _Moment(NamedTuple):
    q: torch.Tensor
    scale: torch.Tensor


Moment = Union[torch.Tensor, _Moment]


def _zeros_moment(p: torch.Tensor, eight_bit: bool) -> Moment:
    if not eight_bit:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    blocks = -(-p.numel() // Q_BLOCK)
    return _Moment(torch.zeros((blocks, Q_BLOCK), dtype=torch.int8,
                               device=p.device),
                   torch.zeros((blocks, 1), dtype=torch.float32,
                               device=p.device))


def init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig) -> dict:
    """Zero moments for ``params`` (path -> tensor), on their device."""
    dev = next(iter(params.values())).device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": {k: _zeros_moment(p, cfg.eight_bit) for k, p in params.items()},
        "v": {k: _zeros_moment(p, cfg.eight_bit) for k, p in params.items()},
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor in ``tree`` (a mapping or
    a sequence), in f32."""
    leaves = tree.values() if isinstance(tree, Mapping) else tree
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in leaves))


@torch.no_grad()
def update(grads: Mapping[str, torch.Tensor], state: dict,
           params: Mapping[str, torch.Tensor], cfg: AdamWConfig,
           lr: Optional[torch.Tensor] = None):
    """One AdamW step over ``params`` (path -> tensor) with ``grads`` of
    the same paths. Returns (params, new_state, stats): the parameters
    updated in place, the state with the new step and moments, and
    {"grad_norm", "lr"} as f32 scalars on the device."""
    step = state["step"] + 1
    gnorm = global_norm([grads[k] for k in params])
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step) if lr is None else lr
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    decay = 1 - lr * cfg.weight_decay
    new_m, new_v = {}, {}
    for k, p in params.items():
        g = grads[k].float() * clip
        m, v = state["m"][k], state["v"][k]
        quantized = isinstance(m, _Moment)
        mf = _dq8(m.q, m.scale, p.shape) if quantized else m
        vf = _dq8_sqrt(v.q, v.scale, p.shape) if quantized else v
        # in place on the f32 moments: cfg.b1 * mf + (1 - cfg.b1) * g
        mf = mf.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        vf = vf.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        upd = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        newp = p.float() * decay - lr * upd
        p.copy_(newp)
        if quantized:
            new_m[k], new_v[k] = _Moment(*_q8(mf)), _Moment(*_q8_sqrt(vf))
        else:
            new_m[k], new_v[k] = mf, vf
    stats = {"grad_norm": gnorm, "lr": lr}
    return params, {"step": step, "m": new_m, "v": new_v}, stats
