"""Shared layer primitives (port of ``repro.models.layers``): RMSNorm,
embedding, gated FFN, RoPE, sinusoidal positions.

Parameters are stored in float32 and cast to the compute dtype at use; norms
and RoPE run in float32 - the reference's numerics. Modules are built with
uninitialized storage (``torch.empty``) on the device they are given;
:func:`repro_torch.models.model_zoo.init` draws the reference's
distributions into them and :func:`repro_torch.models.convert.from_jax_params`
copies the JAX package's values. Parameters are built without
``requires_grad``, so serving records no graph; the trainer
(:func:`repro_torch.train.train_state.init_state`) turns it on.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def param(*shape: int, device=None) -> nn.Parameter:
    """An uninitialized float32 parameter of ``shape``, not requiring
    grad until the trainer asks."""
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


def truncated_normal_(t: torch.Tensor, scale: float,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """``scale`` times a standard normal truncated to [-2, 2], in place:
    the reference's ``truncated_normal`` drawn from a torch generator."""
    with torch.no_grad():
        nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                              generator=generator)
        return t.mul_(scale)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ w (+ b) with the parameters cast to x's dtype."""
    y = x @ w.to(x.dtype)
    return y if b is None else y + b.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = param(d, device=device)

    def reset(self, generator=None) -> None:
        nn.init.ones_(self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.scale).to(x.dtype)


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, device=None):
        super().__init__()
        self.table = param(vocab, d, device=device)

    def reset(self, generator=None) -> None:
        truncated_normal_(self.table, 1.0, generator)

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        # gather then cast: the same values as the reference's cast then
        # gather, without casting the whole table; F.embedding's backward
        # sums each row's gradients in a fixed order (an indexing
        # backward adds them in an order that varies from run to run)
        return F.embedding(ids, self.table).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D) or (..., S, D); positions (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                # (..., S, half)
    if x.ndim == ang.ndim + 1:                                # head dim present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(seq: int, d: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """(seq, d) sine / cosine positions, computed in float32: sines in the
    even columns, cosines in the odd ones. The cosines take the first
    ``(d + 1) // 2`` frequencies, as the reference's do, so an odd ``d``
    raises on both sides."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(-math.log(10_000.0) * torch.arange(
        0, d, 2, dtype=torch.float32, device=device) / d)
    pe = torch.zeros(seq, d, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: (d + 1) // 2])
    return pe.to(dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":        # jax.nn.gelu defaults to the tanh form
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


class FFN(nn.Module):
    def __init__(self, d: int, f: int, glu: bool, act: str, device=None):
        super().__init__()
        self.act = act
        self.w_in = param(d, f, device=device)
        self.w_out = param(f, d, device=device)
        self.w_gate = param(d, f, device=device) if glu else None

    def reset(self, generator=None) -> None:
        d, f = self.w_in.shape
        truncated_normal_(self.w_in, d ** -0.5, generator)
        truncated_normal_(self.w_out, f ** -0.5, generator)
        if self.w_gate is not None:
            truncated_normal_(self.w_gate, d ** -0.5, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = linear(x, self.w_in)
        if self.w_gate is not None:
            h = activation(linear(x, self.w_gate), self.act) * h
        else:
            h = activation(h, self.act)
        return linear(h, self.w_out)
