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

On a mesh (:mod:`repro_torch.distributed.sharding`) a module's forward
finds the parameters its ``TP_LEAVES`` name as this rank's blocks over
the "model" axis where their specs split them (:func:`tp_split` gives the
split's record and the axis's ops), and runs its products tensor-parallel
(Megatron): a column-parallel product takes its input through
``tp.copy`` (whose backward sums the input's gradient over "model") and
gives this rank's columns; a row-parallel one (:func:`row_linear`) takes
this rank's slice of the features and sums the partial products over
"model". A module whose leaves are whole runs as on one device.
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
    """x @ w (+ b) with the parameters cast to x's dtype. Its
    column-parallel form is the same call on ``tp.copy(x)`` and w's block
    of columns (the output: this rank's columns)."""
    y = x @ w.to(x.dtype)
    return y if b is None else y + b.to(x.dtype)


def row_linear(x: torch.Tensor, w: torch.Tensor, tp) -> torch.Tensor:
    """The row-parallel form of :func:`linear`: ``x`` this rank's slice of
    the input features and ``w`` its block of rows; the partial products
    summed over "model" (``tp.reduce``)."""
    return tp.reduce(linear(x, w))


def narrow_spans(t: torch.Tensor, dim: int, spans) -> torch.Tensor:
    """Entries ``spans`` ([start, stop) pairs) along ``dim`` of ``t``,
    concatenated in order (a view where there is one span)."""
    if len(spans) == 1:
        (a, b), = spans
        return t.narrow(dim, a, b - a)
    return torch.cat([t.narrow(dim, a, b - a) for a, b in spans], dim)


def tp_split(module: nn.Module, name: str):
    """The record of ``module``'s parameter ``name`` kept as this rank's
    block over "model" (a ``sharding.TPSplit``: the split dim, the axis's
    size and this rank's index, and the axis's ops), or None where the
    leaf is whole (one device, or a spec that leaves it replicated)."""
    return module.__dict__.get("_tp_leaves", {}).get(name)


def mark_vocab_split(logits: torch.Tensor, tp) -> torch.Tensor:
    """Mark ``logits`` as this rank's columns of the vocabulary (a
    vocab-parallel head's), for the loss and ``sharding.gather_logits``."""
    logits._vocab_split = tp
    return logits


def vocab_split(logits: torch.Tensor):
    """The record of a vocab-parallel head that ``logits`` came from
    (:func:`mark_vocab_split`), or None (whole logits)."""
    return getattr(logits, "_vocab_split", None)


def mark_seq_split(cache: torch.Tensor, split) -> torch.Tensor:
    """Mark a decode cache leaf (k or v, (..., B, S, Hkv, hd)) as this
    rank's block of its sequence over "model" (a ``sharding.SeqSplit``:
    the axis's size, this rank's index and the decode ops), for
    attention's decode (``sharding.decode_step`` marks them)."""
    cache._seq_split = split
    return cache


def seq_split(cache: torch.Tensor):
    """The record of a cache leaf held as this rank's sequence block
    (:func:`mark_seq_split`), or None (the whole sequence)."""
    return getattr(cache, "_seq_split", None)


def mark_head_split(state: torch.Tensor, tp) -> torch.Tensor:
    """Mark a decode cache's SSM state ((..., B, H, P, N)) as this rank's
    block of its heads over "model" (a ``sharding.TPSplit``), for
    mamba's decode (``sharding.decode_step`` marks it)."""
    state._head_split = tp
    return state


def head_split(state: torch.Tensor):
    """The record of an SSM state held as this rank's head block
    (:func:`mark_head_split`), or None (every head)."""
    return getattr(state, "_head_split", None)


def cache_slots(cache: torch.Tensor, dim: int = 1) -> int:
    """The slots of a decode cache along its sequence ``dim``: the whole
    sequence's, where the leaf holds this rank's block of it."""
    split = seq_split(cache)
    return cache.shape[dim] * (1 if split is None else split.size)


def layer_view(cache: torch.Tensor, i: int) -> torch.Tensor:
    """Layer ``i`` of a stacked cache leaf, its sequence or head block's
    mark kept."""
    view = cache[i]
    if seq_split(cache) is not None:
        return mark_seq_split(view, seq_split(cache))
    if head_split(cache) is not None:
        return mark_head_split(view, head_split(cache))
    return view


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
    """A (V, d) table. Vocab-parallel on a mesh where ``table`` is split
    over V: each rank looks up the ids of its vocabulary range (zeros
    elsewhere) and the rows are summed over "model"; the table's gradient
    stays this rank's rows."""

    TP_LEAVES = ("table",)

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
        tp = tp_split(self, "table")
        if tp is None:
            return F.embedding(ids, self.table).to(dtype)
        lo = tp.index * self.table.shape[0]
        mine = (ids >= lo) & (ids < lo + self.table.shape[0])
        rows = F.embedding(torch.where(mine, ids - lo, 0), self.table)
        rows = torch.where(mine[..., None], rows, 0.0)
        return tp.reduce(rows).to(dtype)


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
    """The (gated) FFN. On a mesh ``w_in`` / ``w_gate`` are
    column-parallel, the activation runs on this rank's columns and
    ``w_out`` is row-parallel (the three split together: f over
    "model")."""

    TP_LEAVES = ("w_in", "w_gate", "w_out")

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
        tp = tp_split(self, "w_out")
        if tp is not None:
            x = tp.copy(x)
        h = linear(x, self.w_in)
        if self.w_gate is not None:
            h = activation(linear(x, self.w_gate), self.act) * h
        else:
            h = activation(h, self.act)
        return linear(h, self.w_out) if tp is None else \
            row_linear(h, self.w_out, tp)
