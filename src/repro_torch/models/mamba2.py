"""Mamba-2 (SSD) block (port of ``repro.models.mamba2``): projections, the
causal depthwise conv, and the selective state space.

The full-sequence path runs the chunked SSD through
:func:`repro_torch.kernels.ops.ssd` (kernel B6 on the card, the reference's
chunked oracle on the CPU or under ``use_kernels=False``); decode is the
one-step recurrence against a cached (H, P, N) state and conv tail, in
plain PyTorch as in the reference.

On a mesh (``layers.tp_split``) the block runs **by head** where its SSM
heads divide "model": rank ``i`` owns heads ``[lo, hi) = tp.span(H)`` and
the groups they read, and runs the conv on their channels, the scan on
them (B6 on a head block on the card), the gated norm on their slice of
``d_inner`` (its sum of squares summed over "model") and the
row-parallel ``out_proj`` straight on their rows. Its in_proj columns
(``[z, x, B, C, dt]``: a contiguous block does not fall on head edges)
come from whichever gather moves fewer bytes: in_proj's columns gathered
and narrowed to the rank's (``mamba in_proj columns``, where the rank's
tokens outweigh ``d_model``), or the product's output gathered and
narrowed (``mamba in_proj output``), each a reduce-scatter back; from a
whole in_proj they are picked. The small whole leaves (``conv_w conv_b
a_log dt_bias d_skip`` and the norm's scale) are picked at the rank's
entries. Decode keeps the state as the rank's head block where
``sharding.decode_step`` marks it so (``layers.head_split``); the conv
tail is whole, so decode gathers every column of in_proj's output and
every rank forms the whole new tail. Where the heads do not divide,
in_proj's output is gathered whole for the conv, the scan and the norm
on every head, and ``out_proj`` takes the rank's slice of the normed
output (``mamba out_proj input``). The route follows from the shapes
and the leaves' splits alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (RMSNorm, head_split, linear,
                                       narrow_spans, param, row_linear,
                                       tp_split, truncated_normal_)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None) -> Dict[str, torch.Tensor]:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "state": torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv + SiLU. u: (B, S, C); w: (K, C); ``tail``:
    (B, K-1, C) carried state for decode. Returns (y, new_tail)."""
    kk = w.shape[0]
    if tail is None:
        tail = torch.zeros((u.shape[0], kk - 1, u.shape[2]), dtype=u.dtype,
                           device=u.device)
    ext = torch.cat([tail, u], dim=1)                       # (B, K-1+S, C)
    s = u.shape[1]
    y = sum(ext[:, i:i + s] * w[i].to(u.dtype) for i in range(kk))
    y = F.silu(y + b.to(u.dtype))
    new_tail = ext[:, -(kk - 1):] if kk > 1 else tail
    return y, new_tail


@dataclasses.dataclass(frozen=True)
class Heads:
    """The SSM heads [lo, hi) and the groups [ga, gb) they read that a
    rank runs; ``tp``: the "model" axis's record where they are this
    rank's share (its whole leaves then picked at their entries), None
    where it runs every head."""

    tp: object
    lo: int
    hi: int
    ga: int
    gb: int

    def pick(self, w: torch.Tensor, dim: int, spans) -> torch.Tensor:
        """Entries ``spans`` of a whole leaf (all of it on every head)."""
        return w if self.tp is None else self.tp.pick_spans(w, dim, spans)


class Mamba2(nn.Module):
    TP_LEAVES = ("in_proj", "out_proj")

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, di = cfg.d_model, cfg.d_inner
        g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.n_ssm_heads
        conv_dim = di + 2 * g * n
        # in_proj columns: [z (di), x (di), B (g*n), C (g*n), dt (h)]
        self.in_proj = param(d, 2 * di + 2 * g * n + h, device=device)
        self.conv_w = param(cfg.ssm_conv, conv_dim, device=device)
        self.conv_b = param(conv_dim, device=device)
        self.a_log = param(h, device=device)                # A = -exp(a_log)
        self.dt_bias = param(h, device=device)
        self.d_skip = param(h, device=device)
        self.norm = RMSNorm(di, cfg.norm_eps, device=device)
        self.out_proj = param(di, d, device=device)

    def reset(self, generator=None) -> None:
        cfg = self.cfg
        truncated_normal_(self.in_proj, cfg.d_model ** -0.5, generator)
        truncated_normal_(self.conv_w, 0.2, generator)
        truncated_normal_(self.out_proj, cfg.d_inner ** -0.5, generator)
        with torch.no_grad():
            self.a_log.copy_(torch.log(torch.linspace(
                1.0, 16.0, cfg.n_ssm_heads, device=self.a_log.device)))
        nn.init.zeros_(self.conv_b)
        nn.init.zeros_(self.dt_bias)
        nn.init.ones_(self.d_skip)

    # ---- the head route on a mesh (module docstring) ----

    def heads(self, state: Optional[torch.Tensor] = None) -> Heads:
        """The heads this rank runs: its share where the heads divide
        "model" (and, in decode, ``state`` is its head block), else every
        head."""
        cfg = self.cfg
        h, g = cfg.n_ssm_heads, cfg.ssm_groups
        tp = tp_split(self, "in_proj") or tp_split(self, "out_proj")
        if tp is None or h % tp.size or (state is not None
                                         and head_split(state) is None):
            return Heads(None, 0, h, 0, g)
        lo, hi = tp.span(h)
        rep = h // g
        return Heads(tp, lo, hi, lo // rep, (hi - 1) // rep + 1)

    def _spans(self, hs: Heads):
        """The heads' [start, stop) spans of in_proj's columns (z, x, B,
        C, dt) and of the conv's channels (x, B, C)."""
        cfg = self.cfg
        hd, n, di = cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
        gn = cfg.ssm_groups * n
        x, grp = (hs.lo * hd, hs.hi * hd), (hs.ga * n, hs.gb * n)

        def at(span, off):
            return span[0] + off, span[1] + off

        dt = at((hs.lo, hs.hi), 2 * di + 2 * gn)
        return ((x, at(x, di), at(grp, 2 * di), at(grp, 2 * di + gn), dt),
                (x, at(grp, di), at(grp, di + gn)))

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        """x @ in_proj, every column: column-parallel and gathered over
        "model" where in_proj is split."""
        tp = tp_split(self, "in_proj")
        if tp is None:
            return linear(x, self.in_proj)
        return tp.gather(linear(tp.copy(x), self.in_proj),
                         "mamba in_proj output")

    def _in_heads(self, x: torch.Tensor, hs: Heads) -> torch.Tensor:
        """The heads' columns of x @ in_proj (module docstring): of in_proj
        gathered or its output gathered, whichever moves fewer bytes, or
        picked from a whole in_proj."""
        tp, cols = hs.tp, self._spans(hs)[0]
        w, xc = self.in_proj, tp.copy(x)
        if tp_split(self, "in_proj") is None:
            return linear(xc, tp.pick_spans(w, 1, cols))
        tokens = x.numel() // x.shape[-1]
        if tokens * x.element_size() > w.shape[0] * w.element_size():
            w = tp.gather(w, "mamba in_proj columns", dim=1, partial=True)
            return linear(xc, narrow_spans(w, 1, cols))
        y = tp.gather(linear(xc, w), "mamba in_proj output", partial=True)
        return narrow_spans(y, -1, cols)

    # ---- shared by prefill and decode ----

    def _split(self, zxbcdt: torch.Tensor, hs: Heads):
        cfg = self.cfg
        di = (hs.hi - hs.lo) * cfg.ssm_head_dim
        gn = (hs.gb - hs.ga) * cfg.ssm_state
        return (zxbcdt[..., :di], zxbcdt[..., di:2 * di],
                zxbcdt[..., 2 * di:2 * di + gn],
                zxbcdt[..., 2 * di + gn:2 * di + 2 * gn],
                zxbcdt[..., 2 * di + 2 * gn:])

    def _conv(self, xs, B, C, hs: Heads, tail=None):
        """The causal conv on the heads' channels: x, B, C and the new
        tail."""
        conv = self._spans(hs)[1]
        xbc, new_tail = causal_conv(torch.cat([xs, B, C], dim=-1),
                                    hs.pick(self.conv_w, 1, conv),
                                    hs.pick(self.conv_b, 0, conv), tail=tail)
        di, gn = xs.shape[-1], B.shape[-1]
        return (xbc[..., :di], xbc[..., di:di + gn], xbc[..., di + gn:],
                new_tail)

    def _prepare_ssd(self, xs, B, C, dt, hs: Heads):
        """Head reshape and dt / A handling shared by prefill and decode."""
        cfg = self.cfg
        bsz, s, _ = xs.shape
        hd, n = cfg.ssm_head_dim, cfg.ssm_state
        heads = ((hs.lo, hs.hi),)
        dt = F.softplus(dt.float() + hs.pick(self.dt_bias, 0, heads))
        a = -torch.exp(hs.pick(self.a_log, 0, heads))           # (H,)
        a_log_dt = dt * a[None, None, :]                        # (B, S, H) <= 0
        xh = xs.reshape(bsz, s, -1, hd) * dt[..., None].to(xs.dtype)
        # each group's repeats: the heads of [lo, hi) that read it
        rep = cfg.n_ssm_heads // cfg.ssm_groups
        reps = [min(hs.hi, (g + 1) * rep) - max(hs.lo, g * rep)
                for g in range(hs.ga, hs.gb)]
        reps = reps[0] if len(set(reps)) == 1 else torch.tensor(
            reps, device=xs.device)
        Bh = torch.repeat_interleave(B.reshape(bsz, s, -1, n), reps, dim=2)
        Ch = torch.repeat_interleave(C.reshape(bsz, s, -1, n), reps, dim=2)
        return xh, a_log_dt, Bh, Ch

    def _norm(self, y: torch.Tensor, hs: Heads) -> torch.Tensor:
        """The gated RMSNorm over all of d_inner: on the heads' slice, its
        f32 sum of squares summed over "model" (forward and backward)."""
        if hs.tp is None:
            return self.norm(y)
        hd = self.cfg.ssm_head_dim
        yf = y.float()
        ss = hs.tp.copy(hs.tp.reduce(torch.sum(yf * yf, -1, keepdim=True)))
        scale = hs.pick(self.norm.scale, 0, ((hs.lo * hd, hs.hi * hd),))
        return (yf * torch.rsqrt(ss / self.cfg.d_inner + self.norm.eps)
                * scale).to(y.dtype)

    def _out(self, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
             hs: Heads):
        bsz, s = z.shape[:2]
        d_skip = hs.pick(self.d_skip, 0, ((hs.lo, hs.hi),))
        y = y + xh * d_skip.to(z.dtype)[None, None, :, None]
        y = self._norm(y.reshape(bsz, s, -1) * F.silu(z), hs)
        if hs.tp is not None:      # out_proj's block of rows: the heads'
            return row_linear(y, self.out_proj, hs.tp)
        tp = tp_split(self, "out_proj")
        if tp is None:
            return linear(y, self.out_proj)
        return row_linear(tp.scatter(y, "mamba out_proj input"),
                          self.out_proj, tp)

    def forward(self, x: torch.Tensor,
                use_kernels: Optional[bool] = None) -> torch.Tensor:
        """Full-sequence path. x: (B, S, d)."""
        hs = self.heads()
        zxbcdt = self._in(x) if hs.tp is None else self._in_heads(x, hs)
        z, xs, B, C, dt = self._split(zxbcdt, hs)
        xs, B, C, _ = self._conv(xs, B, C, hs)
        xh, a_log, Bh, Ch = self._prepare_ssd(xs, B, C, dt, hs)
        y = ops.ssd(xh, a_log, Bh, Ch, chunk=self.cfg.ssm_chunk,
                    use_kernels=use_kernels)
        return self._out(y, xh, z, hs)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One-token recurrence. x: (B, 1, d). The cache dict is updated
        with the new state (this rank's head block where it holds one)
        and the whole conv tail, and returned."""
        cfg = self.cfg
        hs = self.heads(cache["state"])
        zxbcdt, tail = self._in(x), cache["conv"]   # every column
        if hs.tp is not None:                 # the new tail spans them all
            di, gn = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
            new_conv = torch.cat([tail, zxbcdt[..., di:2 * di + 2 * gn]],
                                 dim=1)[:, 1:]
            cols, conv = self._spans(hs)
            zxbcdt, tail = (narrow_spans(zxbcdt, -1, cols),
                            narrow_spans(tail, -1, conv))
        z, xs, B, C, dt = self._split(zxbcdt, hs)
        xs, B, C, tail = self._conv(xs, B, C, hs, tail=tail)
        if hs.tp is None:
            new_conv = tail
        xh, a_log, Bh, Ch = self._prepare_ssd(xs, B, C, dt, hs)
        # exact one-step recurrence: h' = exp(a) h + x (x) B ; y = h' C
        a = torch.exp(a_log[:, 0].float())[:, :, None, None]
        upd = torch.einsum("bhp,bhn->bhpn", xh[:, 0].float(),
                           Bh[:, 0].float())
        state = a * cache["state"] + upd
        y = torch.einsum("bhpn,bhn->bhp", state, Ch[:, 0].float())
        y = y.to(x.dtype)[:, None]                              # (B,1,H,P)
        cache["state"], cache["conv"] = state, new_conv
        return self._out(y, xh, z, hs), cache
