"""Mamba-2 (SSD) block (port of ``repro.models.mamba2``): projections, the
causal depthwise conv, and the selective state space.

The full-sequence path runs the chunked SSD through
:func:`repro_torch.kernels.ops.ssd` (kernel B6 on the card, the reference's
chunked oracle on the CPU or under ``use_kernels=False``); decode is the
one-step recurrence against a cached (H, P, N) state and conv tail, in
plain PyTorch as in the reference.

On a mesh (``layers.tp_split``) ``in_proj`` is column-parallel where its
spec splits it, its output gathered over "model" (counted) for the conv,
the scan and the gated norm, which span every head and all of
``d_inner``; ``out_proj`` is row-parallel on this rank's slice of the
normed output. Re-laying ``in_proj``'s columns by head, to keep the scan
local, is ROADMAP.md A.7e.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (RMSNorm, linear, param, row_linear,
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

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        """x @ in_proj, every column: column-parallel and gathered over
        "model" where in_proj is split."""
        tp = tp_split(self, "in_proj")
        if tp is None:
            return linear(x, self.in_proj)
        return tp.gather(linear(tp.copy(x), self.in_proj),
                         "mamba in_proj output")

    def _split(self, zxbcdt: torch.Tensor):
        cfg = self.cfg
        di, gn, h = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.n_ssm_heads
        return (zxbcdt[..., :di], zxbcdt[..., di:2 * di],
                zxbcdt[..., 2 * di:2 * di + gn],
                zxbcdt[..., 2 * di + gn:2 * di + 2 * gn],
                zxbcdt[..., 2 * di + 2 * gn:2 * di + 2 * gn + h])

    def _prepare_ssd(self, xs, B, C, dt):
        """Head reshape and dt / A handling shared by prefill and decode."""
        cfg = self.cfg
        bsz, s, _ = xs.shape
        h, hd = cfg.n_ssm_heads, cfg.ssm_head_dim
        g, n = cfg.ssm_groups, cfg.ssm_state
        dt = F.softplus(dt.float() + self.dt_bias)              # (B, S, H)
        a = -torch.exp(self.a_log)                              # (H,)
        a_log_dt = dt * a[None, None, :]                        # (B, S, H) <= 0
        xh = xs.reshape(bsz, s, h, hd) * dt[..., None].to(xs.dtype)
        rep = h // g
        Bh = torch.repeat_interleave(B.reshape(bsz, s, g, n), rep, dim=2)
        Ch = torch.repeat_interleave(C.reshape(bsz, s, g, n), rep, dim=2)
        return xh, a_log_dt, Bh, Ch

    def _mix(self, xbc: torch.Tensor):
        di, gn = self.cfg.d_inner, self.cfg.ssm_groups * self.cfg.ssm_state
        return xbc[..., :di], xbc[..., di:di + gn], xbc[..., di + gn:]

    def _out(self, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor):
        bsz, s = z.shape[:2]
        y = y + xh * self.d_skip.to(z.dtype)[None, None, :, None]
        y = self.norm(y.reshape(bsz, s, self.cfg.d_inner) * F.silu(z))
        tp = tp_split(self, "out_proj")
        if tp is None:
            return linear(y, self.out_proj)
        return row_linear(tp.scatter(y, "mamba out_proj input"),
                          self.out_proj, tp)

    def forward(self, x: torch.Tensor,
                use_kernels: Optional[bool] = None) -> torch.Tensor:
        """Full-sequence path. x: (B, S, d)."""
        z, xs, B, C, dt = self._split(self._in(x))
        xbc, _ = causal_conv(torch.cat([xs, B, C], dim=-1), self.conv_w,
                             self.conv_b)
        xs, B, C = self._mix(xbc)
        xh, a_log, Bh, Ch = self._prepare_ssd(xs, B, C, dt)
        y = ops.ssd(xh, a_log, Bh, Ch, chunk=self.cfg.ssm_chunk,
                    use_kernels=use_kernels)
        return self._out(y, xh, z)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One-token recurrence. x: (B, 1, d). The cache dict is updated
        with the new state and conv tail and returned."""
        z, xs, B, C, dt = self._split(self._in(x))
        xbc, new_conv = causal_conv(torch.cat([xs, B, C], dim=-1),
                                    self.conv_w, self.conv_b,
                                    tail=cache["conv"])
        xs, B, C = self._mix(xbc)
        xh, a_log, Bh, Ch = self._prepare_ssd(xs, B, C, dt)
        # exact one-step recurrence: h' = exp(a) h + x (x) B ; y = h' C
        a = torch.exp(a_log[:, 0].float())[:, :, None, None]
        upd = torch.einsum("bhp,bhn->bhpn", xh[:, 0].float(),
                           Bh[:, 0].float())
        state = a * cache["state"] + upd
        y = torch.einsum("bhpn,bhn->bhp", state, Ch[:, 0].float())
        y = y.to(x.dtype)[:, None]                              # (B,1,H,P)
        cache["state"], cache["conv"] = state, new_conv
        return self._out(y, xh, z), cache
