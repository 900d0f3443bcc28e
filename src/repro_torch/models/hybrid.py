"""Hymba-style hybrid mixer (port of ``repro.models.hybrid``): parallel
attention and Mamba heads on the same normalized input, each output
RMS-normalized and averaged with learnable per-path scales.

Most layers use sliding-window attention; ``cfg.global_layers`` use full
attention. Each layer knows which it is (``is_global``), so exactly one
attention runs per layer, as the reference's ``lax.cond`` arranges.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import RMSNorm, cache_slots, param


def init_hybrid_cache(cfg: ModelConfig, batch: int, max_len: int,
                      is_global: bool = False, dtype=torch.bfloat16,
                      device=None):
    """Windowed layers keep a ``window``-slot KV ring; global layers the
    full horizon."""
    if is_global or cfg.window is None:
        kv_len = max_len
    else:
        kv_len = min(max_len, cfg.window)
    return {"attn": attn.init_kv_cache(cfg, batch, kv_len, dtype, device),
            "ssm": mamba2.init_ssm_cache(cfg, batch, dtype, device)}


class Hybrid(nn.Module):
    def __init__(self, cfg: ModelConfig, is_global: bool, device=None):
        super().__init__()
        self.cfg = cfg
        self.is_global = is_global
        self.attn = attn.Attention(cfg, device=device)
        self.ssm = mamba2.Mamba2(cfg, device=device)
        self.attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.ssm_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.attn_scale = param(device=device)
        self.ssm_scale = param(device=device)

    def reset(self, generator=None) -> None:
        nn.init.ones_(self.attn_scale)
        nn.init.ones_(self.ssm_scale)

    def _fuse(self, ya: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
        ya, ys = self.attn_norm(ya), self.ssm_norm(ys)
        return 0.5 * (self.attn_scale.to(ya.dtype) * ya
                      + self.ssm_scale.to(ys.dtype) * ys)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                use_kernels: Optional[bool] = None) -> torch.Tensor:
        """Full-sequence path: windowed or global attention, and the SSM."""
        window = None if self.is_global else self.cfg.window
        ya = self.attn(x, positions, window=window, use_kernels=use_kernels)
        return self._fuse(ya, self.ssm(x, use_kernels=use_kernels))

    def decode(self, x: torch.Tensor, cache: Dict, cache_index: int
               ) -> Tuple[torch.Tensor, Dict]:
        """One-token decode; the attention cache is a ring buffer of its
        own length (RoPE at absolute positions keeps offsets exact)."""
        smax = cache_slots(cache["attn"]["k"])
        ya, kv = self.attn.decode(x, cache["attn"], cache_index % smax,
                                  cache_index, min(cache_index + 1, smax))
        ys, st = self.ssm.decode(x, cache["ssm"])
        return self._fuse(ya, ys), {"attn": kv, "ssm": st}
