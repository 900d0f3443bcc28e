"""Decoder-only LM for the dense, ssm and hybrid families (port of
``repro.models.transformer``).

The reference scans over layers whose parameters are stacked on a leading
axis; here the layers are an ``nn.ModuleList`` and the scan is a Python
loop. Remat is a training concern and waits with the trainer; so do the
moe and vlm families (:data:`WAITING`).

Caches: hybrid models keep a per-layer list (global layers carry the full
horizon, windowed layers a ring of ``window`` slots); dense and ssm models
keep the reference's stacked (n_layers, ...) tensors. Decode updates the
caches in place and returns them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (FFN, Embedding, RMSNorm, param,
                                       truncated_normal_)

FAMILIES = ("dense", "ssm", "hybrid")
# families the reference runs that this package does not yet, and the
# ROADMAP.md item that ports them
WAITING = {"moe": "ROADMAP.md A.10 (models/moe.py)",
           "vlm": "ROADMAP.md A.10 (models/frontends.py, the vision stub)",
           "encdec": "ROADMAP.md A.10 (models/encdec.py)"}

Caches = Union[List[Dict], Dict[str, torch.Tensor]]


def check_family(cfg: ModelConfig) -> None:
    if cfg.family in WAITING:
        raise NotImplementedError(
            f"repro_torch runs the {FAMILIES} families; {cfg.family!r} "
            f"({cfg.name}) waits for {WAITING[cfg.family]}")
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")


class Block(nn.Module):
    """One residual block: mixer (attention, SSM or hybrid) and FFN."""

    def __init__(self, cfg: ModelConfig, is_global: bool, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.ln1 = RMSNorm(d, cfg.norm_eps, device=device)
        self.attn = self.ssm = self.mix = None
        if cfg.family == "ssm":
            self.ssm = mamba_mod.Mamba2(cfg, device=device)
        elif cfg.family == "hybrid":
            self.mix = hybrid_mod.Hybrid(cfg, is_global, device=device)
        else:
            self.attn = attn_mod.Attention(cfg, device=device)
        has_ffn = cfg.family != "ssm" or cfg.d_ff
        self.ln2 = RMSNorm(d, cfg.norm_eps, device=device) if has_ffn else None
        self.ffn = FFN(d, cfg.d_ff, cfg.glu, cfg.act, device=device) \
            if has_ffn else None

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.ffn is None else x + self.ffn(self.ln2(x))

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        h = self.ln1(x)
        if self.ssm is not None:
            x = x + self.ssm(h)
        elif self.mix is not None:
            x = x + self.mix(h, positions)
        else:
            x = x + self.attn(h, positions, window=self.cfg.window)
        return self._ffn(x)

    def decode(self, x: torch.Tensor, cache: Dict, cache_index: int):
        h = self.ln1(x)
        if self.ssm is not None:
            y, nc = self.ssm.decode(h, cache)
        elif self.mix is not None:
            y, nc = self.mix.decode(h, cache, cache_index)
        else:
            smax = cache["k"].shape[1]
            y, nc = self.attn.decode(h, cache, cache_index % smax,
                                     cache_index, min(cache_index + 1, smax))
        return self._ffn(x + y), nc


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        g = set(cfg.global_layers)
        self.embed = Embedding(cfg.vocab, cfg.d_model, device=device)
        self.blocks = nn.ModuleList(Block(cfg, i in g, device=device)
                                    for i in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.head = None if cfg.tie_embeddings else \
            param(cfg.d_model, cfg.vocab, device=device)

    def reset(self, generator=None) -> None:
        if self.head is not None:
            truncated_normal_(self.head, self.cfg.d_model ** -0.5, generator)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed(tokens, getattr(torch, self.cfg.dtype))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        head = self.embed.table.T if self.head is None else self.head
        logits = x @ head.to(x.dtype)
        if self.cfg.logit_softcap:
            c = self.cfg.logit_softcap
            logits = c * torch.tanh(logits.float() / c)
        return logits

    def _positions(self, tokens: torch.Tensor) -> torch.Tensor:
        b, s = tokens.shape
        return torch.arange(s, dtype=torch.int32,
                            device=tokens.device)[None].expand(b, s)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Training / prefill forward: tokens (B, S) -> logits (B, S, V)."""
        x = self._embed(tokens)
        positions = self._positions(tokens)
        for blk in self.blocks:
            x = blk(x, positions)
        return self._logits(x)

    def prefill(self, tokens: torch.Tensor):
        """Forward plus the per-layer KV of the dense family (stacked
        (n_layers, B, S, Hkv, hd)); ssm and hybrid models return None."""
        x = self._embed(tokens)
        positions = self._positions(tokens)
        ks, vs = [], []
        for blk in self.blocks:
            if blk.attn is not None:
                _, k, v = blk.attn.project_qkv(blk.ln1(x), positions)
                ks.append(k)
                vs.append(v)
            x = blk(x, positions)
        kv = {"k": torch.stack(ks), "v": torch.stack(vs)} if ks else None
        return self._logits(x), kv

    def init_caches(self, batch: int, max_len: int,
                    dtype=torch.bfloat16) -> Caches:
        cfg, dev = self.cfg, self.device
        if cfg.family == "hybrid":
            g = set(cfg.global_layers)
            return [hybrid_mod.init_hybrid_cache(cfg, batch, max_len,
                                                 is_global=(i in g),
                                                 dtype=dtype, device=dev)
                    for i in range(cfg.n_layers)]
        if cfg.family == "ssm":
            one = mamba_mod.init_ssm_cache(cfg, batch, dtype, dev)
        else:
            one = attn_mod.init_kv_cache(cfg, batch, max_len, dtype, dev)
        return {k: torch.stack([v] * cfg.n_layers) for k, v in one.items()}

    def decode_step(self, token: torch.Tensor, caches: Caches,
                    cache_index: int):
        """One serving step: token (B, 1) -> (logits (B, 1, V), caches)."""
        x = self._embed(token)
        cache_index = int(cache_index)
        for i, blk in enumerate(self.blocks):
            if isinstance(caches, list):
                x, caches[i] = blk.decode(x, caches[i], cache_index)
                continue
            views = {k: v[i] for k, v in caches.items()}
            x, nc = blk.decode(x, dict(views), cache_index)
            for k, v in nc.items():
                if v is not views[k]:          # replaced, not written in place
                    caches[k][i].copy_(v)
        return self._logits(x), caches
