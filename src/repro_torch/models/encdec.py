"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``).

The conv / mel frontend is a stub in the reference too: the encoder takes
precomputed frame embeddings (B, encoder_seq, d_model). Sinusoidal
positions are added on both sides. Encoder: bidirectional self-attention
blocks. Decoder: causal self-attention, cross-attention to the encoder
memory, FFN. On the card all three attentions run B5: non-causal over the
frames, causal over the tokens, and the cross form with Sq != Sk.

Decode caches, stacked on a leading layer axis as the reference's: a
self-attention KV ring and the cross K/V computed once from the memory.
Decode's cross step is ``masked_decode_attention`` over the whole memory,
plain PyTorch as in the reference. Decode updates the self-attention
caches in place and returns them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (FFN, Embedding, RMSNorm, param,
                                       sinusoidal_positions,
                                       truncated_normal_)
from repro_torch.models.transformer import maybe_remat


class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = RMSNorm(d, cfg.norm_eps, device=device)
        self.attn = attn_mod.Attention(cfg, device=device)
        self.ln2 = RMSNorm(d, cfg.norm_eps, device=device)
        self.ffn = FFN(d, cfg.d_ff, cfg.glu, cfg.act, device=device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                use_kernels: Optional[bool] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), positions, causal=False,
                          use_kernels=use_kernels)
        return x + self.ffn(self.ln2(x))


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = RMSNorm(d, cfg.norm_eps, device=device)
        self.attn = attn_mod.Attention(cfg, device=device)
        self.ln_x = RMSNorm(d, cfg.norm_eps, device=device)
        self.xattn = attn_mod.Attention(cfg, device=device)
        self.ln2 = RMSNorm(d, cfg.norm_eps, device=device)
        self.ffn = FFN(d, cfg.d_ff, cfg.glu, cfg.act, device=device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                memory: torch.Tensor, use_kernels: Optional[bool] = None
                ) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), positions, causal=True,
                          use_kernels=use_kernels)
        x = x + self.xattn.cross(self.ln_x(x), memory,
                                 use_kernels=use_kernels)
        return x + self.ffn(self.ln2(x))


class EncDec(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.embed = Embedding(cfg.vocab, d, device=device)
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, device)
                                        for _ in range(cfg.encoder_layers))
        self.enc_norm = RMSNorm(d, cfg.norm_eps, device=device)
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, device)
                                        for _ in range(cfg.n_layers))
        self.dec_norm = RMSNorm(d, cfg.norm_eps, device=device)
        self.head = param(d, cfg.vocab, device=device)

    def reset(self, generator=None) -> None:
        truncated_normal_(self.head, self.cfg.d_model ** -0.5, generator)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    def _positions(self, x: torch.Tensor):
        """(sinusoidal table (S, d) in the compute dtype, positions (B, S))."""
        b, s = x.shape[:2]
        table = sinusoidal_positions(s, self.cfg.d_model, self.dtype,
                                     x.device)
        pos = torch.arange(s, dtype=torch.int32,
                           device=x.device)[None].expand(b, s)
        return table, pos

    def encode(self, frames: torch.Tensor,
               use_kernels: Optional[bool] = None) -> torch.Tensor:
        """frames (B, S_enc, d), the stub frontend's embeddings -> memory
        (B, S_enc, d). Each block under ``maybe_remat`` (the reference's
        remat of the encoder scan)."""
        table, positions = self._positions(frames)
        x = frames.to(self.dtype) + table[None]
        for blk in self.enc_blocks:
            x = maybe_remat(blk, self.cfg, x, positions,
                            use_kernels=use_kernels)
        return self.enc_norm(x)

    def decode_train(self, tokens: torch.Tensor, memory: torch.Tensor,
                     use_kernels: Optional[bool] = None) -> torch.Tensor:
        """Teacher-forced decoder pass: tokens (B, S) and the memory ->
        logits (B, S, V), each block under ``maybe_remat``."""
        table, positions = self._positions(tokens)
        x = self.embed(tokens, self.dtype) + table[None]
        for blk in self.dec_blocks:
            x = maybe_remat(blk, self.cfg, x, positions, memory,
                            use_kernels=use_kernels)
        return self._logits(x)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.dec_norm(x) @ self.head.to(x.dtype)

    def forward(self, frames: torch.Tensor, tokens: torch.Tensor,
                use_kernels: Optional[bool] = None):
        """(logits, aux): the aux loss is a float32 zero."""
        memory = self.encode(frames, use_kernels=use_kernels)
        logits = self.decode_train(tokens, memory, use_kernels=use_kernels)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)

    def init_decode_caches(self, memory: torch.Tensor, batch: int,
                           max_len: int, dtype=torch.bfloat16
                           ) -> Dict:
        """Per layer, stacked on a leading layer axis: a self-attention KV
        cache of ``max_len`` slots, and the cross K / V (B, Sm, Hkv, hd)
        projected from ``memory`` once."""
        cfg = self.cfg
        sm = memory.shape[1]
        ks, vs = [], []
        for blk in self.dec_blocks:
            w = blk.xattn
            ks.append((memory @ w.wk.to(memory.dtype))
                      .reshape(batch, sm, cfg.n_kv, cfg.hd).to(dtype))
            vs.append((memory @ w.wv.to(memory.dtype))
                      .reshape(batch, sm, cfg.n_kv, cfg.hd).to(dtype))
        one = attn_mod.init_kv_cache(cfg, batch, max_len, dtype, self.device)
        return {"self": {k: torch.stack([v] * cfg.n_layers)
                         for k, v in one.items()},
                "cross_k": torch.stack(ks), "cross_v": torch.stack(vs)}

    def decode_step(self, token: torch.Tensor, caches: Dict,
                    cache_index: int):
        """One decoder token (B, 1) against the cached self and cross KV ->
        (logits (B, 1, V), caches updated in place)."""
        cfg, dtype = self.cfg, self.dtype
        cache_index = int(cache_index)
        b = token.shape[0]
        hq, hd = cfg.n_heads, cfg.hd
        smax = caches["self"]["k"].shape[2]
        # the reference's dynamic_slice clamps a start past the table
        table = sinusoidal_positions(smax, cfg.d_model, dtype, token.device)
        x = self.embed(token, dtype) + table[min(cache_index, smax - 1)]
        kv_len = min(cache_index + 1, smax)
        for i, blk in enumerate(self.dec_blocks):
            self_cache = {k: v[i] for k, v in caches["self"].items()}
            y, nc = blk.attn.decode(blk.ln1(x), dict(self_cache),
                                    cache_index % smax, cache_index, kv_len)
            for k, v in nc.items():
                if v is not self_cache[k]:     # replaced, not written in place
                    caches["self"][k][i].copy_(v)
            x = x + y
            h = blk.ln_x(x)
            q = (h @ blk.xattn.wq.to(dtype)).reshape(b, 1, hq, hd)
            ck, cv = caches["cross_k"][i], caches["cross_v"][i]
            o = attn_mod.masked_decode_attention(
                q.movedim(2, 1), ck.movedim(2, 1).to(dtype),
                cv.movedim(2, 1).to(dtype), ck.shape[1])
            x = x + o.movedim(1, 2).reshape(b, 1, hq * hd) \
                @ blk.xattn.wo.to(dtype)
            x = x + blk.ffn(blk.ln2(x))
        return self._logits(x), caches
