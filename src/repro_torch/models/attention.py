"""GQA attention with RoPE, a KV cache, sliding windows and
cross-attention (port of ``repro.models.attention``).

The full-sequence paths (training / prefill, and the encoder-decoder's
cross-attention) go through :func:`repro_torch.kernels.ops.attention`:
kernel B5 on the card, the reference's plain oracles on the CPU or when
the caller passes ``use_kernels=False`` (the trainer does). The
decode path writes one token into the cache and attends with a kv-length
mask in plain PyTorch, as the reference does (``masked_decode_attention``
reaches no kernel there either).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import linear, param, rope, truncated_normal_


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def masked_decode_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, kv_len: int) -> torch.Tensor:
    """Decode attention with an explicit kv-length mask (f32 softmax).
    q: (B, Hq, 1, hd); k/v: (B, Hkv, Smax, hd)."""
    b, hq, _, hd = q.shape
    hkv = k.shape[1]
    qf = q.float().reshape(b, hkv, hq // hkv, hd)
    logits = torch.einsum("bhgd,bhkd->bhgk", qf, k.float()) / (hd ** 0.5)
    mask = torch.arange(k.shape[2], device=q.device)[None, :] < kv_len
    logits = torch.where(mask[None, None], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", probs, v.float())
    return o.reshape(b, hq, 1, hd).to(q.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, d_in: Optional[int] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        d = d_in or cfg.d_model
        hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv
        self.wq = param(d, hq * hd, device=device)
        self.wk = param(d, hkv * hd, device=device)
        self.wv = param(d, hkv * hd, device=device)
        self.wo = param(hq * hd, d, device=device)
        if cfg.qkv_bias:
            self.bq = param(hq * hd, device=device)
            self.bk = param(hkv * hd, device=device)
            self.bv = param(hkv * hd, device=device)
        else:
            self.bq = self.bk = self.bv = None

    def reset(self, generator=None) -> None:
        d = self.wq.shape[0]
        for w in (self.wq, self.wk, self.wv):
            truncated_normal_(w, d ** -0.5, generator)
        truncated_normal_(self.wo, self.wo.shape[0] ** -0.5, generator)
        for b in (self.bq, self.bk, self.bv):
            if b is not None:
                nn.init.zeros_(b)

    def project_qkv(self, x: torch.Tensor, positions: torch.Tensor,
                    use_rope: bool = True):
        """q (B, S, Hq, hd), k and v (B, S, Hkv, hd), RoPE applied."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = linear(x, self.wq, self.bq).reshape(b, s, cfg.n_heads, cfg.hd)
        k = linear(x, self.wk, self.bk).reshape(b, s, cfg.n_kv, cfg.hd)
        v = linear(x, self.wv, self.bv).reshape(b, s, cfg.n_kv, cfg.hd)
        if use_rope and cfg.pos == "rope":
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        return q, k, v

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                window: Optional[int] = None, causal: bool = True,
                use_kernels: Optional[bool] = None) -> torch.Tensor:
        """Full-sequence (training / prefill) attention. x: (B, S, d)."""
        q, k, v = self.project_qkv(x, positions)
        # (B, Hq, S, hd) views: the kernel reads them through their strides
        o = ops.attention(q.movedim(2, 1), k.movedim(2, 1), v.movedim(2, 1),
                          causal=causal, window=window,
                          use_kernels=use_kernels)
        b, s = x.shape[:2]
        o = o.movedim(1, 2).reshape(b, s, self.cfg.n_heads * self.cfg.hd)
        return linear(o, self.wo)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               write_idx: int, position: int, kv_len: int
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One-token decode. x: (B, 1, d); cache k/v (B, Smax, Hkv, hd).

        ``write_idx`` is the cache slot to write (ring buffers: position %
        Smax), ``position`` the absolute token position (RoPE), ``kv_len``
        the number of valid slots. The cache is updated in place and
        returned. Keys are stored rotated at their absolute positions, so
        ring-buffer slot order does not matter.
        """
        b = x.shape[0]
        positions = torch.full((b, 1), position, dtype=torch.int32,
                               device=x.device)
        q, k, v = self.project_qkv(x, positions)
        cache["k"][:, write_idx:write_idx + 1] = k.to(cache["k"].dtype)
        cache["v"][:, write_idx:write_idx + 1] = v.to(cache["v"].dtype)
        kh = cache["k"].movedim(2, 1).to(x.dtype)     # (B, Hkv, Smax, hd)
        vh = cache["v"].movedim(2, 1).to(x.dtype)
        o = masked_decode_attention(q.movedim(2, 1), kh, vh, kv_len)
        o = o.movedim(1, 2).reshape(b, 1, self.cfg.n_heads * self.cfg.hd)
        return linear(o, self.wo), cache

    def cross(self, x: torch.Tensor, memory: torch.Tensor,
              use_kernels: Optional[bool] = None) -> torch.Tensor:
        """Decoder cross-attention (``apply_cross_attention``): queries from
        x (B, S, d), keys and values from the encoder memory (B, Sm, d), no
        RoPE and no biases, every query attending to every memory row (on
        the card: B5 with Sq != Sk, causal off)."""
        cfg = self.cfg
        b, s, _ = x.shape
        sm = memory.shape[1]
        hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv
        q = linear(x, self.wq).reshape(b, s, hq, hd)
        k = (memory @ self.wk.to(x.dtype)).reshape(b, sm, hkv, hd)
        v = (memory @ self.wv.to(x.dtype)).reshape(b, sm, hkv, hd)
        o = ops.attention(q.movedim(2, 1), k.movedim(2, 1), v.movedim(2, 1),
                          causal=False, use_kernels=use_kernels)
        o = o.movedim(1, 2).reshape(b, s, hq * hd)
        return linear(o, self.wo)
