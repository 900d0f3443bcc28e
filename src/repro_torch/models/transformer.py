"""Decoder-only LM for the dense, moe, ssm, hybrid and vlm families (port
of ``repro.models.transformer``).

The reference scans over layers whose parameters are stacked on a leading
axis; here the layers are an ``nn.ModuleList`` and the scan is a Python
loop. While autograd records, each block runs under :func:`maybe_remat`,
the reference's per-layer remat with its policies. The moe
family's blocks take :class:`~repro_torch.models.moe.MoE` for their FFN;
a vlm model projects the frontend's prefix embeddings with
``frontend_proj`` and prepends them to the token embeddings. The
encoder-decoder family is :mod:`repro_torch.models.encdec`.

Caches: hybrid models keep a per-layer list (global layers carry the full
horizon, windowed layers a ring of ``window`` slots); the other families
keep the reference's stacked (n_layers, ...) tensors. Decode updates the
caches in place and returns them.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Union

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention as attn_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (FFN, Embedding, RMSNorm, param,
                                       truncated_normal_)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")

Caches = Union[List[Dict], Dict[str, torch.Tensor]]


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")


# the products that ``checkpoint_dots_with_no_batch_dims`` saves: a matmul
# with no batch dimension (``x @ w`` folds its leading axes into ``mm``);
# the batched products (``bmm``: attention scores, the SSD's chunk
# products, the experts) are recomputed, as the reference's policy does
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def maybe_remat(block: nn.Module, cfg: ModelConfig, *args, **kwargs):
    """``block(*args, **kwargs)`` with per-layer remat under
    ``cfg.remat_policy`` (the reference's ``maybe_remat``): 'full'
    recomputes the whole block in the backward, 'dots' saves the outputs of
    the products with no batch dimension and recomputes the rest, 'none'
    (or ``cfg.remat`` off) saves everything. Remat applies only while
    autograd records the block (grad mode on, and a parameter or input
    that requires grad); serving runs the block as it is."""
    recording = torch.is_grad_enabled() and (
        any(isinstance(a, torch.Tensor) and a.requires_grad for a in args)
        or any(p.requires_grad for p in block.parameters()))
    if not recording or not cfg.remat or cfg.remat_policy == "none":
        return block(*args, **kwargs)
    if cfg.remat_policy == "full":
        return ckpt.checkpoint(block, *args, use_reentrant=False, **kwargs)
    if cfg.remat_policy == "dots":
        return ckpt.checkpoint(
            block, *args, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy),
            **kwargs)
    raise ValueError(f"unknown remat policy {cfg.remat_policy!r}")


class Block(nn.Module):
    """One residual block: mixer (attention, SSM or hybrid) and FFN (the
    moe family: the expert FFN, whose aux loss the block returns; the
    other blocks return ``None`` for it)."""

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
        self.ffn = self.moe = None
        if cfg.family == "moe":
            assert cfg.moe_every == 1, "every layer of a moe model is moe"
            self.moe = moe_mod.MoE(cfg, device=device)
        elif has_ffn:
            self.ffn = FFN(d, cfg.d_ff, cfg.glu, cfg.act, device=device)

    def _ffn(self, x: torch.Tensor):
        """x plus the FFN's output, and the aux loss (moe) or None."""
        if self.moe is not None:
            y, aux = self.moe(self.ln2(x))
            return x + y, aux
        if self.ffn is None:
            return x, None
        return x + self.ffn(self.ln2(x)), None

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                use_kernels: Optional[bool] = None):
        """(x, aux): aux is the moe FFN's float32 loss, else None."""
        h = self.ln1(x)
        if self.ssm is not None:
            x = x + self.ssm(h, use_kernels=use_kernels)
        elif self.mix is not None:
            x = x + self.mix(h, positions, use_kernels=use_kernels)
        else:
            x = x + self.attn(h, positions, window=self.cfg.window,
                              use_kernels=use_kernels)
        return self._ffn(x)

    def decode(self, x: torch.Tensor, cache: Dict, cache_index: int):
        """(x, aux, cache) for one token, the cache updated in place."""
        h = self.ln1(x)
        if self.ssm is not None:
            y, nc = self.ssm.decode(h, cache)
        elif self.mix is not None:
            y, nc = self.mix.decode(h, cache, cache_index)
        else:
            smax = cache["k"].shape[1]
            y, nc = self.attn.decode(h, cache, cache_index % smax,
                                     cache_index, min(cache_index + 1, smax))
        x, aux = self._ffn(x + y)
        return x, aux, nc


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
        self.frontend_proj = None if cfg.frontend is None else \
            param(cfg.d_model, cfg.d_model, device=device)

    def reset(self, generator=None) -> None:
        for w in (self.head, self.frontend_proj):
            if w is not None:
                truncated_normal_(w, self.cfg.d_model ** -0.5, generator)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _embed(self, tokens: torch.Tensor,
               prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings, after the projected prefix embeddings (B, P,
        d) of a frontend when given."""
        dtype = getattr(torch, self.cfg.dtype)
        x = self.embed(tokens, dtype)
        if prefix_embeds is None:
            return x
        pe = prefix_embeds.to(dtype) @ self.frontend_proj.to(dtype)
        return torch.cat([pe, x], dim=1)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        head = self.embed.table.T if self.head is None else self.head
        logits = x @ head.to(x.dtype)
        if self.cfg.logit_softcap:
            c = self.cfg.logit_softcap
            logits = c * torch.tanh(logits.float() / c)
        return logits

    @staticmethod
    def _positions(x: torch.Tensor) -> torch.Tensor:
        b, s = x.shape[:2]
        return torch.arange(s, dtype=torch.int32,
                            device=x.device)[None].expand(b, s)

    def forward(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None,
                use_kernels: Optional[bool] = None):
        """Training / prefill forward: tokens (B, S) (after prefix_embeds
        (B, P, d) when given) -> (logits (B, P + S, V), aux), aux the
        float32 sum of the moe layers' losses (0 without them)."""
        return self._run(tokens, prefix_embeds, collect_kv=False,
                         use_kernels=use_kernels)[:2]

    def prefill(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None):
        """Forward plus the per-layer KV of the attention families (dense,
        moe, vlm: stacked (n_layers, B, S, Hkv, hd)); ssm and hybrid
        models return None. Returns (logits, aux, kv)."""
        return self._run(tokens, prefix_embeds, collect_kv=True)

    def _run(self, tokens, prefix_embeds, collect_kv: bool,
             use_kernels: Optional[bool] = None):
        x = self._embed(tokens, prefix_embeds)
        positions = self._positions(x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        ks, vs = [], []
        for blk in self.blocks:
            if collect_kv and blk.attn is not None:
                _, k, v = blk.attn.project_qkv(blk.ln1(x), positions)
                ks.append(k)
                vs.append(v)
            x, a = maybe_remat(blk, self.cfg, x, positions,
                               use_kernels=use_kernels)
            if a is not None:
                aux = aux + a
        kv = {"k": torch.stack(ks), "v": torch.stack(vs)} if ks else None
        return self._logits(x), aux, kv

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
                x, _, caches[i] = blk.decode(x, caches[i], cache_index)
                continue
            views = {k: v[i] for k, v in caches.items()}
            x, _, nc = blk.decode(x, dict(views), cache_index)
            for k, v in nc.items():
                if v is not views[k]:          # replaced, not written in place
                    caches[k][i].copy_(v)
        return self._logits(x), caches
