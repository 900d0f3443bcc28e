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

On a mesh the blocks' attention, FFN and SSM run tensor-parallel (see
:mod:`repro_torch.models.layers`); the embedding is vocab-parallel where
``table`` is split, the head column-parallel where ``head`` (or the tied
table) is split over V, its logits left as this rank's columns of the
vocabulary (``layers.vocab_split`` marks them; the loss is vocab-parallel
and ``sharding.gather_logits`` makes them whole), the softcap on those
columns, and ``frontend_proj`` column-parallel with its output gathered.
The moe FFN's experts split over "model" in E, its router whole
(:mod:`repro_torch.models.moe`).

Caches: hybrid models keep a per-layer list (global layers carry the full
horizon, windowed layers a ring of ``window`` slots); the other families
keep the reference's stacked (n_layers, ...) tensors. Decode updates the
caches in place and returns them.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Optional, Union

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.distributed import collectives as coll
from repro_torch.models import attention as attn_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (FFN, Embedding, RMSNorm,
                                       cache_slots, layer_view,
                                       mark_vocab_split, param, tp_split,
                                       truncated_normal_)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")

Caches = Union[List[Dict], Dict[str, torch.Tensor]]


def identity_shard(x: torch.Tensor, name: str) -> torch.Tensor:
    """The default ``shard_fn``: no constraint (one device)."""
    return x


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
    that requires grad); serving runs the block as it is. The recompute
    records its collectives into the transport scope of the forward and
    its obs events into the forward's trace."""
    recording = torch.is_grad_enabled() and (
        any(isinstance(a, torch.Tensor) and a.requires_grad for a in args)
        or any(p.requires_grad for p in block.parameters()))
    if not recording or not cfg.remat or cfg.remat_policy == "none":
        return block(*args, **kwargs)
    if cfg.remat_policy == "full":
        contexts = ckpt.noop_context_fn
    elif cfg.remat_policy == "dots":
        contexts = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    else:
        raise ValueError(f"unknown remat policy {cfg.remat_policy!r}")
    return ckpt.checkpoint(block, *args, use_reentrant=False,
                           context_fn=functools.partial(_scoped, contexts),
                           **kwargs)


def _scoped(contexts):
    """``contexts()``'s (forward, recompute) contexts, the recompute's
    inside the transport scope and the obs trace active now: the
    recompute runs on autograd's thread, which on CUDA tensors sees none
    of this one's ContextVars (``collectives.transport_scope``)."""
    forward, recompute = contexts()
    rec = coll.forward_scopes()

    @contextlib.contextmanager
    def recompute_scoped():
        with coll.transport_scope(rec), recompute:
            yield

    return forward, recompute_scoped()


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

    def _ffn(self, x: torch.Tensor, shard_fn=identity_shard):
        """x plus the FFN's output, and the aux loss (moe) or None."""
        if self.moe is not None:
            y, aux = self.moe(self.ln2(x), shard_fn)
            return x + y, aux
        if self.ffn is None:
            return x, None
        return x + self.ffn(self.ln2(x)), None

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                use_kernels: Optional[bool] = None, shard_fn=identity_shard,
                kv_out: Optional[list] = None):
        """(x, aux): aux is the moe FFN's float32 loss, else None.
        ``shard_fn(x, "residual")`` constrains the residual where the
        reference's ``apply_block`` does. ``kv_out``: a list that an
        attention block appends its (k, v) to, every kv head (prefill's
        caches)."""
        h = self.ln1(x)
        if kv_out is not None and self.attn is not None:
            kv_out.append(self.attn.cache_kv(h, positions))
        if self.ssm is not None:
            x, aux = self._ffn(x + self.ssm(h, use_kernels=use_kernels),
                               shard_fn)
            return shard_fn(x, "residual"), aux
        if self.mix is not None:
            x = x + self.mix(h, positions, use_kernels=use_kernels)
        else:
            x = x + self.attn(h, positions, window=self.cfg.window,
                              use_kernels=use_kernels)
        x, aux = self._ffn(shard_fn(x, "residual"), shard_fn)
        return shard_fn(x, "residual"), aux

    def decode(self, x: torch.Tensor, cache: Dict, cache_index: int,
               shard_fn=identity_shard):
        """(x, aux, cache) for one token, the cache updated in place."""
        h = self.ln1(x)
        if self.ssm is not None:
            y, nc = self.ssm.decode(h, cache)
        elif self.mix is not None:
            y, nc = self.mix.decode(h, cache, cache_index)
        else:
            smax = cache_slots(cache["k"])
            y, nc = self.attn.decode(h, cache, cache_index % smax,
                                     cache_index, min(cache_index + 1, smax))
        x, aux = self._ffn(x + y, shard_fn)
        return x, aux, nc


def logits_of(x: torch.Tensor, head: torch.Tensor, tp,
              softcap: Optional[float] = None) -> torch.Tensor:
    """x @ head (+ the softcap): column-parallel where ``tp`` (the head's
    split over V) is given, the logits then this rank's columns, marked
    for the loss (``layers.mark_vocab_split``)."""
    logits = (x if tp is None else tp.copy(x)) @ head.to(x.dtype)
    if softcap:
        logits = softcap * torch.tanh(logits.float() / softcap)
    return logits if tp is None else mark_vocab_split(logits, tp)


class LM(nn.Module):
    TP_LEAVES = ("head", "frontend_proj")

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
        pe = prefix_embeds.to(dtype)
        tp = tp_split(self, "frontend_proj")
        if tp is None:
            pe = pe @ self.frontend_proj.to(dtype)
        else:
            pe = tp.gather(tp.copy(pe) @ self.frontend_proj.to(dtype),
                           "frontend_proj output")
        return torch.cat([pe, x], dim=1)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.head is None:
            head, tp = self.embed.table.T, tp_split(self.embed, "table")
        else:
            head, tp = self.head, tp_split(self, "head")
        return logits_of(self.final_norm(x), head, tp,
                         self.cfg.logit_softcap)

    @staticmethod
    def _positions(x: torch.Tensor) -> torch.Tensor:
        b, s = x.shape[:2]
        return torch.arange(s, dtype=torch.int32,
                            device=x.device)[None].expand(b, s)

    def forward(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None,
                use_kernels: Optional[bool] = None, shard_fn=identity_shard):
        """Training / prefill forward: tokens (B, S) (after prefix_embeds
        (B, P, d) when given) -> (logits (B, P + S, V), aux), aux the
        float32 sum of the moe layers' losses (0 without them)."""
        return self._run(tokens, prefix_embeds, collect_kv=False,
                         use_kernels=use_kernels, shard_fn=shard_fn)[:2]

    def prefill(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None,
                shard_fn=identity_shard, use_kernels: Optional[bool] = None):
        """Forward plus the per-layer KV of the attention families (dense,
        moe, vlm: stacked (n_layers, B, S, Hkv, hd)); ssm and hybrid
        models return None. Returns (logits, aux, kv)."""
        return self._run(tokens, prefix_embeds, collect_kv=True,
                         use_kernels=use_kernels, shard_fn=shard_fn)

    def _run(self, tokens, prefix_embeds, collect_kv: bool,
             use_kernels: Optional[bool] = None, shard_fn=identity_shard):
        x = shard_fn(self._embed(tokens, prefix_embeds), "residual")
        positions = self._positions(x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        kvs = [] if collect_kv else None
        for blk in self.blocks:
            x, a = maybe_remat(blk, self.cfg, x, positions,
                               use_kernels=use_kernels, shard_fn=shard_fn,
                               kv_out=kvs)
            if a is not None:
                aux = aux + a
        kv = {"k": torch.stack([k for k, _ in kvs]),
              "v": torch.stack([v for _, v in kvs])} if kvs else None
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
                    cache_index: int, shard_fn=identity_shard):
        """One serving step: token (B, 1) -> (logits (B, 1, V), caches)."""
        x = shard_fn(self._embed(token), "residual")
        cache_index = int(cache_index)
        for i, blk in enumerate(self.blocks):
            if isinstance(caches, list):
                x, _, caches[i] = blk.decode(x, caches[i], cache_index,
                                             shard_fn)
            else:
                views = {k: layer_view(v, i) for k, v in caches.items()}
                x, _, nc = blk.decode(x, dict(views), cache_index, shard_fn)
                for k, v in nc.items():
                    if v is not views[k]:      # replaced, not written in place
                        caches[k][i].copy_(v)
            x = shard_fn(x, "residual")
        return self._logits(x), caches
