"""GQA attention with RoPE, a KV cache, sliding windows and
cross-attention (port of ``repro.models.attention``).

The full-sequence paths (training / prefill, and the encoder-decoder's
cross-attention) go through :func:`repro_torch.kernels.ops.attention`:
kernel B5 on the card, the reference's plain oracles on the CPU or when
the caller passes ``use_kernels=False`` (the trainer does). The
decode path writes one token into the cache and attends with a kv-length
mask in plain PyTorch, as the reference does (``masked_decode_attention``
reaches no kernel there either).

On a mesh (``layers.tp_split``) the layer runs tensor-parallel. Where the
q heads divide the "model" axis, each rank runs its block of q heads:
``wq`` column-parallel, ``wo`` row-parallel, and the kv heads those q
heads read, from ``wk`` / ``wv``'s own block where the kv heads divide
too, else from their columns gathered over "model" (each rank's gradient
of them summed back: a reduce-scatter) or picked from a whole leaf; the
attention core (B5 on the card, the plain oracles elsewhere) takes the
local heads unchanged. Where the heads do not divide (hymba's 25), q, k
and v are computed on each rank's columns and gathered over "model", the
core runs whole, and ``wo`` runs row-parallel on the rank's slice of its
input. The gathers are counted as redistributions. Decode writes the new
token's k and v with every kv head (gathered) into its cache, which holds
every head on a mesh too (``sharding.decode_step``).

Where ``sharding.decode_step`` hands decode a cache leaf that is this
rank's block of the sequence over "model" (``layers.seq_split`` marks
it), decode is flash-decoding on the block: the token's k and v, every
kv head, are written only by the rank whose block holds the slot; q of
every head (gathered over "model" where TP split the heads) runs the
partial softmax over the block, and the partials are combined over
"model" (``collectives.block_decode_attention``); where the rank runs
its own q heads it keeps their rows for the row-parallel ``wo``. The
gathers and the combine are counted as decode ops (``decode q``,
``decode kv token``, ``decode combine``). The cross K / V are handled
alike where their frames are split.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (cache_slots, linear, param, rope,
                                       row_linear, seq_split, tp_split,
                                       truncated_normal_)


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
    TP_LEAVES = ("wq", "wk", "wv", "wo")

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

    # ---- tensor parallelism (module docstring) ----

    def _tp(self):
        """(the "model" axis's record, or None on one device; this rank's
        (q heads, kv heads) [start, stop) pairs where it runs its own q
        heads, or None where the core runs whole)."""
        tp = next((r for r in (tp_split(self, n) for n in self.TP_LEAVES)
                   if r is not None), None)
        hq, g = self.cfg.n_heads, self.cfg.n_heads // self.cfg.n_kv
        if tp is None or hq % tp.size or tp_split(self, "wq") is None \
                or tp_split(self, "wo") is None:
            return tp, None
        qa, qb = tp.span(hq)
        return tp, ((qa, qb), (qa // g, (qb - 1) // g + 1))

    def _cols(self, x, xc, tp, name: str, bias, span=None, gather=None):
        """Columns ``span`` (head indices; None: every head) of x @ w (+
        bias), w = ``getattr(self, name)``: from w's block, from its
        columns gathered over "model" or from a whole leaf's entries where
        ``span`` is this rank's heads; every column, gathered over
        "model" where w is split (by ``gather``, default ``tp.gather``
        counted as a redistribution). ``xc`` is ``tp.copy(x)``."""
        w, hd = getattr(self, name), self.cfg.hd
        rec = None if tp is None else tp_split(self, name)
        if span is None:
            if rec is None:
                return linear(x, w, bias)
            y = linear(xc, w)
            y = tp.gather(y, f"attention {name} output") if gather is None \
                else gather(y)
            return y if bias is None else y + bias.to(y.dtype)
        lo, hi = span[0] * hd, span[1] * hd
        if rec is None:
            w = tp.pick(w, 1, lo, hi)
        elif (lo, hi) != (rec.index * w.shape[1],
                          (rec.index + 1) * w.shape[1]):
            w = tp.gather(w, f"attention {name} columns", dim=1,
                          partial=True).narrow(1, lo, hi - lo)
        if bias is not None:
            bias = tp.pick(bias, 0, lo, hi)
        return linear(xc, w, bias)

    def _out(self, o, tp, local: bool):
        """o @ wo: row-parallel on this rank's heads (``local``) or on its
        slice of the whole o, else whole."""
        if tp is None or tp_split(self, "wo") is None:
            return linear(o, self.wo)
        if not local:
            o = tp.scatter(o, "attention wo input")
        return row_linear(o, self.wo, tp)

    def _qkv(self, x, positions, use_rope: bool = True, kv_src=None):
        """q, k, v for this rank's core (module docstring), the axis's
        record and whether the core runs on this rank's own heads;
        ``kv_src``: where k and v come from (cross-attention's memory,
        without biases then; default ``x``)."""
        tp, heads = self._tp()
        xc = x if tp is None else tp.copy(x)
        q = self._q(x, xc, tp, heads, positions, use_rope, kv_src is None)
        if kv_src is None:
            k, v = self._kv(x, xc, tp, heads, positions, use_rope)
        else:
            sc = kv_src if tp is None else tp.copy(kv_src)
            k, v = self._kv(kv_src, sc, tp, heads, None, False, bias=False)
        if heads is not None:
            k, v = self._grouped(k, heads), self._grouped(v, heads)
        return q, k, v, tp, heads is not None

    def _q(self, x, xc, tp, heads, positions, use_rope: bool = True,
           bias: bool = True, gather=None):
        """q (B, S, heads, hd): this rank's q heads, or every head."""
        cfg = self.cfg
        q = self._cols(x, xc, tp, "wq", self.bq if bias else None,
                       None if heads is None else heads[0], gather)
        q = q.reshape(x.shape[0], x.shape[1], -1, cfg.hd)
        if use_rope and cfg.pos == "rope":
            q = rope(q, positions, cfg.rope_theta)
        return q

    def _kv(self, src, sc, tp, heads, positions, use_rope: bool = True,
            bias: bool = True, gather=None):
        """k and v (B, S, heads, hd) of ``src``: the kv heads this rank's q
        heads read, or every kv head (``heads`` None). ``sc`` is
        ``tp.copy(src)``."""
        cfg = self.cfg
        span = None if heads is None else heads[1]
        b, s = src.shape[:2]
        k = self._cols(src, sc, tp, "wk", self.bk if bias else None, span,
                       gather)
        v = self._cols(src, sc, tp, "wv", self.bv if bias else None, span,
                       gather)
        k, v = k.reshape(b, s, -1, cfg.hd), v.reshape(b, s, -1, cfg.hd)
        if use_rope and cfg.pos == "rope":
            k = rope(k, positions, cfg.rope_theta)
        return k, v

    def _grouped(self, k, heads):
        """k (B, S, kv heads of this rank, hd) for the local q heads'
        grouped reads: q head i reads kv head i // (Hq_local / Hkv_local)
        where this rank's q heads map onto its kv heads that way; else
        one kv head per q head."""
        (qa, qb), (ka, kb) = heads
        g = self.cfg.n_heads // self.cfg.n_kv
        want = [(qa + i) // g - ka for i in range(qb - qa)]
        nq, nk = qb - qa, kb - ka
        if nq % nk == 0 and want == [i // (nq // nk) for i in range(nq)]:
            return k
        return k[:, :, want]

    def project_qkv(self, x: torch.Tensor, positions: torch.Tensor,
                    use_rope: bool = True):
        """q (B, S, Hq, hd), k and v (B, S, Hkv, hd), RoPE applied; on a
        mesh, the heads this rank's core runs (module docstring)."""
        return self._qkv(x, positions, use_rope)[:3]

    def cache_kv(self, x: torch.Tensor, positions: torch.Tensor):
        """k and v (B, S, Hkv, hd) with every kv head, RoPE applied (what
        a cache holds; gathered over "model" on a mesh)."""
        tp, _ = self._tp()
        return self._kv(x, x if tp is None else tp.copy(x), tp, None,
                        positions)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                window: Optional[int] = None, causal: bool = True,
                use_kernels: Optional[bool] = None) -> torch.Tensor:
        """Full-sequence (training / prefill) attention. x: (B, S, d)."""
        q, k, v, tp, local = self._qkv(x, positions)
        # (B, Hq, S, hd) views: the kernel reads them through their strides
        o = ops.attention(q.movedim(2, 1), k.movedim(2, 1), v.movedim(2, 1),
                          causal=causal, window=window,
                          use_kernels=use_kernels)
        b, s = x.shape[:2]
        return self._out(o.movedim(1, 2).reshape(b, s, -1), tp, local)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               write_idx: int, position: int, kv_len: int
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One-token decode. x: (B, 1, d); cache k/v (B, Smax, Hkv, hd).

        ``write_idx`` is the cache slot to write (ring buffers: position %
        Smax), ``position`` the absolute token position (RoPE), ``kv_len``
        the number of valid slots. The cache is updated in place and
        returned. Keys are stored rotated at their absolute positions, so
        ring-buffer slot order does not matter. On a mesh the token's k
        and v are written with every kv head, and this rank's q heads read
        theirs from the cache, or from every rank's block of it (module
        docstring).
        """
        b = x.shape[0]
        positions = torch.full((b, 1), position, dtype=torch.int32,
                               device=x.device)
        tp, heads = self._tp()
        xc = x if tp is None else tp.copy(x)
        seq = seq_split(cache["k"])
        q = self._q(x, xc, tp, heads, positions,
                    gather=seq and seq.gatherer("decode q"))
        k, v = self._kv(x, xc, tp, None, positions,
                        gather=seq and seq.gatherer("decode kv token"))
        if seq is None:
            cache["k"][:, write_idx:write_idx + 1] = k.to(cache["k"].dtype)
            cache["v"][:, write_idx:write_idx + 1] = v.to(cache["v"].dtype)
            o = self._attend_cache(q, cache["k"], cache["v"], heads, kv_len,
                                   x.dtype)
        else:
            seq.write(cache["k"], write_idx, k)
            seq.write(cache["v"], write_idx, v)
            o = self._attend_block(q, cache["k"], cache["v"], seq, heads,
                                   kv_len, x.dtype)
        return self._out(o, tp, heads is not None), cache

    def _attend_cache(self, q, ck, cv, heads, kv_len: int, dtype):
        """q (B, 1, Hq_local, hd) against a cache (B, Smax, Hkv, hd) with
        every kv head: this rank's kv heads read where it runs its own q
        heads. Returns (B, 1, Hq_local * hd)."""
        if heads is not None:
            (ka, kb) = heads[1]
            ck = self._grouped(ck[:, :, ka:kb], heads)
            cv = self._grouped(cv[:, :, ka:kb], heads)
        o = masked_decode_attention(q.movedim(2, 1),
                                    ck.movedim(2, 1).to(dtype),
                                    cv.movedim(2, 1).to(dtype), kv_len)
        return o.movedim(1, 2).reshape(q.shape[0], 1, -1)

    def _attend_block(self, q, ck, cv, seq, heads, kv_len: int, dtype):
        """q (B, 1, Hq_local, hd) against this rank's sequence block (B,
        Sc, Hkv, hd) of a cache with every kv head (``seq``): every q head
        (gathered over "model" where the rank runs its own) over the
        block, the partials combined over "model"; this rank's q heads'
        rows of the result. Returns (B, 1, Hq_local * hd)."""
        if heads is not None:
            q = seq.gather(q, "decode q", dim=2)
        o = seq.attend(q[:, 0], ck.to(dtype), cv.to(dtype), kv_len)
        if heads is not None:
            (qa, qb) = heads[0]
            o = o[:, qa:qb]
        return o.reshape(q.shape[0], 1, -1)

    def cross(self, x: torch.Tensor, memory: torch.Tensor,
              use_kernels: Optional[bool] = None) -> torch.Tensor:
        """Decoder cross-attention (``apply_cross_attention``): queries from
        x (B, S, d), keys and values from the encoder memory (B, Sm, d), no
        RoPE and no biases, every query attending to every memory row (on
        the card: B5 with Sq != Sk, causal off)."""
        q, k, v, tp, local = self._qkv(x, None, use_rope=False,
                                       kv_src=memory)
        o = ops.attention(q.movedim(2, 1), k.movedim(2, 1), v.movedim(2, 1),
                          causal=False, use_kernels=use_kernels)
        b, s = x.shape[:2]
        return self._out(o.movedim(1, 2).reshape(b, s, -1), tp, local)

    def cross_decode(self, x: torch.Tensor, ck: torch.Tensor,
                     cv: torch.Tensor) -> torch.Tensor:
        """One decoder token x (B, 1, d) against the cross K / V (B, Sm,
        Hkv, hd) projected from the memory once: no RoPE, no biases, every
        memory row valid; on a mesh, their block of the frames where they
        are split (module docstring)."""
        tp, heads = self._tp()
        xc = x if tp is None else tp.copy(x)
        seq = seq_split(ck)
        q = self._q(x, xc, tp, heads, None, use_rope=False, bias=False,
                    gather=seq and seq.gatherer("decode q"))
        if seq is None:
            o = self._attend_cache(q, ck, cv, heads, ck.shape[1], x.dtype)
        else:
            o = self._attend_block(q, ck, cv, seq, heads, cache_slots(ck),
                                   x.dtype)
        return self._out(o, tp, heads is not None)
