"""Mixture-of-Experts FFN with sort-based token dispatch, dropping
(port of ``repro.models.moe``).

Router logits in float32, softmax, top-k with the gates renormalised, the
Switch load-balancing aux loss from the top-1 fraction. The (token, k)
assignments are sorted stably by expert; each one's position inside its
expert comes from the exclusive cumsum of the counts, and assignments at
or past the capacity go to a spare slot (dropped). The kept tokens fill an
(E, cap, d) buffer, and the three expert products are batched matmuls over
it: plain large products, as the reference's ``einsum`` outside any Pallas
kernel, so no kernel of this package runs them.

The combine differs in form. The reference scatter-adds each assignment's
gated output into its token's row (``.at[st].add``), in expert order; a
scatter-add on the card sums in an order that changes from run to run.
Here the sort permutation is undone instead: each token gathers its k slot
outputs in its own top-k order (a dropped one reads a zero row), scales
them by its gates and sums over k. Both sides sum the same k terms, in
another order (f32: within rounding), and two calls on the card are
bitwise equal.

``cfg.moe_grouped`` dispatches per batch row (group = one sequence, aux
meaned over the rows). Every group is handled in one pass: the groups'
(E, cap, d) buffers are laid side by side as (E, G * cap, d).

On a mesh each rank holds a share of the batch's rows, and the flat
dispatch still sees the global batch, as the reference's does under
``jit``: the models' ``shard_fn`` hook tells how many equal shares there
are (``row_shares``; 1, and no collective, on one device). The capacity
comes from the global token count; the aux loss from the router's
statistics summed over the shares (``"dp_sum"``); an assignment's
position inside its expert counts the assignments of the shares before
this one (``"dp_cumsum"`` of the counts), so exactly the reference's
assignments are dropped, and a kept one goes to that global slot. The
shares' slots of an expert are disjoint and together are the one-device
buffer, each expert's capacity padded to a multiple of the shares
(:func:`padded_capacity`; drops still follow the unpadded one, so no
token lands in a pad slot). The hook's ``"slot_window"`` sums the
shares' buffers over the DP ranks and hands each its window of every
expert's slots, ``capacity / shares`` of them (a reduce-scatter of
disjoint blocks: exact); the expert FFN runs on that window, and
``"slot_gather"`` gathers the outputs back, so each rank reads its own
tokens' slots.

The experts are split over "model" in E, as the reference's rules split
them, where the model axis divides E (``TP_LEAVES``; the hooks keep this
rank's block, ``layers.tp_split``): a rank dispatches only the
assignments to its experts and sums its experts' gated outputs, a slot
of another rank's expert reading the zero row, and the partial outputs
are summed over "model" (``split.reduce``). The dispatched tokens and
the gates enter through ``split.copy``, whose backward sums their
gradients over "model" (each rank's covers its experts only); the
router's input and the aux loss are whole and the same on every rank.
The ``router`` (d, E) stays whole: softmax and top-k read every
expert's logit. Grouped dispatch splits the experts the same way and
needs no exchange: its groups are whole rows, each rank's own.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (activation, param, tp_split,
                                       truncated_normal_)


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``n_tokens`` tokens: the capacity factor's
    share, rounded up to a multiple of 8, at least 8."""
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def padded_capacity(cap: int, shares: int) -> int:
    """An expert's slots on a mesh of ``shares`` DP ranks: ``cap`` rounded
    up to a multiple of ``shares``, so each rank's window of them
    (:func:`slot_window`) is the same size."""
    return -(-cap // shares) * shares


def slot_window(cap: int, shares: int, index: int) -> slice:
    """The slots of every expert that DP rank ``index`` (flat, over the
    DP axes in mesh order) multiplies, of :func:`padded_capacity`'s."""
    w = padded_capacity(cap, shares) // shares
    return slice(index * w, (index + 1) * w)


class MoE(nn.Module):
    """The moe FFN: ``router`` (d, E), ``w_in`` / ``w_gate`` (E, d, de),
    ``w_out`` (E, de, d), the reference's names and shapes; on a mesh the
    experts split over "model" in E (module docstring)."""

    TP_LEAVES = ("w_in", "w_gate", "w_out")

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, e = cfg.d_model, cfg.n_experts
        de = cfg.d_expert or cfg.d_ff
        self.router = param(d, e, device=device)
        self.w_in = param(e, d, de, device=device)
        self.w_out = param(e, de, d, device=device)
        self.w_gate = param(e, d, de, device=device) if cfg.glu else None

    def reset(self, generator=None) -> None:
        d, de = self.w_in.shape[1:]
        truncated_normal_(self.router, d ** -0.5, generator)
        truncated_normal_(self.w_in, d ** -0.5, generator)
        truncated_normal_(self.w_out, de ** -0.5, generator)
        if self.w_gate is not None:
            truncated_normal_(self.w_gate, d ** -0.5, generator)

    def forward(self, x: torch.Tensor, shard_fn=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, d) -> (y (B, S, d), aux: float32 scalar). ``shard_fn``:
        the models' hook on a mesh (module docstring)."""
        b, s, d = x.shape
        if self.cfg.moe_grouped:
            y, aux = self._dispatch(x)
            return y, aux.mean()
        y, aux = self._dispatch(x.reshape(1, b * s, d), shard_fn)
        return y.reshape(b, s, d), aux[0]

    def _dispatch(self, xt: torch.Tensor, shard_fn=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sort-based dispatch over G token groups xt (G, T, d); returns
        y (G, T, d) and each group's aux (G,). With ``shard_fn``'s
        ``row_shares`` > 1 the one group is a share of the global one."""
        cfg = self.cfg
        dtype, dev = xt.dtype, xt.device
        g, t, d = xt.shape
        k, e = cfg.top_k, cfg.n_experts
        shares = getattr(shard_fn, "row_shares", 1)
        cap = capacity(t * shares, cfg)
        cap_pad = padded_capacity(cap, shares)
        split = tp_split(self, "w_in")            # this rank's experts
        e0, e1 = split.span(e) if split is not None else (0, e)
        el = e1 - e0

        logits = xt.float() @ self.router.float()                 # (G, T, E)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, expert_ids = torch.topk(probs, k, dim=-1)      # (G, T, k)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

        # ---- load-balancing aux loss (Switch-style) ----
        top1 = F.one_hot(expert_ids[..., 0], e).float()
        if shares == 1:
            me = probs.mean(1)                                    # mean prob
            ce = top1.mean(1)                                     # top-1 share
        else:                                   # over the global batch
            me = shard_fn(probs.sum(1), "dp_sum") / (t * shares)
            ce = shard_fn(top1.sum(1), "dp_sum") / (t * shares)
        aux = cfg.router_aux_coef * e * (me * ce).sum(-1)

        # ---- sort-based dispatch ----
        flat_e = expert_ids.reshape(g, t * k)
        order = torch.argsort(flat_e, dim=-1, stable=True)
        se = flat_e.gather(1, order)
        st = order // k                       # the token of each sorted slot
        counts = F.one_hot(flat_e, e).sum(1)                      # (G, E)
        starts = counts.cumsum(-1) - counts                       # exclusive
        pos = torch.arange(t * k, device=dev) - starts.gather(1, se)
        if shares > 1:      # the global slot, behind the earlier shares'
            before = shard_fn(counts, "dp_cumsum") - counts
            pos = pos + before.gather(1, se)
        mine = (pos < cap) & (se >= e0) & (se < e1)
        dest = torch.where(mine, (se - e0) * cap_pad + pos,
                           torch.full_like(se, el * cap_pad))     # drop slot

        gates = gate_vals
        if split is not None:   # gradients from this rank's experts only
            xt, gates = split.copy(xt), split.copy(gate_vals)
        rows = torch.arange(g, device=dev)[:, None]
        buf = torch.zeros(g, el * cap_pad + 1, d, dtype=dtype, device=dev)
        buf[rows, dest] = xt[rows, st]        # the spare row is discarded
        h = buf[:, :el * cap_pad].reshape(g, el, cap_pad, d).transpose(0, 1) \
            .reshape(el, g * cap_pad, d)
        if shares > 1:                        # this rank's window of slots
            h = shard_fn(h, "slot_window")

        # ---- expert FFN: batched products over the experts ----
        up = torch.bmm(h, self.w_in.to(dtype))
        if self.w_gate is not None:
            up = activation(torch.bmm(h, self.w_gate.to(dtype)),
                            cfg.act) * up
        else:
            up = activation(up, cfg.act)
        out = torch.bmm(up, self.w_out.to(dtype))
        if shares > 1:                        # every slot's output back
            out = shard_fn(out, "slot_gather")                    # (E', cap', d)

        # ---- combine: undo the sort, sum each token's k gated slots ----
        out_flat = torch.cat([
            out.reshape(el, g, cap_pad, d).transpose(0, 1)
            .reshape(g, el * cap_pad, d),
            torch.zeros(g, 1, d, dtype=dtype, device=dev)], dim=1)
        slot = torch.empty_like(dest).scatter_(1, order, dest)   # token order
        slot_out = out_flat[rows, slot].reshape(g, t, k, d)
        y = (slot_out * gates.to(dtype)[..., None]).sum(2)
        if split is not None:                 # the other ranks' experts
            y = split.reduce(y)
        return y, aux
