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
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import activation, param, truncated_normal_


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``n_tokens`` tokens: the capacity factor's
    share, rounded up to a multiple of 8, at least 8."""
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


class MoE(nn.Module):
    """The moe FFN: ``router`` (d, E), ``w_in`` / ``w_gate`` (E, d, de),
    ``w_out`` (E, de, d), the reference's names and shapes."""

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

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, d) -> (y (B, S, d), aux: float32 scalar)."""
        b, s, d = x.shape
        if self.cfg.moe_grouped:
            y, aux = self._dispatch(x)
            return y, aux.mean()
        y, aux = self._dispatch(x.reshape(1, b * s, d))
        return y.reshape(b, s, d), aux[0]

    def _dispatch(self, xt: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sort-based dispatch over G token groups xt (G, T, d); returns
        y (G, T, d) and each group's aux (G,)."""
        cfg = self.cfg
        dtype, dev = xt.dtype, xt.device
        g, t, d = xt.shape
        k, e = cfg.top_k, cfg.n_experts
        cap = capacity(t, cfg)

        logits = xt.float() @ self.router.float()                 # (G, T, E)
        probs = torch.softmax(logits, dim=-1)
        gate_vals, expert_ids = torch.topk(probs, k, dim=-1)      # (G, T, k)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

        # ---- load-balancing aux loss (Switch-style) ----
        me = probs.mean(1)                                        # mean prob
        ce = F.one_hot(expert_ids[..., 0], e).float().mean(1)     # top-1 share
        aux = cfg.router_aux_coef * e * (me * ce).sum(-1)

        # ---- sort-based dispatch ----
        flat_e = expert_ids.reshape(g, t * k)
        order = torch.argsort(flat_e, dim=-1, stable=True)
        se = flat_e.gather(1, order)
        st = order // k                       # the token of each sorted slot
        counts = F.one_hot(flat_e, e).sum(1)                      # (G, E)
        starts = counts.cumsum(-1) - counts                       # exclusive
        pos = torch.arange(t * k, device=dev) - starts.gather(1, se)
        dest = torch.where(pos < cap, se * cap + pos,
                           torch.full_like(se, e * cap))          # drop slot

        rows = torch.arange(g, device=dev)[:, None]
        buf = torch.zeros(g, e * cap + 1, d, dtype=dtype, device=dev)
        buf[rows, dest] = xt[rows, st]        # the spare row is discarded
        h = buf[:, :e * cap].reshape(g, e, cap, d).transpose(0, 1) \
            .reshape(e, g * cap, d)

        # ---- expert FFN: batched products over the experts ----
        up = torch.bmm(h, self.w_in.to(dtype))
        if self.w_gate is not None:
            up = activation(torch.bmm(h, self.w_gate.to(dtype)),
                            cfg.act) * up
        else:
            up = activation(up, cfg.act)
        out = torch.bmm(up, self.w_out.to(dtype))                # (E, G*cap, d)

        # ---- combine: undo the sort, sum each token's k gated slots ----
        out_flat = torch.cat([
            out.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d),
            torch.zeros(g, 1, d, dtype=dtype, device=dev)], dim=1)
        slot = torch.empty_like(dest).scatter_(1, order, dest)   # token order
        slot_out = out_flat[rows, slot].reshape(g, t, k, d)
        y = (slot_out * gate_vals.to(dtype)[..., None]).sum(2)
        return y, aux
