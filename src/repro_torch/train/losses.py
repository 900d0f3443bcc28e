"""Losses (port of ``repro.train.losses``): causal-LM cross entropy in
float32 with the z-loss regularizer."""
from __future__ import annotations

from typing import Optional

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy. logits (B, S, V) any dtype; labels (B, S).

    z-loss (PaLM) keeps the softmax normalizer bounded. With ``mask`` the
    mean is over the masked-in tokens (at least one)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    z_loss: float = 1e-4) -> torch.Tensor:
    """Shifted LM loss: predict tokens[t+1] from logits[t]. Logits longer
    than the tokens (prefix embeddings prepended) drop the prefix
    positions before the shift."""
    extra = logits.shape[1] - tokens.shape[1]
    if extra:
        logits = logits[:, extra:]
    return cross_entropy(logits[:, :-1], tokens[:, 1:], z_loss=z_loss)
