"""Losses (port of ``repro.train.losses``): causal-LM cross entropy in
float32 with the z-loss regularizer.

Vocab-parallel logits (this rank's columns of a head split over "model",
marked by ``models.layers.vocab_split``) take the vocab-parallel form:
the row maximum, the sum of exponentials and the target's logit are each
reduced over "model", so the logits are never gathered."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import vocab_split


def _lse_gold(lf: torch.Tensor, labels: torch.Tensor, split):
    """(logsumexp over the vocabulary, the label's logit) of f32 logits:
    whole, or this rank's columns of them (``split``)."""
    if split is None:
        gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
        return torch.logsumexp(lf, dim=-1), gold
    v = lf.shape[-1]
    m = split.max(lf.detach().amax(-1))
    lse = m + torch.log(split.reduce(torch.exp(lf - m[..., None]).sum(-1)))
    idx = labels.long() - split.index * v
    mine = (idx >= 0) & (idx < v)
    gold = torch.gather(lf, -1, torch.where(mine, idx, 0)[..., None])[..., 0]
    return lse, split.reduce(torch.where(mine, gold, 0.0))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_loss: float = 1e-4, split=None) -> torch.Tensor:
    """Mean token cross-entropy. logits (B, S, V) any dtype; labels (B, S).

    z-loss (PaLM) keeps the softmax normalizer bounded. With ``mask`` the
    mean is over the masked-in tokens (at least one). ``split``: the
    vocab-parallel head's record (default: the logits' own mark)."""
    split = vocab_split(logits) if split is None else split
    lse, gold = _lse_gold(logits.float(), labels, split)
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
    split = vocab_split(logits)
    extra = logits.shape[1] - tokens.shape[1]
    if extra:
        logits = logits[:, extra:]
    return cross_entropy(logits[:, :-1], tokens[:, 1:], z_loss=z_loss,
                         split=split)
