"""The train state's plain pieces, shared by the models, the optimizer and
the sharding rules (it imports none of them): the parameters' module
paths and the 8-bit moment's pair of tensors.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch import nn


def named_parameters(model: nn.Module) -> Dict[str, nn.Parameter]:
    """``model``'s parameters keyed by module path with ``/`` separators,
    in registration order."""
    return {n.replace(".", "/"): p for n, p in model.named_parameters()}


class _Moment(NamedTuple):
    """An 8-bit moment: int8 codes (blocks, 256) and f32 block scales
    (blocks, 1)."""
    q: torch.Tensor
    scale: torch.Tensor
