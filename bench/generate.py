"""The traffic generator: a cell's inputs, made on its device from the
seed in a few large calls.

The configuration gives the batch, the item's shape and the dtype; the
traffic file names the driver (``routine``, whose reference module makes
its kind of item from the Gaussian source below, reading its parameters
from the traffic file) and the right-hand sides (``nrhs``). The seed
changes the values only, never a size.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def make_inputs(config: Dict, traffic: Dict, routine, seed: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, b) of one cell from ``seed``: the same seed, the same inputs.
    b is Gaussian, (batch, m, nrhs)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    batch, m, n = config["batch"], config["m"], config["n"]
    dtype = getattr(torch, config["dtype"])
    rand = lambda *shape: torch.randn(shape, generator=gen, device=device,
                                      dtype=dtype)
    a = routine.items(rand, batch, m, n, traffic)
    return a, rand(batch, m, traffic["nrhs"])
