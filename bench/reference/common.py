"""Shared pieces of the plain references."""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def matmul_precision(tf32: bool) -> Iterator[None]:
    """Matrix products of float32 in TF32 (``tf32=True``) or in full
    float32 inside the block; the previous setting after it."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def worst_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over items of ||got_i - want_i||_F / ||want_i||_F (leading axis
    the items), NaN read as infinity."""
    diff = (got.to(want.dtype) - want).flatten(1).norm(dim=1)
    rel = diff / want.flatten(1).norm(dim=1)
    return float(torch.nan_to_num(rel, nan=float("inf")).max())

