"""dtype names and widths shared by the planners, the registry and linalg.

Accepts ``torch.dtype``, numpy dtypes/types and plain names ("float32",
"bfloat16"), so a plan or registry key built from a torch tensor matches
the one the JAX package builds from the same numpy-named dtype.
"""
from __future__ import annotations

import numpy as np
import torch

_TORCH_BY_NAME = {"float16": torch.float16, "bfloat16": torch.bfloat16,
                  "float32": torch.float32, "float64": torch.float64,
                  "int32": torch.int32, "int64": torch.int64}


def name(dtype) -> str:
    """Canonical numpy-style name: torch.float32 -> "float32"."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    n = getattr(dtype, "name", None)
    if isinstance(n, str):
        return n
    if isinstance(dtype, str) and dtype in _TORCH_BY_NAME:
        return dtype
    return np.dtype(dtype).name


def itemsize(dtype) -> int:
    """Bytes per element of ``dtype``."""
    return to_torch(dtype).itemsize


def to_torch(dtype) -> torch.dtype:
    """``dtype`` as a torch.dtype; ValueError on a name torch lacks."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _TORCH_BY_NAME[name(dtype)]
    except (KeyError, TypeError):
        raise ValueError(f"unsupported dtype {dtype!r}") from None
