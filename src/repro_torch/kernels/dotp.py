"""B4: <x, y> in float32 on a hand-written Hopper kernel (``csrc/dotp.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/dotp.py::dotp``
(``_dotp_kernel``). The TPU kernel streams (U, 128) tiles into U * 128
independent f32 chains, U from ``optimal_accumulators(n)`` (the paper's
eq. 3 applied to the VPU's add latency). The card hides latency with
threads instead: each thread keeps :data:`ILP` partial sums over a
grid-stride walk, each CTA reduces its threads to one partial, and a
second single-CTA pass sums the partials in a fixed order (no float
atomics, so the result is deterministic). The kernel is bound by bytes;
see the note at the top of ``csrc/dotp.cu``.

:func:`dotp` launches the kernel for CUDA tensors and runs
:func:`dotp_plain` for CPU tensors; there is no other path.
``dotp.launches`` counts kernel launches on the card and
``dotp.last_launch`` records the U of ``optimal_accumulators(n)`` (the
TPU's VPU count, recorded, not used: it does not fit this card) beside
the launch shape.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.codesign import optimal_accumulators
from repro_torch.kernels import _build

# csrc/dotp.cu's launch shape
THREADS, ILP, MAX_BLOCKS = 256, 4, 1024
# dtype codes of csrc/common.cuh (repro::DType)
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def dotp_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: sum of the f32 products (0-d, f32)."""
    return torch.sum(x.float() * y.float())


def blocks_for(n: int) -> int:
    """CTAs of the first pass for n elements (csrc/dotp.cu::launch)."""
    return min(MAX_BLOCKS, -(-n // (THREADS * ILP)))


def dotp(x: torch.Tensor, y: torch.Tensor,
         accumulators: Optional[int] = None) -> torch.Tensor:
    """<x, y> as a 0-d float32 tensor: the CUDA kernel for CUDA tensors,
    :func:`dotp_plain` for CPU tensors. ``accumulators`` (default
    ``optimal_accumulators(n)``) is recorded, not used."""
    if x.ndim != 1 or x.shape != y.shape:
        raise ValueError(f"dotp needs two vectors of one length; got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    if x.device != y.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dotp runs on cuda (kernel) or cpu (plain "
                         f"version); got {x.device} and {y.device}")
    if x.device.type == "cpu":
        return dotp_plain(x, y)
    if x.dtype != y.dtype or x.dtype not in DTYPE_CODES:
        raise ValueError(f"dotp on the card takes x and y of one of "
                         f"{tuple(DTYPE_CODES)}; got {x.dtype}, {y.dtype}")
    n = x.shape[0]
    if n == 0:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    partials = torch.empty(MAX_BLOCKS, dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    lib = _build.library("dotp")
    with torch.cuda.device(x.device):
        err = lib.repro_dotp(DTYPE_CODES[x.dtype], x.data_ptr(), x.stride(0),
                             y.data_ptr(), y.stride(0), n,
                             partials.data_ptr(), out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "repro_dotp")
    dotp.launches += 1
    dotp.last_launch = {
        "accumulators": accumulators or optimal_accumulators(n),
        "blocks": blocks_for(n), "threads": THREADS, "ilp": ILP, "n": n}
    return out


dotp.launches = 0
dotp.last_launch = None
