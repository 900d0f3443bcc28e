"""B1: C = A @ B on a hand-written Hopper kernel (``csrc/gemm.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/gemm.py::gemm``
(``_gemm_kernel``). What bounds it on the H100, and what the design does
about it, is in the note at the top of ``csrc/gemm.cu``: at the main
path's shapes it is bound by operations; float32 runs IEEE FFMA (never
TF32); each CTA owns a 64x64 output tile and loops over K inside the
block, in place of the TPU's sequential K grid axis; ragged edges are
masked in-kernel and operands are read through their strides, so the
blocked drivers' transposed and sliced views need no copy.

:func:`gemm` launches the kernel for CUDA tensors and runs
:func:`gemm_plain` (the same function in plain PyTorch) for CPU tensors;
there is no other path. ``gemm.launches`` counts its calls (kernel
launches on the card) and ``gemm.last_launch`` records the
:class:`~repro_torch.core.codesign.GemmPlan` it was handed beside the CTA
tile it launched with.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.codesign import GemmPlan, plan_gemm
from repro_torch.kernels import _build

# the CTA tile csrc/gemm.cu launches with: (BM, BN, BK)
TILE = (64, 64, 16)
# dtype codes of csrc/common.cuh (repro::DType)
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
# output dtypes the kernel stores for each operand dtype
OUT_DTYPES = {torch.float32: (torch.float32,),
              torch.float64: (torch.float64,),
              torch.bfloat16: (torch.bfloat16, torch.float32)}
_MAX_ROW_BLOCKS = 65535                 # gridDim.y limit


def accumulator_dtype(dtype: torch.dtype) -> torch.dtype:
    """Per-precision accumulator width: float64 operands accumulate in
    float64, everything narrower (float32, bfloat16) in float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def gemm_plain(a: torch.Tensor, b: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the product at the
    accumulator width, cast to ``out_dtype`` (default: a's dtype)."""
    acc = accumulator_dtype(a.dtype)
    return (a.to(acc) @ b.to(acc)).to(out_dtype or a.dtype)


def check_operands(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.dtype:
    """Validate a GEMM's operands for the kernel; returns the output dtype."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm needs (m, k) @ (k, n); got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in DTYPE_CODES:
        raise ValueError(f"gemm operands must share one of "
                         f"{tuple(DTYPE_CODES)}; got {a.dtype}, {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in OUT_DTYPES[a.dtype]:
        raise ValueError(f"gemm of {a.dtype} stores {OUT_DTYPES[a.dtype]}, "
                         f"not {out_dtype}")
    if a.device != b.device:
        raise ValueError(f"gemm operands on {a.device} and {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gemm runs on cuda (kernel) or cpu (plain "
                         f"version), not {a.device}")
    if -(-a.shape[0] // TILE[0]) > _MAX_ROW_BLOCKS:
        raise ValueError(f"gemm takes at most {_MAX_ROW_BLOCKS * TILE[0]} "
                         f"rows, got {a.shape[0]}")
    return out_dtype


def launch(entry: str, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           *epilogue_args) -> None:
    """Launch one csrc/gemm.cu entry point writing into ``c`` (contiguous)
    on the current stream of a's device; raises on a refused launch."""
    m, k = a.shape
    n = b.shape[1]
    lib = _build.library("gemm")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            DTYPE_CODES[a.dtype], DTYPE_CODES[c.dtype],
            a.data_ptr(), a.stride(0), a.stride(1),
            b.data_ptr(), b.stride(0), b.stride(1), *epilogue_args,
            c.data_ptr(), c.stride(0), m, n, k, stream)
    _build.check(err, entry)


def gemm(a: torch.Tensor, b: torch.Tensor, plan: Optional[GemmPlan] = None,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B: the CUDA kernel for CUDA tensors, :func:`gemm_plain` for
    CPU tensors. ``plan`` (default: :func:`plan_gemm` at a's dtype) is
    recorded, not tiled by: the kernel's CTA tile is :data:`TILE`."""
    out_dtype = check_operands(a, b, out_dtype)
    m, k = a.shape
    n = b.shape[1]
    if plan is None:
        plan = plan_gemm(m, n, k, dtype=a.dtype)
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=out_dtype, device=a.device)
    gemm.launches += 1
    gemm.last_launch = {"plan": plan, "tile": TILE, "device": a.device.type}
    if a.device.type == "cpu":
        return gemm_plain(a, b, out_dtype)
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    launch("repro_gemm", a, b, c)
    return c


gemm.launches = 0
gemm.last_launch = None
