"""B6: the Mamba-2 chunked SSD scan on a hand-written Hopper kernel
(``csrc/ssd_scan.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``
(``_ssd_kernel``). One CTA owns one (batch, head) and walks the chunks in
order inside the block, in place of the TPU's sequential chunk grid axis,
with the f32 (P, N) state in shared memory; the within-chunk c x c decay
scores are tiled by 64 x 64 so a 256-step chunk fits the card's shared
memory. Layout as the reference: x (B, H, L, P), a_log (B, H, L), B/C
(B, H, L, N); operands are read through their strides, so the transposed
views :func:`repro_torch.kernels.ops.ssd` hands it need no copy.

:func:`ssd_scan` launches the kernel for CUDA tensors and runs
:func:`ssd_scan_plain` for CPU tensors; there is no other path.
``ssd_scan.launches`` counts kernel launches on the card and
``ssd_scan.last_launch`` records the
:class:`~repro_torch.core.codesign.SSDPlan` beside the chunk it ran.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.codesign import SSDPlan, plan_ssd
from repro_torch.kernels import _build, ref

MAX_HEAD_DIM = 128
SMEM_LIMIT = 232_448     # bytes of shared memory one CTA may use (H100)
# dtype codes of csrc/common.cuh (repro::DType) the kernel takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}


def effective_chunk(L: int, chunk: Optional[int], plan: SSDPlan) -> int:
    """The chunk the scan runs with: the plan's unless given, at most
    ``max(L, 8)`` (the reference's rule)."""
    return min(chunk or plan.chunk, max(L, 8))


def ssd_scan_plain(x: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, chunk: Optional[int] = None
                   ) -> torch.Tensor:
    """The plain PyTorch version: :func:`ref.ssd_chunked` in the kernel
    layout (B, H, L, ...), with the kernel's chunk rule."""
    if 0 in x.shape or 0 in a_log.shape or 0 in B.shape or 0 in C.shape:
        return torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    bsz, h, L, p = x.shape
    c = effective_chunk(L, chunk, plan_ssd(L, h, p, B.shape[-1]))
    y = ref.ssd_chunked(x.movedim(1, 2), a_log.movedim(1, 2),
                        B.movedim(1, 2), C.movedim(1, 2), chunk=c)
    return y.movedim(2, 1)


def ssd_scan(x: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, chunk: Optional[int] = None) -> torch.Tensor:
    """Chunked SSD over the (B, H, L, ...) layout; returns y (B, H, L, P)
    in x's dtype: the CUDA kernel for CUDA tensors, :func:`ssd_scan_plain`
    for CPU tensors. The chunk defaults to :func:`plan_ssd`'s."""
    if x.ndim != 4 or a_log.shape != x.shape[:3] or B.shape != C.shape \
            or B.shape[:3] != x.shape[:3]:
        raise ValueError(f"ssd_scan needs x (B, H, L, P), a_log (B, H, L), "
                         f"B/C (B, H, L, N); got {tuple(x.shape)}, "
                         f"{tuple(a_log.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    devs = {t.device for t in (x, a_log, B, C)}
    if len(devs) != 1 or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on cuda (kernel) or cpu (plain "
                         f"version); got {sorted(map(str, devs))}")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, a_log, B, C, chunk=chunk)
    if not x.dtype == B.dtype == C.dtype or x.dtype not in DTYPE_CODES:
        raise ValueError(f"ssd_scan on the card takes x, B, C of one of "
                         f"{tuple(DTYPE_CODES)}; got {x.dtype}, {B.dtype}, "
                         f"{C.dtype}")
    if 0 in x.shape or 0 in a_log.shape or 0 in B.shape or 0 in C.shape:
        return torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    bsz, h, L, p = x.shape
    n = B.shape[-1]
    if p > MAX_HEAD_DIM:
        raise ValueError(f"ssd_scan kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {p}")
    plan = plan_ssd(L, h, p, n)          # the reference's call
    c = effective_chunk(L, chunk, plan)
    lib = _build.library("ssd_scan")
    smem = lib.repro_ssd_scan_smem_bytes(p, n, c)
    if smem > SMEM_LIMIT or h > 2 ** 31 - 1 or bsz > 65535:
        raise ValueError(f"ssd_scan: head_dim {p}, state {n}, chunk {c} "
                         f"need {smem} B of shared memory (limit "
                         f"{SMEM_LIMIT}) or the grid is too large")
    a = a_log.float()
    # y is laid out (B, L, H, P) so the model's moveaxis back is free
    y = torch.empty((bsz, L, h, p), dtype=x.dtype,
                    device=x.device).movedim(2, 1)

    def strides(t):   # (batch, seq, head, element) of a (B, H, L, E) view
        return t.stride(0), t.stride(2), t.stride(1), t.stride(3)

    with torch.cuda.device(x.device):
        err = lib.repro_ssd_scan(
            DTYPE_CODES[x.dtype], x.data_ptr(), *strides(x), a.data_ptr(),
            a.stride(0), a.stride(2), a.stride(1), B.data_ptr(), *strides(B),
            C.data_ptr(), *strides(C), y.data_ptr(), *strides(y), bsz, h, L,
            p, n, c, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "repro_ssd_scan")
    ssd_scan.launches += 1
    ssd_scan.last_launch = {"plan": plan, "chunk": c, "grid": (h, bsz),
                            "smem_bytes": smem}
    return y


ssd_scan.launches = 0
ssd_scan.last_launch = None
