"""B6: the Mamba-2 chunked SSD scan on hand-written Hopper kernels
(``csrc/ssd_scan.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``
(``_ssd_kernel``). The TPU walks the chunks in order on its sequential grid
axis with the f32 (P, N) state in VMEM; the card runs Mamba-2's chunked
decomposition over every chunk at once, in three launches (see the note at
the top of ``csrc/ssd_scan.cu``): the chunk states, the state passing
across chunks, and each chunk's output (bf16 on ``mma.sync``, f32 on
FFMA). :func:`ssd_scan_passes` writes the same three passes out step for
step in plain PyTorch. Layout as the reference: x (B, H, L, P), a_log
(B, H, L), B/C (B, H, L, N); operands are read through their strides, so
the transposed views :func:`repro_torch.kernels.ops.ssd` hands it need no
copy.

:func:`ssd_scan` launches the kernels for CUDA tensors and runs
:func:`ssd_scan_plain` for CPU tensors; there is no other path.
``ssd_scan.launches`` counts calls that launched the kernels on the card
(one per call, three kernels each) and ``ssd_scan.last_launch`` records the
:class:`~repro_torch.core.codesign.SSDPlan` and the
:class:`SSDScanPlan` it ran (grids, shared memory, scratch bytes).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.codesign import SSDPlan, plan_ssd
from repro_torch.kernels import _build, ref
from repro_torch.kernels import launch_record as _rec

MAX_HEAD_DIM = 128
MAX_STATE = 128
SMEM_LIMIT = 232_448     # bytes of shared memory one CTA may use (H100)
# dtype codes of csrc/common.cuh (repro::DType) the kernel takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}
# csrc/ssd_scan.cu's launch shape: tile rows, threads of passes 1, 2 and 3
# (3 by route)
TILE = 64
THREADS = {"pass1": 256, "pass2": 256, "mma": 128, "ffma": 256}


def effective_chunk(L: int, chunk: Optional[int], plan: SSDPlan) -> int:
    """The chunk the scan runs with: the plan's unless given, at most
    ``max(L, 8)`` (the reference's rule)."""
    return min(chunk or plan.chunk, max(L, 8))


def _pad_pow2(v: int) -> int:
    return next((w for w in (16, 32, 64, 128) if v <= w), 0)


@dataclass(frozen=True)
class SSDScanPlan:
    """The three launches of one call: pass 1 (chunk states) and pass 3
    (chunk output) grids over ((chunk [x query block]) x head, batch),
    pass 2 over (state slice, head, batch); their threads and dynamic
    shared memory, and the f32 scratch the wrapper allocates."""

    route: str                      # pass 3: "mma" (bf16) or "ffma" (f32)
    chunk: int
    n_chunks: int
    query_blocks: int               # 64-row query blocks per chunk
    grids: Tuple[Tuple[int, int, int], ...]
    threads: Tuple[int, int, int]
    smem_bytes: Tuple[int, int, int]
    scratch_bytes: int

    @property
    def ctas(self) -> Tuple[int, ...]:
        return tuple(x * y * z for x, y, z in self.grids)


def ssd_scan_plan(bsz: int, h: int, L: int, p: int, n: int, chunk: int,
                  dtype: torch.dtype) -> SSDScanPlan:
    """The launch shapes of csrc/ssd_scan.cu for x (bsz, h, L, p), state
    n and ``chunk`` (already :func:`effective_chunk`); shared memory as
    the C side computes it (``repro_ssd_scan_smem_bytes``). Raises when
    the kernels do not take the shape."""
    if dtype not in DTYPE_CODES:
        raise ValueError(f"ssd_scan kernel takes {tuple(DTYPE_CODES)}, got "
                         f"{dtype}")
    if p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"ssd_scan kernel takes head_dim <= {MAX_HEAD_DIM} "
                         f"and state <= {MAX_STATE}, got {p}, {n}")
    pp, np_ = _pad_pow2(p), _pad_pow2(n)
    nch = -(-L // chunk)
    qb = -(-chunk // TILE)
    route = "mma" if dtype == torch.bfloat16 else "ffma"
    # pass 1: cum and decay rows, then f32 tiles of x and B beside two
    # stages in the storage type (after the loop: the row groups' partial
    # states, 32 per thread)
    smem1 = 8 * (-(-chunk // 4) * 4) + max(
        4 * TILE * (pp + np_)
        + 2 * TILE * (pp + np_) * (2 if dtype == torch.bfloat16 else 4),
        4 * 32 * THREADS["pass1"])
    if route == "mma":     # C, two stages of B and x, carried^T, cum rows
        smem3 = 2 * (3 * TILE * (np_ + 8) + 2 * TILE * (pp + 8)) \
            + 4 * (np_ * (pp + 2) + 3 * TILE)
    else:
        smem3 = 4 * (2 * TILE * (n + 1) + TILE * pp + TILE * (TILE + 1)
                     + pp * (n + 1) + 2 * TILE)
    if max(smem1, smem3) > SMEM_LIMIT or h > 65535 or bsz > 65535 \
            or nch * qb * h > 2 ** 31 - 1:
        raise ValueError(f"ssd_scan: head_dim {p}, state {n}, chunk {chunk} "
                         f"need {smem1} / {smem3} B of shared memory (limit "
                         f"{SMEM_LIMIT}) or the grid is too large")
    # passes 1 and 3 put the heads fastest in x (CTAs that run together
    # read neighbouring heads of the same rows), the batch in y
    grids = ((nch * h, bsz, 1), (-(-p * n // THREADS["pass2"]), h, bsz),
             (nch * qb * h, bsz, 1))
    scratch = 4 * (bsz * h * L + bsz * h * nch * (2 * p * n + 1))
    return SSDScanPlan(route, chunk, nch, qb, grids,
                       (THREADS["pass1"], THREADS["pass2"], THREADS[route]),
                       (smem1, 0, smem3), scratch)


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


def ssd_scan_passes(x: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, chunk: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The kernels' three passes written out step for step in plain
    PyTorch (f32), in the kernel layout, with the kernel's chunk rule and
    its ragged last chunk cut to its valid length. Returns y (x's dtype)
    and the intermediates the kernels keep in scratch: ``cum`` (B, H, L),
    ``states`` and ``carried`` (B, H, chunks, P, N), ``decay``
    (B, H, chunks)."""
    bsz, h, L, p = x.shape
    n = B.shape[-1]
    c = effective_chunk(L, chunk, plan_ssd(L, h, p, n))
    xf, af, bf, cf = (t.float() for t in (x, a_log, B, C))
    cum, states, decay, ys = [], [], [], []
    # pass 1: per chunk, cum and the local state from zero
    for l0 in range(0, L, c):
        sl = slice(l0, min(l0 + c, L))
        cu = torch.cumsum(af[:, :, sl], dim=-1)                   # (B,H,cv)
        w = torch.exp(cu[..., -1:] - cu)
        states.append(torch.einsum("bhsp,bhsn->bhpn", xf[:, :, sl],
                                   bf[:, :, sl] * w[..., None]))
        decay.append(torch.exp(cu[..., -1]))
        cum.append(cu)
    # pass 2: the state entering each chunk
    carried = [torch.zeros_like(states[0])]
    for i in range(len(states) - 1):
        carried.append(decay[i][..., None, None] * carried[i] + states[i])
    # pass 3: every chunk's output from its carried state
    for i, l0 in enumerate(range(0, L, c)):
        sl = slice(l0, min(l0 + c, L))
        cu = cum[i]
        cv = cu.shape[-1]
        tri = torch.tril(torch.ones((cv, cv), dtype=torch.bool,
                                    device=x.device))
        diff = cu[..., :, None] - cu[..., None, :]
        lmat = torch.exp(torch.where(tri, diff,
                                     torch.full_like(diff, float("-inf"))))
        scores = torch.einsum("bhtn,bhsn->bhts", cf[:, :, sl],
                              bf[:, :, sl]) * lmat
        y = torch.einsum("bhts,bhsp->bhtp", scores, xf[:, :, sl])
        ys.append(y + torch.einsum("bhtn,bhpn->bhtp",
                                   cf[:, :, sl] * torch.exp(cu)[..., None],
                                   carried[i]))
    passes = {"cum": torch.cat(cum, dim=-1), "states": torch.stack(states, 2),
              "decay": torch.stack(decay, 2),
              "carried": torch.stack(carried, 2)}
    return torch.cat(ys, dim=2).to(x.dtype), passes


def _vec(t: torch.Tensor) -> int:
    """1 when the kernels may read the operand's rows as 16-byte vectors:
    contiguous aligned rows whose length is a whole number of vectors."""
    per = 16 // t.element_size()
    return int(t.stride(3) == 1 and _rec.address(t) % 16 == 0
               and t.shape[3] % per == 0
               and all(s % per == 0 for s in t.stride()[:3]))


def _check_shapes(x, a_log, B, C) -> None:
    if x.ndim != 4 or a_log.shape != x.shape[:3] or B.shape != C.shape \
            or B.shape[:3] != x.shape[:3]:
        raise ValueError(f"ssd_scan needs x (B, H, L, P), a_log (B, H, L), "
                         f"B/C (B, H, L, N); got {tuple(x.shape)}, "
                         f"{tuple(a_log.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")


def _check_card_dtypes(x, B, C) -> None:
    if not x.dtype == B.dtype == C.dtype or x.dtype not in DTYPE_CODES:
        raise ValueError(f"ssd_scan on the card takes x, B, C of one of "
                         f"{tuple(DTYPE_CODES)}; got {x.dtype}, {B.dtype}, "
                         f"{C.dtype}")


def ssd_scan_kernel(x: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, chunk: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The three kernels on CUDA tensors with no zero-sized dimension: y
    and the scratch they filled, under the names of
    :func:`ssd_scan_passes`. :func:`ssd_scan` is this without the scratch;
    each call counts one launch."""
    _check_shapes(x, a_log, B, C)
    if any(t.device.type != "cuda" or t.device != x.device
           for t in (x, a_log, B, C)):
        raise ValueError("ssd_scan_kernel runs on one CUDA device")
    _check_card_dtypes(x, B, C)
    if 0 in x.shape or 0 in B.shape:
        raise ValueError(f"ssd_scan_kernel: nothing to launch for x "
                         f"{tuple(x.shape)}, B {tuple(B.shape)}")
    bsz, h, L, p = x.shape
    n = B.shape[-1]
    plan = plan_ssd(L, h, p, n)          # the reference's call
    c = effective_chunk(L, chunk, plan)
    launch = ssd_scan_plan(bsz, h, L, p, n, c, x.dtype)
    a = a_log.float()
    nch = launch.n_chunks
    # one allocation for the four f32 scratch arrays
    shapes = {"cum": (bsz, h, L), "states": (bsz, h, nch, p, n),
              "decay": (bsz, h, nch), "carried": (bsz, h, nch, p, n)}
    flat = torch.empty(launch.scratch_bytes // 4, dtype=torch.float32,
                       device=x.device)
    scratch, at = {}, 0
    for key, shape in shapes.items():
        size = math.prod(shape)
        scratch[key] = flat[at:at + size].view(shape)
        at += size
    # y is laid out (B, L, H, P) so the model's moveaxis back is free
    y = torch.empty((bsz, L, h, p), dtype=x.dtype,
                    device=x.device).movedim(2, 1)

    recording = _rec.active()
    fake = recording and _rec.is_fake(x)
    ptr = _rec.address if fake else torch.Tensor.data_ptr
    ops = (x, a, B, C, y, *(scratch[k] for k in
                            ("cum", "states", "decay", "carried")))
    dims = (int(p % 2 == 0), bsz, h, L, p, n, c)
    if fake:
        _record(_args(ops, dims, ptr, None), launch, c,
                (x, a_log, B, C, y), True)
        return y, scratch
    lib = _build.library("ssd_scan")
    with torch.cuda.device(x.device):
        call = _args(ops, dims, ptr, torch.cuda.current_stream().cuda_stream)
        err = lib.repro_ssd_scan(*call)
    _build.check(err, "repro_ssd_scan")
    ssd_scan.launches += 1
    ssd_scan.last_launch = {"plan": plan, "chunk": c, "launch": launch,
                            "grids": launch.grids,
                            "smem_bytes": launch.smem_bytes,
                            "scratch_bytes": launch.scratch_bytes}
    if recording:
        _record(call, launch, c, (x, a_log, B, C, y), False)
    return y, scratch


def _strides(t) -> tuple:
    """(batch, seq, head, element) strides of a (B, H, L, E) view."""
    return t.stride(0), t.stride(2), t.stride(1), t.stride(3)


def _args(ops, dims, ptr, stream) -> tuple:
    """The C call's arguments of one :func:`ssd_scan_kernel` launch
    (``ops``: x, a (f32), B, C, y and the four scratch arrays; ``dims``:
    the even-P flag, batch, heads, L, P, N and chunk; ``ptr`` reads each
    operand's address)."""
    x, a, B, C, y, *scratch = ops
    return (DTYPE_CODES[x.dtype], ptr(x), *_strides(x), _vec(x),
            ptr(a), a.stride(0), a.stride(2), a.stride(1),
            ptr(B), *_strides(B), _vec(B), ptr(C), *_strides(C), _vec(C),
            ptr(y), *_strides(y), *dims, *(ptr(t) for t in scratch), stream)


def _record(call, launch, chunk, operands, fake):
    _rec.emit(__name__, "ssd_scan", "ssd_scan", "repro_ssd_scan", call,
              variant=launch.route, tile=(TILE, chunk), grid=launch.grids,
              smem_bytes=launch.smem_bytes, operands=operands, fake=fake)


def ssd_scan(x: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, chunk: Optional[int] = None) -> torch.Tensor:
    """Chunked SSD over the (B, H, L, ...) layout; returns y (B, H, L, P)
    in x's dtype: the CUDA kernels for CUDA tensors, :func:`ssd_scan_plain`
    for CPU tensors. The chunk defaults to :func:`plan_ssd`'s."""
    _check_shapes(x, a_log, B, C)
    devs = {t.device for t in (x, a_log, B, C)}
    if len(devs) != 1 or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on cuda (kernel) or cpu (plain "
                         f"version); got {sorted(map(str, devs))}")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, a_log, B, C, chunk=chunk)
    _check_card_dtypes(x, B, C)
    if 0 in x.shape or 0 in B.shape:
        return torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    return ssd_scan_kernel(x, a_log, B, C, chunk=chunk)[0]


ssd_scan.launches = 0
ssd_scan.last_launch = None
