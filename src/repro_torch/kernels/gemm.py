"""B1: C = A @ B on a hand-written Hopper kernel (``csrc/gemm.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/gemm.py::gemm``
(``_gemm_kernel``). What bounds it on the H100, and what the design does
about it, is in the note at the top of ``csrc/gemm.cu``: at the main
path's shapes it is bound by operations. Each CTA owns one output tile and
loops over K inside the block, in place of the TPU's sequential K grid
axis. The source has five variants (:data:`VARIANTS`), and
:func:`gemm_variant` picks one from dtype, shape and layout alone:

- ``"wgmma"``: bf16 on the tensor cores (TMA ring, wgmma), 128x256 or
  128x128 tiles;
- ``"ffma"``: f32 on IEEE FFMA (never TF32), 128x128 or 64x128 tiles,
  cp.async ring;
- ``"dmma"``: f64 on the FP64 tensor cores (mma.sync m16n8k8), 128x128 or
  64x128 tiles, TMA ring, warp-specialised;
- ``"gemv"``: any dtype, ``n <= SKINNY < m`` with A's column stride 1 (the
  blocked TRSM's 128 x k x nrhs updates, ``linalg.gemv``): bound by the
  bytes of A, K split over the CTAs (:func:`gemv_split`) and the partials
  summed in a fixed order by a second pass;
- ``"simt"``: any dtype and any strides, 64x64 tiles: the products with
  ``m <= SKINNY`` or a skinny n on a transposed A, and the layouts the tiled
  variants cannot read (a column stride other than 1, a row stride or base
  address off 16 bytes: the drivers' transposed views).

:func:`gemm` launches the kernel for CUDA tensors and runs
:func:`gemm_plain` (the same function in plain PyTorch) for CPU tensors;
there is no other path, and a variant that refuses its operands raises.

A batch, (B, m, k) @ (B, k, n) with either operand 2-D and broadcast, is
one launch (the counterpart of ``vmap`` over the TPU kernel's
``pallas_call``, which adds a batch axis to its grid): the variant and the
tile come from one item's (m, n, k) and layout, each item runs the 2-D
launch's tile and K order on a grid axis of its own, so item i is bitwise
the 2-D launch on item i (``"wgmma"`` and ``"dmma"`` read a batch
through 3-D TMA maps, the batch outermost). A batch of more than
:data:`MAX_BATCH` items is cut into launches of at most that many, each
counted.
``gemm.launches`` counts kernel launches on the card (the CPU route
counts nothing), ``gemm.variant_launches`` the same per variant, and
``gemm.last_launch`` records, on both routes, the
:class:`~repro_torch.core.codesign.GemmPlan` it was handed beside the
variant, the CTA tile it runs (:func:`launch_tile`) and where that tile
came from (``tile_source``: ``"plan"`` or ``"default"``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import arch as _arch
from repro_torch.core.codesign import (HOPPER_TILES, GemmPlan, cta_smem_bytes,
                                       plan_gemm)
from repro_torch.kernels import _build
from repro_torch.kernels import launch_record as _rec

# csrc/gemm.cu's variants (index = repro::Variant code; "gemv" has its
# own entry point) and the CTA tiles (BM, BN, BK) each is compiled for, the
# default first; "simt" and "gemv" have one fixed shape each
VARIANTS = ("simt", "wgmma", "ffma", "dmma", "gemv")
TILE_SETS = {"simt": ((64, 64, 16),),
             "gemv": ((16, 16, 256),),   # rows per CTA, largest n, k per chunk
             **{v: tuple(t[:3] for t in tiles)
                for v, tiles in HOPPER_TILES.values()}}
TILES = {v: tiles[0] for v, tiles in TILE_SETS.items()}   # the defaults
# the tiled variant of each dtype
TILED = {torch.bfloat16: "wgmma", torch.float32: "ffma",
         torch.float64: "dmma"}
SKINNY = 16      # n at or below which "gemv" runs, m at or below "simt"
GEMV_CTAS_PER_SM = 4     # the K split aims at this many CTAs per SM
# dtype codes of csrc/common.cuh (repro::DType)
DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
# output dtypes the kernel stores for each operand dtype
OUT_DTYPES = {torch.float32: (torch.float32,),
              torch.float64: (torch.float64,),
              torch.bfloat16: (torch.bfloat16, torch.float32)}
_MAX_ROW_BLOCKS = 65535                 # gridDim.y limit of "simt"
MAX_BATCH = 65535       # items per launch: gridDim.y / gridDim.z limit


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
    if a.ndim not in (2, 3) or b.ndim not in (2, 3) \
            or a.shape[-1] != b.shape[-2] \
            or (a.ndim == b.ndim == 3 and a.shape[0] != b.shape[0]):
        raise ValueError(f"gemm needs (m, k) @ (k, n) or a batch (B, m, k) "
                         f"@ (B, k, n), either side 2-D and broadcast; got "
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
    return out_dtype


def batch_of(a: torch.Tensor, b: torch.Tensor) -> Optional[int]:
    """The batch of A @ B: its items when either operand is 3-D, None for
    a 2-D product."""
    return a.shape[0] if a.ndim == 3 else b.shape[0] if b.ndim == 3 else None


def batch_stride(t: torch.Tensor) -> int:
    """Elements between the items of ``t`` as the kernel reads them: 0 for
    a 2-D operand (broadcast) or a batch of one."""
    return t.stride(0) if t.ndim == 3 and t.shape[0] > 1 else 0


def rows_aligned(t: torch.Tensor) -> bool:
    """Can TMA / 16-byte cp.async read ``t`` row by row: unit column
    stride, row stride, base address and (for a batch) the items' stride
    multiples of 16 bytes?"""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.stride(-2) * size % 16 == 0
            and batch_stride(t) * size % 16 == 0
            and _rec.address(t) % 16 == 0)


def gemm_variant(a: torch.Tensor, b: torch.Tensor) -> str:
    """The csrc/gemm.cu variant for A @ B (2-D or a batch, from one item's
    shape), from dtype, shape and layout alone: ``"gemv"`` for ``n <=
    SKINNY < m`` with A's column stride 1; else the dtype's tiled variant
    (:data:`TILED`) when both operands are :func:`rows_aligned` and the
    product is neither skinny nor empty in k; else ``"simt"``."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if k == 0 or m <= SKINNY:
        return "simt"
    if n <= SKINNY:
        return "gemv" if a.stride(-1) == 1 else "simt"
    if not (rows_aligned(a) and rows_aligned(b)):
        return "simt"
    return TILED[a.dtype]


def gemv_split(m: int, k: int, sms: int) -> tuple:
    """(segments, k per segment) of the ``"gemv"`` grid: K cut into
    segments of whole 256-deep chunks so that (segments) x (row groups of
    16) comes near :data:`GEMV_CTAS_PER_SM` CTAs on each of ``sms`` SMs,
    one segment when the row groups alone fill the card."""
    bm, _, kc = TILES["gemv"]
    chunks = -(-k // kc)
    groups = -(-m // bm)
    segs = min(chunks, max(1, -(-GEMV_CTAS_PER_SM * sms // groups)))
    ks = -(-chunks // segs) * kc
    return -(-k // ks), ks


def default_plan(a: torch.Tensor, b: torch.Tensor) -> GemmPlan:
    """:func:`plan_gemm` for A @ B (one item's shape) at a's dtype under
    the ambient machine of a's device (``"h100"`` on the card, unless a
    scope names another)."""
    return plan_gemm(a.shape[-2], b.shape[-1], a.shape[-1], dtype=a.dtype,
                     machine=_arch.resolve_machine(None, a.device))


def launch_tile(variant: str, plan: Optional[GemmPlan]) -> tuple:
    """(CTA tile, source) a call runs on ``variant``: the plan's (bm, bn,
    bk) when the variant is compiled for it (``"plan"``), else the
    variant's default tile, :data:`TILES` (``"default"``: a plan priced for
    another machine, or "simt" / "gemv", which have one shape each)."""
    if plan is not None and (plan.bm, plan.bn, plan.bk) in TILE_SETS[variant]:
        return (plan.bm, plan.bn, plan.bk), "plan"
    return TILES[variant], "default"


def record_call(wrapper, plan, variant: str, device: torch.device) -> tuple:
    """Record the plan, variant, CTA tile and the tile's source of one call
    of ``wrapper`` (either route) in ``wrapper.last_launch``, a record only;
    counts nothing. Returns the CTA tile the call runs
    (:func:`launch_tile`), which the caller hands to :func:`launch`."""
    tile, source = launch_tile(variant, plan)
    wrapper.last_launch = {"plan": plan, "variant": variant, "tile": tile,
                           "tile_source": source, "device": device.type}
    return tile


def reset_launches(wrapper) -> None:
    """Zero a GEMM wrapper's launch counts (total and per variant)."""
    wrapper.launches = 0
    wrapper.variant_launches = dict.fromkeys(VARIANTS, 0)


def launch_grid(variant: str, tile: tuple, m: int, n: int,
                split: Optional[tuple] = None,
                batch: Optional[int] = None) -> tuple:
    """The grid csrc/gemm.cu launches ``variant`` with for an (m, n)
    output: one CTA per ``tile`` of C (1-D) for the tiled variants, (column
    blocks, row blocks) for ``"simt"``, (K segments, row groups) for
    ``"gemv"`` (``split`` = :func:`gemv_split`'s, whose second pass sums the
    segments when there is more than one); a launch of ``batch`` items adds
    its axis last (y for the tiled variants, z for the others)."""
    if variant == "gemv":
        grid = (split[0], -(-m // tile[0]))
    elif variant == "simt":
        grid = (-(-n // tile[1]), -(-m // tile[0]))
    else:
        grid = (-(-m // tile[0]) * -(-n // tile[1]),)
    return grid if batch is None else grid + (batch,)


def launch_smem(variant: str, tile: tuple, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA of ``variant`` at ``tile``
    (:func:`repro_torch.core.codesign.cta_smem_bytes` at the tile's compiled
    stages; ``"simt"`` and ``"gemv"`` use static shared memory only)."""
    if variant in ("simt", "gemv"):
        return 0
    db = dtype.itemsize
    for t in HOPPER_TILES[db][1]:
        if tuple(t[:3]) == tuple(tile):
            return cta_smem_bytes(db, *t[:4])
    # a tile the variant is not compiled for (only a planted record):
    # price it at the default tile's stages
    return cta_smem_bytes(db, *tile, HOPPER_TILES[db][1][0][3])


def launch(wrapper, entry: str, variant: str, tile: tuple, a: torch.Tensor,
           b: torch.Tensor, c: torch.Tensor, bias: Optional[int] = None,
           epilogue: int = 0) -> None:
    """Launch one csrc/gemm.cu entry point of ``wrapper`` on ``variant``
    writing into ``c`` (contiguous) on the current stream of a's device
    (``bias`` a pointer or None, ``epilogue`` an EPILOGUES code, both for
    ``repro_gemm_bias_act``); ``"gemv"`` goes to ``repro_gemv`` with its K
    split. Raises on a refused launch, and counts the launch in ``wrapper``
    (total and per variant) once it has gone through. The tiled variants
    run ``tile`` (bm, bn, bk), the one :func:`record_call` returned. A
    batch (``c`` 3-D) is cut into launches of at most :data:`MAX_BATCH`
    items, each launched, counted and recorded as one.
    Fake operands (the analyzer's trace) record the launch
    (:mod:`repro_torch.kernels.launch_record`) and launch nothing."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if variant == "simt" and -(-m // TILES["simt"][0]) > _MAX_ROW_BLOCKS:
        raise ValueError(f"gemm takes at most "
                         f"{_MAX_ROW_BLOCKS * TILES['simt'][0]} rows on the "
                         f"simt variant, got {m}")
    if c.ndim == 3 and c.shape[0] > MAX_BATCH:
        for i0 in range(0, c.shape[0], MAX_BATCH):
            i1 = min(i0 + MAX_BATCH, c.shape[0])
            launch(wrapper, entry, variant, tile,
                   *(t[i0:i1] if t.ndim == 3 else t for t in (a, b, c)),
                   bias, epilogue)
        return
    recording = _rec.active()
    fake = recording and _rec.is_fake(a)
    ptr = _rec.address if fake else torch.Tensor.data_ptr
    split = partials = None
    if variant == "gemv":
        sms = _rec.h100().pe.sm_count if fake else \
            torch.cuda.get_device_properties(a.device).multi_processor_count
        split = gemv_split(m, k, sms)
        partials = torch.empty(
            (*c.shape[:-2], split[0], m, n) if split[0] > 1 else (0,),
            dtype=accumulator_dtype(a.dtype), device=a.device)
        wrapper.last_launch["split"] = split
        entry = "repro_gemv"
    if fake:
        _record(wrapper, entry, variant, tile, a, b, c, split,
                _args(entry, variant, tile, a, b, c, bias, epilogue, split,
                      partials, ptr, None), True)
        return
    lib = _build.library("gemm")
    with torch.cuda.device(a.device):
        call = _args(entry, variant, tile, a, b, c, bias, epilogue, split,
                     partials, ptr, torch.cuda.current_stream().cuda_stream)
        err = getattr(lib, entry)(*call)
    _build.check(err, entry)
    wrapper.launches += 1
    wrapper.variant_launches[variant] += 1
    if recording:
        _record(wrapper, entry, variant, tile, a, b, c, split, call, False)


def _args(entry, variant, tile, a, b, c, bias, epilogue, split, partials,
          ptr, stream) -> tuple:
    """The C call's arguments of one :func:`launch` (``ptr`` reads each
    operand's address); the batch (1 for a 2-D product) and the operands'
    batch strides (:func:`batch_stride`) go in ``long long`` slots, in
    every entry."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = (c.shape[0] if c.ndim == 3 else 1, batch_stride(a),
             batch_stride(b), batch_stride(c))
    if variant == "gemv":
        return (DTYPE_CODES[a.dtype], DTYPE_CODES[c.dtype],
                ptr(a), a.stride(-2), ptr(b), b.stride(-2), b.stride(-1),
                bias, epilogue, ptr(partials) if split[0] > 1 else None,
                split[1], ptr(c), c.stride(-2), m, n, k, *batch, stream)
    return (VARIANTS.index(variant), *tile, DTYPE_CODES[a.dtype],
            DTYPE_CODES[c.dtype], ptr(a), a.stride(-2), a.stride(-1),
            ptr(b), b.stride(-2), b.stride(-1),
            *(() if entry == "repro_gemm" else (bias, epilogue)),
            ptr(c), c.stride(-2), m, n, k, *batch, stream)


def _record(wrapper, entry, variant, tile, a, b, c, split, call, fake):
    m, n = c.shape[-2:]
    _rec.emit(wrapper.__module__, wrapper.__name__, "gemm", entry, call,
              variant=variant, tile=tile,
              grid=launch_grid(variant, tile, m, n, split,
                               c.shape[0] if c.ndim == 3 else None),
              smem_bytes=launch_smem(variant, tile, a.dtype),
              operands=(a, b, c), fake=fake)


def attributes(variant: str, tile: tuple, out_dtype: torch.dtype,
               batched: bool) -> tuple:
    """(registers, local-memory bytes) per thread of the tiled variant's
    instantiation at ``tile`` storing ``out_dtype``, 2-D or batched, as the
    card's ``cudaFuncGetAttributes`` reports them (builds the library)."""
    out = (ctypes.c_int * 2)()
    err = _build.library("gemm").repro_gemm_attributes(
        VARIANTS.index(variant), *tile, DTYPE_CODES[out_dtype], int(batched),
        out)
    _build.check(err, "repro_gemm_attributes")
    return out[0], out[1]


def gemm(a: torch.Tensor, b: torch.Tensor, plan: Optional[GemmPlan] = None,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B: the CUDA kernel for CUDA tensors, :func:`gemm_plain` for
    CPU tensors. (m, k) @ (k, n), or a batch (B, m, k) @ (B, k, n) with
    either side 2-D and broadcast: (B, m, n), one launch.

    The variant comes from dtype, shape and layout (:func:`gemm_variant`);
    the CTA tile from ``plan`` (default: :func:`default_plan`, the
    ambient machine's plan for a's device): a tiled variant runs the
    plan's (bm, bn, bk) when it is compiled for that tile
    (:data:`TILE_SETS`), else its default tile (:data:`TILES`), and
    ``last_launch["tile_source"]`` says which (:func:`launch_tile`)."""
    out_dtype = check_operands(a, b, out_dtype)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = batch_of(a, b)
    shape = (m, n) if batch is None else (batch, m, n)
    if plan is None:
        plan = default_plan(a, b)
    if m == 0 or n == 0 or batch == 0:
        return torch.empty(shape, dtype=out_dtype, device=a.device)
    variant = gemm_variant(a, b)
    tile = record_call(gemm, plan, variant, a.device)
    if a.device.type == "cpu":
        return gemm_plain(a, b, out_dtype)
    c = torch.empty(shape, dtype=out_dtype, device=a.device)
    launch(gemm, "repro_gemm", variant, tile, a, b, c)
    return c


reset_launches(gemm)
gemm.last_launch = None
