"""B5: streaming-softmax attention on a hand-written Hopper kernel
(``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::attention``
(``_attn_kernel``). One CTA owns one (batch, query head, query block) and
loops over the KV blocks inside the block, in place of the TPU's
sequential KV grid axis; the f32 running (m, l, acc) stay on chip. The
source has two variants (:data:`VARIANTS`), picked by
:func:`attention_variant` from dtype, head dim and layout alone:

- ``"wgmma"``: bf16 with a head dim of at most 128 (a multiple of 8) whose
  q / k / v TMA can read (unit dim stride, 16-byte aligned base and
  strides): 128 query rows per CTA on the tensor cores (wgmma), K / V fed
  through a TMA ring, masks and online softmax in registers, P split into
  bf16 hi + lo parts for two P V products. The model paths' moveaxis views
  take it.
- ``"ffma"``: everything else (f32, head dims up to 256, other strides):
  64 query rows per CTA, QK^T and PV on FP32 FFMA.
KV blocks that the causal, window and ``kv_len`` masks cover for the whole
query block are skipped. Layout as the reference: q (B, Hq, Sq, D), k/v
(B, Hkv, Sk, D), GQA through ``h // (Hq / Hkv)``; operands are read
through their strides, so the model's moveaxis views need no copy.

A row with no unmasked key gets 0 (as :func:`ref.attention`), where the
Pallas kernel returns the mean of its first KV block's values; no row of
the model paths is fully masked.

:func:`attention` launches the kernel for CUDA tensors and runs
:func:`attention_plain` for CPU tensors; there is no other path.
``attention.launches`` counts kernel launches on the card (and
``attention.variant_launches`` per variant); ``attention.last_launch``
records the :class:`~repro_torch.core.codesign.AttentionPlan` it was
handed beside the variant, CTA tile and grid it launched with.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.codesign import AttentionPlan, plan_attention
from repro_torch.kernels import _build, ref
from repro_torch.kernels import launch_record as _rec

VARIANTS = ("ffma", "wgmma")       # index = the csrc variant code
MAX_HEAD_DIM = 256                 # "ffma"
MAX_TC_HEAD_DIM = 128              # "wgmma" (a multiple of 8)
# dtype codes of csrc/common.cuh (repro::DType) the kernel takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}


def tile(variant: str, head_dim: int) -> tuple:
    """(query rows per CTA, keys per staged KV block) of a variant
    (csrc/flash_attention.cu: tc::BQ / tc::BKV, and BQ / Tile::BK)."""
    if variant == "wgmma":
        return 128, 128
    return 64, 32 if head_dim > 128 else 64


def smem_bytes(variant: str, head_dim: int) -> int:
    """Dynamic shared memory of one CTA (csrc/flash_attention.cu: the
    ``"ffma"`` Tile's floats at the head dim padded to 32 / 64 / 128 / 256;
    ``"wgmma"``'s Layout at 64 / 128: Q, three K+V stages, the mbarriers and
    the 1024-byte alignment)."""
    if variant == "wgmma":
        ch = (64 if head_dim <= 64 else 128) // 64
        return ch * 128 * 128 * 7 + 7 * 8 + 1024
    dp = next(w for w in (32, 64, 128, 256) if head_dim <= w)
    bq, bk = 64, 32 if dp > 128 else 64
    return 4 * (bq * (dp + 1) + bk * (dp + 1) + bk * dp + bq * (bk + 1)
                + 3 * bq)


def tma_readable(t: torch.Tensor) -> bool:
    """Can a TMA tensor map read this (B, H, S, D) bf16 operand: unit dim
    stride, base and every stride of an axis longer than 1 multiples of 16
    bytes?"""
    return (t.stride(3) == 1 and _rec.address(t) % 16 == 0
            and all(size == 1 or (st > 0 and st * t.element_size() % 16 == 0)
                    for size, st in zip(t.shape[:3], t.stride()[:3])))


def attention_variant(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> str:
    """The csrc/flash_attention.cu variant for these operands, from dtype,
    head dim and layout alone: ``"wgmma"`` for bf16 with a head dim of at
    most :data:`MAX_TC_HEAD_DIM` (a multiple of 8) and operands TMA can
    read, else ``"ffma"``."""
    d = q.shape[3]
    if (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and 0 < d <= MAX_TC_HEAD_DIM and d % 8 == 0
            and all(tma_readable(t) for t in (q, k, v))):
        return "wgmma"
    return "ffma"


def _kv_len(sk: int, kv_len: Optional[int]) -> int:
    return sk if kv_len is None else max(0, min(int(kv_len), sk))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    q_offset: int = 0, window: Optional[int] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version: :func:`ref.attention` over the first
    ``kv_len`` keys."""
    n = _kv_len(k.shape[2], kv_len)
    if 0 in q.shape or n == 0:
        return torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    return ref.attention(q, k[:, :, :n], v[:, :, :n], causal=causal,
                         scale=scale, q_offset=q_offset, window=window)


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Validate attention operands (shapes, devices, GQA grouping)."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"attention needs q (B, Hq, Sq, D) and k, v "
                         f"(B, Hkv, Sk, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"attention batch/head-dim mismatch: q "
                         f"{tuple(q.shape)} vs k {tuple(k.shape)}")
    if k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"query heads {q.shape[1]} are not a multiple of "
                         f"kv heads {k.shape[1]}")
    if not q.device == k.device == v.device or \
            q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention runs on cuda (kernel) or cpu (plain "
                         f"version); got {q.device}, {k.device}, {v.device}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: Optional[float] = None,
              q_offset: int = 0, window: Optional[int] = None,
              kv_len: Optional[int] = None,
              plan: Optional[AttentionPlan] = None) -> torch.Tensor:
    """Flash attention: the CUDA kernel for CUDA tensors,
    :func:`attention_plain` for CPU tensors. Returns q-shaped in q's dtype.
    ``plan`` (default: :func:`plan_attention`) is recorded, not tiled by:
    the CTA tile is that of :func:`attention_variant` (:func:`tile`)."""
    check_operands(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset, window=window,
                               kv_len=kv_len)
    if not q.dtype == k.dtype == v.dtype or q.dtype not in DTYPE_CODES:
        raise ValueError(f"attention on the card takes q, k, v of one of "
                         f"{tuple(DTYPE_CODES)}; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {d}")
    variant = attention_variant(q, k, v)
    bq = tile(variant, d)[0]
    if (-(-sq // bq) * (hq * b if variant == "wgmma" else 1) > 2 ** 31 - 1
            or hq > 65535 or b > 65535):
        raise ValueError(f"attention grid too large for {tuple(q.shape)}")
    n = _kv_len(sk, kv_len)
    if 0 in q.shape or n == 0:
        return torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    if plan is None:
        plan = plan_attention(sq, sk, d)   # the reference's call
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    grid = ((-(-sq // bq) * hq * b,) if variant == "wgmma"
            else (-(-sq // bq), hq, b))
    recording = _rec.active()
    fake = recording and _rec.is_fake(q)
    ptr = _rec.address if fake else torch.Tensor.data_ptr
    shape = (b, hq, hkv, sq, sk, d, float(scale), int(bool(causal)),
             int(q_offset), -1 if window is None else int(window), n)
    if fake:
        _record(_args(variant, q, k, v, o, shape, ptr, None), variant, d,
                grid, (q, k, v, o), True)
        return o
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        call = _args(variant, q, k, v, o, shape, ptr,
                     torch.cuda.current_stream().cuda_stream)
        err = lib.repro_attention(*call)
    _build.check(err, "repro_attention")
    attention.launches += 1
    attention.variant_launches[variant] += 1
    attention.last_launch = {
        "plan": plan, "variant": variant, "tile": tile(variant, d),
        "grid": grid}
    if recording:
        _record(call, variant, d, grid, (q, k, v, o), False)
    return o


def _args(variant, q, k, v, o, shape, ptr, stream) -> tuple:
    """The C call's arguments of one launch (``shape``: the sizes and
    options after the operands; ``ptr`` reads each operand's address)."""
    return (VARIANTS.index(variant), DTYPE_CODES[q.dtype],
            ptr(q), *q.stride(), ptr(k), *k.stride(), ptr(v), *v.stride(),
            ptr(o), *o.stride(), *shape, stream)


def _record(call, variant, d, grid, operands, fake):
    _rec.emit(__name__, "attention", "flash_attention", "repro_attention",
              call, variant=variant, tile=tile(variant, d), grid=grid,
              smem_bytes=smem_bytes(variant, d), operands=operands,
              fake=fake)


def reset_launches() -> None:
    """Zero :func:`attention`'s launch counts (all variants)."""
    attention.launches = 0
    attention.variant_launches = dict.fromkeys(VARIANTS, 0)


reset_launches()
attention.last_launch = None
