"""Model-facing wrappers over the kernels (port of ``repro.kernels.ops``).

The tensor's device decides the route; there is no ``use_pallas`` or
``interpret`` flag. A CUDA tensor goes to the hand-written kernel (B1 ``gemm``,
B4 ``dotp``, B5 ``flash_attention.attention``, B6 ``ssd_scan``), which
launches or raises. A CPU tensor takes the reference's plain
(``use_pallas=False``) route through :mod:`repro_torch.kernels.ref`,
including its choice among the banded, blocked and full attention
oracles, so the CPU tests stay on the reference's oracle paths.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dotp as _dotp
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd

BLOCKED_ATTN_THRESHOLD = 2048


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"repro_torch kernels run on cuda or cpu, not "
                         f"{t.device}")
    return t.device.type == "cuda"


def gemm(a, b, plan=None):
    if _on_card(a):
        return _gemm.gemm(a, b, plan=plan)
    return ref.gemm(a, b)


def dotp(x, y, accumulators=None):
    if _on_card(x):
        return _dotp.dotp(x, y, accumulators=accumulators)
    return ref.dotp(x, y)


def attention(q, k, v, causal: bool = True, scale=None, q_offset: int = 0,
              window=None, kv_len: Optional[int] = None):
    """Attention over q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D). Keys at or
    past ``kv_len`` are masked on both routes (the CPU route slices them
    off before it picks its oracle)."""
    if _on_card(q):
        return _fa.attention(q, k, v, causal=causal, scale=scale,
                             q_offset=q_offset, window=window, kv_len=kv_len)
    if kv_len is not None and kv_len < k.shape[2]:
        k, v = k[:, :, :max(kv_len, 0)], v[:, :, :max(kv_len, 0)]
    if (window is not None and causal and q_offset == 0
            and q.shape[2] == k.shape[2] and k.shape[2] >= 4 * window):
        # banded path: O(S*2w) flops/bytes instead of O(S^2)
        return ref.banded_attention(q, k, v, window, scale=scale)
    if k.shape[2] >= BLOCKED_ATTN_THRESHOLD:
        # streaming path: O(S*block) memory
        return ref.blocked_attention(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset, window=window)
    return ref.attention(q, k, v, causal=causal, scale=scale,
                         q_offset=q_offset, window=window)


def ssd(x, a_log, B, C, chunk=None):
    """SSD in model layout: x (B, L, H, P), a_log (B, L, H), B/C (B, L, H, N).
    Returns y (B, L, H, P)."""
    if not _on_card(x):
        return ref.ssd_chunked(x, a_log, B, C, chunk=chunk or 64)
    y = _ssd.ssd_scan(x.movedim(2, 1), a_log.movedim(2, 1),
                      B.movedim(2, 1), C.movedim(2, 1), chunk=chunk)
    return y.movedim(1, 2)
