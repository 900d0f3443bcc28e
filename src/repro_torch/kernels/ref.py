"""Plain PyTorch oracles for the model kernels (port of ``repro.kernels.ref``).

Each function computes what the JAX package's oracle of the same name
computes, in the same order of operations where it matters (f32 softmax
and state, masks applied before the exp). They are the plain versions of
kernels B4-B6 and the CPU routes of :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

from typing import Optional

import torch


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B at the accumulator width (f64 for f64, else f32), cast back."""
    acc = torch.float64 if a.dtype == torch.float64 else torch.float32
    return (a.to(acc) @ b.to(acc)).to(a.dtype)


def dotp(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> in float32 (a 0-d tensor)."""
    return torch.sum(x.float() * y.float())


def _mask(sq: int, sk: int, causal: bool, q_offset: int,
          window: Optional[int], device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: Optional[float] = None,
              q_offset: int = 0, window: Optional[int] = None
              ) -> torch.Tensor:
    """Multi-head attention oracle.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), Hq a multiple of Hkv (GQA).
    ``q_offset`` is the absolute position of q[0]; ``window`` a sliding
    window (None = full). Softmax in f32; rows with no unmasked key give
    0. Returns (B, Hq, Sq, D) in q's dtype.
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, hkv, group, sq, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    mask = _mask(sq, sk, causal, q_offset, window, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)       # fully masked rows
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, hq, sq, d).to(q.dtype)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, scale: Optional[float] = None,
                      q_offset: int = 0, window: Optional[int] = None,
                      block_k: int = 1024) -> torch.Tensor:
    """Streaming-softmax attention over KV blocks of ``block_k``: the
    semantics of :func:`attention` in O(Sq * block_k) live memory. Masked
    scores are -1e30, as in the reference, so a row with no unmasked key
    in the first block averages that block's values."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qf = q.float().reshape(b, hkv, g, sq, d) * scale
    qpos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, hkv, g, sq), -1e30, device=q.device)
    l = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), device=q.device)
    for k0 in range(0, sk, block_k):
        kc = k[:, :, k0:k0 + block_k].float()
        vc = v[:, :, k0:k0 + block_k].float()
        pad = block_k - kc.shape[2]
        if pad:
            kc = torch.nn.functional.pad(kc, (0, 0, 0, pad))
            vc = torch.nn.functional.pad(vc, (0, 0, 0, pad))
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kc)
        kpos = k0 + torch.arange(block_k, device=q.device)
        mask = (kpos[None, :] < sk).expand(sq, block_k)
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        if window is not None:
            mask = mask & ((qpos[:, None] - kpos[None, :]) < window)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                    vc)
        m = m_new
    safe = torch.where(l > 0, l, torch.ones_like(l))
    out = (acc / safe[..., None]).reshape(b, hq, sq, d)
    return out.to(q.dtype)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, scale: Optional[float] = None,
                     q_offset: int = 0) -> torch.Tensor:
    """Causal sliding-window attention in O(S * 2w): queries of tile i
    attend keys of tiles i-1 and i only (full-sequence prefill)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    assert sq == sk and q_offset == 0, "banded path is for full-seq prefill"
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    w = window
    pad = (-sq) % w
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                   for t in (q, k, v))
    sp = sq + pad
    nb = sp // w
    qb = q.reshape(b, hkv, g, nb, w, d).float() * scale
    kb = k.reshape(b, hkv, nb, w, d).float()
    vb = v.reshape(b, hkv, nb, w, d).float()
    # previous tile (zeros before tile 0)
    kprev = torch.nn.functional.pad(kb, (0, 0, 0, 0, 1, 0))[:, :, :nb]
    vprev = torch.nn.functional.pad(vb, (0, 0, 0, 0, 1, 0))[:, :, :nb]
    kcat = torch.cat([kprev, kb], dim=3)                  # (b,hkv,nb,2w,d)
    vcat = torch.cat([vprev, vb], dim=3)
    s = torch.einsum("bhgnqd,bhnkd->bhgnqk", qb, kcat)    # (b,hkv,g,nb,w,2w)
    qpos = torch.arange(w, device=q.device)[:, None] + w
    kpos = torch.arange(2 * w, device=q.device)[None, :]
    mask = (qpos >= kpos) & (qpos - kpos < w)
    m0 = mask & (kpos >= w)                               # tile 0: no prev
    tile0 = (torch.arange(nb, device=q.device) == 0)[:, None, None]
    full_mask = torch.where(tile0, m0[None], mask[None])
    s = torch.where(full_mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgnqk,bhnkd->bhgnqd", p, vcat)
    return o.reshape(b, hq, sp, d)[:, :, :sq].to(q.dtype)


def ssd(x: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, state: Optional[torch.Tensor] = None,
        return_state: bool = False):
    """Mamba-2 SSD oracle: the exact O(L) recurrence.

    x (batch, L, H, P), a_log (batch, L, H) (<= 0), B/C (batch, L, H, N),
    state (batch, H, P, N) optional. h_t = exp(a_t) h_{t-1} + x_t (x) B_t,
    y_t = h_t @ C_t. Returns y (batch, L, H, P) [and the f32 final state].
    """
    bsz, L, H, P = x.shape
    N = B.shape[-1]
    xf, af, Bf, Cf = x.float(), a_log.float(), B.float(), C.float()
    h = (torch.zeros((bsz, H, P, N), device=x.device) if state is None
         else state.float())
    ys = []
    for t in range(L):
        a_t = torch.exp(af[:, t])[..., None, None]
        h = a_t * h + torch.einsum("bhp,bhn->bhpn", xf[:, t], Bf[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cf[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((bsz, 0, H, P), device=x.device)).to(x.dtype)
    return (y, h) if return_state else y


def ssd_chunked(x: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int = 64,
                state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Chunked SSD (the algorithm kernel B6 implements): a masked-decay
    quadratic term within each chunk plus the cross-chunk state
    recurrence. Mathematically identical to :func:`ssd`; model layout."""
    bsz, L, H, P = x.shape
    N = B.shape[-1]
    if L == 0:
        y = torch.zeros_like(x)
        h = (torch.zeros((bsz, H, P, N), device=x.device) if state is None
             else state.float())
        return (y, h) if return_state else y
    pad = (-L) % chunk
    if pad:   # a_log pads with 0 (decay 1): the state passes through
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        a_log = torch.nn.functional.pad(a_log, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, 0, 0, pad))
    nch = (L + pad) // chunk

    def to_chunks(t):   # (b, L, H, ...) -> (nch, b, H, chunk, ...)
        t = t.reshape(bsz, nch, chunk, *t.shape[2:])
        return t.movedim(3, 2).movedim(1, 0).float()

    xc, ac, Bc, Cc = (to_chunks(t) for t in (x, a_log, B, C))
    h = (torch.zeros((bsz, H, P, N), device=x.device) if state is None
         else state.float())
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    ys = []
    for i in range(nch):
        xk, ak, Bk, Ck = xc[i], ac[i], Bc[i], Cc[i]
        cum = torch.cumsum(ak, dim=-1)                    # (b,H,c)
        seg = torch.exp(cum)
        # mask BEFORE exp: the upper-triangle differences are positive
        diff = cum[..., :, None] - cum[..., None, :]
        lmat = torch.exp(torch.where(tri, diff,
                                     torch.full_like(diff, float("-inf"))))
        scores = torch.einsum("bhtn,bhsn->bhts", Ck, Bk) * lmat
        y = torch.einsum("bhts,bhsp->bhtp", scores, xk)
        y = y + torch.einsum("bhtn,bhpn->bhtp", Ck * seg[..., None], h)
        dout = torch.exp(cum[..., -1:] - cum)
        h = (torch.exp(cum[..., -1])[..., None, None] * h
             + torch.einsum("bhsp,bhsn->bhpn", xk, Bk * dout[..., None]))
        ys.append(y)
    y = torch.stack(ys, dim=2).reshape(bsz, H, nch * chunk, P)
    y = y.movedim(1, 2)[:, :L].to(x.dtype)
    return (y, h) if return_state else y


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
