"""Kernels B4-B6 of repro_torch and their ops against the JAX package.

On the CPU the port's ``ops.dotp`` / ``ops.attention`` / ``ops.ssd`` take
the reference's plain routes and each kernel wrapper runs its plain
version. Both are held here to the JAX package's Pallas kernels run with
``interpret=True`` (and to its oracles) on the same numpy inputs, over the
grids of ``tests/test_kernels.py``: GQA, causal / window, decode
``q_offset``, ``kv_len``, ragged L, chunk invariance and zero-dim inputs.
bfloat16 inputs are the same rounded bits on both sides. Tolerances are
``tests/test_kernels.py``'s: 5e-4 (f32) and 5e-2 (bf16), absolute and
relative. The CUDA kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dotp import dotp as jdotp
from repro.kernels.flash_attention import attention as jfa
from repro.kernels.ssd_scan import ssd_scan as jssd
from repro_torch.kernels import dotp as tdk
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd

TOL = {"float32": dict(atol=5e-4, rtol=5e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2)}


def _both(x: np.ndarray, dtype: str = "float32"):
    """One float32 numpy array as (jax array, torch tensor) of ``dtype``."""
    x = x.astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _close(got: torch.Tensor, want, dtype="float32", **kw):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **{**TOL[dtype], **kw})


# ----------------------------------- B4 -------------------------------------

@pytest.mark.parametrize("n", [128, 1000, 131])
@pytest.mark.parametrize("u", [1, 8])
def test_dotp_matches_pallas(rng, n, u):
    (jx, tx), (jy, ty) = _both(rng.normal(size=n)), _both(rng.normal(size=n))
    want = float(jdotp(jx, jy, accumulators=u, interpret=True))
    for got in (tops.dotp(tx, ty), tdk.dotp(tx, ty, accumulators=u)):
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == pytest.approx(want, rel=1e-4, abs=1e-4)
    assert float(tdk.dotp_plain(tx, ty)) == pytest.approx(
        float(jref.dotp(jx, jy)), rel=1e-5, abs=1e-5)


def test_dotp_bf16_and_empty(rng):
    (jx, tx), (jy, ty) = (_both(rng.normal(size=300), "bfloat16")
                          for _ in range(2))
    assert float(tops.dotp(tx, ty)) == pytest.approx(
        float(jdotp(jx, jy, interpret=True)), rel=1e-4, abs=1e-3)
    assert float(tdk.dotp(tx[:0], ty[:0])) == 0.0
    with pytest.raises(ValueError):
        tdk.dotp(tx, ty[:5])


# ----------------------------------- B5 -------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 40)])
def test_attention_matches_pallas(rng, dtype, hq, hkv, causal, window):
    b, s, d = 2, 96, 64
    jq, tq = _both(rng.normal(size=(b, hq, s, d)), dtype)
    jk, tk = _both(rng.normal(size=(b, hkv, s, d)), dtype)
    jv, tv = _both(rng.normal(size=(b, hkv, s, d)), dtype)
    want = jfa(jq, jk, jv, causal=causal, window=window, block_q=16,
               block_k=32, interpret=True)
    for got in (tops.attention(tq, tk, tv, causal=causal, window=window),
                tfa.attention(tq, tk, tv, causal=causal, window=window)):
        assert got.dtype == tq.dtype and got.shape == tq.shape
        _close(got, want.astype(jnp.float32), dtype)


def test_attention_decode_and_kv_len(rng):
    b, hq, hkv, s, d = 2, 8, 2, 160, 64
    jq, tq = _both(rng.normal(size=(b, hq, 1, d)))
    jk, tk = _both(rng.normal(size=(b, hkv, s, d)))
    jv, tv = _both(rng.normal(size=(b, hkv, s, d)))
    want = jfa(jq, jk, jv, causal=True, q_offset=s - 1, block_q=8,
               block_k=64, interpret=True)
    for fn in (tops.attention, tfa.attention):
        _close(fn(tq, tk, tv, causal=True, q_offset=s - 1), want, atol=3e-4)
    # padded cache: only the first kv_len keys take part
    want = jfa(jq, jk, jv, causal=False, kv_len=70, block_q=8, block_k=32,
               interpret=True)
    for fn in (tops.attention, tfa.attention):
        _close(fn(tq, tk, tv, causal=False, kv_len=70), want, atol=3e-4)


@pytest.mark.parametrize("sq,sk,off,window", [(37, 201, 164, 50),
                                              (70, 70, 0, None),
                                              (5, 133, 0, None)])
def test_attention_ragged_matches_pallas(rng, sq, sk, off, window):
    """Ragged Sq / Sk, an absolute q_offset and a window; the last case is
    non-causal with Sq < Sk (no row is fully masked in any case)."""
    causal = off > 0 or sq == sk
    jq, tq = _both(rng.normal(size=(1, 4, sq, 40)))
    jk, tk = _both(rng.normal(size=(1, 2, sk, 40)))
    jv, tv = _both(rng.normal(size=(1, 2, sk, 40)))
    want = jfa(jq, jk, jv, causal=causal, q_offset=off, window=window,
               block_q=16, block_k=64, interpret=True)
    for fn in (tops.attention, tfa.attention):
        _close(fn(tq, tk, tv, causal=causal, q_offset=off, window=window),
               want)


@pytest.mark.parametrize("s,window", [(64, 16), (2048, None), (40, 8)])
def test_attention_cpu_route_is_the_references(rng, s, window):
    """The CPU route picks the reference's oracle (banded when windowed,
    causal and Sk >= 4 w; blocked when Sk >= 2048; else full) and agrees
    with ``repro.kernels.ops.attention(use_pallas=False)``."""
    sq = 1 if s >= 2048 else s
    jq, tq = _both(rng.normal(size=(1, 2, sq, 16)))
    jk, tk = _both(rng.normal(size=(1, 2, s, 16)))
    jv, tv = _both(rng.normal(size=(1, 2, s, 16)))
    off = s - sq
    want = jops.attention(jq, jk, jv, causal=True, q_offset=off,
                          window=window, use_pallas=False)
    got = tops.attention(tq, tk, tv, causal=True, q_offset=off,
                         window=window)
    _close(got, want, atol=5e-5, rtol=5e-5)
    for name, fn, args in (
            ("banded", tref.banded_attention, (tq, tk, tv, window or 8)),
            ("blocked", tref.blocked_attention, (tq, tk, tv))):
        if name == "banded" and sq != s:
            continue
        jfn = getattr(jref, f"{name}_attention")
        jargs = (jq, jk, jv) + args[3:]
        kw = {} if name == "banded" else dict(causal=True, q_offset=off,
                                              block_k=32)
        _close(fn(*args, **kw), jfn(*jargs, **kw), atol=5e-5, rtol=5e-5)


def test_attention_zero_dim():
    q = torch.zeros((1, 2, 0, 16))
    k = torch.zeros((1, 2, 5, 16))
    assert tops.attention(q, k, k).shape == (1, 2, 0, 16)
    assert tfa.attention(q, k, k).shape == (1, 2, 0, 16)
    q = torch.ones((1, 2, 3, 16))
    empty = torch.zeros((1, 2, 0, 16))
    out = tfa.attention(q, empty, empty)
    assert out.shape == q.shape and not out.any()
    want = jfa(jnp.ones((1, 2, 3, 16)), jnp.zeros((1, 2, 0, 16)),
               jnp.zeros((1, 2, 0, 16)), interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tfa.attention(q, torch.zeros((1, 3, 5, 16)), torch.zeros((1, 3, 5, 16)))


# ----------------------------------- B6 -------------------------------------

def _ssd_inputs(rng, b, h, L, p, n, layout="kernel"):
    shape = (b, h, L) if layout == "kernel" else (b, L, h)
    x = 0.5 * rng.normal(size=shape + (p,))
    a = -0.3 * np.abs(rng.normal(size=shape))
    B = 0.5 * rng.normal(size=shape + (n,))
    C = 0.5 * rng.normal(size=shape + (n,))
    return [_both(t) for t in (x, a, B, C)]


@pytest.mark.parametrize("L,chunk", [(64, 16), (100, 32), (256, 64)])
def test_ssd_scan_matches_pallas(rng, L, chunk):
    both = _ssd_inputs(rng, 2, 3, L, 16, 8)
    jargs, targs = [t[0] for t in both], [t[1] for t in both]
    want = jssd(*jargs, chunk=chunk, interpret=True)
    got = tssd.ssd_scan(*targs, chunk=chunk)
    assert got.shape == targs[0].shape
    _close(got, want)
    # ops.ssd in the model layout, and the exact recurrence
    tr = lambda t: t.movedim(1, 2)
    _close(tops.ssd(*map(tr, targs), chunk=chunk), np.moveaxis(
        np.asarray(want), 1, 2))
    jtr = lambda t: jnp.moveaxis(t, 1, 2)
    _close(tr(tref.ssd(*map(tr, targs))), jtr(jref.ssd(*map(jtr, jargs))),
           atol=1e-5, rtol=1e-5)


def test_ssd_chunk_invariance(rng):
    """The chunk does not change the math, on either side."""
    both = _ssd_inputs(rng, 1, 2, 96, 8, 4, layout="model")
    jargs, targs = [t[0] for t in both], [t[1] for t in both]
    want = np.asarray(jref.ssd_chunked(*jargs, chunk=8))
    for c in (8, 24, 96):
        _close(tref.ssd_chunked(*targs, chunk=c), want, atol=3e-4)
        _close(tops.ssd(*targs, chunk=c), jops.ssd(
            *jargs, chunk=c, use_pallas=False), atol=1e-5, rtol=1e-5)


def test_ssd_plain_chunk_rule_and_zero_dim(rng):
    """ssd_scan's chunk is min(chunk or plan, max(L, 8)), as the Pallas
    wrapper's; zero-dim inputs give zeros of x's shape."""
    both = _ssd_inputs(rng, 1, 2, 5, 8, 4)
    jargs, targs = [t[0] for t in both], [t[1] for t in both]
    _close(tssd.ssd_scan(*targs), jssd(*jargs, interpret=True))
    _close(tssd.ssd_scan(*targs, chunk=64), jssd(*jargs, chunk=64,
                                                 interpret=True))
    zero = torch.zeros((1, 2, 0, 8))
    assert tssd.ssd_scan(zero, zero[..., 0], zero[..., :4],
                         zero[..., :4]).shape == zero.shape
    out = tssd.ssd_scan(targs[0], targs[1], targs[2][..., :0],
                        targs[3][..., :0])
    assert out.shape == targs[0].shape and not out.any()
    with pytest.raises(ValueError):
        tssd.ssd_scan(targs[0], targs[1][..., :3], targs[2], targs[3])


def test_rmsnorm_matches_reference(rng):
    (jx, tx), (jw, tw) = _both(rng.normal(size=(3, 5, 32))), _both(
        rng.normal(size=32))
    _close(tref.rmsnorm(tx, tw), jref.rmsnorm(jx, jw), atol=1e-6, rtol=1e-6)


def test_foreign_device_raises():
    m = torch.empty((1, 2, 4, 16), device="meta")
    with pytest.raises(ValueError):
        tops.attention(m, m, m)
    with pytest.raises(ValueError):
        tfa.attention(m, m, m)
    with pytest.raises(ValueError):
        tdk.dotp(torch.empty(4, device="meta"), torch.empty(4, device="meta"))


# (shape of the (B, S, H, D) storage, dtype) of q, k, v handed over as
# moveaxis views, as the model does
def _model_views(d, dtype, b=2, s=40, hq=25, hkv=5):
    q = torch.zeros(b, s, hq, d, dtype=dtype).movedim(2, 1)
    k = torch.zeros(b, s, hkv, d, dtype=dtype).movedim(2, 1)
    return q, k, k.clone()


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 40, "wgmma"), (torch.bfloat16, 8, "wgmma"),
    (torch.bfloat16, 36, "ffma"), (torch.bfloat16, 256, "ffma"),
    (torch.float32, 64, "ffma"), (torch.float32, 128, "ffma")])
def test_attention_variant_choice(dtype, d, want):
    """attention_variant is a pure function of dtype, head dim and layout:
    the model's moveaxis views and contiguous operands in bf16 with
    D <= 128 (a multiple of 8) take the tensor-core variant, f32 and other
    head dims the FFMA one."""
    views = _model_views(d, dtype)
    assert tfa.attention_variant(*views) == want
    assert tfa.attention_variant(*(t.contiguous() for t in views)) == want
    assert tfa.tile(want, d) == ((128, 128) if want == "wgmma"
                                 else (64, 32 if d > 128 else 64))


@pytest.mark.parametrize("make", [
    lambda q: q[..., ::2],                                 # dim stride 2
    lambda q: torch.zeros(q.numel() + 1, dtype=q.dtype)[1:]
    .view(q.shape),                                        # base off 16 B
    lambda q: torch.zeros(2, 25, 40, 65, dtype=q.dtype)[..., :64],  # rows
])
def test_attention_variant_layouts(make):
    """A q, k or v that TMA cannot read sends bf16 to the FFMA variant."""
    q, k, v = _model_views(128, torch.bfloat16)
    bad = make(q.contiguous())
    assert not tfa.tma_readable(bad)
    d = bad.shape[3]
    k, v = k[..., :d], v[..., :d]
    assert tfa.attention_variant(bad, k, v) == "ffma"
    # a fresh copy of the same values is readable again
    assert tfa.attention_variant(*(t.clone(memory_format=torch.contiguous_format)
                                   for t in (bad, k, v))) == "wgmma"


def test_attention_variant_counts_reset():
    """The per-variant launch counts start at zero for every variant and
    reset_launches zeroes them (the CPU route launches nothing)."""
    tfa.reset_launches()
    q, k, v = _model_views(64, torch.bfloat16)
    tfa.attention(q, k, v)
    assert tfa.attention.launches == 0
    assert tfa.attention.variant_launches == {"ffma": 0, "wgmma": 0}
