"""The three passes of repro_torch's SSD scan (B6) against the JAX package,
and the launch shapes of B6 and B4.

``ssd_scan_passes`` writes the card kernels' chunk states, state passing
and chunk output out step for step in plain PyTorch; here it is held to
the JAX package's Pallas ``ssd_scan`` run with ``interpret=True`` on the
same numpy inputs (float32, tolerance 2e-4 absolute and relative: f32 sums
in another order), over ragged L, chunks 16 / 64 / 256 and states 8 / 128,
and its intermediates to the recurrence they stand for. The launch plans
(``ssd_scan_plan``, ``dotp_grid``) are pure host-side functions, checked at
the hymba-1.5b and mamba2-130m prefill shapes. The kernels themselves are
held to these plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as jssd
from repro_torch.kernels import dotp as tdk
from repro_torch.kernels import ssd_scan as tssd

TOL = dict(atol=2e-4, rtol=2e-4)


def _inputs(rng, b, h, L, p, n):
    x = 0.5 * rng.normal(size=(b, h, L, p))
    a = -0.3 * np.abs(rng.normal(size=(b, h, L)))
    B = 0.5 * rng.normal(size=(b, h, L, n))
    C = 0.5 * rng.normal(size=(b, h, L, n))
    return [t.astype(np.float32) for t in (x, a, B, C)]


@pytest.mark.parametrize("n", [8, 128])
@pytest.mark.parametrize("chunk", [16, 64, 256])
@pytest.mark.parametrize("L", [5, 100, 257, 300])
def test_ssd_scan_passes_match_pallas(rng, L, chunk, n):
    args = _inputs(rng, 1, 2, L, 16, n)
    want = np.asarray(jssd(*map(jnp.asarray, args), chunk=chunk,
                           interpret=True))
    targs = [torch.from_numpy(t) for t in args]
    y, passes = tssd.ssd_scan_passes(*targs, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    # the intermediates are the recurrence they stand for
    c = min(chunk, max(L, 8))
    nch = -(-L // c)
    assert passes["states"].shape == passes["carried"].shape == \
        (1, 2, nch, 16, n)
    assert passes["decay"].shape == (1, 2, nch)
    assert not passes["carried"][:, :, 0].any()
    for i in range(nch):
        sl = slice(i * c, min(L, (i + 1) * c))
        cum = torch.cumsum(targs[1][:, :, sl], dim=-1)
        torch.testing.assert_close(passes["cum"][:, :, sl], cum)
        torch.testing.assert_close(passes["decay"][:, :, i],
                                   torch.exp(cum[..., -1]))
        if i + 1 < nch:
            torch.testing.assert_close(
                passes["carried"][:, :, i + 1],
                passes["decay"][:, :, i, None, None]
                * passes["carried"][:, :, i] + passes["states"][:, :, i])


def test_ssd_scan_passes_bf16_match_plain(rng):
    """bf16 operands: the passes compute in f32 from the same bits as the
    plain version and round y once, so they differ by one bf16 step at
    most."""
    args = [torch.from_numpy(t).to(torch.bfloat16) if i != 1 else
            torch.from_numpy(t) for i, t in enumerate(_inputs(rng, 2, 3, 300,
                                                              64, 16))]
    y, _ = tssd.ssd_scan_passes(*args, chunk=64)
    want = tssd.ssd_scan_plain(*args, chunk=64)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), want.float(), atol=2e-2,
                               rtol=2 ** -7)


def test_ssd_scan_kernel_needs_the_card(rng):
    args = [torch.from_numpy(t) for t in _inputs(rng, 1, 2, 40, 16, 8)]
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_scan_kernel(*args, chunk=16)


# (name, batch, heads, L, head dim, state, chunk) of the model paths'
# prefills at 2 x 4096 tokens
MODEL_SHAPES = [("hymba-1.5b", 2, 50, 4096, 64, 16, 256),
                ("mamba2-130m", 2, 24, 4096, 64, 128, 256)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", MODEL_SHAPES, ids=lambda s: s[0])
def test_ssd_scan_plan(shape, dtype):
    """B6's three grids, threads, shared memory and scratch are a pure
    function of the shape: pass 1 one CTA per (chunk, head, batch), pass
    2 one thread per state entry, pass 3 one CTA per 64 query rows of
    every chunk; every pass within the card's shared memory."""
    name, b, h, L, p, n, chunk = shape
    plan = tssd.ssd_scan_plan(b, h, L, p, n, chunk, dtype)
    assert plan == tssd.ssd_scan_plan(b, h, L, p, n, chunk, dtype)
    nch = L // chunk
    assert plan.route == ("mma" if dtype == torch.bfloat16 else "ffma")
    assert plan.n_chunks == nch and plan.query_blocks == chunk // 64
    assert plan.grids == ((nch * h, b, 1), (-(-p * n // 256), h, b),
                          (nch * chunk // 64 * h, b, 1))
    assert plan.threads == (256, 256, 128 if plan.route == "mma" else 256)
    assert all(0 <= s <= tssd.SMEM_LIMIT for s in plan.smem_bytes)
    assert plan.smem_bytes[1] == 0
    assert plan.scratch_bytes == 4 * (b * h * L + b * h * nch
                                      * (2 * p * n + 1))
    if name == "hymba-1.5b":
        assert plan.ctas == (1600, 400, 6400)
    assert plan.ctas[0] >= 132 * 3      # pass 1 fills the card's 132 SMs


@pytest.mark.parametrize("L,chunk,p,n", [(5, 8, 16, 4), (257, 64, 40, 16),
                                         (1000, 256, 128, 128),
                                         (300, 1024, 64, 16)])
def test_ssd_scan_plan_ragged(L, chunk, p, n):
    """Ragged L and chunks: the last chunk's query blocks past L exit in
    the kernel, so the grid counts whole chunks; a chunk longer than L
    keeps its shared memory for the prefix sum."""
    for dtype in (torch.bfloat16, torch.float32):
        plan = tssd.ssd_scan_plan(1, 2, L, p, n, chunk, dtype)
        assert plan.n_chunks == -(-L // chunk)
        assert plan.grids[2][0] == plan.n_chunks * -(-chunk // 64) * 2
        assert plan.smem_bytes[0] >= 4 * chunk
        assert max(plan.smem_bytes) <= tssd.SMEM_LIMIT


def test_ssd_scan_plan_refuses():
    with pytest.raises(ValueError, match="head_dim"):
        tssd.ssd_scan_plan(1, 2, 64, 256, 16, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="state"):
        tssd.ssd_scan_plan(1, 2, 64, 64, 256, 64, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        tssd.ssd_scan_plan(1, 2, 10 ** 6, 64, 16, 10 ** 6, torch.float32)
    with pytest.raises(ValueError, match="takes"):
        tssd.ssd_scan_plan(1, 2, 64, 64, 16, 64, torch.float64)


# ----------------------------------- B4 -------------------------------------

@pytest.mark.parametrize("n,itemsize,vec,per_sm,want", [
    (2 ** 26, 4, True, 5, 132 * 4),    # one whole wave of 4 CTAs per SM
    (2 ** 26, 4, False, 8, 132 * 4),
    (2 ** 26, 8, True, 3, 132 * 3),    # the occupancy query allows 3
    (10 ** 6 + 7, 2, True, 5, 123),    # 125000 vectors / (256 x 4)
    (10 ** 6 + 7, 2, False, 5, 132 * 4),
    (131, 4, True, 5, 1), (1, 8, True, 5, 1), (1, 4, False, 5, 1)])
def test_dotp_grid(n, itemsize, vec, per_sm, want):
    """B4's first pass runs one whole wave (a multiple of the SM count),
    or one CTA per full ILP step of 16-byte vectors (scalars when the
    operands are strided or unaligned) when n is smaller."""
    got = tdk.dotp_grid(n, 132, per_sm, itemsize, vec)
    wave = 132 * min(per_sm, tdk.CTAS_PER_SM)
    assert got == want
    assert got <= wave and (got < wave or got % 132 == 0)


def test_dotp_vector_loads_choice():
    x = torch.zeros(1001)
    assert tdk.vector_loads(x[:1000], x[:1000])
    assert not tdk.vector_loads(x[1:], x[:1000])        # unaligned start
    assert not tdk.vector_loads(x[::2], x[:501])        # stride 2
