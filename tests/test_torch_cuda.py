"""Each CUDA kernel of repro_torch against its plain version, on the card.

The kernels have no CPU mode, so every test here is marked ``cuda`` and
skips without a card. The file imports neither jax nor ``repro`` (the
machine with the card has no jax), so it runs there without this
directory's conftest::

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import codesign as cd
from repro_torch.core import isa
from repro_torch.core import pe
from repro_torch.kernels import dotp as dk
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fpu_chain as fc
from repro_torch.kernels import fused as fk
from repro_torch.kernels import gemm as gk
from repro_torch.kernels import ops
from repro_torch.kernels import pe_scoreboard as ps
from repro_torch.kernels import ssd_scan as sk

# tests/conftest.py's dtype tolerances (rtol, atol), repeated here so the
# file needs no jax
TOL = {"float32": (2e-4, 1e-4), "float64": (1e-12, 1e-12),
       "bfloat16": (5e-2, 5e-2)}
# chip_smoke.py's CLOSE_TOL for B5 (rtol, atol in units of the plain
# output's rms, normwise limit): bf16 sides each round one f32 value once,
# so they differ by at most one bf16 step; f32 sums in another order
CLOSE_TOL = {"float32": (2e-4, 2e-4, 2e-4), "bfloat16": (2 ** -7, 1e-2, 1e-2)}
GEMM_SHAPES = [(1, 1, 1), (7, 129, 33), (70, 33, 129), (200, 300, 517)]
# (nb, n, m; m is lu's, syrk takes m = n): ragged panels, the drivers' nb
# at a ragged n and with m = 0 (X only), one too wide for 32-column X
# blocks with L11 from device memory
TRSM_GEMM_SHAPES = [(8, 8, 8), (13, 130, 70), (100, 300, 260),
                    (128, 1000, 963), (128, 200, 0), (2000, 40, 30)]
# (m, k) of the "gemv" checks: the 8192 solve's largest TRSM update, rows
# that are not 16-byte aligned (k = 7, k = 1), a ragged row count
GEMV_SHAPES = [(128, 8064), (37, 7), (128, 1), (300, 1000)]
DOTP_SIZES = [1, 131, 1000, 10 ** 6 + 7]
# (b, hq, hkv, sq, sk, d, causal, window, q_offset, kv_len): GQA 8/2 and
# 25/5, causal / full / windowed, decode, kv_len, ragged Sq/Sk/D, D = 256
ATTN_CASES = [
    (2, 8, 2, 96, 96, 64, True, None, 0, None),
    (2, 8, 2, 96, 96, 64, False, None, 0, None),
    (2, 8, 2, 96, 96, 64, True, 40, 0, None),
    (1, 25, 5, 130, 130, 64, True, 40, 0, None),
    (2, 8, 2, 1, 160, 64, True, None, 159, None),
    (1, 2, 2, 1, 128, 32, False, None, 0, 70),
    (1, 4, 2, 37, 201, 40, True, 50, 164, None),
    (1, 2, 1, 70, 70, 128, True, None, 0, None),
    (1, 2, 2, 65, 65, 256, True, 30, 0, None),
]
# (b, h, L, p, n, chunk): ragged L, chunks 16 / 64 / 256, mamba2's N = 128
SSD_CASES = [(2, 3, 64, 16, 8, 16), (2, 3, 100, 16, 8, 32),
             (1, 2, 300, 64, 16, 256), (1, 2, 257, 40, 16, 64),
             (1, 2, 130, 64, 128, 256), (1, 1, 5, 16, 4, 64)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, dtype, scale):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               want.double().cpu().numpy(),
                               rtol=rtol * scale, atol=atol * scale)


def _close_scaled(got, want, dtype):
    """chip_smoke.py's compare_close: |got - want| <= rtol |want| +
    atol rms(want) elementwise and ||got - want|| <= norm_tol ||want||,
    so a wrong or misplaced KV tile cannot hide under an absolute limit
    larger than the output's values."""
    rtol, atol, norm_tol = CLOSE_TOL[dtype]
    g, w = got.double(), want.double()
    diff = (g - w).abs()
    limit = rtol * w.abs() + atol * w.square().mean().sqrt()
    assert torch.isfinite(g).all()
    worst = (diff / limit.clamp_min(1e-300)).max().item()
    assert worst <= 1.0, f"elementwise {worst:.3g} of its limit"
    norm_err = (diff.norm() / w.norm().clamp_min(1e-300)).item()
    assert norm_err <= norm_tol, f"normwise {norm_err:.3g} > {norm_tol}"
    return worst, norm_err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_gemm_kernels_match_plain(card, dtype):
    rng = np.random.default_rng(0)
    dev = lambda *s: torch.from_numpy(rng.normal(size=s)).to(
        card, getattr(torch, dtype))
    for m, n, k in GEMM_SHAPES:
        a, b, bias = dev(m, k), dev(k, n), dev(n)
        _close(gk.gemm(a, b), gk.gemm_plain(a, b), dtype, 4.0)
        _close(gk.gemm(b.T, a.T), gk.gemm_plain(b.T, a.T), dtype, 4.0)
        for epi in fk.EPILOGUES:
            _close(fk.gemm_bias_act(a, b, bias, epi),
                   fk.gemm_bias_act_plain(a, b, bias, epi), dtype, 4.0)
    torch.cuda.synchronize()


# (m, n, k) at which each tiled variant runs: edges that cut the tiles in
# m, n and k (n and k multiples of 8, so contiguous rows stay 16-byte
# aligned), one tile, several tiles and a partial last k stage
TILED_SHAPES = [(17, 40, 8), (200, 296, 520), (1000, 776, 520)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out,variant", [
    ("bfloat16", "bfloat16", "wgmma"), ("bfloat16", "float32", "wgmma"),
    ("float32", "float32", "ffma"), ("float64", "float64", "dmma")])
def test_gemm_tiled_variants_match_plain(card, dtype, out, variant):
    """Each tiled variant (and B3 on it) against the plain version at
    ragged shapes and on a sliced, 16-byte aligned view."""
    rng = np.random.default_rng(1)
    tdt, odt = getattr(torch, dtype), getattr(torch, out)
    dev = lambda *s: torch.from_numpy(rng.normal(size=s)).to(card, tdt)
    for m, n, k in TILED_SHAPES:
        a, b, bias = dev(m, k), dev(k, n), dev(n)
        assert gk.gemm_variant(a, b) == variant
        before = gk.gemm.variant_launches[variant]
        got = gk.gemm(a, b, out_dtype=odt)
        assert gk.gemm.variant_launches[variant] == before + 1
        assert gk.gemm.last_launch["variant"] == variant
        # the h100 plan's tile, which is always a compiled one
        plan = gk.gemm.last_launch["plan"]
        assert gk.gemm.last_launch["tile"] == (plan.bm, plan.bn, plan.bk)
        assert gk.gemm.last_launch["tile_source"] == "plan"
        assert gk.gemm.last_launch["tile"] in gk.TILE_SETS[variant]
        _close(got, gk.gemm_plain(a, b, odt), out, 4.0)
        for epi in fk.EPILOGUES:
            _close(fk.gemm_bias_act(a, b, bias, epi, out_dtype=odt),
                   fk.gemm_bias_act_plain(a, b, bias, epi, odt), out, 4.0)
            assert fk.gemm_bias_act.last_launch["variant"] == variant
    # a window of a larger matrix: row stride 1024, base 16-byte aligned
    big = dev(400, 1024)
    a, b = big[40:240, 64:64 + 320], big[:320, 128:128 + 200]
    assert gk.gemm_variant(a, b) == variant
    _close(gk.gemm(a, b, out_dtype=odt), gk.gemm_plain(a, b, odt), out, 4.0)
    torch.cuda.synchronize()


# every compiled tile of the tiled variants, with its operand and output
# dtypes (B3 on the same tile)
TILE_CASES = [(dt, out, v, t) for dt, outs in (
    ("bfloat16", ("bfloat16", "float32")), ("float32", ("float32",)),
    ("float64", ("float64",))) for out in outs
    for v in (gk.TILED[getattr(torch, dt)],) for t in gk.TILE_SETS[v]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out,variant,tile", TILE_CASES)
def test_gemm_compiled_tile_matches_plain(card, dtype, out, variant, tile):
    """Each compiled CTA tile, handed over in a plan, launches (its own
    tile, ``tile_source == "plan"``) and agrees with the plain version at a
    shape that cuts it in m, n and k and at one it divides; B3 on it."""
    rng = np.random.default_rng(6)
    tdt, odt = getattr(torch, dtype), getattr(torch, out)
    dev = lambda *s: torch.from_numpy(rng.normal(size=s)).to(card, tdt)
    bm, bn, bk = tile
    for m, n, k in ((3 * bm + 5, 2 * bn + 8, 5 * bk + 8),
                    (2 * bm, 2 * bn, 4 * bk)):
        a, b, bias = dev(m, k), dev(k, n), dev(n)
        plan = cd.plan_from_blocks(m, n, k, bm, bn, bk, dtype=tdt,
                                   machine="h100")
        before = gk.gemm.variant_launches[variant]
        got = gk.gemm(a, b, plan=plan, out_dtype=odt)
        assert gk.gemm.variant_launches[variant] == before + 1
        assert gk.gemm.last_launch["tile"] == tile
        assert gk.gemm.last_launch["tile_source"] == "plan"
        _close(got, gk.gemm_plain(a, b, odt), out, 4.0)
        got = fk.gemm_bias_act(a, b, bias, "gelu", plan=plan, out_dtype=odt)
        assert fk.gemm_bias_act.last_launch["tile"] == tile
        _close(got, fk.gemm_bias_act_plain(a, b, bias, "gelu", odt), out, 4.0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("op", fc.OP_CLASSES)
def test_fpu_chain_matches_plain_bitwise(card, op):
    """The dependent chain of each op class on the card gives the plain
    loop's bits (IEEE float32 mul, add, div and sqrt round alike) and a
    positive cycle count of at least one cycle per step."""
    v0 = torch.from_numpy(1.5 + np.random.default_rng(7).uniform(size=8)
                          .astype(np.float32)).to(card)
    before = fc.fpu_chain.launches
    got, cycles = fc.fpu_chain(op, v0, 512)
    assert fc.fpu_chain.launches == before + 1
    assert torch.equal(got, fc.fpu_chain_plain(op, v0, 512))
    cycles = int(cycles)
    assert cycles >= 512, cycles
    print(f"\nfpu_chain {op}: {cycles / 512:.2f} cycles per dependent op")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_gemm_simt_layouts_match_plain(card, dtype):
    """The layouts the tiled variants do not read (transposed, misaligned,
    skinny) run on "simt" and agree with the plain version."""
    rng = np.random.default_rng(2)
    tdt = getattr(torch, dtype)
    dev = lambda *s: torch.from_numpy(rng.normal(size=s)).to(card, tdt)
    a, b = dev(200, 300), dev(300, 150)
    big = dev(320, 330)
    cases = [(b.T, a.T), (big[1:201, 3:303], big[5:305, 7:157]),
             (dev(8192, 128).T, dev(8192, 1)), (dev(5, 64), dev(64, 96))]
    for x, y in cases:
        assert gk.gemm_variant(x, y) == "simt", (x.shape, x.stride())
        _close(gk.gemm(x, y), gk.gemm_plain(x, y), dtype, 4.0)
        assert gk.gemm.last_launch["tile"] == gk.TILES["simt"]
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32"), ("float64", "float64")])
def test_gemm_gemv_matches_plain(card, dtype, out):
    """The "gemv" variant (and B3 on it) against the plain version at
    n = 1, 3, 16: aligned rows (a window of a larger matrix, as the blocked
    TRSM passes it), unaligned rows, strided B, every epilogue with and
    without bias; one launch per call."""
    rng = np.random.default_rng(4)
    tdt, odt = getattr(torch, dtype), getattr(torch, out)
    dev = lambda *s: torch.from_numpy(rng.normal(size=s)).to(card, tdt)
    for m, k in GEMV_SHAPES:
        big = dev(m + 1, k + 8)
        for a in (big[1:, 8:], big[:m, 1:k + 1]):     # aligned (k + 8 = 8j),
            for n in (1, 3, 16):                      # unaligned base
                bbig = dev(k, 2 * n)
                for b in (bbig[:, :n], bbig[:, ::2], dev(n, k).T):
                    assert gk.gemm_variant(a, b) == "gemv"
                    before = gk.gemm.variant_launches["gemv"]
                    got = gk.gemm(a, b, out_dtype=odt)
                    assert gk.gemm.variant_launches["gemv"] == before + 1
                    assert gk.gemm.last_launch["tile"] == gk.TILES["gemv"]
                    _close(got, gk.gemm_plain(a, b, odt), out, 4.0)
                bias = dev(n)
                for epi in fk.EPILOGUES:
                    for bb in (None, bias):
                        before = fk.gemm_bias_act.launches
                        got = fk.gemm_bias_act(a, b, bb, epi, out_dtype=odt)
                        assert fk.gemm_bias_act.launches == before + 1
                        assert fk.gemm_bias_act.last_launch["variant"] == "gemv"
                        _close(got, fk.gemm_bias_act_plain(a, b, bb, epi, odt),
                               out, 4.0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_qr_trailing_update_matches_plain(card, dtype):
    """geqrf with its trailing products on B1 (``model``) against the same
    factorization with plain products (``reference``) on the card: 5
    panels of 64, 4 with trailing columns, two tiled launches each."""
    from repro_torch.lapack import qr
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(384, 320, generator=gen, device=card, dtype=torch.float64)
    a = a.to(dt)
    gk.reset_launches(gk.gemm)
    packed, tau = qr.geqrf(a, block=64, policy="model")
    launches = dict(gk.gemm.variant_launches)
    plain, plain_tau = qr.geqrf(a, block=64, policy="reference")
    assert launches == {**dict.fromkeys(gk.VARIANTS, 0), gk.TILED[dt]: 8}
    _close(packed, plain, dtype, 16.0)
    _close(tau, plain_tau, dtype, 16.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_trsm_gemm_kernel_matches_plain(card, dtype):
    rng = np.random.default_rng(0)
    tdt = getattr(torch, dtype)
    dev = lambda x: torch.from_numpy(x).to(card, tdt)
    for nb, n, m in TRSM_GEMM_SHAPES:
        l11 = dev(np.tril(rng.normal(size=(nb, nb)), -1) / nb
                  + np.diag(1 + rng.uniform(size=nb)))
        for form in ("lu", "syrk"):
            mm = n if form == "syrk" else m
            args = (l11, dev(rng.normal(size=(n, nb))).T,
                    None if form == "syrk" else dev(rng.normal(size=(mm, nb))),
                    dev(rng.normal(size=(mm, n))))
            for unit in (False, True):
                before = fk.trsm_gemm.launches
                x, c = fk.trsm_gemm(*args, form=form, unit_diag=unit)
                assert fk.trsm_gemm.launches == before + 1
                assert fk.trsm_gemm.last_launch["plan"] == \
                    fk.trsm_gemm_plan(tdt, nb, form)
                assert x.shape == (nb, n) and c.shape == (mm, n)
                xp, cp = fk.trsm_gemm_plain(*args, form=form, unit_diag=unit)
                _close(x, xp, dtype, 4.0)
                _close(c, cp, dtype, 8.0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_trsm_gemm_reads_driver_windows(card, dtype):
    """B2 on the views potrf and getrf pass (windows of one matrix, AP
    transposed for potrf), read in place, against the plain version on
    contiguous copies; one launch per call."""
    rng = np.random.default_rng(5)
    nb, n = 128, 300
    a = torch.from_numpy(rng.normal(size=(nb + n, nb + n))).to(
        card, getattr(torch, dtype))
    a[:nb, :nb] = torch.from_numpy(np.tril(rng.normal(size=(nb, nb)), -1) / nb
                                   + np.diag(1 + rng.uniform(size=nb))).to(a)
    for form, views in (
            ("syrk", (a[:nb, :nb], a[nb:, :nb].T, None, a[nb:, nb:])),
            ("lu", (a[:nb, :nb], a[:nb, nb:], a[nb:, :nb], a[nb:, nb:]))):
        unit = form == "lu"
        before = fk.trsm_gemm.launches
        x, c = fk.trsm_gemm(*views, form=form, unit_diag=unit)
        assert fk.trsm_gemm.launches == before + 1
        xp, cp = fk.trsm_gemm_plain(*(None if v is None else v.contiguous()
                                      for v in views), form=form,
                                    unit_diag=unit)
        _close(x, xp, dtype, 4.0)
        _close(c, cp, dtype, 8.0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_dotp_kernel_matches_plain(card, dtype):
    rng = np.random.default_rng(0)
    for n in DOTP_SIZES:
        x = torch.from_numpy(rng.normal(size=2 * n)).to(card,
                                                        getattr(torch, dtype))
        y = torch.from_numpy(rng.normal(size=n + 1)).to(card,
                                                        getattr(torch, dtype))
        # contiguous (16-byte loads), strided and offset by one element
        # (unaligned): both scalar loads
        for xv, yv, vec in ((x[:n], y[:n], True), (x[::2], y[:n], False),
                            (x[1:n + 1], y[1:], False)):
            got, want = dk.dotp(xv, yv), dk.dotp_plain(xv, yv)
            assert dk.dotp.last_launch["vector_loads"] == vec
            # f32 sums in another order: relative to sum |x_i y_i|
            mag = (xv.float() * yv.float()).abs().sum().item()
            assert got.dtype == torch.float32 and got.shape == ()
            assert abs(got.item() - want.item()) <= 1e-5 * mag + 1e-6, n
            assert torch.equal(got, dk.dotp(xv, yv))      # no float atomics
    assert dk.dotp(x[:0], y[:0]).item() == 0.0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernel_matches_plain(card, dtype):
    rng = np.random.default_rng(0)
    tdt = getattr(torch, dtype)
    for b, hq, hkv, sq, sk, d, causal, window, off, kv_len in ATTN_CASES:
        # the model's layout (B, S, H, D) read through moveaxis views
        q = torch.from_numpy(rng.normal(size=(b, sq, hq, d))).to(
            card, tdt).movedim(2, 1)
        k, v = (torch.from_numpy(rng.normal(size=(b, sk, hkv, d))).to(
            card, tdt).movedim(2, 1) for _ in range(2))
        kw = dict(causal=causal, window=window, q_offset=off, kv_len=kv_len)
        before = fa.attention.launches
        got = fa.attention(q, k, v, **kw)
        assert fa.attention.launches == before + 1
        _close(got, fa.attention_plain(q, k, v, **kw), dtype, 4.0)
        _close(ops.attention(q, k, v, **kw), got, dtype, 1.0)
    empty = torch.zeros((1, 2, 0, 64), device=card, dtype=tdt)
    assert fa.attention(empty, empty, empty).shape == empty.shape
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("bfloat16", 64), ("bfloat16", 128),
                                     ("bfloat16", 40), ("float32", 64),
                                     ("bfloat16", 256)])
def test_attention_variants_match_plain(card, dtype, d):
    """bf16 at head dims up to 128 runs the tensor-core variant, f32 and
    D = 256 the FFMA one; each agrees with the plain version on the
    model's moveaxis views and on contiguous operands, elementwise and
    normwise at chip_smoke.py's CLOSE_TOL."""
    rng = np.random.default_rng(3)
    tdt = getattr(torch, dtype)
    want = "wgmma" if dtype == "bfloat16" and d <= 128 else "ffma"
    readings = []
    for b, hq, hkv, sq, sk, causal, window, off, kv_len in [
            (2, 8, 2, 300, 300, True, None, 0, None),
            (1, 25, 5, 700, 700, True, 256, 0, None),
            (1, 4, 2, 1, 333, True, None, 332, None),
            (1, 4, 2, 130, 260, False, None, 0, 200),
            (1, 4, 4, 150, 400, True, 64, 250, None)]:
        q = torch.from_numpy(rng.normal(size=(b, sq, hq, d))).to(
            card, tdt).movedim(2, 1)
        k, v = (torch.from_numpy(rng.normal(size=(b, sk, hkv, d))).to(
            card, tdt).movedim(2, 1) for _ in range(2))
        kw = dict(causal=causal, window=window, q_offset=off, kv_len=kv_len)
        for args in ((q, k, v), tuple(t.contiguous() for t in (q, k, v))):
            assert fa.attention_variant(*args) == want
            got = fa.attention(*args, **kw)
            assert fa.attention.last_launch["variant"] == want
            plain = fa.attention_plain(*args, **kw)
            _close(got, plain, dtype, 4.0)
            readings.append(_close_scaled(got, plain, dtype))
    worst, norm_err = map(max, zip(*readings))     # shown under pytest -s
    print(f"\nattention {dtype} D={d} [{want}]: elementwise <= {worst:.4g} "
          f"of its limit, normwise <= {norm_err:.3g}")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [
    (4, 12, 12, 1500, 1500, 64, False),    # whisper-small's encoder
    (4, 12, 12, 448, 1500, 64, False),     # its cross-attention
    (2, 64, 4, 4096, 4096, 128, True),     # qwen3-moe, 16:1 GQA
    (2, 14, 2, 4096, 4096, 64, True),      # internvl2-1b, 7:1 GQA
])
def test_attention_family_forms_match_plain(card, b, hq, hkv, sq, sk, d,
                                            causal):
    """B5 at the model families' own forms (bf16, ``wgmma``), including a
    ragged 1500-key tail with causal off and Sq != Sk, at chip_smoke.py's
    CLOSE_TOL."""
    gen = torch.Generator(device=card).manual_seed(0)

    def view(s, h):
        return torch.randn(b, s, h, d, generator=gen, device=card) \
            .to(torch.bfloat16).movedim(2, 1)
    q, k, v = view(sq, hq), view(sk, hkv), view(sk, hkv)
    assert fa.attention_variant(q, k, v) == "wgmma"
    got = fa.attention(q, k, v, causal=causal)
    worst, norm_err = _close_scaled(
        got, fa.attention_plain(q, k, v, causal=causal), "bfloat16")
    print(f"\nattention q{tuple(q.shape)} k{tuple(k.shape)} causal={causal}"
          f": elementwise <= {worst:.4g} of its limit, normwise <= "
          f"{norm_err:.3g}")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_moe_forward_is_bitwise_repeatable(card, factor):
    """The moe FFN combines each token's k gated slots by a sum over k (no
    scatter-add), so two calls on the card are bitwise equal, drops
    included (capacity factor 0.5)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch.train import reduce_config
    from repro_torch.models import model_zoo
    cfg = dataclasses.replace(reduce_config(
        registry.get_config("qwen3-moe-235b-a22b"), layers=2, d_model=256,
        vocab=512, heads=4), capacity_factor=factor)
    model = model_zoo.init(cfg, device=card)
    tokens = torch.randint(0, cfg.vocab, (2, 300), device=card,
                           generator=torch.Generator(card).manual_seed(1))
    one = model_zoo.forward(model, {"tokens": tokens}, cfg)
    two = model_zoo.forward(model, {"tokens": tokens}, cfg)
    assert torch.isfinite(one[0]).all() and one[1].item() > 0
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain(card, dtype):
    rng = np.random.default_rng(0)
    tdt = getattr(torch, dtype)
    for b, h, L, p, n, chunk in SSD_CASES:
        dev = lambda *s, f=0.5: torch.from_numpy(
            f * rng.normal(size=s)).to(card, tdt)
        x, B, C = dev(b, L, h, p), dev(b, L, h, n), dev(b, L, h, n)
        a = -torch.from_numpy(0.3 * np.abs(rng.normal(size=(b, L, h)))).to(
            card, torch.float32)
        args = (x.movedim(2, 1), a.movedim(2, 1), B.movedim(2, 1),
                C.movedim(2, 1))
        before = sk.ssd_scan.launches
        got = sk.ssd_scan(*args, chunk=chunk)
        assert sk.ssd_scan.launches == before + 1
        assert sk.ssd_scan.last_launch["chunk"] == min(chunk, max(L, 8))
        _close(got, sk.ssd_scan_plain(*args, chunk=chunk), dtype, 4.0)
        _close(ops.ssd(x, a, B, C, chunk=chunk).movedim(2, 1), got, dtype,
               1.0)
        # the three passes' scratch against the plain passes (f32), and
        # two calls bitwise equal (no atomics, a fixed order of every sum)
        y, scratch = sk.ssd_scan_kernel(*args, chunk=chunk)
        assert torch.equal(y, got)
        _, want = sk.ssd_scan_passes(*args, chunk=chunk)
        for key in ("cum", "states", "decay", "carried"):
            _close_scaled(scratch[key], want[key], "float32")
    zero = torch.zeros((1, 2, 0, 16), device=card, dtype=tdt)
    assert sk.ssd_scan(zero, zero[..., 0], zero, zero).shape == zero.shape
    torch.cuda.synchronize()


def _pe_random_stream(rng, n):
    """A random SSA stream: any opcode, each source an earlier id or -1."""
    idx = np.arange(n)
    src = [np.where(idx > 0, rng.integers(-1, np.maximum(idx, 1)), -1)
           for _ in range(2)]
    return (rng.integers(0, isa.N_OPCODES, size=n).astype(np.int32),
            src[0].astype(np.int32), src[1].astype(np.int32))


def _pe_edge_stream(rng, n, dists):
    """A stream of n instructions whose sources lie ``dists`` back (drawn
    per source; negative where that reaches before instruction 0), one in
    five replaced by a source the reference reads as 0: at the instruction
    itself, after it, at or past n, or below -1 (INT32_MIN included); the
    opcodes run from -9 to 9 (negative ones wrap, large ones clamp)."""
    i = np.arange(n)
    out = [rng.integers(-9, 10, size=n).astype(np.int32)]
    for _ in range(2):
        s = i - rng.choice(np.asarray(dists), size=n)
        pick = rng.random(n)
        s = np.where(pick < 0.05, i, s)
        s = np.where((pick >= 0.05) & (pick < 0.1),
                     i + rng.integers(1, 50, n), s)
        s = np.where((pick >= 0.1) & (pick < 0.15),
                     n + rng.integers(0, 5, n), s)
        s = np.where((pick >= 0.15) & (pick < 0.2), rng.choice(
            [-1, -2, -7, np.iinfo(np.int32).min], size=n), s)
        out.append(s.astype(np.int32))
    return tuple(out)


def _pe_kernel_edge_streams(rng):
    """Streams at the kernel's edges (kernels/pe_scoreboard.py's CHUNK,
    WINDOW, NEAR): sources at the register / ring boundary (NEAR, NEAR + 1)
    and at W - 1, W and W + 1 back in a stream longer than 2W; sources
    straddling every chunk boundary; n = 1, CHUNK and CHUNK + 1; each with
    forward and negative sources and negative opcodes."""
    ch, w, near = ps.CHUNK, ps.WINDOW, ps.NEAR
    window = [1, 2, near, near + 1, near + 2, w - 1, w, w + 1, w + near,
              w + near + 1, ch - 1, ch, ch + 1, 3 * ch + 1]
    straddle = list(range(1, 2 * ps.UNROLL + near + 1)) + [ch - 1, ch + 1]
    out = [_pe_edge_stream(rng, 2 * w + 3 * ch + 5, window),
           _pe_edge_stream(rng, 4 * ch + 7, straddle)]
    out += [_pe_edge_stream(rng, n, straddle) for n in (1, ch, ch + 1)]
    return out


def _pe_streams(rng):
    """Random streams (one past a staged chunk, one of several chunks), the
    kernel's edge streams, and compiled BLAS/LAPACK streams of every
    compiler form, the paper's dgeqrf at n = 100 among them (sources up to
    39,687 back, past the shared-memory ring)."""
    out = [_pe_random_stream(rng, n) for n in (1, 37, 1025, 5000)]
    out += _pe_kernel_edge_streams(rng)
    for s in (isa.compile_ddot(300, schedule="sequential"),
              isa.compile_ddot(300, dot4=True),
              isa.compile_ddot(300, fma=True),
              isa.compile_dgemm(16, 16, 16, unroll=4),
              isa.compile_dgemm(12, 12, 12, dot4=True),
              isa.compile_dgeqrf(24), isa.compile_dgetrf(24),
              isa.compile_dpotrf(24), isa.compile_dgeqrf(100)):
        out.append((s.opcode, s.src1, s.src2))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("configs", [1, 3, 8])
def test_pe_scoreboard_matches_plain_exactly(card, configs):
    """Every stream of _pe_streams, cycles and stalls exactly the plain
    version's; the latencies include negative ones and 0."""
    rng = np.random.default_rng(configs)
    for opcode, src1, src2 in _pe_streams(rng):
        lat = rng.integers(-5, 40, size=(configs, isa.N_OPCODES)).astype(
            np.int32)
        args = [torch.from_numpy(a) for a in (opcode, src1, src2, lat)]
        before = ps.pe_scoreboard.launches
        cycles, stalls = ps.pe_scoreboard(*(a.to(card) for a in args))
        assert ps.pe_scoreboard.launches == before + 1
        want_cycles, want_stalls = ps.pe_scoreboard_plain(*args)
        assert cycles.cpu().tolist() == want_cycles.tolist()
        assert stalls.cpu().tolist() == want_stalls.tolist()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_pe_sweeps_launch_once_each(card):
    """One B8 launch per simulate, sweep and sweep_joint, on the card by
    default, each equal to the CPU route's results."""
    s = isa.compile_dgeqrf(20)
    calls = [lambda **kw: [pe.simulate(s, {"add": 6}, **kw)],
             lambda **kw: pe.sweep(s, "add", [2, 4, 8, 16], **kw),
             lambda **kw: pe.sweep_joint(s, ["sqrt", "div"], [2, 4, 8, 16],
                                         **kw)]
    for call in calls:
        before = ps.pe_scoreboard.launches
        got = call()
        assert ps.pe_scoreboard.launches == before + 1
        assert got == call(device="cpu")


@pytest.mark.cuda
def test_pe_scoreboard_geometry_matches_kernel(card):
    """The wrapper's CHUNK / WINDOW / NEAR / UNROLL (which the edge streams
    are built from) are the kernel's, and its shared memory fits a CTA."""
    from repro_torch.kernels import _build
    geometry = _build.library("pe_scoreboard").repro_pe_scoreboard_geometry
    assert [geometry(k) for k in range(4)] == [ps.CHUNK, ps.WINDOW, ps.NEAR,
                                               ps.UNROLL]
    props = torch.cuda.get_device_properties(card)
    optin = getattr(props, "shared_memory_per_block_optin", 232448)
    assert ps.WINDOW * 4 < geometry(4) <= optin


@pytest.mark.cuda
def test_pe_scoreboard_refuses_empty_stream(card):
    empty = torch.zeros(0, dtype=torch.int32, device=card)
    lat = torch.ones((1, isa.N_OPCODES), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="empty stream"):
        ps.pe_scoreboard(empty, empty, empty, lat)


def _reduced_train_cfg(arch):
    """chip_smoke.py's reduced f32 train config (3 layers, d_model 256, 4
    heads, vocab 512; the hybrid's window 128 for the banded oracle)."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch.train import reduce_config
    cfg = dataclasses.replace(reduce_config(
        registry.get_config(arch), layers=3, d_model=256, vocab=512,
        heads=4), dtype="float32", accum_steps=1)
    return dataclasses.replace(cfg, window=128) if cfg.window else cfg


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "granite-3-8b"])
@pytest.mark.parametrize("eight_bit", [False, True])
def test_train_step_on_card_matches_cpu(card, arch, eight_bit):
    """Three train steps of one reduced state on the card and on the CPU
    (the plain oracles on both, TF32 off; no kernel launches): loss and
    grad norm within rtol 1e-5 (f32 sums in another order), the learning
    rate within 1e-6, the f32 run's parameters within 2e-4 at lr 5e-3
    (AdamW's normalization of near-zero gradients); the 8-bit codes after
    the first step at most 0.1 % apart, by one step at most, after the
    last at most 0.1 % apart (the parameters have moved apart by then)."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import model_zoo
    from repro_torch.train import optimizer
    from repro_torch.train import train_state as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _reduced_train_cfg(arch)
    opt = optimizer.AdamWConfig(lr=5e-3, warmup_steps=2, decay_steps=20,
                                eight_bit=eight_bit)
    data = DataConfig(vocab=cfg.vocab, global_batch=2, seq_len=1024)
    cpu = ts.init_state(torch.Generator().manual_seed(0), cfg, opt, "cpu")
    model = model_zoo.build(cfg, card)
    model.load_state_dict(cpu["params"].state_dict())
    gpu = ts.state_for(model, opt)
    step = ts.make_train_step(cfg, opt)
    def codes_apart():
        off = torch.cat([(g.q.cpu().int() - cpu["opt"][mom][k].q.int())
                         .abs().reshape(-1) for mom in ("m", "v")
                         for k, g in gpu["opt"][mom].items()])
        return off.max().item(), (off > 0).float().mean().item()

    fa.attention.launches = sk.ssd_scan.launches = 0
    for i in range(3):
        batch = make_batch(cfg, data, i, device="cpu")
        gpu, got = step(gpu, {k: v.to(card) for k, v in batch.items()})
        cpu, want = step(cpu, batch)
        for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-5), ("lr", 1e-6)):
            assert got[k].item() == pytest.approx(want[k].item(),
                                                  rel=rtol), (i, k)
        if eight_bit and i == 0:
            worst, share = codes_apart()
            assert worst <= 1 and share <= 1e-3, (worst, share)
    assert fa.attention.launches == sk.ssd_scan.launches == 0
    if eight_bit:
        assert codes_apart()[1] <= 1e-3
        return
    for a, b in zip(gpu["params"].parameters(), cpu["params"].parameters()):
        assert (a.detach().cpu() - b.detach()).abs().max() <= 2e-4


@pytest.mark.cuda
def test_train_forward_with_kernels_refuses_grads(card):
    """On the card a recording forward must ask for the plain route: the
    kernels have no backward."""
    from repro_torch.models import model_zoo
    cfg = _reduced_train_cfg("hymba-1.5b")
    model = model_zoo.init(cfg, device=card)
    tokens = torch.zeros((1, 64), dtype=torch.int64, device=card)
    logits, _ = model_zoo.forward(model, {"tokens": tokens}, cfg)
    assert not logits.requires_grad
    model.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        model_zoo.forward(model, {"tokens": tokens}, cfg)
    logits, _ = model_zoo.forward(model, {"tokens": tokens}, cfg,
                                  use_kernels=False)
    assert logits.requires_grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_one_rank_nccl_pdgemm_is_gemm(card, tmp_path, dtype):
    """A (1, 1) mesh on a one-rank NCCL group: ``linalg.gemm`` under
    ``use(mesh=(1, 1))`` runs SUMMA's one step - zero hops, one B1 launch
    at the single-device plan - and equals the single-device ``gemm``
    bitwise; a multi-rank NCCL leg needs a card per rank."""
    import torch.distributed as dist
    from repro_torch import linalg
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        g = torch.Generator(device="cuda").manual_seed(0)
        dt = getattr(torch, dtype)
        a = torch.randn((1000, 777), generator=g, device="cuda", dtype=dt)
        b = torch.randn((777, 900), generator=g, device="cuda", dtype=dt)
        with linalg.use(policy="model"):
            want = linalg.gemm(a, b)
        gk.reset_launches(gk.gemm)
        with linalg.use(policy="model", mesh=(1, 1)):
            got = linalg.gemm(a, b)
        torch.cuda.synchronize()
        assert gk.gemm.launches == 1
        assert torch.equal(got, want)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "whisper-small"])
def test_prefill_plain_route_launches_no_kernel(card, arch):
    """``model_zoo.prefill(..., use_kernels=False)`` (the reference's
    ``use_pallas=False``, the dry run's route) launches no B5 and no B6
    on a reduced hymba and whisper, and gives the plain route's logits
    (the CPU's, TF32 off) where the default route launches its kernels."""
    from repro_torch.models import model_zoo

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _reduced_train_cfg(arch)
    model = model_zoo.init(cfg, device=card)
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 256), generator=g,
                                     device=card)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, cfg.encoder_seq, cfg.d_model),
                                      generator=g, device=card)
    fa.attention.launches = sk.ssd_scan.launches = 0
    model_zoo.prefill(model, batch, cfg)
    torch.cuda.synchronize()
    assert fa.attention.launches > 0
    assert (sk.ssd_scan.launches > 0) == (cfg.family == "hybrid")
    fa.attention.launches = sk.ssd_scan.launches = 0
    plain = model_zoo.prefill(model, batch, cfg, use_kernels=False)[0]
    torch.cuda.synchronize()
    assert fa.attention.launches == 0 and sk.ssd_scan.launches == 0
    cpu = model_zoo.build(cfg, "cpu")
    cpu.load_state_dict(model.state_dict())
    want = model_zoo.prefill(cpu, {k: v.cpu() for k, v in batch.items()},
                             cfg)[0]
    _close(plain, want, "float32", 10.0)


# ------------------------- the batch axis (B1, B2) --------------------------

# (items, m, k, n, dtype, variant): the tiled variants at ragged shapes (m
# not a multiple of the tile), "gemv" at a TRSM update, "simt" at m <= 16
BATCHED_GEMM_CASES = [(5, 200, 96, 160, "float32", "ffma"),
                      (5, 200, 96, 160, "float64", "dmma"),
                      (3, 130, 300, 8, "float32", "gemv"),
                      (3, 130, 1000, 4, "float64", "gemv"),
                      (4, 12, 40, 70, "float32", "simt")]


@pytest.mark.cuda
@pytest.mark.parametrize("items,m,k,n,dtype,variant", BATCHED_GEMM_CASES)
def test_batched_gemm_is_bitwise_the_2d_launch_per_item(card, items, m, k,
                                                        n, dtype, variant):
    """One launch for the batch; A a row window of taller items (so a
    tile past m would read the item's own next rows, never zeros, were
    the batch not its own TMA axis); each item bitwise the 2-D launch on
    it and close to the plain version; a 2-D B broadcast too."""
    g = torch.Generator(device="cuda").manual_seed(1)
    tdt = getattr(torch, dtype)
    tall = torch.randn(items, m + 48, k, generator=g, device=card).to(tdt)
    a = tall[:, 16:16 + m]
    b = torch.randn(items, k, n, generator=g, device=card).to(tdt)
    for bb in (b, b[0]):
        before = gk.gemm.launches
        got = gk.gemm(a, bb)
        assert gk.gemm.launches == before + 1
        assert gk.gemm.last_launch["variant"] == variant
        _close(got, gk.gemm_plain(a, bb), dtype, 4.0)
        for i in range(items):
            want = gk.gemm(a[i], bb if bb.ndim == 2 else bb[i])
            assert gk.gemm.last_launch["variant"] == variant
            assert torch.equal(got[i], want), (variant, i)
    torch.cuda.synchronize()


# (items, m, k, n, output dtype, tile) of the batched "wgmma" (bf16 on the
# tensor cores): both compiled tiles, both output dtypes, m and n ragged
# against the tile, k ragged against its 64-deep stage
BATCHED_WGMMA_CASES = [(5, 200, 96, 264, "bfloat16", (128, 256, 64)),
                       (5, 200, 96, 264, "float32", (128, 256, 64)),
                       (4, 130, 200, 136, "bfloat16", (128, 128, 64)),
                       (4, 130, 200, 136, "float32", (128, 128, 64))]


def _wgmma_operands(card, items, m, k, n, seed):
    """A as row windows of taller items (a tile past m would read the
    item's own next rows, never zeros, were the batch not its own TMA
    axis), B a batch, both bf16."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    tall = torch.randn(items, m + 48, k, generator=g, device=card)
    a = tall.to(torch.bfloat16)[:, 16:16 + m]
    b = torch.randn(items, k, n, generator=g, device=card).to(torch.bfloat16)
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("items,m,k,n,out,tile", BATCHED_WGMMA_CASES)
def test_batched_wgmma_is_bitwise_the_2d_launch_per_item(card, items, m, k,
                                                        n, out, tile):
    """A batched bf16 product is one "wgmma" launch at the plan's tile,
    through 3-D TMA maps: A a batch of row windows, or a 2-D A broadcast;
    B a batch, or a 2-D B broadcast. Each item bitwise the 2-D launch on
    it, and close to the plain version."""
    a, b = _wgmma_operands(card, items, m, k, n, 2)
    odt = getattr(torch, out)
    plan = cd.plan_from_blocks(m, n, k, *tile, dtype=torch.bfloat16,
                               machine="h100")
    for aa, bb in ((a, b), (a, b[1]), (a[2], b)):
        before = gk.gemm.variant_launches["wgmma"]
        got = gk.gemm(aa, bb, plan=plan, out_dtype=odt)
        assert gk.gemm.variant_launches["wgmma"] == before + 1
        assert gk.gemm.last_launch["tile"] == tile
        _close(got, gk.gemm_plain(aa, bb, odt), out, 4.0)
        for i in range(items):
            want = gk.gemm(aa if aa.ndim == 2 else aa[i],
                           bb if bb.ndim == 2 else bb[i], plan=plan,
                           out_dtype=odt)
            assert gk.gemm.last_launch["variant"] == "wgmma"
            assert torch.equal(got[i], want), (aa.ndim, bb.ndim, i)
    torch.cuda.synchronize()


# (items, m, k, n, dtype, variant) of the batched B3: the tiled variants
# and "simt" (m <= 16), ragged against their tiles
BATCHED_B3_CASES = [(5, 200, 96, 264, "bfloat16", "wgmma"),
                    (5, 200, 96, 160, "float32", "ffma"),
                    (5, 200, 96, 160, "float64", "dmma"),
                    (4, 12, 40, 70, "float32", "simt")]


@pytest.mark.cuda
@pytest.mark.parametrize("items,m,k,n,dtype,variant", BATCHED_B3_CASES)
def test_batched_gemm_bias_act_is_bitwise_the_2d_launch_per_item(
        card, items, m, k, n, dtype, variant):
    """B3 over a batch, one length-n bias for every item: one launch, A a
    batch of row windows or a 2-D A broadcast, B a batch or a 2-D B
    broadcast, each epilogue; each item bitwise the 2-D launch on it, and
    close to the plain version."""
    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    tall = torch.randn(items, m + 48, k, generator=g, device=card).to(tdt)
    a = tall[:, 16:16 + m]
    b = torch.randn(items, k, n, generator=g, device=card).to(tdt)
    bias = torch.randn(n, generator=g, device=card).to(tdt)
    for epilogue, bb, aa in (("gelu", b, a), ("relu", b[1], a),
                             ("none", b, a[3])):
        before = fk.gemm_bias_act.launches
        got = fk.gemm_bias_act(aa, bb, bias, epilogue)
        assert fk.gemm_bias_act.launches == before + 1
        assert fk.gemm_bias_act.last_launch["variant"] == variant
        _close(got, fk.gemm_bias_act_plain(aa, bb, bias, epilogue), dtype,
               4.0)
        for i in range(items):
            want = fk.gemm_bias_act(aa if aa.ndim == 2 else aa[i],
                                    bb if bb.ndim == 2 else bb[i], bias,
                                    epilogue)
            assert torch.equal(got[i], want), (epilogue, i)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_tiled_gemm_instantiations_use_no_local_memory(card):
    """Every compiled tile of the tiled variants, 2-D and batched, each
    output dtype: no local memory (the batched "wgmma" added four
    instantiations; the others had none before it either)."""
    got = {}
    for dtype, outs in ((torch.bfloat16, (torch.bfloat16, torch.float32)),
                        (torch.float32, (torch.float32,)),
                        (torch.float64, (torch.float64,))):
        variant = gk.TILED[dtype]
        for tile in gk.TILE_SETS[variant]:
            for out in outs:
                for batched in (False, True):
                    got[variant, tile, out, batched] = gk.attributes(
                        variant, tile, out, batched)
    print("\n" + "\n".join(f"{k}: {v[0]} registers" for k, v in got.items()))
    assert not {k: v for k, v in got.items() if v[1] != 0}, got


# (dtype, items, nb, n', forms) of the batched B2: the drivers' views in
# f32, f64 and bf16; a batch whose tasks exceed the grid many times; nb not
# a multiple of 16; n' < 128; L11 too large to stage (read through the
# cache, 64- and 32-column X blocks); the solve alone (lu at m = 0)
BATCHED_TRSM_CASES = [
    ("float32", 6, 64, 200, ("syrk", "lu")),
    ("float64", 6, 64, 200, ("syrk", "lu")),
    ("bfloat16", 6, 64, 200, ("syrk", "lu")),
    ("float32", 300, 32, 40, ("syrk", "lu")),
    ("float32", 5, 50, 200, ("syrk", "lu")),
    ("float32", 4, 64, 100, ("syrk", "lu")),
    ("float32", 3, 300, 150, ("syrk", "lu")),
    ("float32", 2, 1000, 60, ("syrk", "lu")),
    ("float32", 6, 64, 200, ("lu m=0",)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,items,nb,n,forms", BATCHED_TRSM_CASES)
def test_batched_trsm_gemm_is_bitwise_the_2d_launch_per_item(card, dtype,
                                                             items, nb, n,
                                                             forms):
    """B2 on the batched drivers' views (a batch of windows), one launch
    for the batch, each item bitwise the 2-D launch on it."""
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.normal(size=(items, nb + n, nb + n))).to(
        card, getattr(torch, dtype))
    a[:, :nb, :nb] = torch.from_numpy(
        np.tril(rng.normal(size=(items, nb, nb)), -1) / nb
        + np.eye(nb) * (1 + rng.uniform(size=(items, 1, nb)))).to(a)
    views = {"syrk": (a[:, :nb, :nb], a[:, nb:, :nb].mT, None,
                      a[:, nb:, nb:]),
             "lu": (a[:, :nb, :nb], a[:, :nb, nb:], a[:, nb:, :nb],
                    a[:, nb:, nb:]),
             "lu m=0": (a[:, :nb, :nb], a[:, :nb, nb:], a[:, nb:nb, :nb],
                        a[:, nb:nb, nb:])}
    for name in forms:
        form = name.split()[0]
        unit = form == "lu"
        before = fk.trsm_gemm.launches
        x, c = fk.trsm_gemm(*views[name], form=form, unit_diag=unit)
        assert fk.trsm_gemm.launches == before + 1
        assert fk.trsm_gemm.last_launch["plan"] == \
            fk.trsm_gemm_batched_plan(getattr(torch, dtype), nb, form)
        xp, cp = fk.trsm_gemm_plain(*views[name], form=form, unit_diag=unit)
        _close(x, xp, dtype, 4.0)
        _close(c, cp, dtype, 8.0)
        for i in range(items):
            xi, ci = fk.trsm_gemm(*(None if v is None else v[i]
                                    for v in views[name]), form=form,
                                  unit_diag=unit)
            assert torch.equal(x[i], xi) and torch.equal(c[i], ci), (name, i)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_batched_trsm_gemm_uses_no_local_memory(card, dtype):
    """Every instantiation of the batched B2 keeps its parameters and
    operands' addresses in registers (no per-task copy in local memory),
    and each B2 kernel's registers are the Python occupancy table's."""
    tdt = getattr(torch, dtype)
    regs, local = fk.trsm_gemm_attributes(tdt)
    assert regs == fk.TRSM_GEMM_REGISTERS[tdt]
    got = {}
    for width, l_smem in fk.TRSM_GEMM_BATCHED_WIDTHS:
        for a_operand in ("X^T", "BL"):
            plan = fk.TrsmGemmPlan(width, l_smem, 128, 0, "", a_operand)
            got[width, l_smem, a_operand] = \
                fk.trsm_gemm_attributes(tdt, plan), \
                fk.trsm_gemm_registers(tdt, plan)
    bad = {k: v for k, v in got.items() if v[0][1] != 0 or v[0][0] != v[1]}
    assert not bad, bad


# ------------------- the 3-D linalg BLAS calls in lockstep -------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_linalg_3d_blas_is_one_launch_per_step_bitwise_per_item(card,
                                                                dtype):
    """``linalg.gemm`` / ``gemm_bias_act`` / ``syrk`` / ``gemv`` on a batch:
    one B1 or B3 launch for the batch, each item bitwise the 2-D call on
    it; ``trsm``: one B1 launch per off-diagonal block update for the
    batch, each item within the dtype's tolerance of the 2-D call (its
    diagonal blocks are eager PyTorch, whose batched products may sum in
    another order than the 2-D ones)."""
    from repro_torch import linalg

    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(4)
    rnd = lambda *s: torch.randn(*s, generator=g, device=card).to(tdt)
    items, m, k, n = 6, 200, 96, 160
    a, b, bias, x = rnd(items, m, k), rnd(items, k, n), rnd(n), rnd(items, k)
    nt, nrhs, block = 192, 32, 64
    t = (torch.randn(items, nt, nt, generator=g, device=card).tril() / nt
         + 2 * torch.eye(nt, device=card)).to(tdt)
    r = rnd(items, nt, nrhs)
    calls = {
        "gemm": (lambda *o: linalg.gemm(*o), (a, b), gk.gemm, 1),
        "gemm_bias_act": (lambda *o: linalg.gemm_bias_act(*o, "gelu"),
                          (a, b, bias), fk.gemm_bias_act, 1),
        "syrk": (lambda *o: linalg.syrk(*o), (a,), gk.gemm, 1),
        "gemv": (lambda *o: linalg.gemv(*o), (a, x), gk.gemm, 1),
        "trsm": (lambda *o: linalg.trsm(*o, block=block), (t, r), gk.gemm,
                 -(-nt // block) - 1),
    }
    with linalg.use(policy="model", device="cuda"):
        for name, (call, ops, wrapper, launches) in calls.items():
            before = wrapper.launches
            got = call(*ops)
            assert wrapper.launches == before + launches, name
            for i in range(items):
                want = call(*(o if o.ndim == 1 else o[i] for o in ops))
                if name == "trsm":
                    _close(got[i], want, dtype, 8.0)
                else:
                    assert torch.equal(got[i], want), (name, i)
    torch.cuda.synchronize()
