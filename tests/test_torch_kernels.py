"""Kernels B1-B3 of repro_torch against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain version; these tests hold it to
``repro.kernels.gemm.gemm`` and ``repro.kernels.fused.{gemm_bias_act,
trsm_gemm}`` run in interpret mode, on the same numpy inputs (bfloat16
inputs are the same rounded bits on both sides), within the dtype
tolerances of ``tests/conftest.py``. The float64 legs (kernels and linalg)
run in one ``JAX_ENABLE_X64`` subprocess. The CUDA kernels themselves are
held to these plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dtype_tolerances
from repro.core import codesign as jcd
from repro.kernels import fused as jfk
from repro.kernels.gemm import gemm as jgemm
from repro_torch.core import codesign as tcd
from repro_torch.kernels import fused as tfk
from repro_torch.kernels import gemm as tgk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ["float32", "bfloat16"]
GEMM_SHAPES = [(1, 1, 1), (7, 129, 33), (130, 64, 40)]
# (nb, n, m): ragged panel widths and trailing blocks
TRSM_GEMM_SHAPES = [(13, 130, 70), (16, 48, 40)]


def _both(x: np.ndarray, dtype: str):
    """One float32 numpy array as (jax array, torch tensor) of ``dtype``
    holding the same values."""
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _close(got: torch.Tensor, want, scale=1.0, msg=""):
    rtol, atol = dtype_tolerances(str(got.dtype).removeprefix("torch."),
                                  scale)
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want.astype(jnp.float32),
                                          np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _lower(rng, nb):
    """A well-conditioned lower triangle (substitution stays bounded)."""
    return (np.tril(rng.normal(size=(nb, nb)), -1) / nb
            + np.diag(1.0 + rng.uniform(size=nb))).astype(np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gemm_matches_pallas(rng, dtype):
    for m, n, k in GEMM_SHAPES:
        ja, ta = _both(rng.normal(size=(m, k)).astype(np.float32), dtype)
        jb, tb = _both(rng.normal(size=(k, n)).astype(np.float32), dtype)
        want = jgemm(ja, jb, interpret=True)
        got = tgk.gemm(ta, tb)
        assert got.dtype == ta.dtype and got.shape == (m, n)
        _close(got, want, scale=4.0, msg=f"{m}x{n}x{k}")
        # transposed views read in place give the same product
        _close(tgk.gemm(ta.T.contiguous().T, tb.T.contiguous().T), want,
               scale=4.0)
    if dtype == "bfloat16":
        assert tgk.gemm(ta, tb, out_dtype=torch.float32).dtype == torch.float32


def test_gemm_records_plan_and_counts(rng):
    """Port of test_gemm_kernel_uses_plan: the wrapper records the plan it
    was handed beside its CTA tile; the CPU route launches nothing, so the
    launch count stays put."""
    plan = tcd.plan_gemm(256, 256, 256, dtype_bytes=4)
    ja, ta = _both(rng.normal(size=(256, 256)).astype(np.float32), "float32")
    jb, tb = _both(rng.normal(size=(256, 256)).astype(np.float32), "float32")
    before = tgk.gemm.launches
    got = tgk.gemm(ta, tb, plan=plan)
    assert tgk.gemm.launches == before
    assert tgk.gemm.last_launch["plan"] is plan
    assert tgk.gemm.last_launch["device"] == "cpu"
    variant = tgk.gemm.last_launch["variant"]
    assert variant == tgk.gemm_variant(ta, tb) == "ffma"
    assert tgk.gemm.last_launch["tile"] == tgk.TILES[variant]
    want = jgemm(ja, jb, plan=jcd.plan_gemm(256, 256, 256, dtype_bytes=4),
                 interpret=True)
    _close(got, want, scale=4.0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("epilogue", tfk.EPILOGUES)
def test_gemm_bias_act_matches_pallas(rng, dtype, epilogue):
    assert tfk.EPILOGUES == jfk.EPILOGUES
    for m, n, k in GEMM_SHAPES[2:]:
        ja, ta = _both(rng.normal(size=(m, k)).astype(np.float32), dtype)
        jb, tb = _both(rng.normal(size=(k, n)).astype(np.float32), dtype)
        jbias, tbias = _both(rng.normal(size=(n,)).astype(np.float32), dtype)
        for use_bias in (False, True):
            want = jfk.gemm_bias_act(ja, jb, jbias if use_bias else None,
                                     epilogue=epilogue, interpret=True)
            got = tfk.gemm_bias_act(ta, tb, tbias if use_bias else None,
                                    epilogue=epilogue)
            assert got.dtype == ta.dtype
            _close(got, want, scale=4.0,
                   msg=f"{m}x{n}x{k} {epilogue} bias={use_bias}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ["lu", "syrk"])
@pytest.mark.parametrize("unit_diag", [False, True])
def test_trsm_gemm_matches_pallas(rng, dtype, form, unit_diag):
    for nb, n, m in TRSM_GEMM_SHAPES:
        m = n if form == "syrk" else m
        jl, tl = _both(_lower(rng, nb), dtype)
        jap, tap = _both(rng.normal(size=(nb, n)).astype(np.float32), dtype)
        jc, tc = _both(rng.normal(size=(m, n)).astype(np.float32), dtype)
        jbl, tbl = (None, None) if form == "syrk" else _both(
            rng.normal(size=(m, nb)).astype(np.float32), dtype)
        jx, jco = jfk.trsm_gemm(jl, jap, jbl, jc, form=form,
                                unit_diag=unit_diag, interpret=True)
        tx, tco = tfk.trsm_gemm(tl, tap, tbl, tc, form=form,
                                unit_diag=unit_diag)
        tag = f"nb={nb} n={n} m={m} {form} unit={unit_diag}"
        assert tx.shape == (nb, n) and tco.shape == (m, n)
        _close(tx, jx, scale=4.0, msg="x " + tag)
        _close(tco, jco, scale=8.0, msg="c " + tag)


def test_trsm_gemm_reads_strided_views(rng):
    """The blocked Cholesky passes transposed, sliced views of one matrix."""
    a = torch.from_numpy(rng.normal(size=(40, 40)).astype(np.float32))
    a[:8, :8] = torch.from_numpy(_lower(rng, 8))
    views = (a[:8, :8], a[8:, :8].T, None, a[8:, 8:])
    x, c = tfk.trsm_gemm(*views, form="syrk")
    xc, cc = tfk.trsm_gemm(*(None if v is None else v.contiguous()
                             for v in views), form="syrk")
    rtol, atol = dtype_tolerances(np.float32)
    torch.testing.assert_close(x, xc, rtol=rtol, atol=atol)
    torch.testing.assert_close(c, cc, rtol=rtol, atol=atol)


def test_wrappers_validate(rng):
    t = torch.ones((4, 4))
    with pytest.raises(ValueError, match="epilogue"):
        tfk.gemm_bias_act(t, t, epilogue="swish")
    with pytest.raises(ValueError, match=r"\(m, k\) @ \(k, n\)"):
        tgk.gemm(t, torch.ones((3, 4)))
    with pytest.raises(ValueError, match="stores"):
        tgk.gemm(t, t, out_dtype=torch.float64)
    with pytest.raises(ValueError, match="runs on cuda"):
        tgk.gemm(t.to("meta"), t.to("meta"))
    with pytest.raises(ValueError, match="b_left=None"):
        tfk.trsm_gemm(t, t, t, t, form="syrk")
    with pytest.raises(ValueError, match="form"):
        tfk.trsm_gemm(t, t, t, t, form="qr")


# ---------------------------- float64 (x64 JAX) -----------------------------

_X64 = textwrap.dedent("""
import sys
sys.path.insert(0, "tests")
from conftest import dtype_tolerances
import numpy as np
import jax.numpy as jnp
import torch
from repro import linalg as jl
from repro.kernels import fused as jfk
from repro.kernels.gemm import gemm as jgemm
from repro_torch import linalg as tl
from repro_torch.kernels import fused as tfk
from repro_torch.kernels import gemm as tgk

def close(got, want, scale=1.0, msg=""):
    assert got.dtype == torch.float64, got.dtype
    rtol, atol = dtype_tolerances(np.float64, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)

rng = np.random.default_rng(0)
a, b = rng.normal(size=(70, 33)), rng.normal(size=(33, 129))
bias = rng.normal(size=(129,))
ta, tb, tbias = map(torch.from_numpy, (a, b, bias))
close(tgk.gemm(ta, tb), jgemm(jnp.asarray(a), jnp.asarray(b), interpret=True),
      msg="gemm")
close(tfk.gemm_bias_act(ta, tb, tbias, "gelu"),
      jfk.gemm_bias_act(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias),
                        "gelu", interpret=True), msg="gemm_bias_act")
nb, n = 13, 70
l = np.tril(rng.normal(size=(nb, nb)), -1) / nb + np.diag(1 + rng.uniform(size=nb))
ap, c, bl = rng.normal(size=(nb, n)), rng.normal(size=(n, n)), rng.normal(size=(n, nb))
# the two forms as the drivers use them: potrf (syrk, non-unit), getrf (lu, unit)
for form, blt, unit in (("syrk", None, False), ("lu", bl, True)):
    jx, jc = jfk.trsm_gemm(*(None if v is None else jnp.asarray(v)
                             for v in (l, ap, blt, c)), form=form,
                           unit_diag=unit, interpret=True)
    tx, tc = tfk.trsm_gemm(*(None if v is None else torch.from_numpy(v)
                             for v in (l, ap, blt, c)), form=form,
                           unit_diag=unit)
    close(tx, jx, 4.0, f"x {form}")
    close(tc, jc, 8.0, f"c {form}")
g = rng.normal(size=(40, 40))
spd = g @ g.T + 40 * np.eye(40)
rhs = rng.normal(size=(40, 3))
with jl.use(policy="model"), tl.use(policy="model", device="cpu"):
    close(tl.cholesky(spd, block=16), jl.cholesky(spd, block=16), 64.0,
          "cholesky")
    tp, tpiv = tl.lu(spd, block=16)
    jp, jpiv = jl.lu(spd, block=16)
    close(tp, jp, 64.0, "lu")
    assert tpiv.dtype == torch.int32
    assert np.array_equal(tpiv.numpy(), np.asarray(jpiv))
    close(tl.solve(spd, rhs, block=16), jl.solve(spd, rhs, block=16), 256.0,
          "solve")
print("x64 legs OK")
""")


def test_float64_legs_against_x64_jax():
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", _X64], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert "x64 legs OK" in r.stdout


# (rows, cols, row stride, column stride, storage offset) of operand views
_ALIGNED = (64, 96, 96, 1, 0)


def _view(dtype, rows, cols, s0, s1, off):
    base = torch.zeros(off + rows * s0 + cols * s1 + 8, dtype=dtype)
    return base.as_strided((rows, cols), (s0, s1), off)


_VARIANT_CASES = [
    (_ALIGNED, (96, 80, 80, 1, 0), "tiled"),            # row-major
    (_ALIGNED, (96, 80, 128, 1, 64), "tiled"),          # aligned window
    ((64, 96, 1, 64, 0), (96, 80, 80, 1, 0), "simt"),   # transposed A
    (_ALIGNED, (96, 80, 1, 96, 0), "simt"),             # transposed B
    (_ALIGNED, (96, 80, 81, 1, 0), "simt"),             # row stride off 16 B
    (_ALIGNED, (96, 80, 96, 1, 3), "simt"),             # base off 16 B
    (_ALIGNED, (96, 16, 16, 1, 0), "gemv"),             # skinny n
    ((16, 96, 96, 1, 0), (96, 80, 80, 1, 0), "simt"),   # skinny m
    ((64, 0, 8, 1, 0), (0, 80, 80, 1, 0), "simt"),      # empty k
    # the blocked TRSM's update a[i0:i1, :i0] @ x[:i0] (a window of the
    # factor, one right-hand side; three)
    ((128, 384, 512, 1, 384 * 512), (384, 1, 1, 1, 0), "gemv"),
    ((128, 384, 512, 1, 384 * 512), (384, 3, 3, 1, 0), "gemv"),
    ((64, 96, 1, 64, 0), (96, 1, 1, 1, 0), "simt"),     # skinny n, A^T
    ((64, 7, 7, 1, 1), (7, 3, 1, 7, 0), "gemv"),        # unaligned rows
    ((16, 96, 96, 1, 0), (96, 1, 1, 1, 0), "simt"),     # skinny m and n
]


def _case_id(i, case):
    """a_layout{i}-b_layout{i}-{expect}; the first nine cases keep the ids
    they had when the expectation was a tiled / not-tiled flag."""
    if i < 9:
        return f"a_layout{i}-b_layout{i}-{case[2] == 'tiled'}"
    return f"a_layout{i}-b_layout{i}-{case[2]}"


@pytest.mark.parametrize("dtype,variant", [
    (torch.bfloat16, "wgmma"), (torch.float32, "ffma"),
    (torch.float64, "dmma")])
@pytest.mark.parametrize("a_layout,b_layout,expect", _VARIANT_CASES,
                         ids=[_case_id(i, c) for i, c in
                              enumerate(_VARIANT_CASES)])
def test_gemm_variant_choice(dtype, variant, a_layout, b_layout, expect):
    """gemm_variant is a pure function of dtype, shape and layout:
    "gemv" for n <= SKINNY < m with A's column stride 1 (aligned or not:
    the kernel picks its loads), the dtype's tiled variant for 16-byte
    aligned row-major operands, "simt" for transposed, misaligned, skinny-m
    or empty-k ones. The wrapper records the choice and its tile, the CPU
    result is the plain one, and the CPU route counts no launch of any
    variant."""
    a, b = _view(dtype, *a_layout), _view(dtype, *b_layout)
    want = variant if expect == "tiled" else expect
    assert tgk.gemm_variant(a, b) == want
    before = (tgk.gemm.launches, dict(tgk.gemm.variant_launches),
              tfk.gemm_bias_act.launches,
              dict(tfk.gemm_bias_act.variant_launches))
    got = tgk.gemm(a, b)
    assert tgk.gemm.last_launch["variant"] == want
    assert tgk.gemm.last_launch["tile"] == tgk.TILES[want]
    assert tgk.gemm.last_launch["device"] == "cpu"
    assert torch.equal(got, tgk.gemm_plain(a, b))
    bias = torch.zeros(b.shape[1], dtype=dtype)
    tfk.gemm_bias_act(a, b, bias, "relu")
    assert tfk.gemm_bias_act.last_launch["variant"] == want
    assert tfk.gemm_bias_act.last_launch["tile"] == tgk.TILES[want]
    assert (tgk.gemm.launches, tgk.gemm.variant_launches,
            tfk.gemm_bias_act.launches,
            tfk.gemm_bias_act.variant_launches) == before


def test_gemm_variant_table():
    """Every dtype the kernel takes has a tiled variant with a tile, and
    the variant codes match csrc/gemm.cu's Variant enum order ("gemv",
    the fifth, has its own entry point)."""
    assert tgk.VARIANTS == ("simt", "wgmma", "ffma", "dmma", "gemv")
    assert set(tgk.TILED) == set(tgk.DTYPE_CODES)
    assert set(tgk.TILES) == set(tgk.VARIANTS)
    assert tgk.TILES["wgmma"] == (128, 256, 64)
    assert tgk.TILES["gemv"][1] == tgk.SKINNY


@pytest.mark.parametrize("m,k,sms,want", [
    (128, 8064, 132, (32, 256)),      # the 8192 solve's first TRSM update
    (128, 128, 132, (1, 256)),        # its last: one chunk, one segment
    (128, 7, 132, (1, 256)),
    (8192, 8192, 132, (2, 4096)),     # linalg.gemv at 8192
    (20000, 8192, 132, (1, 8192)),    # the row groups alone fill the card
    (37, 100000, 132, (131, 768)),
    (1000, 3000, 8, (1, 3072)),
])
def test_gemv_split(m, k, sms, want):
    """gemv_split is a pure function: whole 256-deep chunks per segment,
    segments x row groups near GEMV_CTAS_PER_SM per SM, the segments
    covering k exactly once."""
    segs, ks = tgk.gemv_split(m, k, sms)
    assert (segs, ks) == want
    bm, _, kc = tgk.TILES["gemv"]
    assert ks % kc == 0 and (segs - 1) * ks < k <= segs * ks
    if segs > 1:
        assert segs * -(-m // bm) <= tgk.GEMV_CTAS_PER_SM * sms + -(-m // bm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("nb", [100, 128, 2000])
@pytest.mark.parametrize("form", ["syrk", "lu"])
def test_trsm_gemm_plan(dtype, nb, form):
    """B2's phase widths are a pure function of (dtype, nb, form): the
    widest solve block that fits the shared memory, L11 beside it when it
    still fits, K padded to the update's depth, the update on FFMA (f32,
    bf16) or mma.sync (f64); and the grid never exceeds the co-resident
    CTAs nor the larger phase's tasks."""
    plan = tfk.trsm_gemm_plan(dtype, nb, form)
    assert plan == tfk.trsm_gemm_plan(dtype, nb, form)
    acc = 8 if dtype == torch.float64 else 4
    want_width = {(100, 4): 32, (128, 4): 32, (2000, 4): 16,
                  (100, 8): 32, (128, 8): 32, (2000, 8): 8}[(nb, acc)]
    assert plan.width == want_width
    assert plan.l_in_smem == (nb != 2000)
    assert plan.nb_padded == {100: 112, 128: 128, 2000: 2000}[nb]
    assert plan.nb_padded % tfk.TRSM_GEMM_TILE[2] == 0
    assert plan.smem_bytes <= tfk.SMEM_LIMIT
    if plan.width < tfk.TRSM_GEMM_WIDTHS[0]:       # the next width is over
        wider = tfk.TRSM_GEMM_WIDTHS[tfk.TRSM_GEMM_WIDTHS.index(plan.width)
                                     - 1]
        assert (plan.nb_padded * (wider + 1)) * acc > tfk.SMEM_LIMIT
    assert plan.update == ("dmma" if dtype == torch.float64 else "ffma")
    assert plan.a_operand == ("X^T" if form == "syrk" else "BL")
    n = 8064 if nb == 128 else 40
    m = n if form == "syrk" else n - 37
    grid = tfk.trsm_gemm_grid(264, plan, m, n, form)
    solve = -(-n // 128) * 128 // plan.width
    assert 1 <= grid <= 264
    assert grid == min(264, max(solve + (0 if form == "syrk" else
                                         -(-plan.nb_padded // 32)
                                         * (-(-m // 128) * 128 // 32)),
                                -(-m // 128) * -(-n // 128)))
    assert tfk.trsm_gemm_grid(264, plan, 0, n, form) >= 1     # m == 0


def test_trsm_gemm_plan_refuses_huge_panels():
    with pytest.raises(ValueError, match="panel width"):
        tfk.trsm_gemm_plan(torch.float64, 20000, "syrk")
