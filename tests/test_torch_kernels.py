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


@pytest.mark.parametrize("dtype,variant", [
    (torch.bfloat16, "wgmma"), (torch.float32, "ffma"),
    (torch.float64, "dmma")])
@pytest.mark.parametrize("a_layout,b_layout,tiled", [
    (_ALIGNED, (96, 80, 80, 1, 0), True),            # row-major
    (_ALIGNED, (96, 80, 128, 1, 64), True),          # aligned window
    ((64, 96, 1, 64, 0), (96, 80, 80, 1, 0), False),  # transposed A
    (_ALIGNED, (96, 80, 1, 96, 0), False),           # transposed B
    (_ALIGNED, (96, 80, 81, 1, 0), False),           # row stride off 16 B
    (_ALIGNED, (96, 80, 96, 1, 3), False),           # base off 16 B
    (_ALIGNED, (96, 16, 16, 1, 0), False),           # skinny n
    ((16, 96, 96, 1, 0), (96, 80, 80, 1, 0), False),  # skinny m
    ((64, 0, 8, 1, 0), (0, 80, 80, 1, 0), False),    # empty k
])
def test_gemm_variant_choice(dtype, variant, a_layout, b_layout, tiled):
    """gemm_variant is a pure function of dtype, shape and layout: the
    dtype's tiled variant for 16-byte aligned row-major operands, "simt"
    for transposed, misaligned, skinny or empty-k ones. The wrapper
    records the choice and its tile, the CPU result is the plain one, and
    the CPU route counts no launch of any variant."""
    a, b = _view(dtype, *a_layout), _view(dtype, *b_layout)
    want = variant if tiled else "simt"
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
    the variant codes match csrc/gemm.cu's Variant enum order."""
    assert tgk.VARIANTS == ("simt", "wgmma", "ffma", "dmma")
    assert set(tgk.TILED) == set(tgk.DTYPE_CODES)
    assert set(tgk.TILES) == set(tgk.VARIANTS)
    assert tgk.TILES["wgmma"] == (128, 256, 64)

