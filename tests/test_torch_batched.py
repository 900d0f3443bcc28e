"""repro_torch's batched LAPACK drivers against repro's.

The same numpy batches from a seed (B = 3, n <= 30) go through
``repro.lapack.batched`` (jitted, the Pallas GEMM in interpret mode under
``model``) and through ``repro_torch.lapack.batched`` /
``repro_torch.linalg`` on the CPU: the three factorizations, their
``reconstruct``, ``batched_solve`` with vector and matrix right-hand
sides, ``FactorizationResult`` itself, both rejections, and the NaNs of a
non-SPD item. Float64 runs in one ``JAX_ENABLE_X64`` subprocess.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dtype_tolerances
from repro.lapack import batched as jb
from repro_torch import linalg as tl
from repro_torch.lapack import batched as tb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, BLOCK = 3, 24, 8
# (kind, port linalg routine, reference driver, (m, n) of an item)
KINDS = [("potrf", "batched_cholesky", "batched_potrf", (N, N)),
         ("getrf", "batched_lu", "batched_getrf", (N, N)),
         ("geqrf", "batched_qr", "batched_geqrf", (30, 20))]


@pytest.fixture(autouse=True)
def _port_default_context():
    tl.reset_context()
    yield
    tl.reset_context()


def _inputs(kind, m, n, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(B, m, n))
    if kind == "potrf":
        g = g @ g.transpose(0, 2, 1) / n + np.eye(n)
    rhs = rng.normal(size=(B, m, 2))
    return g.astype(np.float32), rhs.astype(np.float32)


@pytest.fixture(scope="module")
def reference():
    """Per kind: the reference's FactorizationResult, reconstruct and
    batched_solve (matrix right-hand side) on ``_inputs``, one jitted call
    each, shared by the tests."""
    out = {}
    solve = jax.jit(jb.batched_solve, static_argnames=("policy",))
    rec = jax.jit(jb.reconstruct)
    for kind, _, driver, (m, n) in KINDS:
        a, rhs = _inputs(kind, m, n)
        res = jax.jit(getattr(jb, driver), static_argnames=(
            "block", "policy"))(jnp.asarray(a), block=BLOCK, policy="model")
        out[kind] = (res, np.asarray(rec(res)),
                     np.asarray(solve(res, jnp.asarray(rhs), policy="model")))
    return out


def _close(got, want, scale=1.0, msg=""):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    rtol, atol = dtype_tolerances(str(got.dtype).removeprefix("torch."),
                                  scale)
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("policy", ["reference", "model"])
@pytest.mark.parametrize("kind,routine,driver,shape", KINDS)
def test_batched_drivers_match_reference(reference, kind, routine, driver,
                                         shape, policy):
    a, rhs = _inputs(kind, *shape)
    jres, jrec, jx = reference[kind]
    with tl.use(policy=policy, device="cpu"):
        res = getattr(tl, routine)(a, block=BLOCK)
        x = tl.batched_solve(res, rhs)
        xv = tl.batched_solve(res, rhs[:, :, 0])
    assert isinstance(res, tl.FactorizationResult)
    assert (res.kind, res.block, res.batch) == (jres.kind, jres.block, B)
    tag = f"{kind} {policy}"
    _close(res.factors, jres.factors, 16.0, f"factors {tag}")
    if kind == "getrf":
        assert res.pivots.dtype == torch.int32
        assert np.array_equal(res.pivots.numpy(), np.asarray(jres.pivots))
    else:
        assert res.pivots is None and jres.pivots is None
    if kind == "geqrf":
        _close(res.tau, jres.tau, 16.0, f"tau {tag}")
    else:
        assert res.tau is None and jres.tau is None
    _close(tb.reconstruct(res), jrec, 16.0, f"reconstruct {tag}")
    _close(tb.reconstruct(res), a, 64.0, f"round trip {tag}")
    assert tuple(x.shape) == jx.shape and tuple(xv.shape) == jx.shape[:2]
    _close(x, jx, 64.0, f"solve {tag}")
    _close(xv, jx[:, :, 0], 64.0, f"vector solve {tag}")


def test_linalg_3d_routes_match_reference(reference):
    """cholesky / lu / qr / solve / lstsq on a 3-D input go through the
    batched drivers, as the reference's do."""
    spd, _ = _inputs("potrf", N, N)
    gen, grhs = _inputs("getrf", N, N)
    tall, trhs = _inputs("geqrf", 30, 20)
    with tl.use(policy="model", device="cpu"):
        _close(tl.cholesky(spd, block=BLOCK), reference["potrf"][0].factors,
               16.0, "cholesky")
        packed, piv = tl.lu(gen, block=BLOCK)
        _close(packed, reference["getrf"][0].factors, 16.0, "lu")
        assert np.array_equal(piv.numpy(),
                              np.asarray(reference["getrf"][0].pivots))
        _close(tl.solve(gen, grhs, block=BLOCK), reference["getrf"][2], 64.0,
               "solve")
        _close(tl.lstsq(tall, trhs, block=BLOCK), reference["geqrf"][2],
               64.0, "lstsq")
        q, r = tl.qr(tall, block=BLOCK)
    _close(q @ r, tall, 16.0, "qr round trip")
    _close(torch.triu(r), r.numpy(), 1.0, "r is upper triangular")
    _close(r, np.triu(np.asarray(reference["geqrf"][0].factors))[:, :20],
           16.0, "qr r")


def test_factorization_result_is_frozen():
    f = torch.zeros((2, 3, 3))
    res = tl.FactorizationResult(f, None, None, "potrf", 8)
    assert [fl.name for fl in dataclasses.fields(res)] == [
        fl.name for fl in dataclasses.fields(jb.FactorizationResult)]
    assert res.batch == 2
    with pytest.raises(dataclasses.FrozenInstanceError):
        res.block = 4
    with pytest.raises(ValueError, match="unknown factorization kind"):
        tb.batched_solve(dataclasses.replace(res, kind="syev"), f[:, :, 0])
    with pytest.raises(ValueError, match="unknown factorization kind"):
        tb.reconstruct(dataclasses.replace(res, kind="syev"))


def test_rejections_match_reference():
    rng = np.random.default_rng(1)
    wide = rng.normal(size=(2, 8, 12)).astype(np.float32)
    rect = rng.normal(size=(2, 12, 8)).astype(np.float32)
    with tl.use(policy="model", device="cpu"):
        res_w = tl.batched_qr(wide, block=4)
        res_r = tl.batched_lu(rect, block=4)
        with pytest.raises(ValueError, match="needs m >= n"):
            tl.batched_solve(res_w, wide[:, :, 0])
        with pytest.raises(ValueError, match="needs square factors"):
            tl.batched_solve(res_r, rect[:, :, 0])
        with pytest.raises(ValueError, match=r"\(B, n, n\)"):
            tl.batched_cholesky(rect)
    # the reference checks the shapes before it solves anything
    jres_w = jb.FactorizationResult(jnp.asarray(wide), None,
                                    jnp.zeros((2, 8)), "geqrf", 4)
    jres_r = jb.FactorizationResult(jnp.asarray(rect), jnp.zeros(
        (2, 8), jnp.int32), None, "getrf", 4)
    with pytest.raises(ValueError, match="needs m >= n"):
        jb.batched_solve(jres_w, jnp.asarray(wide[:, :, 0]))
    with pytest.raises(ValueError, match="needs square factors"):
        jb.batched_solve(jres_r, jnp.asarray(rect[:, :, 0]))


def test_non_spd_item_gives_nans_like_reference():
    spd, _ = _inputs("potrf", 12, 12, seed=2)
    spd[1] -= 3 * np.eye(12, dtype=np.float32)      # item 1 is indefinite
    want = np.asarray(jax.jit(jb.batched_potrf, static_argnames=("block",))(
        jnp.asarray(spd), block=4).factors)
    with tl.use(policy="model", device="cpu"):
        got = tl.batched_cholesky(spd, block=4).factors.numpy()
    assert np.isnan(want[1]).any()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    _close(torch.from_numpy(got[ok]), want[ok], 16.0, "finite entries")


_X64 = textwrap.dedent("""
import sys
sys.path.insert(0, "tests")
from conftest import dtype_tolerances
import numpy as np
import jax
import jax.numpy as jnp
import torch
from repro.lapack import batched as jb
from repro_torch import linalg as tl
from repro_torch.lapack import batched as tb

def close(got, want, scale, msg):
    assert got.dtype == torch.float64, got.dtype
    rtol, atol = dtype_tolerances(np.float64, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)

rng = np.random.default_rng(0)
g = rng.normal(size=(3, 16, 16))
spd = g @ g.transpose(0, 2, 1) / 16 + np.eye(16)
rhs = rng.normal(size=(3, 16, 2))
tall = rng.normal(size=(3, 20, 12))
trhs = rng.normal(size=(3, 20))
solve = jax.jit(jb.batched_solve, static_argnames=("policy",))
with tl.use(policy="model", device="cpu"):
    for kind, a, b, routine, driver in (
            ("potrf", spd, rhs, "batched_cholesky", "batched_potrf"),
            ("getrf", g, rhs, "batched_lu", "batched_getrf"),
            ("geqrf", tall, trhs, "batched_qr", "batched_geqrf")):
        jres = jax.jit(getattr(jb, driver), static_argnames=(
            "block", "policy"))(jnp.asarray(a), block=8, policy="model")
        res = getattr(tl, routine)(a, block=8)
        close(res.factors, jres.factors, 16.0, kind)
        close(tb.reconstruct(res), a, 64.0, kind + " round trip")
        close(tl.batched_solve(res, b),
              solve(jres, jnp.asarray(b), policy="model"), 64.0,
              kind + " solve")
print("x64 batched legs OK")
""")


def test_float64_batched_against_x64_jax():
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", _X64], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert "x64 batched legs OK" in r.stdout
