"""repro_torch's Householder QR and least squares against repro's.

The same numpy inputs from a seed go through ``repro.lapack.qr`` /
``repro.lapack.solve`` / ``repro.linalg`` (the Pallas GEMM in interpret
mode under ``model``) and through the port on the CPU, where the kernel
wrappers run their plain versions: the unblocked and blocked ``geqrf``
(packed factor and tau), ``q_from_geqrf``, the thin ``qr``,
``lstsq_qr`` and ``linalg.qr`` / ``linalg.lstsq``, at tall, square, wide
and ragged (m, n, block); 3-D inputs against the 2-D path here and
against the reference in tests/test_torch_batched.py. Float64 runs in one
``JAX_ENABLE_X64`` subprocess.
"""
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
from repro import linalg as jl
from repro import obs as jobs
from repro.lapack import qr as jqr
from repro.lapack import solve as jsolve
from repro.linalg import lapack as jl_lapack
from repro_torch import linalg as tl
from repro_torch import obs as tobs
from repro_torch.kernels import gemm as tgk
from repro_torch.lapack import qr as tqr
from repro_torch.lapack import solve as tsolve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (m, n, block): tall, square with a ragged last panel, wide
SHAPES = [(48, 32, 16), (37, 37, 16), (24, 40, 8)]
POLICIES = ("reference", "model")


@pytest.fixture(autouse=True)
def _port_default_context():
    tl.reset_context()
    yield
    tl.reset_context()


def _mat(m, n, seed=0):
    return np.random.default_rng(seed).normal(size=(m, n)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_geqrf():
    """(packed, tau, Q) of the reference for ``_mat(m, n, seed)``: one
    jitted call per (shape, block, policy, seed), shared by the tests (the
    JAX side is the slow one here)."""
    geqrf = jax.jit(jqr.geqrf, static_argnames=("block", "policy"))
    q_from = jax.jit(jqr.q_from_geqrf)
    cache = {}

    def get(m, n, block, policy="model", seed=0):
        key = (m, n, block, policy, seed)
        if key not in cache:
            p, t = geqrf(jnp.asarray(_mat(m, n, seed)), block=block,
                         policy=policy)
            cache[key] = tuple(map(np.asarray, (p, t, q_from(p, t))))
        return cache[key]
    return get


def _close(got, want, scale=1.0, msg=""):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    rtol, atol = dtype_tolerances(str(got.dtype).removeprefix("torch."),
                                  scale)
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


# the port under both policies against the reference under "model" (the
# Pallas GEMM in interpret mode), and both sides under "reference" once
@pytest.mark.parametrize("m,n,block,policy,jax_policy", [
    *[(*s, p, "model") for s in SHAPES for p in POLICIES],
    (*SHAPES[0], "reference", "reference")])
def test_geqrf_and_q_match_reference(jax_geqrf, m, n, block, policy,
                                     jax_policy):
    a = torch.from_numpy(_mat(m, n))
    jp, jt, jq = jax_geqrf(m, n, block, jax_policy)
    tp, tt = tqr.geqrf(a, block=block, policy=policy)
    tag = f"{m}x{n} nb={block} {policy} / {jax_policy}"
    _close(tp, jp, 16.0, f"packed {tag}")
    _close(tt, jt, 16.0, f"tau {tag}")
    _close(tqr.q_from_geqrf(tp, tt), jq, 16.0, f"q {tag}")
    kmin = min(m, n)
    _close(tqr.q_from_geqrf(tp, tt, kmin), jq[:, :kmin], 16.0,
           f"thin q {tag}")
    # the reference's qr is exactly (Q[:, :kmin], triu(packed)[:kmin])
    tq, tr = tqr.qr(a, block=block, policy=policy)
    assert tuple(tq.shape) == (m, kmin) and tuple(tr.shape) == (kmin, n)
    _close(tq, jq[:, :kmin], 16.0, f"qr q {tag}")
    _close(tr, np.triu(jp)[:kmin], 16.0, f"qr r {tag}")


@pytest.mark.parametrize("m,n", [(20, 12), (6, 11)])
def test_unblocked_geqrf_matches_reference(m, n):
    a = _mat(m, n, seed=1)
    jp, jt = jax.jit(jqr.geqrf_unblocked)(jnp.asarray(a))
    tp, tt = tqr.geqrf_unblocked(torch.from_numpy(a))
    _close(tp, jp, 4.0, "packed")
    _close(tt, jt, 4.0, "tau")


def test_zero_column_gives_zero_tau():
    a = _mat(10, 6, seed=2)
    a[:, 0] = 0.0
    a[3:, 2] = 0.0                        # zero below the diagonal only
    jp, jt = jax.jit(jqr.geqrf_unblocked)(jnp.asarray(a))
    assert float(jt[0]) == 0.0
    for block in (None, 2):
        tp, tt = tqr.geqrf(torch.from_numpy(a), block=block)
        assert tt[0].item() == 0.0 and torch.isfinite(tp).all()
        _close(tp, jp, 4.0, f"packed block={block}")
        _close(tt, jt, 4.0, f"tau block={block}")


@pytest.mark.parametrize("m,n,block,nrhs", [(48, 32, 16, 3), (33, 20, 8, 0)])
def test_lstsq_matches_reference(m, n, block, nrhs):
    a = _mat(m, n, seed=3)
    rng = np.random.default_rng(4)
    b = rng.normal(size=(m, nrhs) if nrhs else (m,)).astype(np.float32)
    want = jax.jit(jsolve.lstsq_qr, static_argnames=("block", "policy"))(
        jnp.asarray(a), jnp.asarray(b), block=block, policy="model")
    for policy in POLICIES:
        got = tsolve.lstsq_qr(torch.from_numpy(a), torch.from_numpy(b),
                              block=block, policy=policy)
        assert tuple(got.shape) == np.shape(want)
        _close(got, want, 16.0, f"lstsq_qr {m}x{n} {policy}")
        with tl.use(policy=policy, device="cpu"):
            _close(tl.lstsq(a, b, block=block), want, 16.0, "linalg.lstsq")


def test_linalg_qr_and_lstsq_take_batches():
    """A 3-D input runs the batch in lockstep, each item within the
    dtype's tolerance of the 2-D path on it; the batched drivers
    themselves meet the reference in tests/test_torch_batched.py."""
    rng = np.random.default_rng(5)
    a3 = rng.normal(size=(2, 30, 20)).astype(np.float32)
    b3 = rng.normal(size=(2, 30, 2)).astype(np.float32)
    w3 = rng.normal(size=(2, 12, 20)).astype(np.float32)
    with tl.use(policy="model", device="cpu"):
        x3 = tl.lstsq(a3, b3, block=8)
        v3 = tl.lstsq(a3, b3[:, :, 0], block=8)
        for i in range(2):
            _close(x3[i], tl.lstsq(a3[i], b3[i], block=8).numpy(), 64.0)
            _close(v3[i], tl.lstsq(a3[i], b3[i, :, 0], block=8).numpy(),
                   64.0)
        for x in (a3, w3):                  # tall and wide
            q3, r3 = tl.qr(x, block=8)
            for i in range(x.shape[0]):
                q, r = tl.qr(x[i], block=8)
                assert q3[i].shape == q.shape and r3[i].shape == r.shape
                _close(q3[i], q.numpy(), 16.0)
                _close(r3[i], r.numpy(), 16.0)


def test_spans_and_flops_match_reference():
    a = _mat(48, 40, seed=6)
    b = _mat(48, 2, seed=7)
    with jobs.trace("qr") as jt, jl.use(policy="model"):
        jl.qr(a, block=16)
    with tobs.trace("qr") as tt, tl.use(policy="model", device="cpu"):
        tl.qr(a, block=16)
        tl.lstsq(a, b, block=16)

    def shape(tr, name):
        ids = {e.id: e for e in tr.events}
        (top,) = tr.spans(name=name)
        return [(e.name, e.cat, {k: e.attrs.get(k) for k in (
                    "j0", "nb", "flops", "shape", "dtype", "bytes")})
                for e in sorted(tr.events, key=lambda e: e.t_start)
                if e is top or e.parent is not None
                and ids[e.parent] is top]
    assert shape(tt, "linalg.qr") == shape(jt, "linalg.qr")
    assert [e[0] for e in shape(tt, "linalg.qr")] == [
        "linalg.qr", "geqrf.panel", "geqrf.trailing", "geqrf.panel",
        "geqrf.trailing", "geqrf.panel"]
    (ls,) = tt.spans(name="linalg.lstsq")
    want = jl_lapack._lstsq_info(jnp.asarray(a), jnp.asarray(b))
    assert {k: ls.attrs[k] for k in want} == want


def test_trailing_products_take_the_tiled_variant(monkeypatch):
    """Both large products of every trailing update read row-major,
    16-byte aligned operands: the tiled variant, never ``simt``."""
    seen = []
    record = tgk.record_call

    def spy(wrapper, plan, variant, device):
        seen.append(variant)
        return record(wrapper, plan, variant, device)

    monkeypatch.setattr(tgk, "record_call", spy)
    for dtype, tiled in ((torch.float32, "ffma"), (torch.float64, "dmma")):
        seen.clear()
        a = torch.from_numpy(_mat(96, 96, seed=8)).to(dtype)
        tqr.geqrf(a, block=32, policy="model")
        assert seen == [tiled] * 4, seen     # 2 panels with trailing columns
        assert tgk.gemm.last_launch["device"] == "cpu"


def test_cold_start_tuned_is_bitwise_model(tmp_path):
    a = _mat(50, 36, seed=9)
    b = _mat(50, 3, seed=10)
    reg = str(tmp_path / "missing.json")
    with tl.use(policy="model", device="cpu"):
        q0, r0 = tl.qr(a, block=16)
        x0 = tl.lstsq(a, b, block=16)
    with tl.use(policy="tuned", registry=reg, device="cpu"):
        q1, r1 = tl.qr(a, block=16)
        x1 = tl.lstsq(a, b, block=16)
    assert torch.equal(q0, q1) and torch.equal(r0, r1) and torch.equal(x0, x1)
    assert not os.path.exists(reg)


_X64 = textwrap.dedent("""
import sys
sys.path.insert(0, "tests")
from conftest import dtype_tolerances
import numpy as np
import jax
import jax.numpy as jnp
import torch
from repro.lapack import qr as jqr
from repro.lapack import solve as jsolve
from repro_torch import linalg as tl
from repro_torch.lapack import qr as tqr

def close(got, want, scale, msg):
    assert got.dtype == torch.float64, got.dtype
    rtol, atol = dtype_tolerances(np.float64, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)

geqrf = jax.jit(jqr.geqrf, static_argnames=("block", "policy"))
rng = np.random.default_rng(0)
for m, n, block in ((48, 32, 16),):
    a = rng.normal(size=(m, n))
    jp, jt = geqrf(jnp.asarray(a), block=block, policy="model")
    jq = np.asarray(jqr.q_from_geqrf(jp, jt))
    tp, tt = tqr.geqrf(torch.from_numpy(a), block=block, policy="model")
    close(tp, jp, 16.0, f"packed {m}x{n}")
    close(tt, jt, 16.0, f"tau {m}x{n}")
    close(tqr.q_from_geqrf(tp, tt), jq, 16.0, "q")
    with tl.use(policy="model", device="cpu"):
        tq, tr = tl.qr(a, block=block)
        k = min(m, n)
        close(tq, jq[:, :k], 16.0, "linalg.qr q")
        close(tr, np.triu(np.asarray(jp))[:k], 16.0, "linalg.qr r")
        if m > n:
            b = rng.normal(size=(m, 2))
            want = jax.jit(jsolve.lstsq_qr, static_argnames=(
                "block", "policy"))(jnp.asarray(a), jnp.asarray(b),
                                    block=block, policy="model")
            close(tl.lstsq(a, b, block=block), want, 64.0, "linalg.lstsq")
print("x64 qr legs OK")
""")


def test_float64_qr_against_x64_jax():
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", _X64], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert "x64 qr legs OK" in r.stdout
