"""repro_torch's level-1 BLAS, the d-prefixed shims and the public surface
against repro's.

Each level-1 routine and each ``dot`` schedule runs on the same numpy
vectors through ``repro.linalg`` and ``repro_torch.linalg`` (CPU). The
shims must warn once per name, at the caller, and equal the ``linalg``
call bitwise; ``use_kernel`` / ``use_pallas`` map onto policies. The
surface equals the reference's, and no file of the port imports jax or
the JAX package (an AST scan, which also sees imports inside functions),
and no file of the JAX package's side differs from before the port began.
"""
import ast
import os
import shutil
import subprocess
import warnings

import numpy as np
import pytest
import torch

from conftest import dtype_tolerances
from repro import linalg as jl
from repro_torch import blas as tblas
from repro_torch import linalg as tl
from repro_torch.blas import _deprecated
from repro_torch.kernels import gemm as tgk
from repro_torch.tune import policy as tpolicy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_state():
    tl.reset_context()
    _deprecated.reset_warned()
    yield
    _deprecated.reset_warned()
    tl.reset_context()


def _vec(n, seed):
    return np.random.default_rng(seed).normal(size=n).astype(np.float32)


def _close(got, want, scale=1.0, msg=""):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    rtol, atol = dtype_tolerances(str(got.dtype).removeprefix("torch."),
                                  scale)
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("n", [1, 37, 1000])
def test_level1_matches_reference(n):
    x, y = _vec(n, 0), _vec(n, 1)
    x[n // 2] = -4.0                      # a unique largest |x|
    with tl.use(device="cpu"):
        for schedule, u in (("tree", 8), ("sequential", 8), ("strided", 8),
                            ("strided", 5)):
            got = tl.dot(x, y, schedule=schedule, accumulators=u)
            want = jl.dot(x, y, schedule=schedule, accumulators=u)
            assert got.shape == () and got.dtype == torch.float32
            _close(got, want, 4.0, f"dot {schedule} U={u} n={n}")
        _close(tl.axpy(1.5, x, y), jl.axpy(1.5, x, y), msg="axpy")
        _close(tl.scal(-2.0, x), jl.scal(-2.0, x), msg="scal")
        _close(tl.nrm2(x), jl.nrm2(x), msg="nrm2")
        big = (1e30 * x).astype(np.float32)        # squares overflow f32
        _close(tl.nrm2(big), jl.nrm2(big), msg="nrm2 1e30")
        assert torch.isfinite(tl.nrm2(big))
        _close(tl.asum(x), jl.asum(x), 4.0, "asum")
        assert tl.iamax(x).item() == int(jl.iamax(x)) == n // 2
        for got, want in zip(tl.rot(x, y, 0.6, 0.8), jl.rot(x, y, 0.6, 0.8)):
            _close(got, want, msg="rot")


def test_dot_rejects_unknown_schedule_and_takes_empty_vectors():
    z = np.zeros(0, np.float32)
    with tl.use(device="cpu"):
        with pytest.raises(ValueError):
            tl.dot(z, z, schedule="pairwise")
        for schedule in ("tree", "sequential", "strided"):
            assert tl.dot(z, z, schedule=schedule).item() == \
                float(jl.dot(z, z, schedule=schedule)) == 0.0


def test_level1_spans_match_reference():
    from repro import obs as jobs
    from repro_torch import obs as tobs
    x, y = _vec(20, 2), _vec(20, 3)
    calls = [("dot", (x, y)), ("axpy", (2.0, x, y)), ("scal", (2.0, x)),
             ("nrm2", (x,)), ("asum", (x,)), ("iamax", (x,)),
             ("rot", (x, y, 0.6, 0.8))]
    with jobs.trace() as jt:
        for name, args in calls:
            getattr(jl, name)(*args)
    with tobs.trace() as tt, tl.use(device="cpu"):
        for name, args in calls:
            getattr(tl, name)(*args)
    keys = ("shape", "dtype", "flops", "bytes")
    for name, _ in calls:
        (j,), (t,) = jt.spans(name="linalg." + name), tt.spans(
            name="linalg." + name)
        assert {k: t.attrs[k] for k in keys} == {k: j.attrs[k] for k in keys}


def _pairs(rng):
    """(shim name, shim call, linalg call) for every d-prefixed shim."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x, y = f(33), f(33)
    a, b, c = f(12, 8), f(8, 10), f(12, 10)
    t = np.tril(f(12, 12)) + 4 * np.eye(12, dtype=np.float32)
    rhs, u8, g1, g2 = f(12, 3), f(8), f(12), f(10)
    return [
        ("ddot", lambda: tblas.ddot(x, y, schedule="strided"),
         lambda: tl.dot(x, y, schedule="strided")),
        ("daxpy", lambda: tblas.daxpy(1.5, x, y), lambda: tl.axpy(1.5, x, y)),
        ("dscal", lambda: tblas.dscal(-2.0, x), lambda: tl.scal(-2.0, x)),
        ("dnrm2", lambda: tblas.dnrm2(x), lambda: tl.nrm2(x)),
        ("dasum", lambda: tblas.level1.dasum(x), lambda: tl.asum(x)),
        ("idamax", lambda: tblas.idamax(x), lambda: tl.iamax(x)),
        ("drot", lambda: tblas.level1.drot(x, y, 0.6, 0.8)[0],
         lambda: tl.rot(x, y, 0.6, 0.8)[0]),
        ("dgemv", lambda: tblas.dgemv(a, u8, alpha=1.5),
         lambda: tl.gemv(a, u8, alpha=1.5)),
        ("dger", lambda: tblas.dger(0.5, g1, g2, c),
         lambda: tl.ger(0.5, g1, g2, c)),
        ("dtrsv", lambda: tblas.dtrsv(t, x[:12]), lambda: tl.trsv(t, x[:12])),
        ("dgemm", lambda: tblas.dgemm(a, b, c=c, alpha=2.0, beta=-1.0),
         lambda: tl.gemm(a, b, c=c, alpha=2.0, beta=-1.0)),
        ("dsyrk", lambda: tblas.dsyrk(a, lower=False),
         lambda: tl.syrk(a, lower=False)),
        ("dtrsm", lambda: tblas.dtrsm(t, rhs, block=4),
         lambda: tl.trsm(t, rhs, block=4)),
    ]


def test_every_shim_warns_once_at_the_caller_and_is_bitwise():
    with tl.use(device="cpu", policy="model"):
        for name, old, new in _pairs(np.random.default_rng(0)):
            with pytest.warns(DeprecationWarning) as rec:
                got = old()
            (w,) = [r for r in rec if name in str(r.message)]
            assert str(w.message).startswith(
                f"repro_torch.blas.{name} is deprecated; use "
                f"repro_torch.linalg."), w.message
            assert w.filename == __file__, (name, w.filename)
            with warnings.catch_warnings():
                warnings.simplefilter("error", DeprecationWarning)
                again = old()                 # once per name per process
            want = new()
            assert torch.equal(got, want) and torch.equal(again, want), name


def test_shims_ignore_context_accumulation_and_machine():
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(12, 8)), rng.normal(size=(8, 10))
    a, b = a.astype(np.float32), b.astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with tl.use(device="cpu", policy="model"):
            plain = tblas.dgemm(a, b)
        with tl.use(device="cpu", policy="model", accum_dtype="float64",
                    machine="h100"):
            shim = tblas.dgemm(a, b)
            ctx = tl.gemm(a, b)
    assert torch.equal(shim, plain) and shim.dtype == torch.float32
    assert not torch.equal(ctx, plain)    # the context's float64 accumulation


def test_use_kernel_and_use_pallas_aliases(monkeypatch):
    monkeypatch.setattr(tpolicy, "_warned_aliases", set())
    for name in ("use_kernel", "use_pallas"):
        with pytest.warns(DeprecationWarning, match=f"{name} is deprecated"):
            assert tpolicy.resolve_policy(**{name: True}) == "model"
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            assert tpolicy.resolve_policy(**{name: False}) == "reference"
            assert tpolicy.resolve_policy("tuned", **{name: False}) == "tuned"
    with pytest.raises(ValueError, match="unknown policy"):
        tpolicy.resolve_policy("fast")
    a = np.eye(24, dtype=np.float32)
    tgk.gemm.last_launch = None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with tl.use(device="cpu"):
            tblas.dgemm(a, a, use_kernel=False)
            assert tgk.gemm.last_launch is None       # reference: no kernel
            tblas.dgemm(a, a, use_pallas=True)
    assert tgk.gemm.last_launch["device"] == "cpu"    # model: the wrapper


def test_surface_equals_reference():
    assert tl.__all__ == jl.__all__
    assert all(callable(getattr(tl, n)) for n in tl.__all__)
    shims = ("ddot", "daxpy", "dscal", "dnrm2", "dasum", "idamax", "drot",
             "dgemv", "dger", "dtrsv", "dgemm", "dsyrk", "dtrsm")
    assert all(callable(getattr(tblas, n)) for n in shims)


def test_no_port_file_imports_jax_or_repro():
    """An AST scan of every module of src/repro_torch and chip_smoke.py,
    imports inside functions included."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            bad += [(os.path.relpath(path, ROOT), m) for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(files) > 50 and not bad, bad


def test_reference_side_is_untouched():
    """No file under src/repro, benchmarks, scripts or tests (the port's
    own tests/test_torch_*.py aside) differs from the commit before the
    one that added src/repro_torch. Needs the checkout's git history;
    skips without it."""
    git = shutil.which("git")
    if git is None or not os.path.isdir(os.path.join(ROOT, ".git")):
        pytest.skip("needs the checkout's git history")

    def run(*args):
        r = subprocess.run([git, *args], cwd=ROOT, capture_output=True,
                           text=True, timeout=120)
        if r.returncode != 0:
            pytest.skip(f"git {args[0]} failed: {r.stderr.strip()[:200]}")
        return r.stdout.split()

    added = run("log", "--diff-filter=A", "--format=%H", "--",
                "src/repro_torch")
    if not added:
        pytest.skip("no commit in this history adds src/repro_torch")
    paths = ["src/repro", "benchmarks", "scripts", "tests"]
    changed = run("diff", "--name-only", added[-1] + "^", "--", *paths) \
        + run("ls-files", "--others", "--exclude-standard", "--", *paths)
    changed = [f for f in changed if not f.startswith("tests/test_torch_")]
    assert not changed, changed
