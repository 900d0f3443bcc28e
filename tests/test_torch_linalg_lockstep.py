"""The 3-D ``repro_torch.linalg`` BLAS calls against the reference's
``vmap``ped ``repro.linalg`` calls, on the same numpy inputs.

``gemm``, ``gemm_bias_act``, ``syrk``, ``trsm`` and ``gemv`` on a leading
batch axis run as one lockstep computation (each GEMM-shaped step one
launch for the batch), where the reference ``vmap``s its local path. On
the CPU the port's kernel wrappers run their plain versions and the JAX
side its Pallas kernels in interpret mode; float64 runs the reference's
plain path in one ``JAX_ENABLE_X64`` subprocess (the policies agree within
the dtype's tolerance). A 2-D operand the port broadcasts over
the batch is handed to the reference broadcast to 3-D (its ``vmap`` maps
every operand). The fake card's launch records show each call's launches
(one per GEMM-shaped step for the whole batch); on the card
``tests/test_torch_cuda.py`` holds each item bitwise to the 2-D call.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from conftest import dtype_tolerances
from repro import linalg as jl
from repro_torch import linalg as tl
from repro_torch.analysis import fake_card
from repro_torch.kernels import gemm as tgk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = torch.device("cuda")
ITEMS, M, K, N = 3, 24, 16, 20          # gemm family: (B, M, K) @ (B, K, N)
NT, NRHS, BLOCK = 40, 5, 16             # trsm: (B, NT, NT), NRHS columns


def _inputs(items, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    tri = np.tril(f(items, NT, NT)) / NT + 2 * np.eye(NT, dtype=np.float32)
    return {"a": f(items, M, K), "at": f(items, K, M), "b": f(items, K, N),
            "bt": f(items, N, K), "a2": f(M, K), "b2": f(K, N),
            "c": f(items, M, N), "bias": f(N), "cm": f(items, M, M),
            "ck": f(items, K, K), "t": tri, "r": f(items, NT, NRHS),
            "rt": f(items, NRHS, NT), "rv": f(items, NT), "x": f(items, K),
            "xm": f(items, M), "yk": f(items, K), "ym": f(items, M)}


# name -> call(lib, inputs, broadcast, **dtype kw); ``broadcast`` turns the
# port's shared 2-D operand into the reference's mapped 3-D one
CASES = {
    "gemm": lambda L, d, bc, **kw: L.gemm(d["a"], d["b"], **kw),
    "gemm broadcast b": lambda L, d, bc, **kw: L.gemm(d["a"], bc(d["b2"]),
                                                      **kw),
    "gemm broadcast a": lambda L, d, bc, **kw: L.gemm(bc(d["a2"]), d["b"],
                                                      **kw),
    "gemm transa transb c": lambda L, d, bc, **kw: L.gemm(
        d["at"], d["bt"], c=d["c"], alpha=0.5, beta=2.0, transa=True,
        transb=True, **kw),
    "gemm_bias_act gelu": lambda L, d, bc, **kw: L.gemm_bias_act(
        d["a"], d["b"], d["bias"], "gelu", **kw),
    "gemm_bias_act relu broadcast b": lambda L, d, bc, **kw:
        L.gemm_bias_act(d["a"], bc(d["b2"]), d["bias"], "relu", **kw),
    "gemm_bias_act no bias": lambda L, d, bc, **kw: L.gemm_bias_act(
        d["a"], d["b"], **kw),
    "syrk": lambda L, d, bc, **kw: L.syrk(d["a"], **kw),
    "syrk upper trans c": lambda L, d, bc, **kw: L.syrk(
        d["a"], c=d["ck"], alpha=0.5, beta=-1.0, lower=False, trans=True,
        **kw),
    "syrk c": lambda L, d, bc, **kw: L.syrk(d["a"], c=d["cm"], beta=2.0,
                                            **kw),
    "trsm": lambda L, d, bc, **kw: L.trsm(d["t"], d["r"], block=BLOCK, **kw),
    "trsm upper right": lambda L, d, bc, **kw: L.trsm(
        d["t"].transpose(0, 2, 1), d["rt"], lower=False, left=False,
        block=BLOCK, **kw),
    "trsm unit vectors": lambda L, d, bc, **kw: L.trsm(
        d["t"], d["rv"], unit_diag=True, block=BLOCK, **kw),
    "gemv": lambda L, d, bc, **kw: L.gemv(d["a"], d["x"], **kw),
    "gemv trans y": lambda L, d, bc, **kw: L.gemv(
        d["a"], d["xm"], y=d["yk"], alpha=2.0, beta=-1.0, trans=True, **kw),
}
ROUTINES = ("gemm", "gemm_bias_act", "syrk", "trsm", "gemv")
# float64's cases (one reference subprocess): each routine once
X64_CASES = ("gemm broadcast b", "gemm_bias_act gelu", "syrk upper trans c",
             "trsm upper right", "gemv trans y")
# a tolerance scale per routine: trsm's substitution compounds rounding
SCALE = {"trsm": 32.0}


@pytest.fixture(autouse=True)
def _port_default_context():
    tl.reset_context()
    yield
    tl.reset_context()


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    """A registry path no test writes: tuned resolves as a cold start."""
    return str(tmp_path_factory.mktemp("reg") / "registry.json")


def _broadcast(items):
    return lambda x: np.broadcast_to(x, (items,) + x.shape)


def _close(got, want, scale, msg):
    rtol, atol = dtype_tolerances(str(got.dtype).removeprefix("torch."),
                                  scale)
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def _compare(names, policy, registry, items=ITEMS, dtype=None):
    d = _inputs(items)
    kw = {} if dtype is None else {"dtype": dtype}
    for name in names:
        with tl.use(policy=policy, registry=registry, device="cpu"):
            got = CASES[name](tl, d, lambda x: x, **kw)
        with jl.use(policy=policy, registry=registry):
            want = CASES[name](jl, d, _broadcast(items), **kw)
        want = np.asarray(want.astype("float32") if dtype else want)
        assert tuple(got.shape) == want.shape, name
        if dtype is not None:
            assert got.dtype == getattr(torch, dtype), name
        _close(got, want, SCALE.get(name.split()[0], 4.0),
               f"{name} policy={policy} dtype={dtype} items={items}")


def test_each_case_is_3d():
    """Every routine has a case, and every case's output keeps the batch."""
    assert {n.split()[0] for n in CASES} == set(ROUTINES)
    with tl.use(policy="model", device="cpu"):
        d = _inputs(ITEMS)
        for name, call in CASES.items():
            assert call(tl, d, lambda x: x).shape[0] == ITEMS, name


@pytest.mark.parametrize("name", list(CASES))
def test_float32_model_matches_vmapped_reference(registry, name):
    _compare([name], "model", registry)


def test_float32_reference_policy_matches_vmapped_reference(registry):
    _compare(["gemm broadcast b", "gemm_bias_act gelu", "syrk upper trans c",
              "trsm", "gemv trans y"], "reference", registry)


def test_bfloat16_matches_vmapped_reference(registry):
    _compare(["gemm", "gemm_bias_act relu broadcast b", "syrk", "gemv"],
             "model", registry, dtype="bfloat16")


def test_a_batch_of_one_matches_vmapped_reference(registry):
    _compare(["gemm transa transb c", "gemm_bias_act gelu", "syrk c",
              "trsm upper right", "gemv"], "model", registry, items=1)


def test_a_zero_item_batch_is_empty_as_the_reference(registry):
    """A batch of no items gives the reference's empty shapes (the
    reference's own kernel path cannot trace one: it is held to its plain
    path) and reaches no kernel wrapper."""
    d = _inputs(0)
    before = tgk.gemm.last_launch
    for name, call in CASES.items():
        with tl.use(policy="model", registry=registry, device="cpu"):
            got = call(tl, d, lambda x: x)
        with jl.use(policy="reference"):
            want = call(jl, d, _broadcast(0))
        assert tuple(got.shape) == np.shape(want), name
        assert got.numel() == 0 and got.dtype == torch.float32, name
    assert tgk.gemm.last_launch is before


def test_cold_start_tuned_is_bitwise_model(registry):
    d = _inputs(ITEMS, seed=1)
    out = {}
    for policy in ("model", "tuned"):
        with tl.use(policy=policy, registry=registry, device="cpu"):
            out[policy] = [call(tl, d, lambda x: x)
                           for call in CASES.values()]
    for name, m, t in zip(CASES, out["model"], out["tuned"]):
        assert torch.equal(m, t), name
    assert not os.path.exists(registry)


# ----------------------- float64: the reference under x64 --------------------

_X64 = textwrap.dedent("""
    import sys
    import numpy as np
    sys.path.insert(0, "tests")
    from test_torch_linalg_lockstep import (CASES, ITEMS, X64_CASES,
                                            _broadcast, _inputs)
    from repro import linalg as jl
    d = _inputs(ITEMS)
    with jl.use(policy="reference"):
        out = {name: np.asarray(CASES[name](jl, d, _broadcast(ITEMS),
                                            dtype="float64"))
               for name in X64_CASES}
    np.savez(sys.argv[1], **out)
    print("x64 reference OK")
""")


@pytest.fixture(scope="module", autouse=True)
def x64_reference(tmp_path_factory):
    """The float64 reference, started in a subprocess with the module's
    first test so that it runs beside the others: (process, npz path)."""
    path = str(tmp_path_factory.mktemp("x64") / "ref64.npz")
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", _X64, path], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_float64_matches_vmapped_x64_reference(x64_reference, registry):
    proc, path = x64_reference
    out, err = proc.communicate(timeout=600)
    assert "x64 reference OK" in out, err[-3000:]
    want = np.load(path)
    d = _inputs(ITEMS)
    with tl.use(policy="model", registry=registry, device="cpu"):
        for name in X64_CASES:
            got = CASES[name](tl, d, lambda x: x, dtype="float64")
            assert got.dtype == torch.float64, name
            assert want[name].dtype == np.float64, name
            _close(got, want[name], SCALE.get(name.split()[0], 4.0),
                   f"{name} float64")


# --------------------- the card route's launch records -----------------------

@pytest.fixture
def no_library(monkeypatch):
    """A fake launch must never reach the build or ctypes."""
    from repro_torch.kernels import _build

    def refuse(stem):
        raise AssertionError(f"_build.library({stem!r}) reached")
    monkeypatch.setattr(_build, "library", refuse)


def _launches(call, *args, **kw):
    with tl.use(policy="model"):
        tr = fake_card.trace(call, args, kw, CARD)
    return [(r["kernel"], r["variant"], r["grid"][-1]) for r in tr.launches]


@pytest.mark.parametrize("dtype,variant", [("float32", "ffma"),
                                           ("bfloat16", "wgmma"),
                                           ("float64", "dmma")])
def test_gemm_is_one_launch_for_the_batch(no_library, dtype, variant):
    a = torch.zeros((64, 256, 128), dtype=getattr(torch, dtype))
    b = torch.zeros((64, 128, 192), dtype=getattr(torch, dtype))
    assert _launches(tl.gemm, a, b) == [("gemm", variant, 64)]
    assert _launches(tl.gemm, a, b[0]) == [("gemm", variant, 64)]
    assert _launches(tl.gemm_bias_act, a, b, torch.zeros(
        192, dtype=a.dtype), epilogue="gelu") == \
        [("gemm_bias_act", variant, 64)]


def test_syrk_gemv_trsm_launch_once_per_step_for_the_batch(no_library):
    items, n, k, nrhs, block = 64, 160, 128, 32, 64
    a = torch.zeros((items, n, k))
    # syrk: A A^T on the transposed view, one "simt" launch (as in 2-D)
    assert _launches(tl.syrk, a) == [("gemm", "simt", items)]
    # gemv: one "gemv" launch for the batch
    assert _launches(tl.gemv, a, torch.zeros((items, k))) == \
        [("gemm", "gemv", items)]
    # trsm: one launch per off-diagonal block update, each for the batch
    t = torch.eye(n).expand(items, n, n).contiguous()
    got = _launches(tl.trsm, t, torch.zeros((items, n, nrhs)), block=block)
    assert got == [("gemm", "ffma", items)] * (-(-n // block) - 1)
    # against the 2-D call: the same kernels, the batch the only change
    two_d = _launches(tl.trsm, t[0], torch.zeros((n, nrhs)), block=block)
    assert [g[:2] for g in got] == [g[:2] for g in two_d]
