"""repro_torch.linalg against repro.linalg on the same numpy inputs.

Every routine of the slice (gemm, gemm_bias_act, syrk, trsm, gemv, ger,
trsv, cholesky, lu, solve) runs under ``use(device="cpu")`` for each
policy - and, for the factorizations, each ``fuse`` state - beside the
same ``repro.linalg`` call, with a small ``block=`` so the blocked and
fused paths run. On the CPU the port's kernel wrappers run their plain
versions; the JAX side runs its Pallas kernels in interpret mode. The
tuned legs point both packages at the same missing registry file (a cold
start). Float64 runs in ``tests/test_torch_kernels.py``'s x64 subprocess.
"""
import numpy as np
import pytest
import torch

from conftest import dtype_tolerances
from repro import linalg as jl
from repro import obs as jobs
from repro_torch import linalg as tl
from repro_torch import obs as tobs
from repro_torch.core import codesign as tcd
from repro_torch.kernels import fused as tfk
from repro_torch.kernels import gemm as tgk

POLICIES = ("reference", "model", "tuned")
FUSES = (None, False, True)
N, BLOCK = 48, 16


@pytest.fixture(autouse=True)
def _port_default_context():
    tl.reset_context()
    yield
    tl.reset_context()


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    """A registry path no test writes: tuned resolves as a cold start."""
    return str(tmp_path_factory.mktemp("reg") / "registry.json")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    g = rng.normal(size=(N, N))
    return {
        "a": f(40, 24), "b": f(24, 30), "c": f(40, 30), "bias": f(30),
        "tri": (np.tril(f(N, N)) + 4 * np.eye(N)).astype(np.float32),
        "rhs": f(N, 5), "x": f(24), "y": f(40),
        "spd": (g @ g.T + N * np.eye(N)).astype(np.float32),
        "gen": (g + 2 * np.eye(N)).astype(np.float32),
    }


def _close(got, want, scale=1.0, msg=""):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    rtol, atol = dtype_tolerances(str(got.dtype).removeprefix("torch."),
                                  scale)
    np.testing.assert_allclose(got.double().numpy(),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def _both(policy, registry):
    """The same context on both sides: (jax scope, port scope on cpu)."""
    return (jl.use(policy=policy, registry=registry),
            tl.use(policy=policy, registry=registry, device="cpu"))


@pytest.mark.parametrize("policy", POLICIES)
def test_blas_matches_reference(data, registry, policy):
    d = data
    js, ts = _both(policy, registry)
    with js, ts:
        pairs = {
            "gemm": (tl.gemm(d["a"], d["b"]), jl.gemm(d["a"], d["b"])),
            "gemm-trans-beta": (
                tl.gemm(d["a"].T, d["b"], c=d["c"], alpha=0.5, beta=2.0,
                        transa=True),
                jl.gemm(d["a"].T, d["b"], c=d["c"], alpha=0.5, beta=2.0,
                        transa=True)),
            "gemm_bias_act": (
                tl.gemm_bias_act(d["a"], d["b"], d["bias"], "gelu"),
                jl.gemm_bias_act(d["a"], d["b"], d["bias"], "gelu")),
            "syrk": (tl.syrk(d["a"], lower=False), jl.syrk(d["a"],
                                                           lower=False)),
            "syrk-trans": (tl.syrk(d["a"], trans=True),
                           jl.syrk(d["a"], trans=True)),
            "trsm": (tl.trsm(d["tri"], d["rhs"], block=BLOCK),
                     jl.trsm(d["tri"], d["rhs"], block=BLOCK)),
            "trsm-upper-right": (
                tl.trsm(d["tri"].T, d["rhs"].T, lower=False, left=False),
                jl.trsm(d["tri"].T, d["rhs"].T, lower=False, left=False)),
            "gemv": (tl.gemv(d["a"], d["x"]), jl.gemv(d["a"], d["x"])),
            "gemv-trans": (tl.gemv(d["a"], d["y"], y=d["x"], beta=-1.0,
                                   trans=True),
                           jl.gemv(d["a"], d["y"], y=d["x"], beta=-1.0,
                                   trans=True)),
            "ger": (tl.ger(0.5, d["y"], d["x"], d["a"]),
                    jl.ger(0.5, d["y"], d["x"], d["a"])),
            "trsv": (tl.trsv(d["tri"], d["rhs"][:, 0], unit_diag=True),
                     jl.trsv(d["tri"], d["rhs"][:, 0], unit_diag=True)),
        }
    for name, (got, want) in pairs.items():
        assert tuple(got.shape) == tuple(np.shape(want)), name
        _close(got, want, scale=16.0, msg=f"{name} policy={policy}")


@pytest.mark.parametrize("policy", ["reference", "model"])
def test_bfloat16_gemm_family(data, registry, policy):
    d = data
    js, ts = _both(policy, registry)
    with js, ts:
        got = tl.gemm(d["a"], d["b"], dtype="bfloat16")
        want = jl.gemm(d["a"], d["b"], dtype="bfloat16")
        got_e = tl.gemm_bias_act(d["a"], d["b"], d["bias"], "relu",
                                 dtype=torch.bfloat16)
        want_e = jl.gemm_bias_act(d["a"], d["b"], d["bias"], "relu",
                                  dtype="bfloat16")
    assert got.dtype == got_e.dtype == torch.bfloat16
    _close(got, want, scale=2.0)
    _close(got_e, want_e, scale=2.0)


_JAX_FACTORS = {}


def _jax_factor(name, policy, fuse, d, registry):
    """The reference's result, computed once per distinct computation:
    under ``reference`` ``fuse`` never reaches a kernel, ``fuse=None`` runs
    the fused chain at these sizes (:func:`test_chain_plan_fuses_here`),
    and a cold-start ``tuned`` run is bitwise the ``model`` run (asserted
    by the reference's own tests/test_fusion.py)."""
    key = (name, "reference" if policy == "reference" else "model",
           None if policy == "reference" else fuse is not False)
    if key not in _JAX_FACTORS:
        with jl.use(policy=key[1], registry=registry):
            if name == "cholesky":
                out = jl.cholesky(d["spd"], block=BLOCK, fuse=fuse)
            elif name == "lu":
                out = jl.lu(d["gen"], block=BLOCK, fuse=fuse)
            else:
                out = jl.solve(d["gen"], d["rhs"], block=BLOCK)
        _JAX_FACTORS[key] = out
    return _JAX_FACTORS[key]


def test_chain_plan_fuses_here():
    """Both packages resolve every trailing update of the test sizes to the
    fused chain, so ``fuse=None`` and ``fuse=True`` run the same path."""
    from repro.tune import dispatch as jtd
    from repro_torch.tune import dispatch as ttd
    for form in ("syrk", "lu"):
        for r in range(BLOCK, N, BLOCK):
            shape = (r, r, BLOCK)
            assert jtd.resolve("trsm+gemm", shape, np.float32, policy="model",
                               form=form).fused
            assert ttd.resolve("trsm+gemm", shape, torch.float32,
                               policy="model", form=form, backend="cpu").fused


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("fuse", FUSES)
def test_factorizations_match_reference(data, registry, policy, fuse):
    d = data
    with tl.use(policy=policy, registry=registry, device="cpu"):
        l = tl.cholesky(d["spd"], block=BLOCK, fuse=fuse)
        packed, piv = tl.lu(d["gen"], block=BLOCK, fuse=fuse)
    tag = f"policy={policy} fuse={fuse}"
    _close(l, _jax_factor("cholesky", policy, fuse, d, registry), 64.0,
           "cholesky " + tag)
    jpacked, jpiv = _jax_factor("lu", policy, fuse, d, registry)
    _close(packed, jpacked, 64.0, "lu " + tag)
    assert piv.dtype == torch.int32
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))


@pytest.mark.parametrize("shape", [(48, 32), (32, 48)])
def test_rectangular_lu_matches_reference(shape, registry):
    """Tall and wide LU: the wide case's last trailing update has no rows
    left, which the dispatcher routes around the fused kernel."""
    a = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    with tl.use(policy="model", device="cpu"):
        packed, piv = tl.lu(a, block=BLOCK)
    with jl.use(policy="model", registry=registry):
        jpacked, jpiv = jl.lu(a, block=BLOCK)
    _close(packed, jpacked, 64.0)
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))


@pytest.mark.parametrize("policy", POLICIES)
def test_solve_matches_reference(data, registry, policy):
    d = data
    with tl.use(policy=policy, registry=registry, device="cpu"):
        x = tl.solve(d["gen"], d["rhs"], block=BLOCK)
        x1 = tl.solve(d["gen"], d["rhs"][:, 0], block=BLOCK)
    want = _jax_factor("solve", policy, None, d, registry)
    _close(x, want, 256.0)
    _close(x1, np.asarray(want)[:, 0], 256.0)


@pytest.mark.parametrize("n,block", [(200, 48), (261, 100)])
def test_ragged_solve_and_cholesky_match_reference(n, block, registry):
    """solve and cholesky at sizes the panel widths do not divide (the
    TRSM's planned block is 128), under the kernel policy: the blocked
    TRSM's updates (block x k x nrhs, a window of the factor) take B1's
    "gemv" variant and every trailing update B2, both on their plain
    routes here."""
    rng = np.random.default_rng(n)
    g = rng.normal(size=(n, n))
    spd = (g @ g.T + n * np.eye(n)).astype(np.float32)
    gen = (g + 2 * np.eye(n)).astype(np.float32)
    rhs = rng.normal(size=(n, 3)).astype(np.float32)
    with tl.use(policy="model", device="cpu"):
        x = tl.solve(gen, rhs, block=block)
        assert tgk.gemm.last_launch["variant"] == "gemv"
        l = tl.cholesky(spd, block=block)
        assert tfk.trsm_gemm.last_launch["plan"] == tfk.trsm_gemm_plan(
            torch.float32, block, "syrk")
    with jl.use(policy="model", registry=registry):
        jx = jl.solve(gen, rhs, block=block)
        jchol = jl.cholesky(spd, block=block)
    _close(x, jx, 256.0, "solve")
    _close(l, jchol, 64.0, "cholesky")


def test_launch_counters_move_under_model_on_cpu(data, registry):
    """The shared ``kernel.launch`` counter moves under ``model`` exactly as
    the reference's ``kernel.launch`` does, and every kernel wrapper is
    reached (its ``last_launch`` records a CPU call) while its own launch
    count stays put: the CPU route launches nothing. The reference policy
    reaches no wrapper."""
    d = data
    wrappers = (tgk.gemm, tfk.gemm_bias_act, tfk.trsm_gemm)

    def run(lin, **ctx):
        with lin.use(policy="model", registry=registry, **ctx):
            lin.gemm(d["a"], d["b"])
            lin.gemm_bias_act(d["a"], d["b"], d["bias"], "relu")
            lin.cholesky(d["spd"], block=BLOCK, fuse=True)
            lin.lu(d["gen"], block=BLOCK, fuse=False)

    counts = lambda: tuple(w.launches for w in wrappers)
    for w in wrappers:
        w.last_launch = None
    before, t0, j0 = counts(), tobs.counters_snapshot(), \
        jobs.counters_snapshot()
    run(tl, device="cpu")
    run(jl)
    assert counts() == before
    assert all(w.last_launch is not None and w.last_launch["device"] == "cpu"
               for w in wrappers), [w.last_launch for w in wrappers]
    t_launch = tobs.counters_delta(t0).get("kernel.launch", 0)
    assert t_launch > 0
    assert t_launch == jobs.counters_delta(j0)["kernel.launch"]
    for w in wrappers:
        w.last_launch = None
    t1 = tobs.counters_snapshot()
    with tl.use(policy="reference", device="cpu"):
        tl.cholesky(d["spd"], block=BLOCK, fuse=True)
        tl.gemm(d["a"], d["b"])
    assert counts() == before
    assert all(w.last_launch is None for w in wrappers)
    assert "kernel.launch" not in tobs.counters_delta(t1)


def test_cold_start_tuned_is_bitwise_model(data, registry):
    d = data
    out = {}
    for pol in ("model", "tuned"):
        with tl.use(policy=pol, registry=registry, device="cpu"):
            out[pol] = (tl.cholesky(d["spd"], block=BLOCK),
                        tl.lu(d["gen"], block=BLOCK)[0],
                        tl.gemm_bias_act(d["a"], d["b"], d["bias"], "gelu"))
    for m, t in zip(out["model"], out["tuned"]):
        assert torch.equal(m, t)


def test_batched_operands_run_in_lockstep_within_tolerance_of_the_2d_path(
        data):
    """3-D operands: the factorizations and gemm run the batch in lockstep
    (one blocked computation, one product, as the reference's vmap), each
    item within the dtype's tolerance of the 2-D path on it and with its
    pivots exactly (on the card each batched launch is bitwise the 2-D
    launch on the item: tests/test_torch_cuda.py)."""
    d = data
    a3 = np.stack([d["spd"], 2 * d["spd"]])
    b3 = np.stack([d["rhs"], -d["rhs"]])
    with tl.use(policy="model", device="cpu"):
        l3 = tl.cholesky(a3, block=BLOCK)
        p3, piv3 = tl.lu(a3, block=BLOCK)
        x3 = tl.solve(a3, b3, block=BLOCK)
        g3 = tl.gemm(a3, b3)
        for i in range(2):
            _close(l3[i], tl.cholesky(a3[i], block=BLOCK).numpy(), 16.0)
            packed, piv = tl.lu(a3[i], block=BLOCK)
            _close(p3[i], packed.numpy(), 16.0)
            assert torch.equal(piv3[i], piv)
            _close(x3[i], tl.solve(a3[i], b3[i], block=BLOCK).numpy(), 64.0)
            _close(g3[i], tl.gemm(a3[i], b3[i]).numpy(), 4.0)


def test_dtype_and_accumulation_context(data):
    d = data
    with tl.use(device="cpu", policy="model", accum_dtype="float64"):
        got = tl.gemm(d["a"], d["b"])
    assert got.dtype == torch.float32
    _close(got, d["a"].astype(np.float64) @ d["b"])
    with tl.use(device="cpu"):
        t = tl.gemm(torch.from_numpy(d["a"]), d["b"], dtype=torch.float64)
    assert t.dtype == torch.float64
    ctx = tl.get_context()
    assert ctx.describe()["device"] == "cuda"
    with pytest.raises(ValueError, match="device"):
        tl.use(device="tpu").__enter__()


def test_machine_and_trace_flow_through(data, registry):
    """The context machine reaches the planners inside the blocked driver,
    and a trace captures the routine, panel, trailing and fused spans."""
    d = data
    with tobs.trace("chol") as tr:
        with tl.use(policy="model", device="cpu", machine="cpu-host",
                    registry=registry):
            tl.cholesky(d["spd"], block=BLOCK, fuse=True)
            tl.gemm(d["a"], d["b"])
    assert tgk.gemm.last_launch["plan"] == tcd.plan_gemm(
        40, 30, 24, dtype=torch.float32, machine="cpu-host")
    names = {e.name for e in tr.events}
    assert {"linalg.cholesky", "potrf.panel", "potrf.trailing",
            "fused.trsm_gemm", "tune.resolve", "linalg.gemm"} <= names
    resolves = tr.spans("tune.resolve")
    assert resolves and all(e.attrs["machine"] == "cpu-host"
                            for e in resolves)
    assert tr.spans("linalg.cholesky")[0].attrs["flops"] == N ** 3 // 3
    with tobs.trace("quiet") as quiet:
        with tl.use(device="cpu", obs=False):
            tl.cholesky(d["spd"], block=BLOCK)
    assert quiet.events == []
