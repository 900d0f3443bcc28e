"""The batched drivers in lockstep: one blocked computation over the batch.

``repro_torch.lapack.batched`` runs a (B, m, n) batch through the blocked
drivers at once, as the reference ``vmap``s them: each panel column is one
set of launches for all items and each trailing update one kernel launch
(B2 for potrf / getrf, B1 twice for geqrf, B1's ``gemv`` once per TRSM
update of a solve). Three groups of cases, each on inputs made from a
numpy seed:

(a) the lockstep drivers against the 2-D drivers run item by item, within
    ``dtype_tolerances`` (pivots exactly): ragged n, m != n, B = 1, a
    non-SPD item whose NaNs stay in it, vector and matrix right-hand
    sides, f32 here and f64 in one ``JAX_ENABLE_X64`` subprocess (which
    also holds them to ``repro.lapack.batched``);
(b) the kernels' plain versions on 3-D operands against ``jax.vmap`` of
    the reference's Pallas kernels in interpret mode (the batch axis's
    differential chain);
(c) the launch records of the card route traced on fake CUDA tensors
    (no card, no build): B2 once per trailing update with 3-D operands and
    the batched grid, B1 twice per QR step, ``gemv`` once per TRSM update,
    the batch cut at 65535 items a launch, a batched bf16 product as one
    "wgmma" launch; and the batched B2's own plan, occupancy table, grid,
    argument tuple (its zeroed ``sync`` workspace, no BL transpose
    workspace) and record.
"""
import ast
import inspect
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
from repro.kernels import fused as jfk
from repro.kernels import gemm as jgk
from repro_torch import linalg as tl
from repro_torch.analysis import fake_card
from repro_torch.kernels import _build, fused as tfk, gemm as tgk
from repro_torch.kernels import launch_record
from repro_torch.lapack import batched as tb
from repro_torch.lapack import cholesky, lu, qr, solve
from repro_torch.tune import dispatch as td

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = torch.device("cuda")
BLOCK = 16


@pytest.fixture(autouse=True)
def _port_default_context():
    tl.reset_context()
    yield
    tl.reset_context()


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(*shape, seed=0):
    return torch.from_numpy(_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def _spd(b, n, seed=0):
    g = _rng(seed).standard_normal((b, n, n))
    return torch.from_numpy((g @ g.transpose(0, 2, 1) / n + np.eye(n))
                            .astype(np.float32))


def _close(got, want, scale, msg=""):
    rtol, atol = dtype_tolerances(str(got.dtype).removeprefix("torch."),
                                  scale)
    np.testing.assert_allclose(got.double().numpy(), want.double().numpy(),
                               rtol=rtol, atol=atol, err_msg=msg)


# ------------------------- (a) lockstep against 2-D --------------------------

def _per_item(kind, a, rhs, pol):
    """The 2-D driver and solve on each item: (factors, pivots or tau,
    solutions)."""
    f, aux, x = [], [], []
    for i in range(a.shape[0]):
        if kind == "potrf":
            fi = cholesky.potrf(a[i], block=BLOCK, policy=pol)
            xi = solve.potrs(fi, rhs[i], policy=pol)
            ai = None
        elif kind == "getrf":
            fi, ai = lu.getrf(a[i], block=BLOCK, policy=pol)
            xi = solve.getrs(fi, ai, rhs[i], policy=pol) \
                if a.shape[1] == a.shape[2] else None
        else:
            fi, ai = qr.geqrf(a[i], block=BLOCK, policy=pol)
            xi = solve.geqrs(fi, ai, rhs[i], policy=pol) \
                if a.shape[1] >= a.shape[2] else None
        f.append(fi)
        aux.append(ai)
        x.append(xi)
    return f, aux, x


# (kind, B, m, n): ragged n (not a multiple of BLOCK), m != n, B = 1
SHAPES = [("potrf", 3, 40, 40), ("potrf", 1, 40, 40),
          ("getrf", 3, 40, 40), ("getrf", 3, 44, 28), ("getrf", 2, 28, 44),
          ("getrf", 1, 36, 36),
          ("geqrf", 3, 44, 28), ("geqrf", 2, 20, 36), ("geqrf", 1, 40, 40)]


@pytest.mark.parametrize("policy", ["model", "reference"])
@pytest.mark.parametrize("kind,b,m,n", SHAPES)
def test_lockstep_matches_the_2d_drivers(kind, b, m, n, policy):
    a = _spd(b, n, seed=m) if kind == "potrf" else _f32(b, m, n, seed=m)
    rhs = _f32(b, m, 3, seed=m + 1)
    driver = getattr(tb, "batched_" + kind)
    res = driver(a, block=BLOCK, policy=policy)
    assert (res.kind, res.block, res.batch) == (kind, BLOCK, b)
    assert res.factors.shape == a.shape
    f, aux, x = _per_item(kind, a, rhs, policy)
    tag = f"{kind} {b}x{m}x{n} {policy}"
    for i in range(b):
        _close(res.factors[i], f[i], 16.0, f"factors {tag} item {i}")
        if kind == "getrf":
            assert res.pivots.dtype == torch.int32
            assert torch.equal(res.pivots[i], aux[i]), (tag, i)
        if kind == "geqrf":
            _close(res.tau[i], aux[i], 16.0, f"tau {tag} item {i}")
    if kind != "getrf" or m == n:              # lu_reconstruct: square
        _close(tb.reconstruct(res), a, 64.0, f"round trip {tag}")
    if x[0] is None:
        return
    got = tb.batched_solve(res, rhs, policy=policy)
    vec = tb.batched_solve(res, rhs[:, :, 0], policy=policy)
    assert got.shape == (b, n, 3) and vec.shape == (b, n)
    for i in range(b):
        _close(got[i], x[i], 64.0, f"solve {tag} item {i}")
        _close(vec[i], x[i][:, 0], 64.0, f"vector solve {tag} item {i}")


def test_non_spd_item_keeps_its_nans():
    spd = _spd(3, 40, seed=2)
    spd[1] -= 3 * torch.eye(40)                  # item 1 is indefinite
    with tl.use(policy="model", device="cpu"):
        got = tl.batched_cholesky(spd, block=BLOCK).factors
    assert torch.isnan(got[1]).any()
    assert not torch.isnan(got[0]).any() and not torch.isnan(got[2]).any()
    for i in (0, 2):
        _close(got[i], cholesky.potrf(spd[i], block=BLOCK, policy="model"),
               16.0, f"item {i}")


def test_zero_pivot_stays_in_its_item():
    a = _f32(3, 36, 36, seed=4)
    a[1, :, 5] = 0                               # item 1: a zero column
    res = tb.batched_getrf(a, block=BLOCK, policy="model")
    for i in range(3):
        packed, piv = lu.getrf(a[i], block=BLOCK, policy="model")
        assert torch.equal(res.pivots[i], piv)
        assert torch.isfinite(res.factors[i]).all()
        _close(res.factors[i], packed, 16.0, f"item {i}")
    assert res.factors[1, 5, 5] == 0


def test_batched_module_has_no_loop_over_items():
    """No Python loop (for, comprehension) anywhere in the batched
    drivers' module: each driver calls the blocked driver once on the
    whole tensor."""
    tree = ast.parse(inspect.getsource(tb))
    loops = [type(n).__name__ for n in ast.walk(tree)
             if isinstance(n, (ast.For, ast.While, ast.comprehension))]
    assert loops == []


_X64 = textwrap.dedent("""
import sys
sys.path.insert(0, "tests")
from conftest import dtype_tolerances
import numpy as np
import jax
import jax.numpy as jnp
import torch
from repro.kernels import fused as jfk
from repro.kernels import gemm as jgk
from repro.lapack import batched as jb
from repro_torch.kernels import fused as tfk, gemm as tgk
from repro_torch.lapack import batched as tb
from repro_torch.lapack import cholesky, lu, qr, solve

def close(got, want, scale, msg):
    assert got.dtype == torch.float64, got.dtype
    rtol, atol = dtype_tolerances(np.float64, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)

rng = np.random.default_rng(0)
g = rng.normal(size=(3, 40, 40))
spd = g @ g.transpose(0, 2, 1) / 40 + np.eye(40)
tall = rng.normal(size=(3, 44, 28))
rhs = rng.normal(size=(3, 40, 2))
trhs = rng.normal(size=(3, 44, 2))
jsolve = jax.jit(jb.batched_solve, static_argnames=("policy",))
for kind, a, b in (("potrf", spd, rhs), ("getrf", g, rhs),
                   ("geqrf", tall, trhs)):
    t = torch.from_numpy(a)
    res = getattr(tb, "batched_" + kind)(t, block=16, policy="model")
    x = tb.batched_solve(res, torch.from_numpy(b), policy="model")
    for i in range(3):
        if kind == "potrf":
            f = cholesky.potrf(t[i], block=16, policy="model")
            xi = solve.potrs(f, torch.from_numpy(b[i]), policy="model")
        elif kind == "getrf":
            f, p = lu.getrf(t[i], block=16, policy="model")
            assert torch.equal(p, res.pivots[i])
            xi = solve.getrs(f, p, torch.from_numpy(b[i]), policy="model")
        else:
            f, tau = qr.geqrf(t[i], block=16, policy="model")
            xi = solve.geqrs(f, tau, torch.from_numpy(b[i]), policy="model")
        close(res.factors[i], f, 16.0, f"{kind} item {i}")
        close(x[i], xi, 64.0, f"{kind} solve item {i}")
    jres = jax.jit(getattr(jb, "batched_" + kind), static_argnames=(
        "block", "policy"))(jnp.asarray(a), block=16, policy="model")
    close(res.factors, jres.factors, 16.0, kind + " reference")
    close(x, jsolve(jres, jnp.asarray(b), policy="model"), 64.0,
          kind + " reference solve")
# (b) in f64: the 3-D plain kernels against vmap of the Pallas kernels
a3, b3 = rng.normal(size=(3, 24, 40)), rng.normal(size=(3, 40, 20))
want = jax.vmap(lambda x, y: jgk.gemm(x, y, interpret=True))(
    jnp.asarray(a3), jnp.asarray(b3))
close(tgk.gemm_plain(torch.from_numpy(a3), torch.from_numpy(b3)), want,
      4.0, "gemm_plain")
l11 = np.tril(rng.normal(size=(3, 16, 16)), -1) / 16 + 2 * np.eye(16)
ap, c = rng.normal(size=(3, 16, 24)), rng.normal(size=(3, 24, 24))
jx, jc = jax.vmap(lambda l, p, cc: jfk.trsm_gemm(
    l, p, None, cc, form="syrk", interpret=True))(
        jnp.asarray(l11), jnp.asarray(ap), jnp.asarray(c))
x, co = tfk.trsm_gemm_plain(*(torch.from_numpy(v) for v in (l11, ap)),
                            None, torch.from_numpy(c), form="syrk")
close(x, jx, 4.0, "trsm_gemm_plain x")
close(co, jc, 16.0, "trsm_gemm_plain c")
print("x64 lockstep legs OK")
""")


def test_float64_lockstep_and_reference_in_x64():
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", _X64], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert "x64 lockstep legs OK" in r.stdout


# --------------------- (b) the 3-D plain kernels, f32 ------------------------

@pytest.mark.parametrize("broadcast", [None, "a", "b"])
def test_gemm_plain_3d_against_vmapped_pallas(broadcast):
    a3, b3 = _f32(3, 24, 40, seed=1), _f32(3, 40, 20, seed=2)
    a = a3[0] if broadcast == "a" else a3
    b = b3[0] if broadcast == "b" else b3
    want = jax.vmap(lambda x, y: jgk.gemm(x, y, interpret=True),
                    in_axes=(None if broadcast == "a" else 0,
                             None if broadcast == "b" else 0))(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    got = tgk.gemm_plain(a, b)
    assert got.shape == (3, 24, 20)
    _close(got, torch.from_numpy(np.asarray(want)), 4.0, "gemm")
    assert torch.equal(tgk.gemm(a, b), got)       # the CPU route


@pytest.mark.parametrize("form", ["lu", "syrk"])
def test_trsm_gemm_plain_3d_against_vmapped_pallas(form):
    nb, n, m = 16, 24, 24 if form == "syrk" else 30
    rng = _rng(3)
    unit = form == "lu"
    l11 = np.tril(rng.standard_normal((3, nb, nb)), -1) / nb + \
        (1.0 if unit else 2.0) * np.eye(nb)
    ap = rng.standard_normal((3, nb, n))
    c = rng.standard_normal((3, m, n))
    bl = rng.standard_normal((3, m, nb)) if form == "lu" else None
    f32 = lambda v: None if v is None else v.astype(np.float32)
    l11, ap, c, bl = f32(l11), f32(ap), f32(c), f32(bl)
    if form == "lu":
        jx, jc = jax.vmap(lambda l, p, b_, cc: jfk.trsm_gemm(
            l, p, b_, cc, form="lu", unit_diag=True, interpret=True))(
                jnp.asarray(l11), jnp.asarray(ap), jnp.asarray(bl),
                jnp.asarray(c))
    else:
        jx, jc = jax.vmap(lambda l, p, cc: jfk.trsm_gemm(
            l, p, None, cc, form="syrk", interpret=True))(
                jnp.asarray(l11), jnp.asarray(ap), jnp.asarray(c))
    t = lambda v: None if v is None else torch.from_numpy(v)
    x, co = tfk.trsm_gemm_plain(t(l11), t(ap), t(bl), t(c), form=form,
                                unit_diag=unit)
    _close(x, torch.from_numpy(np.asarray(jx)), 4.0, f"{form} x")
    _close(co, torch.from_numpy(np.asarray(jc)), 16.0, f"{form} c")
    x2, c2 = tfk.trsm_gemm(t(l11), t(ap), t(bl), t(c), form=form,
                           unit_diag=unit)    # the CPU route
    assert torch.equal(x2, x) and torch.equal(c2, co)
    for i in range(3):                          # each item against 2-D
        xi, ci = tfk.trsm_gemm_plain(
            t(l11)[i], t(ap)[i], None if bl is None else t(bl)[i],
            t(c)[i], form=form, unit_diag=unit)
        _close(x[i], xi, 4.0, f"{form} x item {i}")
        _close(co[i], ci, 16.0, f"{form} c item {i}")


# --------------------- (c) the card route's launch records -------------------

@pytest.fixture
def no_library(monkeypatch):
    """A fake launch must never reach the build or ctypes."""
    def refuse(stem):
        raise AssertionError(f"_build.library({stem!r}) reached")
    monkeypatch.setattr(_build, "library", refuse)


def _trace(fn, *args, **kw):
    with tl.use(policy="model"):
        return fake_card.trace(fn, args, kw, CARD)


def _kinds(tr):
    out = {}
    for r in tr.launches:
        out[f"{r['kernel']}/{r['variant']}"] = \
            out.get(f"{r['kernel']}/{r['variant']}", 0) + 1
    return out


@pytest.mark.parametrize("routine,form", [("batched_cholesky", "syrk"),
                                          ("batched_lu", "lu")])
def test_b2_once_per_trailing_update_for_the_batch(no_library, routine,
                                                   form):
    b, n, nb = 4, 96, 32
    a = _spd(b, n) if form == "syrk" else _f32(b, n, n)
    tr = _trace(getattr(tl, routine), a.numpy(), block=nb)
    fused = [td.resolve("trsm+gemm", (n - j1, n - j1, nb), torch.float32,
                        policy="model", backend="cuda", form=form).fused
             for j1 in range(nb, n, nb)]
    assert all(fused) and len(fused) == n // nb - 1
    assert _kinds(tr) == {"trsm_gemm/ffma": n // nb - 1}
    sms = launch_record.h100().pe.sm_count
    for rec, j1 in zip(tr.launches, range(nb, n, nb)):
        r = n - j1
        plan = tfk.trsm_gemm_batched_plan(torch.float32, nb, form)
        co = tfk.co_resident_ctas(torch.float32, plan.smem_bytes, sms, plan)
        shapes = [o[0] for o in rec["operands"]]
        want = [(b, nb, nb), (b, nb, r)] + \
            ([(b, r, nb)] if form == "lu" else []) + [(b, r, r)]
        assert shapes == want, (shapes, want)
        assert rec["grid"] == (tfk.trsm_gemm_grid(co, plan, r, r, form, b),)
        assert rec["grid"][0] <= co
        assert rec["smem_bytes"] == plan.smem_bytes


def test_b1_twice_per_qr_step_for_the_batch(no_library):
    b, m, n, nb = 4, 64, 64, 32
    tr = _trace(tl.batched_qr, _f32(b, m, n).numpy(), block=nb)
    steps = sum(j0 + min(nb, n - j0) < n for j0 in range(0, n, nb))
    assert _kinds(tr) == {"gemm/ffma": 2 * steps}
    for rec in tr.launches:
        a, bb, c = (o[0] for o in rec["operands"])
        assert len(a) == len(bb) == len(c) == 3 and c[0] == b
        assert rec["grid"] == tgk.launch_grid("ffma", rec["tile"], c[1],
                                              c[2], None, b)


def test_gemv_once_per_trsm_update_for_the_batch(no_library):
    b, n, nrhs = 3, 256, 4
    factors = np.tril(_f32(b, n, n).numpy()) + n * np.eye(n, dtype=np.float32)
    res = tb.FactorizationResult(torch.from_numpy(factors), None, None,
                                 "potrf", 16)
    tr = _trace(tl.batched_solve, res, _f32(b, n, nrhs).numpy())
    block = td.resolve("trsm", (n, nrhs), torch.float32, policy="model",
                       backend="cuda").block
    per_item = 2 * (-(-n // block) - 1)         # the lower and upper solve
    assert _kinds(tr) == {"gemm/gemv": per_item}
    for rec in tr.launches:
        m, k = rec["operands"][0][0][1:]
        segs, ks = tgk.gemv_split(m, k, launch_record.h100().pe.sm_count)
        assert rec["grid"] == (segs, -(-m // tgk.TILES["gemv"][0]), b)


def test_batch_is_cut_at_the_grid_limit(no_library):
    big = tgk.MAX_BATCH + 7

    def build():
        a = torch.empty((big, 32, 32), device="cuda")
        bb = torch.empty((32, 32), device="cuda")      # broadcast
        return tgk.gemm, (a, bb), {}
    tr = fake_card.run(build, CARD)
    assert [r["grid"][-1] for r in tr.launches] == [tgk.MAX_BATCH, 7]
    assert {r["variant"] for r in tr.launches} == {"ffma"}
    assert all(r["operands"][1][0] == (32, 32) for r in tr.launches)


def test_batched_bf16_on_the_tensor_cores_is_refused(no_library):
    """No longer refused: "wgmma" reads a batch through 3-D TMA maps, so a
    batched bf16 product is one "wgmma" launch with the batch as its
    grid's y axis (the name stays from when the card route raised)."""
    a = torch.zeros((2, 64, 64), dtype=torch.bfloat16)
    tr = fake_card.trace(tgk.gemm, (a, a), {}, CARD)
    assert [(r["variant"], r["grid"][-1]) for r in tr.launches] == \
        [("wgmma", 2)]
    assert tr.launches[0]["grid"] == tgk.launch_grid(
        "wgmma", tr.launches[0]["tile"], 64, 64, None, 2)
    # the CPU route computes it (the plain version)
    assert tgk.gemm(a, a).shape == (2, 64, 64)


def test_batched_variant_reads_each_items_alignment():
    """A tiled variant needs every item's base 16-byte aligned: the batch
    stride in bytes is tested beside the row stride."""
    a = torch.zeros((3, 40, 36))                  # item stride 1440 floats
    assert tgk.gemm_variant(a, torch.zeros(3, 36, 32)) == "ffma"
    odd = torch.zeros((3, 40 * 36 + 1))[:, :40 * 36].view(3, 40, 36)
    assert odd.stride(0) == 40 * 36 + 1
    assert tgk.gemm_variant(odd, torch.zeros(3, 36, 32)) == "simt"
    assert tgk.gemm_variant(odd[:1], torch.zeros(1, 36, 32)) == "ffma"
    assert tgk.batch_stride(odd[:1]) == 0 and tgk.batch_stride(a[0]) == 0


# --------------------- (d) the batched B2's own launch -----------------------

@pytest.mark.parametrize("dtype,nb,width,l_smem", [
    (torch.float32, 128, 64, True), (torch.bfloat16, 128, 64, True),
    (torch.float64, 128, 64, True), (torch.float32, 32, 64, True),
    (torch.float32, 50, 64, True), (torch.float32, 300, 64, False),
    (torch.float64, 200, 64, False), (torch.float32, 1000, 32, False),
    (torch.float64, 600, 32, False)])
def test_batched_b2_plan(dtype, nb, width, l_smem):
    """64 columns of X with L11 staged (a packed lower triangle, rows
    padded to multiples of 4), else 64 or 32 with L11 read through the
    cache; the shared memory is the kernel's formula."""
    for form in ("syrk", "lu"):
        plan = tfk.trsm_gemm_batched_plan(dtype, nb, form)
        assert (plan.width, plan.l_in_smem) == (width, l_smem)
        assert plan.nb_padded == -(-nb // 16) * 16
        acc = 8 if dtype == torch.float64 else 4
        nbp = plan.nb_padded
        packed = sum(-(-(r + 1) // 4) * 4 for r in range(nbp))
        solve = (nbp * (width + 2) + (packed if l_smem else 0)) * acc
        mb = 128 if acc == 8 else 64
        ring_a = 16 * (132 if acc == 8 else 64) * acc
        ring_b = 16 * (132 if acc == 8 else 128) * acc
        rings = max(3 * (ring_a + ring_b), 3 * ring_b + ring_a + 3 * mb * 144)
        update = (rings + mb * 128 * acc if acc == 4
                  else max(rings, mb * 128 * acc))
        assert plan.smem_bytes == max(solve, update) + 16
        assert plan.smem_bytes <= tfk.SMEM_LIMIT
        assert plan.update == ("dmma" if dtype == torch.float64 else "ffma")
        assert plan.a_operand == ("X^T" if form == "syrk" else "BL")


def test_batched_b2_plan_refuses_panels_past_32_columns():
    with pytest.raises(ValueError, match="32-column X block"):
        tfk.trsm_gemm_batched_plan(torch.float32, 1800, "syrk")
    assert tfk.trsm_gemm_plan(torch.float32, 1800, "syrk").width >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_batched_b2_occupancy_is_its_own(dtype, monkeypatch):
    """Each kernel's co-resident CTAs come from its own registers and
    shared memory: a batched kernel that needed more registers would
    shrink its own grid, never a 2-D launch's."""
    sms = launch_record.h100().pe.sm_count
    plan2 = tfk.trsm_gemm_plan(dtype, 128, "syrk")
    planb = tfk.trsm_gemm_batched_plan(dtype, 128, "syrk")
    two_d = tfk.co_resident_ctas(dtype, plan2.smem_bytes, sms)
    both = tfk.co_resident_ctas(dtype, planb.smem_bytes, sms, planb)
    per_sm = 2 if dtype != torch.float64 else 1
    assert two_d == both == per_sm * sms
    assert tfk.trsm_gemm_registers(dtype) == tfk.TRSM_GEMM_REGISTERS[dtype]
    assert tfk.trsm_gemm_registers(dtype, planb) == \
        tfk.TRSM_GEMM_BATCHED_REGISTERS[dtype, 64, True, "X^T"]
    heavy = dict(tfk.TRSM_GEMM_BATCHED_REGISTERS)
    heavy[dtype, planb.width, planb.l_in_smem, planb.a_operand] = 255
    monkeypatch.setattr(tfk, "TRSM_GEMM_BATCHED_REGISTERS", heavy)
    assert tfk.co_resident_ctas(dtype, planb.smem_bytes, sms, planb) == sms
    assert tfk.co_resident_ctas(dtype, plan2.smem_bytes, sms) == two_d


@pytest.mark.parametrize("m,n,batch", [(384, 384, 64), (128, 128, 64),
                                       (0, 384, 64), (40, 40, 300),
                                       (200, 200, 2), (384, 384, 1)])
def test_batched_b2_grid_is_one_task_list(m, n, batch):
    """A batch's grid is the co-resident CTAs or its whole task list
    (every item's solve blocks and C tiles), whichever is fewer; one item
    keeps the 2-D kernel's larger phase."""
    co = 264
    plan = (tfk.trsm_gemm_batched_plan if batch > 1 else
            tfk.trsm_gemm_plan)(torch.float32, 128, "lu")
    solves = -(-n // 128) * 128 // plan.width
    rows = 64 if batch > 1 else 128        # the batched f32 tile: 64 x 128
    tiles = -(-m // rows) * -(-n // 128)
    grid = tfk.trsm_gemm_grid(co, plan, m, n, "lu", batch)
    if batch > 1:
        assert grid == min(co, batch * (solves + tiles))
    else:
        transposes = 128 // 32 * (-(-m // 128) * 128 // 32)
        assert grid == min(co, max(solves + transposes, tiles))


@pytest.mark.parametrize("form", ["syrk", "lu"])
def test_batched_b2_arguments_and_record(no_library, form):
    """The batched launch's C arguments: no BL transpose workspace, the
    zeroed ``sync`` workspace (the ticket, then one count per item) last
    before the stream; its record carries the batched plan's shared
    memory and grid, and its int slots the batched width."""
    b, nb, n = 5, 64, 200
    seen = {}
    real_args = tfk._trsm_args

    def spy(plan, form_, unit, ops, grid, ptr, stream):
        seen["ops"], seen["plan"] = ops, plan
        seen["call"] = real_args(plan, form_, unit, ops, grid, ptr, stream)
        return seen["call"]

    def build():
        a = torch.empty((b, nb + n, nb + n), device="cuda")
        views = (a[:, :nb, :nb], a[:, nb:, :nb].mT, None, a[:, nb:, nb:]) \
            if form == "syrk" else (a[:, :nb, :nb], a[:, :nb, nb:],
                                    a[:, nb:, :nb], a[:, nb:, nb:])
        return tfk.trsm_gemm, views, {"form": form,
                                      "unit_diag": form == "lu"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfk, "_trsm_args", spy)
        tr = fake_card.run(build, CARD)
    (rec,) = tr.launches
    plan = tfk.trsm_gemm_batched_plan(torch.float32, nb, form)
    assert seen["plan"] == plan
    sync, blt = seen["ops"][8], seen["ops"][7]
    assert blt is None
    assert sync.shape == (1 + b,) and sync.dtype == torch.int32
    call = seen["call"]
    assert call[18] is None                       # blt
    assert call[-2] == launch_record.address(sync)
    assert call[-1] is None                       # the fake launch's stream
    assert call[26] == b and call[22] == plan.width
    co = tfk.co_resident_ctas(torch.float32, plan.smem_bytes,
                              launch_record.h100().pe.sm_count, plan)
    assert rec["grid"] == (tfk.trsm_gemm_grid(co, plan, n, n, form, b),)
    assert rec["smem_bytes"] == plan.smem_bytes
    assert rec["ints"][:3] == (0, int(form == "syrk"), int(form == "lu"))
    assert plan.width in rec["ints"]
