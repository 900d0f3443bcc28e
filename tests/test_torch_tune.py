"""repro_torch's tuning loop against the JAX package, on the CPU.

The paper's pipeline model (``core/pipeline_model``) against
``repro.core.pipeline_model`` in float64 (the reference in x64 mode); the
machine specs (every reference JSON through the port, the ``h100`` spec);
the planners under ``h100`` (every GEMM plan a compiled, fitting CTA tile;
B2 priced by its own shared memory and fused at the drivers' shapes); the
machine a call that names none is priced for (its device's); ``measure``
on the reference's synthetic timers; ``search`` against the reference
(candidates and scores under ``tpu-like``, registries the reference
reads, the winner's tile launched by dispatch). The kernels' plain
versions run here; the card runs the kernels (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import dataclasses
import inspect
import itertools
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro import arch as jarch
from repro.core import pipeline_model as jpm
from repro.tune import measure as JM
from repro.tune import registry as jreg
from repro.tune import search as jsearch
from repro_torch import arch as tarch
from repro_torch import linalg as tl
from repro_torch.core import codesign as tcd
from repro_torch.core import pipeline_model as tpm
from repro_torch.linalg import context as tctx
from repro_torch.kernels import fused as tfk
from repro_torch.kernels import gemm as tgk
from repro_torch.tune import dispatch as ttd
from repro_torch.tune import measure as TM
from repro_torch.tune import registry as treg
from repro_torch.tune import search as tsearch

MACHINES = ("tpu-like", "paper-pe", "cpu-host")
H100 = tarch.get("h100")
DTYPES = (torch.bfloat16, torch.float32, torch.float64)
# ragged, skinny, square, the main path's and the tune phase's shapes
H100_SHAPES = [(1, 1, 1), (7, 129, 33), (17, 40, 8), (128, 1, 8064),
               (128, 8064, 128), (1000, 776, 520), (1024, 1024, 1024),
               (4096, 4096, 4096), (8064, 8064, 128), (8192, 8192, 8192),
               (20000, 16, 300)]
RTOL = 1e-12      # float64 on both sides, the same operations in order


@pytest.fixture
def x64():
    """The reference's pipeline model in float64 (its x64 mode), restored
    afterwards."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


@pytest.fixture(autouse=True)
def _port_default_context():
    tl.reset_context()
    yield
    tl.reset_context()


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                      np.float64)


# ------------------------------ pipeline model -------------------------------

@pytest.mark.parametrize("n_i,ratio,gamma", [
    (1e2, 0.1, 0.5), (1e4, 0.01, 0.2), (1e6, 0.001, 0.8), (5e5, 0.0, 0.5),
    (3.0, 0.4, 0.9)])
def test_pipeline_model_matches_reference(x64, n_i, ratio, gamma):
    """tpi over a depth grid, the closed-form and the integer optimum, the
    multi-pipe TPI and throughput: the port equals the reference."""
    p = np.arange(1, 65)
    kw = dict(n_i=n_i, n_h=ratio * n_i, gamma=gamma, t_p=40.0, t_o=1.0)
    np.testing.assert_allclose(_np(tpm.tpi(p, **kw)), _np(jpm.tpi(p, **kw)),
                               rtol=RTOL)
    np.testing.assert_allclose(_np(tpm.p_opt(**kw)), _np(jpm.p_opt(**kw)),
                               rtol=RTOL)
    tp = tpm.PipeParams(n_i, ratio * n_i, gamma, 40.0, 1.0)
    jp = jpm.PipeParams(n_i, ratio * n_i, gamma, 40.0, 1.0)
    assert tpm.p_opt_int(tp) == jpm.p_opt_int(jp)
    np.testing.assert_allclose(_np(tpm.total_time(5.0, tp)),
                               _np(jpm.total_time(5.0, jp)), rtol=RTOL)
    depths = {"mul": 5, "add": 4}
    tpipes = {"mul": tp, "add": tp.replace(n_i=2 * n_i)}
    jpipes = {"mul": jp, "add": jp.replace(n_i=2 * n_i)}
    np.testing.assert_allclose(_np(tpm.tpi_multi(depths, tpipes)),
                               _np(jpm.tpi_multi(depths, jpipes)), rtol=RTOL)
    assert tpm.throughput(depths, tpipes) == pytest.approx(
        jpm.throughput(depths, jpipes), rel=RTOL)


@pytest.mark.parametrize("figure", ["figure2_curves", "figure3_curves",
                                    "figure4_curves"])
def test_figure_curves_match_reference(x64, figure):
    t, j = getattr(tpm, figure)(), getattr(jpm, figure)()
    assert list(t) == list(j)
    for key in j:
        for tv, jv in zip(t[key], j[key]):
            np.testing.assert_allclose(_np(tv), _np(jv), rtol=RTOL)


@pytest.mark.parametrize("name", MACHINES)
def test_fpu_spec_feeds_pipeline_model(x64, name):
    t, j = tarch.get(name).fpu, jarch.get(name).fpu
    for cls in tarch.OP_CLASSES:
        assert dataclasses.asdict(t.pipe_params(cls, 1e5, 1e3)) == \
            dataclasses.asdict(j.pipe_params(cls, 1e5, 1e3))
        np.testing.assert_allclose(_np(t.tpi(cls, np.arange(1, 9), 1e5, 1e3)),
                                   _np(j.tpi(cls, np.arange(1, 9), 1e5, 1e3)),
                                   rtol=RTOL)
        assert t.p_opt(cls, 1e5, 1e3) == j.p_opt(cls, 1e5, 1e3)
        assert math.isinf(t.p_opt(cls, 1e5, 0))


# ----------------------------------- specs -----------------------------------

@pytest.mark.parametrize("name", MACHINES)
def test_reference_spec_json_loads_and_writes_back(tmp_path, name):
    """A spec file the reference writes loads into the port and writes back
    byte for byte (the port's optional fields stay out)."""
    path = jarch.get(name).save(str(tmp_path / f"{name}.json"))
    back = tarch.MachineSpec.load(path).save(str(tmp_path / "back.json"))
    assert open(back).read() == open(path).read()


def test_h100_spec_roundtrips_and_has_its_fields(tmp_path):
    path = H100.save(str(tmp_path / "h100.json"))
    assert tarch.MachineSpec.load(path) == H100
    blob = json.load(open(path))
    assert blob["pe"]["sm_count"] == 132 and blob["native_dtype"] == "float32"
    assert H100.memory.vmem_bytes == 232448 and H100.pe.vreg_budget == 255
    assert H100.pe.peak_flops == 67e12 and H100.memory.hbm_bw == 3.35e12
    # the SM clock the FP32 peak implies, and the FP32 lanes behind it
    assert H100.pe.vpu_flops * 2 == pytest.approx(H100.pe.peak_flops)
    assert tcd.is_gpu(H100) and not any(tcd.is_gpu(tarch.get(m))
                                        for m in MACHINES)
    with pytest.raises(ValueError, match="sm_count"):
        dataclasses.replace(H100.pe, sm_count=0)


# ------------------------------ h100 planners --------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_h100_gemm_plans_are_compiled_fitting_tiles(dtype):
    """Every plan_gemm / plan_from_blocks tile under h100 is one the dtype's
    tiled variant is compiled for; its stages fit the shared memory one CTA
    may use, its accumulator the register budget, and bm/bn/bk are
    multiples of the MMA granule; the footprint is the kernel's."""
    db = dtype.itemsize
    variant = tgk.TILED[dtype]
    tiles = {t[:3]: t for t in tcd.hopper_tiles(db)}
    assert set(tiles) == set(tgk.TILE_SETS[variant])
    for m, n, k in H100_SHAPES:
        p = tcd.plan_gemm(m, n, k, dtype=dtype, machine="h100")
        bm, bn, bk, stages, threads = tiles[(p.bm, p.bn, p.bk)]
        assert p.vmem_bytes == tcd.cta_smem_bytes(db, bm, bn, bk, stages)
        assert p.vmem_bytes <= H100.memory.vmem_bytes
        assert tcd.accumulator_registers(db, bm, bn, threads) \
            <= H100.pe.vreg_budget
        assert all(d % H100.pe.mxu == 0 for d in (p.bm, p.bn, p.bk))
        assert p.ridge == H100.pe.peak_flops / H100.memory.hbm_bw
        assert p.grid == (-(-m // bm), -(-n // bn), -(-k // bk))
        assert tcd.plan_from_blocks(m, n, k, bm, bn, bk, dtype=dtype,
                                    machine="h100") == p
        launch_plan = tgk.launch_tile(variant, p)
        assert launch_plan == ((p.bm, p.bn, p.bk), "plan")


def test_h100_main_path_tiles_and_waves():
    """At the main path's shapes the model keeps the tiles the kernels
    shipped with; a grid too small for a wave of 132 SMs takes the tile
    with more CTAs."""
    tile = lambda m, n, k, dt: (lambda p: (p.bm, p.bn, p.bk))(
        tcd.plan_gemm(m, n, k, dtype=dt, machine="h100"))
    assert tile(8192, 8192, 8192, torch.float32) == (128, 128, 16)
    assert tile(8192, 8192, 8192, torch.bfloat16) == (128, 256, 64)
    assert tile(4096, 4096, 4096, torch.float64) == (128, 128, 32)
    assert tile(1024, 1024, 1024, torch.float32) == (64, 128, 16)
    assert tile(1024, 1024, 1024, torch.bfloat16) == (128, 128, 64)
    # no tile fits a tiny budget: the smallest footprint, still compiled
    p = tcd.plan_gemm(512, 512, 512, dtype=torch.float64, machine="h100",
                      vmem_budget=1)
    assert (p.bm, p.bn, p.bk) == (64, 128, 32)


@pytest.mark.parametrize("form", ["syrk", "lu"])
@pytest.mark.parametrize("dtype,n_prime", [(torch.float32, 8064),
                                           (torch.float64, 3968)])
def test_h100_chain_planner_prices_b2_and_fuses(form, dtype, n_prime):
    """Under h100 the trsm+gemm chain prices B2's real shared memory per CTA
    (trsm_gemm_smem, the formula B2's wrapper launches with) and fuses the
    drivers' main-path updates (nb 128); the TPU's resident-panel formula
    would not fit."""
    db = dtype.itemsize
    c = tcd.plan_fused_chain("trsm+gemm", n_prime, n_prime, 128, dtype=dtype,
                             form=form, machine="h100")
    plan = tfk.trsm_gemm_plan(dtype, 128, form)
    assert c.vmem_bytes == plan.smem_bytes == tcd.trsm_gemm_smem(
        db, 128, plan.width, plan.l_in_smem)
    assert c.fits_vmem and c.fused_wins and c.block == 128
    assert c.gemm.ridge == H100.pe.peak_flops / H100.memory.hbm_bw
    assert ttd.resolve("trsm+gemm", (n_prime, n_prime, 128), dtype,
                       policy="model", backend="cuda", form=form).fused
    # the same shape priced the TPU's way on h100's numbers does not fit
    tpu_budget = (128 * 128 + 128 * n_prime) * db
    assert tpu_budget > H100.memory.vmem_bytes


def test_trsm_smem_is_b2s_only_footprint_formula():
    """B2's shared-memory formula lives in codesign alone: the wrapper
    launches with it and defines none of its own."""
    src = inspect.getsource(tfk)
    assert not any(f"def {name}" in src for name in (
        "_trsm_smem", "trsm_gemm_smem", "trsm_gemm_footprint"))
    assert "_TRSM_STAGES" not in src and "trsm_gemm_footprint(" in src
    for dtype in (torch.float32, torch.float64):
        for nb in (100, 128, 2000):
            p = tfk.trsm_gemm_plan(dtype, nb, "syrk")
            assert p.smem_bytes == tcd.trsm_gemm_smem(
                dtype.itemsize, nb, p.width, p.l_in_smem)


def test_h100_gemm_epilogue_and_factorization_plans():
    c = tcd.plan_fused_chain("gemm+epilogue", 8192, 8192, 8192,
                             dtype=torch.float32, epilogue="gelu",
                             machine="h100")
    assert c.vmem_bytes == c.gemm.vmem_bytes and c.fused_wins
    assert (c.gemm.bm, c.gemm.bn, c.gemm.bk) == (128, 128, 16)
    for kind in ("potrf", "getrf"):
        f = tcd.plan_factorization(8192, kind, dtype=torch.float32,
                                   machine="h100")
        assert f.block == 128 and f.gemm.ridge == c.gemm.ridge
        assert f.panel_time > 0 and f.trailing_time > 0
    assert tcd.plan_trsm(8192, 1, dtype=torch.float32,
                         machine="h100").block == 128


# ----------------------------- ambient machine -------------------------------

def test_call_is_priced_for_its_devices_machine():
    """A call that names no machine is priced for its device's: h100 for
    cuda, tpu-like for cpu (resolved without a card); a named machine or a
    scope wins; the registry key component stays the reference's per
    device."""
    assert tarch.device_machine("cuda").name == "h100"
    assert tarch.device_machine(torch.device("cpu")).name == "tpu-like"
    assert tarch.current_machine().name == "tpu-like"
    for backend, want in (("cuda", "h100"), ("cpu", "tpu-like")):
        r = ttd.resolve("gemm", (256, 256, 256), torch.float32,
                        policy="model", backend=backend)
        assert r.machine == want
        ctx = tl.ExecutionContext(device=backend)
        assert tctx.resolved_machine(ctx).name == want
        assert ctx.over(tl.get_context()).describe()["machine"] == want
        assert tarch.machine_key_component(None, backend) is None
        named = ttd.resolve("gemm", (256, 256, 256), torch.float32,
                            policy="model", backend=backend,
                            machine="paper-pe")
        assert named.machine == "paper-pe"
        with tarch.machine_scope("cpu-host"):
            assert tctx.resolved_machine(ctx).name == "cpu-host"
            assert tarch.machine_key_component(None, backend) == "cpu-host"
    assert tctx.resolved_machine(tl.ExecutionContext(
        device="cuda", machine="tpu-like")).name == "tpu-like"
    assert tarch.machine_key_component("tpu-like", "cuda") == "tpu-like"
    assert tarch.machine_key_component("h100", "cpu") == "h100"


def test_cpu_routine_plans_stay_the_references(tmp_path):
    """linalg on the CPU runs under tpu-like: the plan the GEMM wrapper
    records is the reference's, and it runs the variant's default tile."""
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(200, 96)), rng.normal(size=(96, 72))
    with tl.use(device="cpu", policy="model"):
        tl.gemm(a.astype(np.float32), b.astype(np.float32))
    launch = tgk.gemm.last_launch
    assert launch["plan"] == tcd.plan_gemm(200, 72, 96, dtype=torch.float32,
                                           machine="tpu-like")
    assert launch["tile_source"] == "default"
    assert launch["tile"] == tgk.TILES[launch["variant"]]


# ---------------------------------- measure ----------------------------------

@pytest.mark.parametrize("reps", [0, -1])
def test_measure_rejects_nonpositive_reps(reps):
    for mod in (TM, JM):
        with pytest.raises(ValueError, match="reps"):
            mod.measure_wall_time(lambda: 1.0, reps=reps)
        with pytest.raises(ValueError, match="reps"):
            mod.measure(lambda: 1.0, reps=reps)


def test_measure_controller_validates_budgets():
    with pytest.raises(ValueError, match="min_reps"):
        TM.repetition_controller(lambda: 1.0, min_reps=0)
    with pytest.raises(ValueError, match="max_reps"):
        TM.repetition_controller(lambda: 1.0, min_reps=4, max_reps=2)
    with pytest.raises(ValueError, match="rel_spread"):
        TM.repetition_controller(lambda: 1.0, rel_spread=-0.1)
    with pytest.raises(ValueError, match="sample"):
        TM.Measurement.from_samples([])
    assert (TM.DEFAULT_MIN_REPS, TM.DEFAULT_MAX_REPS,
            TM.DEFAULT_REL_SPREAD) == (JM.DEFAULT_MIN_REPS,
                                       JM.DEFAULT_MAX_REPS,
                                       JM.DEFAULT_REL_SPREAD)
    assert tsearch.measure_wall_time is TM.measure_wall_time


def test_measure_pinned_reps_and_one_warm_up():
    calls = []
    m = TM.measure(lambda x: calls.append(x) or x * 2.0,
                   torch.tensor(3.0), reps=4)
    assert len(calls) == 5                  # one untimed warm-up
    assert m.reps == 4 and len(m.samples) == 4 and all(s > 0
                                                       for s in m.samples)
    assert m.seconds_median == pytest.approx(float(np.median(m.samples)))
    assert set(m.row_fields()) == {"seconds_median", "seconds_spread", "reps"}
    assert json.loads(json.dumps(m.to_json()))["reps"] == 4


@pytest.mark.parametrize("case", ["quiet", "noisy", "tightens", "outlier"])
def test_controller_matches_reference_on_synthetic_timers(case):
    """The reference's synthetic timers through both controllers: the same
    samples, rep counts, medians, spreads and exits."""
    def timer():
        return {"quiet": itertools.cycle([1.00, 1.01, 0.99]),
                "noisy": itertools.cycle([0.1, 1.0, 10.0]),
                "tightens": iter([1.0, 5.0, 0.2] + [1.0] * 40),
                "outlier": itertools.cycle([1.0, 1.0, 1.0, 100.0])}[case]
    kw = {"quiet": dict(min_reps=3, max_reps=50, rel_spread=0.10),
          "noisy": dict(min_reps=3, max_reps=7, rel_spread=0.01),
          "tightens": dict(min_reps=3, max_reps=40, rel_spread=0.05),
          "outlier": dict(min_reps=4, max_reps=4, rel_spread=0.1)}[case]
    t_timer, j_timer = timer(), timer()
    t = TM.repetition_controller(lambda: next(t_timer), **kw)
    j = JM.repetition_controller(lambda: next(j_timer), **kw)
    assert (t.samples, t.seconds_median, t.seconds_spread, t.reps,
            t.converged) == (j.samples, j.seconds_median, j.seconds_spread,
                             j.reps, j.converged)
    want = {"quiet": (True, 3), "noisy": (False, 7), "outlier": (False, 4)}
    if case in want:
        assert (t.converged, t.reps) == want[case]
    else:
        assert t.converged and 3 < t.reps < 40
    if case == "outlier":
        assert t.seconds_median == t.seconds_min == 1.0 < t.seconds_mean


def test_model_residual_matches_reference():
    for modeled, measured in ((1.0, 1.0), (0.5, 1.0), (2.0, 1.0),
                              (1.0, 0.0), (1.0, float("nan")), (3e-3, 4e-3)):
        t = TM.model_residual(modeled, measured)
        j = JM.model_residual(modeled, measured)
        assert (math.isnan(t) and math.isnan(j)) or t == j


def test_measure_annotates_the_enclosing_span():
    from repro_torch import obs
    with obs.trace("m") as tr:
        with obs.span("outer"):
            TM.measure(lambda: None, reps=2)
        TM.measure(lambda: None, reps=2)
    outer = tr.spans("outer")[0]
    assert outer.attrs["measure_reps"] == 2
    assert [e.name for e in tr.events].count("tune.measure") == 1


# ---------------------------------- search -----------------------------------

@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("shape", [(64, 64, 64), (300, 200, 100),
                                   (1024, 4096, 64)])
def test_candidates_and_scores_match_reference(machine, shape):
    for db in (2, 4):
        tc = tsearch.gemm_candidates(*shape, dtype_bytes=db, machine=machine)
        jc = jsearch.gemm_candidates(*shape, dtype_bytes=db, machine=machine)
        assert [dataclasses.asdict(p) for p in tc] == \
            [dataclasses.asdict(p) for p in jc]
        for p, q in zip(tc, jc):
            assert tsearch.model_score(p, *shape, db, machine=machine) == \
                pytest.approx(jsearch.model_score(q, *shape, db,
                                                  machine=machine), rel=1e-6)
    assert tsearch.trsm_candidates(96, 4, machine=machine) == \
        jsearch.trsm_candidates(96, 4, machine=machine)


@pytest.mark.parametrize("dtype", DTYPES)
def test_h100_candidates_are_the_compiled_tiles(dtype):
    db = dtype.itemsize
    cands = tsearch.gemm_candidates(4096, 4096, 4096, dtype_bytes=db,
                                    max_candidates=3, machine="h100")
    assert cands[0] == tcd.plan_gemm(4096, 4096, 4096, dtype_bytes=db,
                                     machine="h100")
    assert {(p.bm, p.bn, p.bk) for p in cands} == \
        set(tgk.TILE_SETS[tgk.TILED[dtype]])


def test_tune_gemm_registry_read_by_reference_and_dispatched(tmp_path):
    """tune_gemm on the CPU under h100 writes a registry the reference's
    Registry reads; the port's dispatch then resolves the winner from it
    (source "registry"), and the GEMM wrapper runs the winner's tile."""
    path = str(tmp_path / "reg.json")
    reg = treg.Registry(path=path, autoload=False)
    res = tsearch.tune_gemm(96, 80, 64, torch.float32, registry=reg, top_k=3,
                            reps=1, machine="h100", device="cpu")
    assert res.backend == "cpu" and len(res.measured) == 2
    assert all(r["tile_source"] == "plan" and tuple(r["tile"]) ==
               (r["bm"], r["bn"], r["bk"]) for r in res.measured)
    assert all(math.isfinite(r["model_residual"]) for r in res.measured)
    reg.save()
    win = res.best.params
    jr = jreg.Registry(path=path)
    got = jr.lookup("gemm", (96, 80, 64), np.float32, "cpu", machine="h100")
    assert got is not None and got.params == win
    rng = np.random.default_rng(1)
    a = rng.normal(size=(96, 64)).astype(np.float32)
    b = rng.normal(size=(64, 80)).astype(np.float32)
    with tl.use(device="cpu", policy="tuned", registry=path, machine="h100"):
        r = ttd.resolve("gemm", (96, 80, 64), torch.float32, backend="cpu",
                        policy="tuned", machine="h100",
                        registry=treg.Registry(path=path))
        out = tl.gemm(a, b)
    assert r.source == "registry"
    launch = tgk.gemm.last_launch
    assert launch["tile"] == (win["bm"], win["bn"], win["bk"])
    assert launch["tile_source"] == "plan"
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["wgmma", "ffma", "dmma", "simt"])
def test_record_call_returns_the_tile_launch_runs(variant):
    """The CTA tile a call launches is the one record_call returns (handed
    to ``launch`` as an argument), equal to what it records: the plan's
    when compiled for the variant, else the variant's default."""
    wrapper = lambda: None
    tiles = tgk.TILE_SETS.get(variant, ()) + ((96, 96, 96),)
    for bm, bn, bk in tiles:
        plan = tcd.plan_from_blocks(1024, 1024, 1024, bm, bn, bk,
                                    dtype=torch.float32, machine="h100")
        tile = tgk.record_call(wrapper, plan, variant, torch.device("cpu"))
        assert (tile, wrapper.last_launch["tile_source"]) == \
            tgk.launch_tile(variant, plan)
        assert wrapper.last_launch["tile"] == tile
    assert list(inspect.signature(tgk.launch).parameters)[:4] == \
        ["wrapper", "entry", "variant", "tile"]


def test_tune_fused_gemm_records_the_fused_flag(tmp_path):
    reg = treg.Registry(path=str(tmp_path / "reg.json"), autoload=False)
    res = tsearch.tune_fused_gemm(64, 48, 32, "gelu", torch.float32,
                                  registry=reg, reps=1, device="cpu")
    assert [r["variant"] for r in res.measured] == ["staged", "fused"]
    assert res.best.params["fused"] in (0, 1)
    r = ttd.resolve("gemm+epilogue", (64, 48, 32), torch.float32,
                    policy="tuned", registry=reg, backend="cpu",
                    epilogue="gelu")
    assert r.source == "registry" and r.fused == bool(
        res.best.params["fused"])


def test_tune_trsm_and_seeded_registry_resolve(tmp_path):
    path = str(tmp_path / "reg.json")
    reg = treg.Registry(path=path, autoload=False)
    res = tsearch.tune_trsm(48, 4, torch.float32, registry=reg, reps=1,
                            blocks=(16, 32), device="cpu")
    assert res.measured[0]["block"] == res.model_params["block"]
    n = tsearch.seed_registry_from_model(
        reg, gemm_shapes=[(256, 256, 256)], trsm_shapes=[(512, 8)],
        dtypes=(torch.float32, torch.float64), backend="cpu")
    assert n == 4
    reg.save()
    jr = jreg.Registry(path=path)
    for dtype in (np.float32, np.float64):
        assert jr.lookup("gemm", (256, 256, 256), dtype, "cpu") is not None
    assert jr.lookup("trsm", (48, 4), np.float32, "cpu").params == \
        res.best.params
    t = ttd.resolve("trsm", (48, 4), torch.float32, policy="tuned",
                    registry=treg.Registry(path=path), backend="cpu")
    assert t.source == "registry" and t.block == res.best.params["block"]
    g = ttd.resolve("gemm", (256, 256, 256), torch.float64, policy="tuned",
                    registry=treg.Registry(path=path), backend="cpu")
    assert g.source == "registry" and g.gemm_plan == tcd.plan_gemm(
        256, 256, 256, dtype=torch.float64)


def test_sweeps_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsearch.tune_gemm(8, 8, 8)
