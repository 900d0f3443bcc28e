"""repro_torch.analysis against repro.analysis: vocabulary, seeded
violations on both sides, the plan view, the drift annotations,
suppression, and the f32 x model surface.

The reference's ``check`` is never the oracle: it imports
``jax.experimental.enable_x64``, which jax 0.9 lacks. Where the reference
can run a violation without ``check``, its linters run it directly
(``jaxpr_lint.lint_dtype_flow`` on a jaxpr made with ``jax_enable_x64`` set
and restored, ``kernel_lint.lint_kernel_launches`` on an interpret-mode
``pallas_call``) and must fire the same rule id the port fires. The port's
checks trace the card route on fake CUDA tensors (no card, no nvcc).
"""
import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from repro import analysis as ranalysis
from repro.analysis import jaxpr_lint as rjaxpr_lint
from repro.analysis import kernel_lint as rkernel_lint
from repro.analysis import report as rreport
from repro.analysis import rules as rrules
from repro_torch import analysis, linalg
from repro_torch.analysis import kernel_lint, report, rules, sweep
from repro_torch.kernels import gemm as gk
from repro_torch.kernels import launch_record


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _f32(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ids(findings):
    return sorted({f.rule for f in findings})


def _rule_ids(rep):
    return _ids(rep.findings)


def _ref_lint(fn, *args):
    """The reference's dtype-flow lint of ``fn``'s jaxpr."""
    return rjaxpr_lint.lint_dtype_flow(jax.make_jaxpr(fn)(*args))


def _ref_launches(fn, *args):
    """The reference's launch lint of ``fn``'s jaxpr (its ambient
    machine)."""
    from repro import arch as rarch
    return rkernel_lint.lint_kernel_launches(jax.make_jaxpr(fn)(*args),
                                             rarch.resolve_machine(None))


# --------------------------- the frozen contract ----------------------------

def test_vocabulary_and_public_names_equal_the_reference():
    assert analysis.__all__ == ranalysis.__all__
    assert list(analysis.RULES) == list(ranalysis.RULES)
    for rid, r in analysis.RULES.items():
        ref = ranalysis.RULES[rid]
        assert (r.id, r.title, r.severity) == (ref.id, ref.title,
                                                ref.severity)
    assert len(analysis.RULES) == 18


def test_report_schema_equals_the_reference(tmp_path):
    assert report.SCHEMA_VERSION == rreport.SCHEMA_VERSION
    fields = lambda cls: [f.name for f in dataclasses.fields(cls)]
    assert fields(analysis.Finding) == fields(ranalysis.Finding)
    assert fields(analysis.AnalysisReport) == fields(
        ranalysis.AnalysisReport)
    f = rules.make_finding("DF003", "m", routine="qr", location="x:1",
                           case={"dtype": "float32"})
    rf = rrules.make_finding("DF003", "m", routine="qr", location="x:1",
                             case={"dtype": "float32"})
    assert f.to_json() == rf.to_json()
    rep = analysis.AnalysisReport("t", [{"routine": "qr"}], [f], [])
    rrep = ranalysis.AnalysisReport("t", [{"routine": "qr"}], [rf], [])
    assert rep.to_json() == rrep.to_json()
    data = json.load(open(rep.save(str(tmp_path / "r.json"))))
    assert set(data) == {"schema_version", "target", "cases", "findings",
                         "suppressed"}
    assert rep.summary() == rrep.summary()


# ------------------------ seeded kernel-launch bugs -------------------------

def _copy_kernel(x_ref, o_ref):
    o_ref[...] = x_ref[...] * 2


def _launch(tile=(128, 128, 16), variant="ffma"):
    """A B1 launch of the given tile and variant, made directly (no
    plan): the fake card records it."""
    def fn(a, b):
        c = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype,
                        device=a.device)
        gk.record_call(gk.gemm, None, variant, a.device)
        gk.launch(gk.gemm, "repro_gemm", variant, tile, a, b, c)
        return c
    return fn


def test_kl001_uncompiled_tile_fires_on_both_sides():
    rep = analysis.check(_launch(tile=(32, 32, 8)), _f32(64, 32),
                         _f32(32, 64), drift=False, retrace=False)
    assert "KL001" in _rule_ids(rep) and not rep.ok

    def bad_block(x):
        return pl.pallas_call(
            _copy_kernel, grid=(3,),
            in_specs=[pl.BlockSpec((16, 128), lambda i: (i, 0))],
            out_specs=pl.BlockSpec((16, 128), lambda i: (i, 0)),
            out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            interpret=True)(x)
    assert "KL001" in _ids(_ref_launches(bad_block, _f32(40, 128)))


def test_kl002_shared_memory_over_budget_fires_on_both_sides():
    def hog(x):
        launch_record.emit("repro_torch.kernels.gemm", "gemm", "gemm",
                           "repro_gemm", (0, 128, 128, 16, 0, 0, 0, 1, 1, 0,
                                          1, 1, 0, 1, 8, 8, 8, 1, 0, 0, 0,
                                          None),
                           variant="ffma", tile=(128, 128, 16), grid=(1,),
                           smem_bytes=300_000, operands=(x, x, x), fake=True)
        return x * 2
    rep = analysis.check(hog, _f32(8, 8), drift=False, retrace=False)
    assert "KL002" in _rule_ids(rep) and not rep.ok

    def vmem_hog(x):
        n = x.shape[0]
        return pl.pallas_call(
            _copy_kernel, grid=(1,),
            in_specs=[pl.BlockSpec((n, n), lambda i: (0, 0))],
            out_specs=pl.BlockSpec((n, n), lambda i: (0, 0)),
            out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            interpret=True)(x)
    assert "KL002" in _ids(_ref_launches(
        vmem_hog, jax.ShapeDtypeStruct((4096, 4096), jnp.float32)))


def test_kl003_index_width_fires_on_both_sides(x64):
    # the port: m past 2**31 in a c_int slot of repro_gemm
    big = torch.empty((2 ** 31 + 64, 32), device="meta")
    rep = analysis.check(lambda a, b: gk.gemm(a, b), big,
                         torch.empty((32, 32), device="meta"),
                         drift=False, retrace=False)
    assert "KL003" in _rule_ids(rep) and not rep.ok

    def i64_kernel(x_ref, o_ref):
        idx = lax.broadcasted_iota(jnp.int64, x_ref.shape, 0)
        o_ref[...] = x_ref[...] + idx.astype(x_ref.dtype)

    def launch(x):
        return pl.pallas_call(
            i64_kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            interpret=True)(x)
    assert "KL003" in _ids(_ref_lint(launch, _f32(8, 128)))


def test_kl004_zero_dim_launch_fires_on_both_sides():
    rep = analysis.check(_launch(), np.zeros((0, 32), np.float32),
                         _f32(32, 64), drift=False, retrace=False)
    assert "KL004" in _rule_ids(rep) and not rep.ok

    def crash(x):                     # a trace that crashes on zero dims
        raise ValueError("empty operand")
    rep = analysis.check(crash, np.zeros((0, 8), np.float32), drift=False,
                         retrace=False)
    assert _rule_ids(rep) == ["KL004"]

    def no_fallback(x):
        return pl.pallas_call(
            _copy_kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            interpret=True)(x)
    from repro import arch as rarch
    assert "KL004" in _ids(rkernel_lint.lint_kernel_launches(
        jax.make_jaxpr(no_fallback)(np.zeros((0, 8), np.float32)),
        rarch.resolve_machine(None), zero_dim_inputs=True))


def test_zero_dim_routine_routes_to_the_plain_path():
    rep = analysis.check(linalg.gemm, np.zeros((0, 32), np.float32),
                         _f32(32, 64), drift=False)
    assert rep.findings == [], rep.summary()


def _poisoned_registry(tmp_path, params):
    from repro_torch.tune.registry import Registry
    reg = Registry(path=str(tmp_path / "reg.json"))
    reg.record("gemm", (48, 64, 32), torch.float32, "cuda", params,
               source="test")
    return reg


def test_kl001_plan_tile_misaligned(tmp_path):
    reg = _poisoned_registry(tmp_path, {"bm": 102, "bn": 128, "bk": 128})
    with linalg.use(policy="tuned", registry=reg):
        rep = analysis.check(linalg.gemm, _f32(48, 32), _f32(32, 64),
                             drift=False, retrace=False)
    assert "KL001" in _rule_ids(rep)       # 102 % sublane(4) != 0


def test_kl002_plan_vmem_exceeded(tmp_path):
    reg = _poisoned_registry(tmp_path, {"bm": 4096, "bn": 4096,
                                        "bk": 4096})
    with linalg.use(policy="tuned", registry=reg):
        rep = analysis.check(linalg.gemm, _f32(48, 32), _f32(32, 64),
                             drift=False, retrace=False)
    assert "KL002" in _rule_ids(rep)


def _resolutions(side):
    """The same five resolutions built by either package's planner."""
    if side == "port":
        from repro_torch import arch as a
        from repro_torch.core import codesign as c
        from repro_torch.tune.dispatch import Resolution
    else:
        from repro import arch as a
        from repro.core import codesign as c
        from repro.tune.dispatch import Resolution
    mach = a.get("tpu-like")
    out = []
    for bm, bn, bk in ((128, 128, 128), (100, 128, 128), (4096, 4096, 4096),
                       (36, 64, 8)):
        plan = c.plan_from_blocks(512, 512, 512, bm, bn, bk, dtype_bytes=4,
                                  machine=mach)
        out.append(Resolution("gemm", "tuned", "registry", True,
                              gemm_plan=plan, machine=mach.name))
    chain = c.plan_fused_chain("trsm+gemm", 8192, 8192, 8192,
                               dtype_bytes=4, machine=mach)
    out.append(Resolution("trsm+gemm", "model", "model", True,
                          gemm_plan=chain.gemm, machine=mach.name,
                          fused=True, chain=chain))
    return out, mach


def test_lint_resolutions_agrees_with_the_reference():
    port, pm = _resolutions("port")
    ref, rm = _resolutions("ref")
    got = kernel_lint.lint_resolutions(port, pm, routine="r")
    want = rkernel_lint.lint_resolutions(ref, rm, routine="r")
    assert [(f.rule, f.message) for f in got] == \
        [(f.rule, f.message) for f in want]
    assert {"KL001", "KL002"} <= set(_ids(got))


# -------------------------- seeded dtype-flow bugs --------------------------

def test_df001_silent_f64_fires_on_both_sides(x64):
    rep = analysis.check(lambda x: (x.double() * 2).float(), _f32(8, 8))
    assert "DF001" in _rule_ids(rep) and not rep.ok
    assert "DF001" in _ids(_ref_lint(
        lambda x: (x.astype(jnp.float64) * 2).astype(jnp.float32),
        _f32(8, 8)))
    rep = analysis.check(lambda x: (x.double() * 2).float(), _f32(8, 8),
                         accum_dtype=torch.float64)
    assert "DF001" not in _rule_ids(rep)


def test_df002_narrow_accumulator_fires_on_both_sides(x64):
    a = np.zeros((8, 8), np.float64)
    # aten has no mm over f64 with a narrower output: the port's form is
    # f64 operands narrowed on their way into the product
    rep = analysis.check(lambda x, y: x.float() @ y.float(), a, a)
    assert "DF002" in _rule_ids(rep) and not rep.ok
    assert "DF002" in _ids(_ref_lint(
        lambda x, y: lax.dot(x, y, preferred_element_type=jnp.float32),
        a, a))
    rep = analysis.check(lambda x, y: x @ y, a, a)
    assert "DF002" not in _rule_ids(rep)


def test_df003_convert_roundtrip_fires_on_both_sides():
    rep = analysis.check(lambda x: x.to(torch.bfloat16).float() * 2.0,
                         _f32(8, 8))
    assert "DF003" in _rule_ids(rep)
    assert rep.ok                          # warn severity
    assert "DF003" in _ids(_ref_lint(
        lambda x: x.astype(jnp.bfloat16).astype(jnp.float32) * 2.0,
        _f32(8, 8)))


def test_df004_host_transfer_fires_on_both_sides():
    def read(x):
        return x * x.sum().item()
    rep = analysis.check(read, _f32(4, 4))
    f = [f for f in rep.findings if f.rule == "DF004"]
    assert f and not rep.ok
    assert f[0].location is None          # no repro_torch frame read it
    rep = analysis.check(lambda x: x.cpu() * 2, _f32(4, 4))
    assert "DF004" in _rule_ids(rep)
    with linalg.use(device="cpu"):               # the plain route: no copy
        assert analysis.check(lambda x: x.cpu() * 2, _f32(4, 4)).ok

    def host_call(x):
        return jax.pure_callback(
            lambda v: v, jax.ShapeDtypeStruct(x.shape, x.dtype), x)
    assert "DF004" in _ids(_ref_lint(host_call, _f32(4, 4)))


# ------------------------- seeded cost-model drift --------------------------

def test_cm001_cm002_annotation_drift():
    rep = analysis.check(lambda a, b: a @ b, _f32(32, 32), _f32(32, 32),
                         info=lambda a, b: {"flops": 1, "bytes": 1},
                         retrace=False)
    ids = _rule_ids(rep)
    assert "CM001" in ids and "CM002" in ids
    assert not rep.ok                      # CM001 is an error


def test_cm003_retrace_instability():
    state = {"n": 0}

    def unstable(x):                       # one more op per trace
        state["n"] += 1
        for _ in range(state["n"]):
            x = x * 2.0
        return x

    rep = analysis.check(unstable, _f32(8,), drift=False)
    assert "CM003" in _rule_ids(rep)
    assert rep.ok                          # warn severity


def test_opaque_lapack_flops_equal_the_reference():
    from jax._src.lax import linalg as jlinalg

    from repro_torch.analysis import fake_card
    a = np.zeros((2, 48, 32), np.float32)
    sq = np.zeros((40, 40), np.float32)
    b = np.zeros((40, 5), np.float32)

    def port(a, sq, b):
        torch.linalg.cholesky_ex(sq)
        torch.linalg.lu_factor_ex(a)
        q, tau = torch.geqrf(a)
        torch.linalg.householder_product(q, tau)
        return torch.linalg.solve_triangular(sq, b, upper=False)

    def ref(a, sq, b):
        jlinalg.cholesky(sq)
        jlinalg.lu(a)
        q, tau = jlinalg.geqrf(a)
        jlinalg.householder_product(q, tau)
        return jlinalg.triangular_solve(sq, b, left_side=True, lower=True)

    tr = fake_card.trace(port, (a, sq, b), {}, torch.device("cpu"))
    got = report._opaque_lapack_flops(tr.graph)
    assert got > 0
    assert got == rreport._opaque_lapack_flops(jax.make_jaxpr(ref)(a, sq, b))


def test_analysis_info_equals_the_reference_at_surface_sizes():
    from repro import linalg as rlinalg
    names = analysis.surface_routines()
    assert names == rreport.surface_routines()
    for name in names:
        ref_args, ref_kw = rreport._surface_args(name)
        port_args, port_kw = report._surface_args(name)
        port = getattr(linalg, name)
        ref = getattr(rlinalg, name)
        assert port._analysis_op == ref._analysis_op == name
        for dt, rdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            pa, pk = report._cast_args(port_args, port_kw, dt)
            ra, rk = rreport._cast_args(ref_args, ref_kw, rdt)
            got = port._analysis_info(*pa, **pk)
            want = ref._analysis_info(*ra, **rk)
            assert (got["flops"], got["bytes"]) == \
                (want["flops"], want["bytes"]), (name, dt)


# ----------------------- suppression and allowlists -------------------------

def _host_read(x):
    return x * x.sum().item()


def test_allow_roundtrip_records_suppression():
    with analysis.allow("DF004"):
        rep = analysis.check(_host_read, _f32(4, 4))
    assert rep.ok and "DF004" not in _rule_ids(rep)
    sup = [f for f in rep.suppressed if f.rule == "DF004"]
    assert sup and sup[0].suppressed and sup[0].suppressed_by == "allow()"


def test_allow_is_routine_scoped():
    with analysis.allow("DF004", routine="someone_else"):
        rep = analysis.check(_host_read, _f32(4, 4))
    assert "DF004" in _rule_ids(rep)


def test_allow_rejects_unknown_rule_id():
    with pytest.raises(KeyError):
        with analysis.allow("XX999"):
            pass


def test_allowlist_file_roundtrip(tmp_path):
    p = tmp_path / "allow.json"
    p.write_text(json.dumps({"schema_version": 1, "allow": [
        {"rule": "DF004", "routine": "_host_read", "reason": "test"}]}))
    al = analysis.load_allowlist(str(p))
    rep = analysis.check(_host_read, _f32(4, 4), allowlist=al)
    assert rep.ok
    assert rep.suppressed[0].suppressed_by == f"allowlist:{p}"


def test_allowlist_missing_file_is_silently_empty(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        al = analysis.load_allowlist(str(tmp_path / "nope.json"))
    assert al.entries == ()


def test_allowlist_corrupt_warns_once_and_refires(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text("{not json")
    with pytest.warns(RuntimeWarning):
        al = analysis.load_allowlist(str(p))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        al2 = analysis.load_allowlist(str(p))   # warned once already
    rep = analysis.check(_host_read, _f32(4, 4), allowlist=al2)
    assert "DF004" in _rule_ids(rep) and al.entries == ()


def test_allowlist_unknown_rule_is_corrupt(tmp_path):
    p = tmp_path / "unknown.json"
    p.write_text(json.dumps({"schema_version": 1, "allow": [
        {"rule": "ZZ001"}]}))
    with pytest.warns(RuntimeWarning):
        assert analysis.load_allowlist(str(p)).entries == ()


def test_committed_allowlist_entries_have_reasons():
    raw = json.load(open(sweep.DEFAULT_ALLOWLIST_PATH))
    assert raw["allow"] and all(e.get("reason") for e in raw["allow"])
    assert analysis.load_allowlist(sweep.DEFAULT_ALLOWLIST_PATH).entries


# ------------------------------- the surface --------------------------------

def test_f32_model_surface_is_silent_with_the_committed_allowlist():
    al = analysis.load_allowlist(sweep.DEFAULT_ALLOWLIST_PATH)
    rep = analysis.check_surface(policies=("model",), dtypes=("float32",),
                                 mesh=None, allowlist=al)
    assert rep.findings == [], rep.summary()
    # the grid is the reference's: every checkable routine, in its order
    grid = [(c["routine"], c["policy"], c["dtype"], c["mesh"])
            for c in rep.cases]
    assert grid == [(n, "model", "float32", None)
                    for n in rreport.surface_routines()]
    # solve traces: its pivot read is the one suppressed finding
    (sup,) = rep.suppressed
    assert (sup.rule, sup.routine) == ("DF004", "solve")
    assert sup.location == "repro_torch/lapack/lu.py:122"
    assert sup.suppressed_by.startswith("allowlist:")


def test_surface_mesh_leg_records_skip():
    rep = analysis.check_surface(routines=["gemm"], policies=("reference",),
                                 dtypes=("float32",), mesh=(64, 64))
    skips = [c for c in rep.cases if "skipped" in c]
    assert skips and "4096 ranks" in skips[0]["skipped"]
    assert rep.ok
