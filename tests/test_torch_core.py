"""repro_torch's jax-free layers against the JAX package: arch specs,
codesign plans (a grid plus the committed golden file), obs vocabulary,
tune resolution over registry and machine files written by ``repro``,
and the guards (no jax/repro import, no silent fallback to the CPU or
away from the kernels)."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import arch as jarch
from repro import obs as jobs
from repro.core import codesign as jcd
from repro.tune import dispatch as jtd
from repro.tune import policy as jpolicy
from repro.tune import registry as jreg
from repro_torch import arch as tarch
from repro_torch import obs as tobs
from repro_torch.core import codesign as tcd
from repro_torch.kernels import _build
from repro_torch.tune import dispatch as ttd
from repro_torch.tune import policy as tpolicy
from repro_torch.tune import registry as treg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MACHINES = ("tpu-like", "paper-pe", "cpu-host")
GEMM_SHAPES = [(1, 1, 1), (7, 129, 33), (300, 300, 300), (1024, 4096, 64),
               (8192, 8192, 8192)]


def _plan_dict(p):
    return dataclasses.asdict(p)


# ----------------------------------- arch -----------------------------------

@pytest.mark.parametrize("name", MACHINES)
def test_builtin_specs_field_for_field(name):
    j, t = jarch.get(name), tarch.get(name)
    assert t.to_json() == j.to_json()
    for part in ("fpu", "memory", "pe", "power_area"):
        tt = dataclasses.asdict(getattr(t, part))
        tj = dataclasses.asdict(getattr(j, part))
        # the port's optional GPU fields (PEGeometry.sm_count, clock_hz)
        # are unset on every reference machine
        assert {f: tt[f] for f in tj} == tj
        assert all(tt[f] is None for f in set(tt) - set(tj))
    assert (t.pe.mxu_clock, t.pe.vpu_flops, t.peak_gflops_per_w(),
            t.dtype_bytes()) == (j.pe.mxu_clock, j.pe.vpu_flops,
                                 j.peak_gflops_per_w(), j.dtype_bytes())


def test_spec_json_crosses_both_ways(tmp_path):
    custom = dataclasses.replace(jarch.get("paper-pe"), name="custom-pe")
    path = custom.save(str(tmp_path / "m.json"))
    loaded = tarch.MachineSpec.load(path)
    assert loaded.to_json() == custom.to_json()
    back = loaded.save(str(tmp_path / "back.json"))
    assert jarch.MachineSpec.load(back) == custom
    (tmp_path / "bad.json").write_text("{not json")
    with pytest.raises(ValueError):
        tarch.MachineSpec.load(str(tmp_path / "bad.json"))
    with pytest.raises(ValueError):
        tarch.MachineSpec.from_json({**custom.to_json(), "schema": 2})


def test_machine_scoping():
    assert tarch.current_machine().name == "tpu-like"
    with tarch.machine_scope("cpu-host") as m:
        assert m.name == tarch.current_machine().name == "cpu-host"
        assert tarch.machine_key_component(None) == "cpu-host"
    assert tarch.machine_key_component(None) is None
    with pytest.raises(ValueError):
        tarch.get("no-such-machine")


# --------------------------------- codesign ---------------------------------

@pytest.mark.parametrize("machine", MACHINES)
def test_plans_match_reference_grid(machine):
    for m, n, k in GEMM_SHAPES:
        for db in (2, 4, 8):
            assert _plan_dict(tcd.plan_gemm(m, n, k, dtype_bytes=db,
                                            machine=machine)) == \
                _plan_dict(jcd.plan_gemm(m, n, k, dtype_bytes=db,
                                         machine=machine))
            assert _plan_dict(tcd.plan_from_blocks(
                m, n, k, 128, 256, 512, dtype_bytes=db, machine=machine)) \
                == _plan_dict(jcd.plan_from_blocks(
                    m, n, k, 128, 256, 512, dtype_bytes=db, machine=machine))
    for n in (1, 17, 96, 4096, 8192):
        for nrhs in (1, 8):
            assert _plan_dict(tcd.plan_trsm(n, nrhs, dtype=np.float32,
                                            machine=machine)) == \
                _plan_dict(jcd.plan_trsm(n, nrhs, dtype=np.float32,
                                         machine=machine))
        for kind in ("potrf", "getrf", "geqrf"):
            assert _plan_dict(tcd.plan_factorization(
                n, kind, dtype=torch.float64, machine=machine)) == \
                _plan_dict(jcd.plan_factorization(n, kind, dtype=np.float64,
                                                  machine=machine))
    for form in ("lu", "syrk"):
        for (m, n, k) in ((8064, 8064, 128), (96, 96, 16), (40, 7, 3)):
            assert _plan_dict(tcd.plan_fused_chain(
                "trsm+gemm", m, n, k, dtype_bytes=4, form=form,
                machine=machine)) == _plan_dict(jcd.plan_fused_chain(
                    "trsm+gemm", m, n, k, dtype_bytes=4, form=form,
                    machine=machine))
    for epi in ("none", "relu", "gelu"):
        for bias in (True, False):
            assert _plan_dict(tcd.plan_fused_chain(
                "gemm+epilogue", 8192, 8192, 8192, dtype=torch.bfloat16,
                epilogue=epi, has_bias=bias, machine=machine)) == \
                _plan_dict(jcd.plan_fused_chain(
                    "gemm+epilogue", 8192, 8192, 8192, dtype="bfloat16",
                    epilogue=epi, has_bias=bias, machine=machine))
    for n in (1, 5, 1000, 10 ** 6):
        assert tcd.optimal_accumulators(n, machine=machine) == \
            jcd.optimal_accumulators(n, machine=machine)
    for sq, sk, hd in ((1, 1, 1), (1, 160, 64), (96, 96, 64),
                       (4096, 4096, 64), (700, 9000, 256)):
        for db in (2, 4):
            assert _plan_dict(tcd.plan_attention(sq, sk, hd, db,
                                                 machine=machine)) == \
                _plan_dict(jcd.plan_attention(sq, sk, hd, db,
                                              machine=machine))
    for L, h, p, n in ((1, 1, 1, 1), (100, 3, 16, 8), (4096, 50, 64, 16),
                       (4096, 24, 64, 128), (40, 2, 64, 4096)):
        for db in (2, 4):
            assert _plan_dict(tcd.plan_ssd(L, h, p, n, db,
                                           machine=machine)) == \
                _plan_dict(jcd.plan_ssd(L, h, p, n, db, machine=machine))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_dtype_width_resolution(dtype):
    tdt = getattr(torch, dtype)
    assert tcd.resolve_dtype_bytes(tdt) == tcd.resolve_dtype_bytes(dtype) \
        == jcd.resolve_dtype_bytes(dtype)
    assert tcd.resolve_dtype_bytes() == jcd.resolve_dtype_bytes() == 2


def test_golden_default_plans():
    """Every golden entry, the distributed ``pdgemm`` section included,
    reproduces bit for bit."""
    with open(os.path.join(ROOT, "scripts", "golden_default_plans.json")) as f:
        golden = json.load(f)
    tpu = tarch.TPU_LIKE
    assert golden["constants"] == {
        "PEAK_BF16_FLOPS": tpu.pe.peak_flops, "HBM_BW": tpu.memory.hbm_bw,
        "ICI_BW": tpu.memory.ici_bw, "VMEM_BYTES": tpu.memory.vmem_bytes,
        "MXU": tpu.pe.mxu, "SUBLANE": tpu.pe.sublane, "LANE": tpu.pe.lane,
        "VPU_ADD_LATENCY": tpu.fpu.add_latency,
        "VREG_BUDGET": tpu.pe.vreg_budget, "ACC_OVERHEAD": tpu.fpu.acc_overhead,
        "PIPELINE_FILL_S": tpu.memory.pipeline_fill_s,
        "MXU_CLOCK": tpu.pe.mxu_clock, "VPU_FLOPS": tpu.pe.vpu_flops}
    n_checked = 0
    for key, want in golden["gemm"].items():
        shape, db = key.split("|")
        p = tcd.plan_gemm(*map(int, shape.split("x")), dtype_bytes=int(db))
        assert {"bm": p.bm, "bn": p.bn, "bk": p.bk,
                "accumulators": p.accumulators, "grid": list(p.grid),
                "vmem_bytes": p.vmem_bytes,
                "arithmetic_intensity": p.arithmetic_intensity,
                "compute_bound": p.compute_bound} == want, key
        n_checked += 1
    for key, want in golden["trsm"].items():
        shape, db = key.split("|")
        t = tcd.plan_trsm(*map(int, shape.split("x")), dtype_bytes=int(db))
        assert {"block": t.block, "panel_time": t.panel_time,
                "trailing_time": t.trailing_time} == want, key
        n_checked += 1
    for key, want in golden["factorization"].items():
        kind, n, db = key.split("|")
        f = tcd.plan_factorization(int(n), kind=kind, dtype_bytes=int(db))
        assert {"block": f.block, "panel_time": f.panel_time,
                "trailing_time": f.trailing_time,
                "gemm": [f.gemm.bm, f.gemm.bn, f.gemm.bk]} == want, key
        n_checked += 1
    for key, want in golden["fused"].items():
        kind, variant, shape, db = key.split("|")
        extra = {"epilogue": variant} if kind == "gemm+epilogue" \
            else {"form": variant}
        c = tcd.plan_fused_chain(kind, *map(int, shape.split("x")),
                                 dtype_bytes=int(db), **extra)
        assert {"block": c.block, "vmem_bytes": c.vmem_bytes,
                "fits_vmem": c.fits_vmem,
                "unfused_hbm_bytes": c.unfused_hbm_bytes,
                "fused_hbm_bytes": c.fused_hbm_bytes,
                "hbm_bytes_saved": c.hbm_bytes_saved,
                "unfused_time": c.unfused_time, "fused_time": c.fused_time,
                "fused_wins": c.fused_wins,
                "gemm": [c.gemm.bm, c.gemm.bn, c.gemm.bk]} == want, key
        n_checked += 1
    for key, want in golden["pdgemm"].items():
        mesh, db = key.split("|")
        px, py = (int(v) for v in mesh[1:].split("y"))
        p = tcd.plan_pdgemm(4096, 4096, 4096, px, py, dtype_bytes=int(db))
        assert {"steps": p.steps, "k_fine": p.k_fine,
                "local": [p.local.bm, p.local.bn, p.local.bk],
                "compute_s": p.compute_s, "collective_s": p.collective_s,
                "collective_bytes": p.collective_bytes} == want, key
        n_checked += 1
    assert n_checked == sum(len(v) for k, v in golden.items()
                            if k != "constants")


# ----------------------------------- obs ------------------------------------

def test_obs_vocabulary_and_trace():
    assert tobs.KNOWN_COUNTERS == jobs.KNOWN_COUNTERS
    assert tobs.EVENT_FIELDS == jobs.EVENT_FIELDS
    assert tobs.SCHEMA_VERSION == jobs.SCHEMA_VERSION
    assert tobs.span("x") is tobs.NOOP_SPAN
    with tobs.trace("t") as tr:
        with tobs.span("outer", flops=2e9, bytes=1e6):
            tobs.event("inner")
            tobs.inc("dispatch.resolve")
    assert [e.name for e in tr.events] == ["inner", "outer"]
    outer = tr.spans("outer")[0]
    assert outer.attrs["machine"] == "tpu-like" and "modeled_s" in outer.attrs
    assert tr.events[0].parent == outer.id
    assert tr.counters == {"dispatch.resolve": 1}
    assert set(outer.to_dict()) == set(tobs.EVENT_FIELDS)


# ----------------------------------- tune -----------------------------------

def test_tune_vocabulary():
    assert tpolicy.POLICIES == jpolicy.POLICIES
    assert ttd.OPS == jtd.OPS
    assert [f.name for f in dataclasses.fields(ttd.Resolution)] == \
        [f.name for f in dataclasses.fields(jtd.Resolution)]


def _same_resolution(t, j):
    assert (t.op, t.policy, t.source, t.use_pallas, t.block, t.machine,
            t.fused) == (j.op, j.policy, j.source, j.use_pallas, j.block,
                         j.machine, j.fused)
    assert (t.gemm_plan is None) == (j.gemm_plan is None)
    if t.gemm_plan is not None:
        assert _plan_dict(t.gemm_plan) == _plan_dict(j.gemm_plan)
    assert (t.chain is None) == (j.chain is None)
    if t.chain is not None:
        assert _plan_dict(t.chain) == _plan_dict(j.chain)
    assert t.describe() == j.describe()


CASES = [("gemm", (64, 48, 32), {}), ("syrk", (64, 64, 16), {}),
         ("gemv", (64, 40), {}), ("trsm", (64, 8), {}),
         ("gemm+epilogue", (64, 48, 32), {"epilogue": "gelu"}),
         ("trsm+gemm", (80, 80, 16), {"form": "syrk"}),
         ("trsm+gemm", (80, 60, 16), {"form": "lu"})]


@pytest.mark.parametrize("machine", [None, "paper-pe"])
def test_registry_written_by_reference_resolves_equal(tmp_path, machine):
    """A registry file written by ``repro`` (backend "cpu") resolves in the
    port to the same Resolution as in the reference: hits, misses, the
    machine-scoped namespace and the fused flag."""
    path = str(tmp_path / "registry.json")
    jr = jreg.Registry(path=path, autoload=False)
    mkey = jarch.machine_key_component(machine)
    jr.record("gemm", (64, 48, 32), np.float32, "cpu",
              {"bm": 256, "bn": 128, "bk": 512}, machine=mkey)
    jr.record("gemm", (64, 1, 40), np.float32, "cpu",
              {"bm": 128, "bn": 128, "bk": 128}, machine=mkey)
    jr.record("trsm", (64, 8), np.float32, "cpu", {"block": 32}, machine=mkey)
    jr.record("trsm+gemm", (80, 80, 16), np.float32, "cpu",
              {"bm": 128, "bn": 128, "bk": 128, "fused": 0}, machine=mkey)
    jr.save()
    tr = treg.Registry(path=path)
    assert tr.keys() == jreg.Registry(path=path).keys()
    for op, shape, kw in CASES:
        for pol in tpolicy.POLICIES:
            j = jtd.resolve(op, shape, np.float32, policy=pol,
                            registry=jreg.Registry(path=path), backend="cpu",
                            machine=machine, **kw)
            t = ttd.resolve(op, shape, torch.float32, policy=pol,
                            registry=tr, backend="cpu", machine=machine, **kw)
            _same_resolution(t, j)
    hit = ttd.resolve("gemm", (64, 48, 32), torch.float32, policy="tuned",
                      registry=tr, backend="cpu", machine=machine)
    assert hit.source == "registry" and hit.gemm_plan.bm == 256
    miss = ttd.resolve("gemm", (64, 48, 32), torch.float32, policy="tuned",
                       registry=tr, backend="cuda", machine=machine)
    assert miss.source == "fallback-model"


def test_registry_corrupt_and_missing(tmp_path):
    missing = treg.Registry(path=str(tmp_path / "none.json"))
    assert len(missing) == 0 and "cold start" in missing.load_error
    bad = tmp_path / "bad.json"
    bad.write_text("{broken")
    with pytest.warns(RuntimeWarning):
        assert treg.Registry(path=str(bad)).load() == 0
    good = treg.Registry(path=str(tmp_path / "rt.json"), autoload=False)
    good.record("gemm", (8, 8, 8), torch.bfloat16, "cuda", {"bm": 1, "bn": 2,
                                                            "bk": 3})
    good.save()
    assert json.load(open(good.path))["entries"] == {
        "gemm|8x8x8|bfloat16|cuda": {"op": "gemm",
                                     "params": {"bm": 1, "bn": 2, "bk": 3},
                                     "source": "sweep", "measured_s": None}}


# ---------------------------------- guards ----------------------------------

def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module, and chip_smoke's imports, load without
    jax or the JAX package."""
    code = """
import ast, importlib, os, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
tree = ast.parse(open("chip_smoke.py").read())
for node in ast.walk(tree):
    if isinstance(node, ast.Import):
        for a in node.names:
            importlib.import_module(a.name)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        importlib.import_module(node.module)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("clean", len([n for n in sys.modules if n.startswith("repro_torch")]))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("clean")


def test_missing_card_raises():
    from repro_torch import linalg
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    a = np.eye(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        linalg.gemm(a, a)
    with linalg.use(policy="model"):
        with pytest.raises(RuntimeError):
            linalg.cholesky(a)


def test_foreign_device_tensor_raises():
    from repro_torch import linalg
    a = torch.empty((4, 4), device="meta")
    with linalg.use(device="cpu"):
        with pytest.raises(ValueError, match="lies on meta"):
            linalg.gemm(a, a)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.nvcc_path()
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.library("gemm")
    assert not os.path.exists(tmp_path / "build" / "gemm.so")
