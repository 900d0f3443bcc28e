"""The mesh layer's host-side pieces against the JAX package, in process:
``plan_pdgemm`` on every machine, the registry's mesh keys, op
``"pdgemm"``'s resolutions, the collectives' pure parts (records, int8
codes, the partial softmax), and the guards - a mesh the world cannot
hold, a mesh context without a process group. One test starts a
one-rank gloo group in process: a (1, 1) mesh is a real group, and its
``pdgemm`` is bitwise the single-device ``gemm``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import arch as jarch
from repro.core import codesign as jcd
from repro.distributed import collectives as jcoll
from repro.launch import mesh as jmesh
from repro.tune import dispatch as jtd
from repro.tune import registry as jreg
from repro_torch import arch as tarch
from repro_torch import linalg
from repro_torch.blas import distributed as tdblas
from repro_torch.core import codesign as tcd
from repro_torch.distributed import collectives as tcoll
from repro_torch.launch import mesh as tmesh
from repro_torch.linalg import context as lctx
from repro_torch.tune import dispatch as ttd
from repro_torch.tune import registry as treg

MACHINES = ("tpu-like", "paper-pe", "cpu-host")
MESHES = [(1, 1), (2, 2), (4, 2), (2, 4), (16, 16)]
SHAPES = [(1, 1, 1), (24, 20, 36), (4096, 4096, 4096), (8192, 8192, 8192),
          (1000, 3000, 77)]


def _pd(p):
    d = dataclasses.asdict(p)
    d["modeled_time"], d["collective_bound"] = p.modeled_time, \
        p.collective_bound
    return d


@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("db", [2, 4, 8])
def test_plan_pdgemm_bit_equal(machine, db):
    for shape in SHAPES:
        for px, py in MESHES:
            t = tcd.plan_pdgemm(*shape, px, py, dtype_bytes=db,
                                machine=tarch.get(machine))
            j = jcd.plan_pdgemm(*shape, px, py, dtype_bytes=db,
                                machine=jarch.get(machine))
            assert _pd(t) == _pd(j), (shape, px, py)


def test_plan_pdgemm_on_the_card_machine():
    """Under ``h100`` the local plan is B1's CTA tile (``plan_gemm``'s)
    and the collective term prices NVLink's 450 GB/s a direction."""
    h100 = tarch.get("h100")
    p = tcd.plan_pdgemm(8192, 8192, 8192, 2, 2, dtype_bytes=4, machine=h100)
    assert p.local == tcd.plan_gemm(4096, 4096, 2048, dtype_bytes=4,
                                    machine=h100)
    assert (p.local.bm, p.local.bn, p.local.bk) in \
        [t[:3] for t in tcd.HOPPER_TILES[4][1]]
    assert p.collective_bytes == 268_435_456
    assert p.collective_s == 268_435_456 / 450e9
    one = tcd.plan_pdgemm(8192, 8192, 8192, 1, 1, dtype_bytes=4,
                          machine=h100)
    assert one.collective_bytes == 0 and one.local == tcd.plan_gemm(
        8192, 8192, 8192, dtype_bytes=4, machine=h100)


def test_registry_mesh_keys_do_not_alias(tmp_path):
    reg = treg.Registry(path=str(tmp_path / "registry.json"))
    reg.record("pdgemm", (128, 128, 64), torch.float32, "cpu",
               {"bm": 128, "bn": 128, "bk": 128}, source="sweep",
               measured_s=1e-3, mesh="x2y4")
    reg.record("gemm", (128, 128, 64), torch.float32, "cpu",
               {"bm": 256, "bn": 128, "bk": 128})
    reloaded = treg.Registry(path=reg.save())
    hit = reloaded.lookup("pdgemm", (128, 128, 64), torch.float32, "cpu",
                          mesh="x2y4")
    assert hit is not None and hit.params["bm"] == 128
    assert reloaded.lookup("pdgemm", (128, 128, 64), torch.float32, "cpu",
                           mesh="x4y2") is None
    assert reloaded.lookup("pdgemm", (128, 128, 64), torch.float32,
                           "cpu") is None
    assert reloaded.lookup("gemm", (128, 128, 64), torch.float32,
                           "cpu").params["bm"] == 256
    assert treg.make_key("pdgemm", (128, 128, 64), torch.float32, "cpu",
                         "x2y4") == jreg.make_key(
        "pdgemm", (128, 128, 64), jnp.float32, "cpu", "x2y4") \
        == "pdgemm|128x128x64|float32|cpu|x2y4"


@pytest.mark.parametrize("policy", ["reference", "model", "tuned"])
@pytest.mark.parametrize("mesh", [(2, 2), (4, 2)])
def test_pdgemm_resolution_equals_reference(tmp_path, policy, mesh):
    """op "pdgemm" resolves field for field as in the reference, from the
    same registry file (a hit under x2y2, a miss elsewhere)."""
    path = str(tmp_path / "registry.json")
    jr = jreg.Registry(path=path, autoload=False)
    jr.record("pdgemm", (64, 64, 64), np.float32, "cpu",
              {"bm": 128, "bn": 128, "bk": 128}, mesh="x2y2")
    jr.save()
    j = jtd.resolve("pdgemm", (64, 64, 64), np.float32, policy=policy,
                    registry=jreg.Registry(path=path), backend="cpu",
                    mesh=mesh)
    t = ttd.resolve("pdgemm", (64, 64, 64), torch.float32, policy=policy,
                    registry=treg.Registry(path=path), backend="cpu",
                    mesh=mesh)
    assert (t.op, t.policy, t.source, t.use_pallas, t.mesh, t.machine) == \
        (j.op, j.policy, j.source, j.use_pallas, j.mesh, j.machine)
    assert (t.gemm_plan is None) == (j.gemm_plan is None)
    if t.gemm_plan is not None:
        assert dataclasses.asdict(t.gemm_plan) == \
            dataclasses.asdict(j.gemm_plan)
    assert t.describe() == j.describe()


def test_pdgemm_resolution_sources(tmp_path):
    reg = treg.Registry(path=str(tmp_path / "registry.json"))
    cold = ttd.resolve("pdgemm", (64, 64, 64), torch.float32,
                       policy="tuned", registry=reg, backend="cpu",
                       mesh=(2, 2))
    model = ttd.resolve("pdgemm", (64, 64, 64), torch.float32,
                        policy="model", backend="cpu", mesh=(2, 2))
    assert cold.source == "fallback-model" and cold.use_pallas
    assert cold.mesh == "x2y2" and cold.describe()["mesh"] == "x2y2"
    assert cold.gemm_plan == model.gemm_plan
    reg.record("pdgemm", (64, 64, 64), torch.float32, "cpu",
               {"bm": 128, "bn": 128, "bk": 128}, mesh="x2y2")
    hit = ttd.resolve("pdgemm", (64, 64, 64), torch.float32, policy="tuned",
                      registry=reg, backend="cpu", mesh=(2, 2))
    assert hit.source == "registry"
    ref = ttd.resolve("pdgemm", (64, 64, 64), torch.float32,
                      policy="reference", mesh=(2, 2))
    assert not ref.use_pallas and ref.mesh == "x2y2"
    with pytest.raises(ValueError, match="mesh"):
        ttd.resolve("pdgemm", (64, 64, 64), torch.float32, policy="model")


def test_collective_vocabulary():
    assert [f.name for f in dataclasses.fields(tcoll.CollectiveRecord)] == \
        [f.name for f in dataclasses.fields(jcoll.CollectiveRecord)]
    assert tcoll.Q_BLOCK == jcoll.Q_BLOCK
    for nbytes, size in [(0, 1), (100, 1), (100, 2), (7, 8)]:
        assert tcoll.ring_bcast_bytes(nbytes, size) == \
            jcoll.ring_bcast_bytes(nbytes, size)
    with tcoll.record_collectives() as rec:
        tcoll.emit_record(tcoll.CollectiveRecord(kind="pad_batch"))
    tcoll.emit_record(tcoll.CollectiveRecord(kind="outside"))
    assert [r.kind for r in rec] == ["pad_batch"]


@pytest.mark.parametrize("shape", [(64, 64), (3, 100), (1,), (5, 7, 11)])
def test_int8_codes_match_reference(rng, shape):
    x = (rng.normal(size=shape) * 10).astype(np.float32)
    tq, ts = tcoll._quantize(torch.from_numpy(x))
    jq, js = jcoll._quantize(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tcoll._dequantize(tq, ts, shape).numpy(),
        np.asarray(jcoll._dequantize(jq, js, shape)))


def test_partial_softmax_matches_reference(rng):
    b, hq, hkv, sc, d = 2, 8, 4, 40, 16
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, sc, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, sc, d)).astype(np.float32)
    valid = np.arange(sc)[None, None, :] < np.array([30, 3])[:, None, None]
    got = tcoll._partial_softmax_attention(*map(torch.from_numpy,
                                                (q, k, v, valid)))
    want = jcoll._partial_softmax_attention(*map(jnp.asarray,
                                                 (q, k, v, valid)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5)


# ------------------------------ the guards ----------------------------------

def test_mesh_without_a_process_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        tmesh.make_debug_mesh(data=2, model=2)
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        tdblas.make_blas_mesh(2, 2)
    a = np.ones((8, 8), np.float32)
    with linalg.use(device="cpu", policy="model", mesh=(2, 2)):
        for call in (lambda: linalg.gemm(a, a), lambda: linalg.syrk(a),
                     lambda: linalg.trsm(np.eye(8, dtype=np.float32), a),
                     lambda: linalg.batched_cholesky(a[None])):
            with pytest.raises(RuntimeError, match="linalg.use\\(mesh="):
                call()


def test_context_mesh_field():
    with pytest.raises(ValueError, match="px, py"):
        lctx.ExecutionContext(mesh=(2,))
    with pytest.raises(ValueError, match="px, py"):
        lctx.ExecutionContext(mesh=(2, 0))
    with pytest.raises(ValueError, match="DeviceMesh"):
        lctx.ExecutionContext(mesh="2x2")
    ctx = lctx.ExecutionContext(mesh=(2, 4))
    assert ctx.over(lctx.get_context()).describe()["mesh"] == [2, 4]
    assert lctx.get_context().describe()["mesh"] is None
    assert lctx.resolved_mesh(lctx.get_context()) is None
    assert lctx.compat_context(policy="model").mesh is None


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo process group in this process, torn down after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh(one_rank, rng):
    """A mesh the world cannot hold raises naming both numbers; a (1, 1)
    mesh is a real one-rank group whose pdgemm launches the single-device
    plan once, with zero hops, bitwise the single-device gemm."""
    with pytest.raises(ValueError, match="needs 4 ranks; the process "
                                         "group holds 1"):
        tmesh.make_debug_mesh(data=2, model=2)
    with pytest.raises(ValueError, match="needs 8 ranks; the process "
                                         "group holds 1"):
        tdblas.make_blas_mesh(4, 2)
    dm = tmesh.make_debug_mesh(data=1, model=1)
    assert tmesh.mesh_name(dm) == jmesh.mesh_name(
        jmesh.make_debug_mesh(data=1, model=1)) == "data1xmodel1"
    mesh = tdblas.make_blas_mesh(1, 1)
    assert tdblas.mesh_key(mesh) == "x1y1"
    assert dist.get_world_size(mesh.get_group("x")) == 1
    a = rng.normal(size=(40, 24)).astype(np.float32)
    b = rng.normal(size=(24, 33)).astype(np.float32)
    with linalg.use(device="cpu", policy="model"):
        want = linalg.gemm(a, b)
    with tcoll.record_collectives() as rec, \
            linalg.use(device="cpu", policy="model", mesh=(1, 1)):
        got = linalg.gemm(a, b)
    assert torch.equal(got, want)
    assert [r.kind for r in rec] == ["pdgemm", "ring_bcast", "ring_bcast"]
    assert all(r.hops == 0 for r in rec)
    assert lctx.resolved_mesh(lctx.ExecutionContext(mesh=(1, 1))) is \
        lctx.resolved_mesh(lctx.ExecutionContext(mesh=(1, 1)))
