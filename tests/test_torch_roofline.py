"""repro_torch.core.roofline held to repro.core.roofline on the inputs of
tests/test_roofline.py: the HLO collective parser, the terms, advice and
the JSON rows each package reads from the other."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.core import roofline as ref
from repro_torch.core import roofline as rl
from repro_torch.core.aten_cost import Cost

SYNTHETIC = """
HloModule m

ENTRY %main {
  %p0 = f32[128,64]{1,0} parameter(0)
  %ag = f32[512,64]{1,0} all-gather(%p0), dimensions={0}
  %ar = f32[512,64]{1,0} all-reduce(%ag), to_apply=%add
  %rs = f32[64,64]{1,0} reduce-scatter(%ar), dimensions={0}
  %cp = f32[64,64]{1,0} collective-permute(%rs), source_target_pairs={{0,1}}
  ROOT %out = f32[64,64]{1,0} add(%cp, %rs)
}
"""
ASYNC = """
ENTRY %main {
  %p0 = f32[100]{0} parameter(0)
  %s = (f32[100]{0}, f32[100]{0}) all-reduce-start(%p0), to_apply=%add
  %d = f32[100]{0} all-reduce-done(%s)
  ROOT %r = f32[100]{0} add(%d, %d)
}
"""
METADATA = """
ENTRY %main {
  %p0 = f32[16]{0} parameter(0)
  %ar = f32[16]{0} all-reduce(%p0), metadata={op_name="f32[9999,9999]"}
}
"""


@pytest.mark.parametrize("text", ["f32[64,256]{1,0}", "bf16[8]",
                                  "(f32[2,2], s8[4])", "pred[]",
                                  "f64[3,5] u16[7] f8e4m3fn[9]", "token[]"])
def test_shape_bytes(text):
    assert rl._shape_bytes(text) == ref._shape_bytes(text)


@pytest.mark.parametrize("hlo", [SYNTHETIC, ASYNC, METADATA],
                         ids=["synthetic", "async", "metadata"])
def test_collective_parser(hlo):
    assert rl.collective_bytes(hlo) == ref.collective_bytes(hlo)
    if hlo is SYNTHETIC:
        assert rl.collective_bytes(hlo)["all-gather"] == 128 * 64 * 4


_SHARDED = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = jax.make_mesh((2, 2), ("x", "y"))
    def f(a, b):
        return jnp.tanh(a @ b).sum(0)
    a = jax.ShapeDtypeStruct((256, 128), jnp.float32)
    b = jax.ShapeDtypeStruct((128, 64), jnp.float32)
    shard = (NamedSharding(mesh, P("x", "y")), NamedSharding(mesh, P("y")))
    print(jax.jit(f, in_shardings=shard).lower(a, b).compile().as_text())
""")


def test_collective_parser_on_compiled_hlo():
    """A sharded program's optimized HLO (compiled in a subprocess with
    four host devices): the same bytes per kind on both sides, and some."""
    r = subprocess.run([sys.executable, "-c", _SHARDED],
                       env=dict(os.environ, PYTHONPATH="src",
                                JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got, want = rl.collective_bytes(r.stdout), ref.collective_bytes(r.stdout)
    assert got == want and sum(got.values()) > 0, (got, want)


def _pair(**kw):
    base = dict(arch="a", shape="s", mesh="m", chips=256,
                hlo_flops=197e12 * 0.010, hlo_bytes=819e9 * 0.005,
                coll_bytes=50e9 * 0.002, coll_breakdown={"all-reduce": 3},
                model_flops=256 * 197e12 * 0.008, bytes_per_device=1e9,
                extra={"kind": "train"})
    base.update(kw)
    return rl.Roofline(**base), ref.Roofline(**base)


PROPS = ("compute_s", "memory_s", "collective_s", "dominant", "step_time_s",
         "useful_flop_ratio", "roofline_fraction", "modeled_gflops_per_w")
CASES = {
    "compute": {},
    "memory": {"hlo_bytes": 819e9 * 0.050},
    "collective": {"coll_bytes": 50e9 * 0.5},
    "low-useful": {"model_flops": 256 * 197e12 * 0.001},
    "zero": {"hlo_flops": 0.0, "hlo_bytes": 0.0, "coll_bytes": 0.0},
    "machine": {"machine": "paper-pe"},
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("prop", PROPS)
def test_roofline_property(case, prop):
    mine, theirs = _pair(**CASES[case])
    a, b = getattr(mine, prop), getattr(theirs, prop)
    if isinstance(b, float) and b != b:
        assert a != a
    else:
        assert a == pytest.approx(b, rel=1e-12), (case, prop)


@pytest.mark.parametrize("case", sorted(CASES))
def test_to_dict(case):
    mine, theirs = _pair(**CASES[case])
    a, b = mine.to_dict(), theirs.to_dict()
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(b[k], float) and b[k] != b[k]:
            assert a[k] != a[k]
        else:
            assert a[k] == (pytest.approx(b[k], rel=1e-12)
                            if isinstance(b[k], float) else b[k]), k


@pytest.mark.parametrize("case", ["compute", "low-useful", "memory",
                                  "collective"])
def test_advice(case):
    mine, theirs = _pair(**CASES[case])
    assert rl.advice(mine) == ref.advice(theirs)
    assert mine.dominant == case.replace("low-useful", "compute")


def test_terms_as_reference_test():
    r, _ = _pair()
    assert r.compute_s == pytest.approx(0.010)
    assert r.memory_s == pytest.approx(0.005)
    assert r.collective_s == pytest.approx(0.002)
    assert r.dominant == "compute"
    assert r.roofline_fraction == pytest.approx(0.8)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_load_json_across_packages(writer, tmp_path):
    rows = [_pair(**CASES[c]) for c in sorted(CASES)]
    path = str(tmp_path / "rows.json")
    if writer == "port":
        rl.save_json(path, [m for m, _ in rows])
        back = ref.load_json(path)
    else:
        ref.save_json(path, [t for _, t in rows])
        back = rl.load_json(path)
    assert len(back) == len(rows)
    for (mine, theirs), b in zip(rows, back):
        want = dataclasses.asdict(mine if writer == "port" else theirs)
        want["machine"] = want["machine"] or "tpu-like"
        assert dataclasses.asdict(b) == want
        assert b.dominant == theirs.dominant


@pytest.mark.parametrize("machine", ["no-such-machine", "h100"])
def test_unknown_machine_falls_back(machine, tmp_path):
    """A name the reading process has not registered prices against the
    default machine on both sides (``"h100"`` is the port's own)."""
    mine, theirs = _pair(machine=machine)
    assert theirs.machine_spec().name == "tpu-like"
    if machine == "h100":
        assert mine.machine_spec().name == "h100"
        mine = dataclasses.replace(mine, machine=None)
    assert mine.compute_s == pytest.approx(theirs.compute_s)
    path = str(tmp_path / "r.json")
    rl.save_json(path, [mine])
    with open(path) as f:
        assert json.load(f)[0]["machine"] == (mine.machine or "tpu-like")
    assert ref.load_json(path)[0].machine_spec().name == "tpu-like"


def test_from_trace():
    cost = Cost(flops=4e12, bytes=9e11, bytes_fused=3e11,
                coll={"all-gather": 5e8, "reduce-scatter": 1e8})
    r = rl.from_trace("a", "train_4k", "data16xmodel16", 256, cost, 1e15,
                      7e10, extra={"kind": "train"}, machine="h100")
    assert (r.hlo_flops, r.hlo_bytes, r.coll_bytes) == (4e12, 3e11, 6e8)
    assert r.extra == {"kind": "train", "bytes_unfused": 9e11}
    assert r.coll_breakdown == {"all-gather": 500000000,
                                "reduce-scatter": 100000000, "all-reduce": 0,
                                "all-to-all": 0, "collective-permute": 0}
    assert r.machine_spec().name == "h100" and r.bytes_per_device == 7e10
    assert rl.from_trace("a", "s", "m", 1, cost, 1.0, 1.0).machine_spec() \
        .name == "tpu-like"
