"""repro_torch.core.pe and its scoreboard (B8's plain version) against
repro.core.pe: cycles and stalls exactly, against the reference's jitted
scan (JAX on the CPU) and against the brute-force oracle of
tests/test_pe_sim.py, on random SSA streams and on compiled BLAS/LAPACK
streams; then simulate / sweep / sweep_joint / best_depth with every
PEResult field equal, with and without ``machine=``. The port runs the
scoreboard on the card by default; these tests pass ``device="cpu"``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import arch as jarch
from repro.core import isa as jisa
from repro.core import pe as jpe
from repro_torch import arch as tarch
from repro_torch.core import isa as tisa
from repro_torch.core import pe as tpe
from repro_torch.kernels import pe_scoreboard as ps
from test_pe_sim import _random_stream, scoreboard_reference


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _random_depths(rng):
    return {"mul": int(rng.integers(1, 20)), "add": int(rng.integers(1, 20)),
            "div": int(rng.integers(1, 40)), "sqrt": int(rng.integers(1, 40))}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 2, 37, 400])
def test_plain_scoreboard_matches_reference_random(seed, n):
    rng = np.random.default_rng(seed)
    opcode, src1, src2 = _random_stream(rng, n)
    lats = np.stack([jpe._latency_vector(_random_depths(rng))
                     for _ in range(3)])
    cycles, stalls = ps.pe_scoreboard(_t(opcode), _t(src1), _t(src2),
                                      _t(lats))
    assert cycles.dtype == stalls.dtype == torch.int32
    jc, js = jpe._scoreboard_sweep(jnp.asarray(opcode), jnp.asarray(src1),
                                   jnp.asarray(src2), jnp.asarray(lats))
    assert cycles.tolist() == np.asarray(jc).tolist()
    assert stalls.tolist() == np.asarray(js).tolist()
    for c, lat in enumerate(lats):
        assert (cycles[c].item(), stalls[c].item()) == \
            scoreboard_reference(opcode, src1, src2, lat)


# the kernel's distance classes (kernels/pe_scoreboard.py: a source 1 back
# joins the walk's chain, 2..NEAR from registers, up to WINDOW from the
# shared-memory ring, further as a staged value), each edge and a chunk's
DISTANCES = [1, 2, 3, ps.NEAR, ps.NEAR + 1, ps.NEAR + 2, 2 * ps.UNROLL,
             100, ps.CHUNK - 1, ps.CHUNK, ps.CHUNK + 1, ps.WINDOW - 1,
             ps.WINDOW, ps.WINDOW + 1, ps.WINDOW + ps.NEAR + 1, 40_000]
LONG_N = 50_000


def _distance_stream(rng, n, forward):
    """n instructions whose sources are drawn half from DISTANCES back and
    half uniformly from 1..n back (-1 where that reaches before the
    stream). With ``forward``, one source in six is one the reference
    reads as 0 (at or after its own instruction, at or past n, below -1)
    and opcodes run from -9 to 9."""
    i = np.arange(n)
    srcs = []
    for _ in range(2):
        d = np.where(rng.random(n) < 0.5, rng.choice(DISTANCES, n),
                     rng.integers(1, n, n))
        s = np.where(i - d < 0, -1, i - d)
        if forward:
            pick = rng.random(n)
            s = np.where(pick < 0.05, i, s)
            s = np.where((pick >= 0.05) & (pick < 0.1),
                         i + rng.integers(1, 100, n), s)
            s = np.where((pick >= 0.1) & (pick < 0.13),
                         n + rng.integers(0, 3, n), s)
            s = np.where((pick >= 0.13) & (pick < 0.17), rng.choice(
                [-2, -7, np.iinfo(np.int32).min], n), s)
        srcs.append(s.astype(np.int32))
    lo = -9 if forward else 0
    return (rng.integers(lo, jisa.N_OPCODES if not forward else 10, n)
            .astype(np.int32), *srcs)


@pytest.mark.parametrize("forward", [False, True],
                         ids=["backward", "forward"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_scoreboard_matches_reference_long(seed, forward):
    """About 50,000 instructions with sources in every distance class the
    card's kernel tells apart (W - 1, W and W + 1 back included): the plain
    version B8 is held to on the card equals the reference's jitted scan
    exactly, and the brute-force oracle on backward-only streams (the
    oracle has no slot for a source at or after its instruction)."""
    rng = np.random.default_rng(100 + seed)
    opcode, src1, src2 = _distance_stream(rng, LONG_N, forward)
    d = np.arange(LONG_N) - src1
    assert {ps.WINDOW - 1, ps.WINDOW, ps.WINDOW + 1} <= set(d.tolist())
    lats = np.stack([jpe._latency_vector(_random_depths(rng))
                     for _ in range(3)])
    if forward:
        lats[1] -= 6        # latencies of 0 and below as well
    cycles, stalls = ps.pe_scoreboard(_t(opcode), _t(src1), _t(src2),
                                      _t(lats))
    jc, js = jpe._scoreboard_sweep(jnp.asarray(opcode), jnp.asarray(src1),
                                   jnp.asarray(src2), jnp.asarray(lats))
    assert cycles.tolist() == np.asarray(jc).tolist()
    assert stalls.tolist() == np.asarray(js).tolist()
    if not forward:
        for c, lat in enumerate(lats):
            assert (cycles[c].item(), stalls[c].item()) == \
                scoreboard_reference(opcode, src1, src2, lat)


COMPILED = [
    ("ddot16 sequential", lambda m: m.compile_ddot(16, schedule="sequential")),
    ("ddot16 strided", lambda m: m.compile_ddot(16, "strided", 3)),
    ("ddot16 dot4", lambda m: m.compile_ddot(16, dot4=True)),
    ("ddot16 fma", lambda m: m.compile_ddot(16, fma=True)),
    ("dgemv8x12", lambda m: m.compile_dgemv(8, 12)),
    ("dgemm8 unroll4", lambda m: m.compile_dgemm(8, 8, 8, unroll=4)),
    ("dgemm9x8x12 unroll1", lambda m: m.compile_dgemm(9, 8, 12, unroll=1)),
    ("dgemm8 dot4", lambda m: m.compile_dgemm(8, 8, 8, dot4=True)),
    ("dgeqrf8", lambda m: m.compile_dgeqrf(8)),
    ("dgeqrf13", lambda m: m.compile_dgeqrf(13)),
    ("dgetrf12", lambda m: m.compile_dgetrf(12)),
    ("dgetrf16", lambda m: m.compile_dgetrf(16)),
    ("dpotrf11", lambda m: m.compile_dpotrf(11)),
    ("dpotrf16", lambda m: m.compile_dpotrf(16)),
]


def _same_result(t, j):
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.cpi, t.tpi, t.time, t.flops_per_time) == \
        (j.cpi, j.tpi, j.time, j.flops_per_time)


@pytest.mark.parametrize("name,build", COMPILED, ids=[c[0] for c in COMPILED])
def test_simulate_compiled_streams_match_reference(name, build):
    t, j = build(tisa), build(jisa)
    lat = jpe._latency_vector(jpe.DEFAULT_DEPTHS)
    assert scoreboard_reference(t.opcode, t.src1, t.src2, lat) == \
        tuple(v.item() for v in ps.pe_scoreboard(
            _t(t.opcode), _t(t.src1), _t(t.src2), _t(lat[None])))
    for depths in (None, {"mul": 3, "add": 2}, {"div": 30, "sqrt": 2}):
        _same_result(tpe.simulate(t, depths, device="cpu"),
                     jpe.simulate(j, depths))
    _same_result(tpe.simulate(t, {"add": 7}, t_o=0.25, device="cpu"),
                 jpe.simulate(j, {"add": 7}, t_o=0.25))


def _machines():
    """(port, reference) machine pairs: None, two registered specs, and a
    paper-pe variant with other depths and constants built on both sides."""
    out = [(None, None)]
    out += [(tarch.get(n), jarch.get(n)) for n in ("tpu-like", "cpu-host")]
    pair = []
    for arch in (tarch, jarch):
        base = arch.get("paper-pe")
        fpu = dataclasses.replace(
            base.fpu, depths={"mul": 3, "add": 2, "div": 20, "sqrt": 9},
            t_o=0.5)
        pair.append(dataclasses.replace(base, name="pe-variant", fpu=fpu))
    return out + [tuple(pair)]


MACHINES = _machines()
SWEEP_STREAMS = [COMPILED[5], COMPILED[8], COMPILED[10], COMPILED[12]]


@pytest.mark.parametrize("name,build", SWEEP_STREAMS,
                         ids=[c[0] for c in SWEEP_STREAMS])
@pytest.mark.parametrize("mi", range(len(MACHINES)))
def test_sweeps_match_reference(name, build, mi):
    tm, jm = MACHINES[mi]
    t, j = build(tisa), build(jisa)
    depths = [1, 2, 4, 8, 16, 24]
    for unit in ("add", "div"):
        got = tpe.sweep(t, unit, depths, machine=tm, device="cpu")
        want = jpe.sweep(j, unit, depths, machine=jm)
        for a, b in zip(got, want, strict=True):
            _same_result(a, b)
        assert tpe.best_depth(got, unit) == jpe.best_depth(want, unit)
    for units in (["add", "mul"], ["sqrt", "div"]):
        got = tpe.sweep_joint(t, units, depths, fixed={"mul": 6},
                              machine=tm, device="cpu")
        want = jpe.sweep_joint(j, units, depths, fixed={"mul": 6},
                               machine=jm)
        for a, b in zip(got, want, strict=True):
            _same_result(a, b)
        assert tpe.best_depth(got, units[0]) == \
            jpe.best_depth(want, units[0])
    single = tpe.simulate(t, {"add": 8}, machine=tm, device="cpu")
    _same_result(single, jpe.simulate(j, {"add": 8}, machine=jm))


def test_pe_helpers_match_reference():
    assert tpe.DEFAULT_DEPTHS == jpe.DEFAULT_DEPTHS
    for depths in ({}, {"mul": 9}, {"add": 1, "div": 33}):
        np.testing.assert_array_equal(tpe._latency_vector(depths),
                                      jpe._latency_vector(depths))
        assert tpe.cycle_time(depths) == jpe.cycle_time(depths)
        assert tpe.cycle_time(depths, used=("add",), t_o=0.3) == \
            jpe.cycle_time(depths, used=("add",), t_o=0.3)


@pytest.mark.parametrize("opcode,src1", [
    ([-1, 1], [-1, 0]), ([-7, 2], [-1, -2]), ([-100, 100], [-1, 0]),
    ([1, 2, 3], [-1, 5, 1]), ([1, 2, 3], [-1, 2, 7])])
def test_out_of_range_inputs_follow_reference(opcode, src1):
    """Inputs no compiler emits: negative and too large opcodes, sources
    below -1, at or beyond n, and not yet produced - the reference's gather
    semantics, exactly."""
    op = np.asarray(opcode, np.int32)
    s1 = np.asarray(src1, np.int32)
    s2 = np.full_like(s1, -1)
    lat = np.asarray([1, 10, 20, 30, 40, 50, 60], np.int32)
    jc, js = jpe._scoreboard(jnp.asarray(op), jnp.asarray(s1),
                             jnp.asarray(s2), jnp.asarray(lat))
    cycles, stalls = ps.pe_scoreboard(_t(op), _t(s1), _t(s2), _t(lat[None]))
    assert (cycles.item(), stalls.item()) == (int(jc), int(js))


def test_empty_stream_refused_as_reference():
    empty = np.zeros(0, np.int32)
    lat = jpe._latency_vector({})
    with pytest.raises(IndexError):
        jpe._scoreboard(jnp.asarray(empty), jnp.asarray(empty),
                        jnp.asarray(empty), jnp.asarray(lat))
    with pytest.raises(ValueError, match="empty stream"):
        ps.pe_scoreboard(_t(empty), _t(empty), _t(empty), _t(lat[None]))
    stream = tisa.InstrStream("empty", empty, empty, empty)
    with pytest.raises(ValueError, match="empty stream"):
        tpe.simulate(stream, device="cpu")


@pytest.mark.parametrize("bad", ["dtype", "shape", "lat", "configs"])
def test_wrapper_rejects_bad_operands(bad):
    op = _t(np.ones(4))
    s = _t(-np.ones(4))
    lat = _t(np.ones((2, 7)))
    if bad == "dtype":
        op = op.long()
    elif bad == "shape":
        s = s[:3]
    elif bad == "lat":
        lat = lat[:, :6]
    else:
        lat = lat[:0]
    with pytest.raises(ValueError):
        ps.pe_scoreboard(op, s, s, lat)


def test_cpu_route_counts_no_launch_and_card_is_default(monkeypatch):
    s = tisa.compile_dgetrf(8)
    before = ps.pe_scoreboard.launches
    tpe.sweep(s, "div", [2, 4], device="cpu")
    assert ps.pe_scoreboard.launches == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tpe.simulate(s), lambda: tpe.sweep(s, "add", [2]),
                 lambda: tpe.sweep_joint(s, ["add"], [2])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
