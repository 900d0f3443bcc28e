"""repro_torch.arch.calibrate and the FPU-chain probe's plain version,
against the JAX package, on the CPU.

``fit_machine`` and the evidence report of both packages on the same
synthetic evidence (the reference's wall-clock chains, and the card's
chain cycles, which only the port has); the suite run on the CPU at tiny
sizes; the persistence convention (round trip, missing and corrupt
files); the chain's plain version against a numpy float32 loop, bit for
bit. The chain kernel itself is held to that plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import importlib
import inspect
import json
import math
import os

import numpy as np
import pytest
import torch

from repro import arch as jarch
from repro.tune import measure as JM
from repro_torch import arch as tarch
from repro_torch.kernels import fpu_chain as fc
from repro_torch.tune import measure as TM

# the modules (each package's arch.calibrate is also the function's name)
jcal = importlib.import_module("repro.arch.calibrate")
tcal = importlib.import_module("repro_torch.arch.calibrate")
# small enough for the test budget: one warm-up and one timed rep each
FAST_CAL = dict(gemm_sizes=(16, 32), stream_elems=1 << 14, chain_iters=16,
                reps=1, backend="cpu")
OPS = {"mul": lambda x, c: x * c, "add": lambda x, c: x + c,
       "div": lambda x, c: x / c,
       "sqrt": lambda x, c: np.sqrt(x) + np.float32(0.5)}


def _evidence(mod, backend, chain_s, cycles=None):
    """Synthetic suite evidence built with ``mod``'s Measurement: a GEMM
    ladder, the two streams, one chain per op class."""
    meas = lambda *s: mod.Measurement.from_samples(s)
    ev = {"backend": backend,
          "gemm": [{"n": n, "flops": 2.0 * n ** 3,
                    "measurement": meas(t, 1.1 * t)}
                   for n, t in ((256, 4e-5), (1024, 9e-4), (2048, 6e-3))],
          "stream": [{"kind": "copy", "bytes": 2 * 4 * 2 ** 20,
                      "measurement": meas(5e-6, 6e-6)},
                     {"kind": "reduction", "bytes": 4 * 2 ** 20,
                      "measurement": meas(2e-6, 2.5e-6)}],
          "chains": {}}
    for cls, s in chain_s.items():
        ev["chains"][cls] = {"iters": 256, "measurement": meas(s, s),
                             "latency_s": s / 256}
        if cycles is not None:
            ev["chains"][cls]["cycles_per_op"] = cycles[cls]
    return ev


CHAIN_S = [{"mul": 1e-6, "add": 1.2e-6, "div": 3e-6, "sqrt": 4.1e-6},
           {"mul": 2e-6, "add": 2e-6, "div": 2e-6, "sqrt": 2e-6},
           {"mul": 1e-7, "add": 5e-7, "div": 9e-6, "sqrt": 1e-4}]


@pytest.mark.parametrize("chain_s", CHAIN_S)
@pytest.mark.parametrize("base", [None, "paper-pe", "tpu-like"])
def test_fit_machine_matches_reference(chain_s, base):
    """The same wall-clock evidence fits the same spec in both packages:
    peak, bandwidth, depths (ratios anchored at the base's multiplier,
    clamped to 1..64), the base's other sections; and the same report."""
    t_ev, j_ev = (_evidence(TM, "cpu", chain_s),
                  _evidence(JM, "cpu", chain_s))
    t = tcal.fit_machine(t_ev, base=None if base is None
                         else tarch.get(base))
    j = jcal.fit_machine(j_ev, base=None if base is None
                         else jarch.get(base))
    assert t.name == j.name == "calibrated-cpu"
    assert t.to_json() == j.to_json()
    t_rows, j_rows = tcal._report(t_ev, t), jcal._report(j_ev, j)
    assert [r["model_residual"] for r in t_rows] == \
        [r["model_residual"] for r in j_rows]
    assert t_rows == j_rows


def test_fit_from_card_chain_cycles():
    """Evidence from the card's chain kernel carries cycles per dependent
    op: each depth is those cycles, rounded and clamped; the base is h100
    and the fit stays a GPU spec (SMs, clock), named calibrated-cuda."""
    cycles = {"mul": 5.45, "add": 4.51, "div": 60.66, "sqrt": 99.0}
    ev = _evidence(TM, "cuda", CHAIN_S[0], cycles)
    m = tcal.fit_machine(ev)
    assert m.name == "calibrated-cuda"
    assert dict(m.fpu.depths) == {"mul": 5, "add": 5, "div": 61, "sqrt": 64}
    h100 = tarch.get("h100")
    assert (m.pe.sm_count, m.pe.clock_hz, m.memory.vmem_bytes) == (
        h100.pe.sm_count, h100.pe.clock_hz, h100.memory.vmem_bytes)
    rate = lambda rows, w: max(r[w] / r["measurement"].seconds_median
                               for r in rows)
    assert m.pe.peak_flops == rate(ev["gemm"], "flops")
    assert m.memory.hbm_bw == rate(ev["stream"], "bytes")
    rows = tcal._report(ev, m)
    chain = [r for r in rows if r["bench"] == "chain"]
    assert [r["params"]["cycles_per_op"] for r in chain] == \
        [cycles[c] for c in tarch.OP_CLASSES]


def test_suite_sizes_default_per_device():
    """The CPU's defaults are the reference's; the card's reach the
    thousands (a wave of 132 SMs), stream past the L2 and run long
    chains."""
    sig = inspect.signature(jcal.run_microbenchmarks).parameters
    assert tcal.SUITE_SIZES["cpu"] == {
        k: sig[k].default for k in ("gemm_sizes", "stream_elems",
                                    "chain_iters")}
    cuda = tcal.SUITE_SIZES["cuda"]
    assert max(cuda["gemm_sizes"]) >= 4096
    assert cuda["stream_elems"] * 4 > 50 * 10 ** 6
    assert cuda["chain_iters"] >= 1 << 16


def test_run_microbenchmarks_on_the_cpu():
    res = tcal.run_microbenchmarks(**FAST_CAL)
    assert res["backend"] == "cpu"
    assert [r["n"] for r in res["gemm"]] == [16, 32]
    assert all(r["allow_tf32"] is False for r in res["gemm"])
    assert [r["kind"] for r in res["stream"]] == ["copy", "reduction"]
    assert set(res["chains"]) == set(tarch.OP_CLASSES)
    for row in res["chains"].values():
        assert row["iters"] == 16 and row["latency_s"] > 0
        assert "cycles_per_op" not in row           # no cycles on the CPU


def test_calibrate_registers_and_fits():
    res = tarch.calibrate_full(**FAST_CAL)
    m = res.machine
    assert m.name == "calibrated-cpu" and tarch.get("calibrated-cpu") == m
    assert m.pe.peak_flops > 0 and m.memory.hbm_bw > 0
    assert all(d >= 1 for d in m.fpu.depths.values())
    assert res.best_residual("gemm") <= tarch.CALIBRATION_TOLERANCE
    assert res.best_residual("stream") <= tarch.CALIBRATION_TOLERANCE
    for row in res.report:
        assert math.isfinite(row["model_residual"])
        assert row["reps"] >= 1 and row["seconds_median"] > 0
    json.dumps(res.to_json())
    with pytest.raises(ValueError, match="no report rows"):
        res.best_residual("nope")


def test_calibrate_roundtrip_persistence(tmp_path):
    p = str(tmp_path / "calibrated.json")
    spec = tarch.calibrate(path=p, **FAST_CAL)
    assert os.path.exists(p) and tarch.MachineSpec.load(p) == spec
    assert jarch.MachineSpec.load(p).to_json() == spec.to_json()
    again = tarch.load_or_calibrate(p, **FAST_CAL)   # loads, no re-measuring
    assert again == spec and tarch.get("calibrated-cpu") == spec


def test_load_or_calibrate_missing_file_calibrates(tmp_path):
    p = str(tmp_path / "nope" / "calibrated.json")
    os.makedirs(os.path.dirname(p))
    spec = tarch.load_or_calibrate(p, **FAST_CAL)
    assert spec.name == "calibrated-cpu"
    assert tarch.MachineSpec.load(p) == spec


def test_load_or_calibrate_corrupt_file_falls_back(tmp_path):
    p = tmp_path / "calibrated.json"
    p.write_text("{not json")
    spec = tarch.load_or_calibrate(str(p), **FAST_CAL)
    assert tarch.MachineSpec.load(str(p)) == spec


def test_calibration_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="backend='cpu'"):
        tarch.calibrate(register=False)
    with pytest.raises(ValueError, match="calibration runs on"):
        tcal.run_microbenchmarks(backend="meta")


# --------------------------- the chain's plain version -----------------------

@pytest.mark.parametrize("op", fc.OP_CLASSES)
@pytest.mark.parametrize("iters", [0, 1, 300])
def test_fpu_chain_plain_matches_numpy_bitwise(op, iters):
    """The plain chain (the kernel's yardstick on the card) against a numpy
    float32 loop with the reference's constant: IEEE mul, add, div and sqrt
    round alike, so the bits agree."""
    v0 = (1.5 + np.random.default_rng(3).uniform(size=fc.LANES)) \
        .astype(np.float32)
    want, c = v0.copy(), np.float32(fc.CHAIN_CONSTANT)
    for _ in range(iters):
        want = OPS[op](want, c)
    got, cycles = fc.fpu_chain(op, torch.from_numpy(v0), iters)
    assert cycles is None and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(fc.fpu_chain_plain(op, torch.from_numpy(v0),
                                             iters).numpy(), want)


def test_fpu_chain_validates_and_counts_no_cpu_launch():
    v0 = torch.full((fc.LANES,), 2.0)
    before = fc.fpu_chain.launches
    fc.fpu_chain("add", v0, 3)
    assert fc.fpu_chain.launches == before
    with pytest.raises(ValueError, match="op class"):
        fc.fpu_chain("fma", v0, 3)
    with pytest.raises(ValueError, match="float32"):
        fc.fpu_chain("add", v0.double(), 3)
    with pytest.raises(ValueError, match="float32"):
        fc.fpu_chain("add", torch.ones(4), 3)
    with pytest.raises(ValueError, match="iters"):
        fc.fpu_chain("add", v0, -1)
    assert set(fc.OP_CLASSES) == set(tarch.OP_CLASSES)
