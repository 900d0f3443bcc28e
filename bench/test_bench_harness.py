"""The benchmark's harness, driven on the CPU at a tiny size.

Each test runs whole cells through :func:`bench.harness.run` on a copy of
the benchmark whose configurations are cut to a few small items: the
port's kernels run as their plain versions, every other part of a run is
as on the card. ``bench/run.py`` itself refuses to run without a card.
"""
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from bench import harness  # noqa: E402

CPU = torch.device("cpu")
TINY = {"sq512_f32": dict(batch=4, m=256, n=256),
        "tall512x256_f32": dict(batch=4, m=256, n=128)}
CELLS = ("sq512_f32.posv", "tall512x256_f32.gels")
SECONDS = 0.3
SEED = 2 ** 31 + 977        # more than 32 signed bits hold


def _tiny_copy(dest: str) -> harness.Spec:
    """The benchmark copied to ``dest``, its configurations cut to TINY."""
    shutil.copytree(HERE, os.path.join(dest, "bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    for c in spec["configs"]:
        path = os.path.join(dest, c["file"])
        with open(path) as fh:
            cfg = json.load(fh)
        cfg.update(TINY[c["name"]])
        with open(path, "w") as fh:
            json.dump(cfg, fh)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return harness.Spec(dest, os.path.join(dest, "bench"))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _tiny_copy(str(tmp_path_factory.mktemp("tiny")))


def _run(spec, cell, trace=False, seed=SEED):
    # which modules are loaded depends on the other tests of this process;
    # test_nothing_loads_jax_or_the_jax_package checks a run of its own
    out, _ = harness.run(cell, seed, SECONDS, trace, CPU, time.perf_counter(),
                         spec)
    return out


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct_with_the_contract_keys(tiny, cell, trace):
    out = _run(tiny, cell, trace)
    want = ["correct", "attempted", "failed", "metrics", "device"] + \
        (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == want
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= (harness.TRACE_MIN_REQUESTS if trace else 1)
    dev = {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["device"]) == (dev | {"busy_s", "window_s"} if trace
                                  else dev)
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in tiny.metrics(kind, cell)}
    assert set(out["metrics"]) <= names
    if not trace:
        assert {"tflops", "setup_s"} <= set(out["metrics"])
    else:
        assert "lapack_mfu" in out["metrics"]      # from unprofiled requests
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(out)


def test_same_seed_same_inputs(tiny):
    from bench import generate
    cfg, traffic = tiny.config("sq512_f32"), tiny.traffic("posv")
    posv = tiny.routine(traffic["routine"])
    a1, b1 = generate.make_inputs(cfg, traffic, posv, SEED, CPU)
    a2, b2 = generate.make_inputs(cfg, traffic, posv, SEED, CPU)
    a3, _ = generate.make_inputs(cfg, traffic, posv, SEED + 1, CPU)
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    assert not torch.equal(a1, a3)
    assert torch.equal(a1, a1.mT)
    assert float(torch.linalg.eigvalsh(a1.double()).min()) >= 0.99


def _faults():
    """Each fault a cell can have, planted in the timed path's public
    calls: (name, wraps factor, wraps solve)."""
    def unchanged(factor):
        def f(a, **kw):
            return dataclasses.replace(factor(a, **kw), factors=a.clone())
        return f

    def half_batch(factor):
        def f(a, **kw):
            res = factor(a, **kw)
            packed = res.factors.clone()
            half = a.shape[0] // 2
            packed[half:] = a[half:]
            return dataclasses.replace(res, factors=packed)
        return f

    def one_answer_altered(solve):
        calls = [0]

        def f(res, b, **kw):
            x = solve(res, b, **kw)
            calls[0] += 1
            # the window's first request (after the warm-up's two): only
            # its solution is altered, not the last one's
            if calls[0] == harness.WARMUP_REQUESTS + 1:
                x = x.clone()
                x[-1, 0] = -x[-1, 0]
            return x
        return f

    return [("state returned unchanged", unchanged, None),
            ("half of the batch left out", half_batch, None),
            ("one answer altered", None, one_answer_altered)]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", _faults(), ids=lambda f: f[0])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    from repro_torch import linalg
    _, wrap_factor, wrap_solve = fault
    traffic = tiny.traffic(tiny.cell(cell)["traffic"])
    if wrap_factor:
        monkeypatch.setattr(linalg, traffic["factor"],
                            wrap_factor(getattr(linalg, traffic["factor"])))
    if wrap_solve:
        monkeypatch.setattr(linalg, traffic["solve"],
                            wrap_solve(getattr(linalg, traffic["solve"])))
    out = _run(tiny, cell)
    assert out["correct"] is False
    if wrap_solve:
        assert out["failed"] == 1
        assert out["checks"]["x_rel"]["value"] > \
            out["checks"]["x_rel"]["limit"]


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a driver with its own kind of item, a traffic mix,
    a limits file and a per-layer metric added as new files, with
    BENCHMARK.json naming them, run with no other file edited."""
    spec = _tiny_copy(str(tmp_path))
    bench = os.path.join(str(tmp_path), "bench")
    with open(os.path.join(bench, "configs", "sq96_f32.json"), "w") as fh:
        json.dump({"name": "sq96_f32", "dtype": "float32", "batch": 3,
                   "m": 96, "n": 96, "reduced": []}, fh)
    with open(os.path.join(bench, "reference", "posv_graded.py"),
              "w") as fh:
        fh.write(
            "import torch\n"
            "from bench.reference.posv import *  # noqa: F401,F403\n"
            "from bench.reference import posv\n\n\n"
            "def items(rand, batch, m, n, traffic):\n"
            "    a = posv.items(rand, batch, m, n, traffic)\n"
            "    d = traffic['grade'] ** (torch.arange(n, device=a.device)"
            " / n)\n"
            "    return a * d[:, None] * d[None, :]\n")
    traffic = dict(spec.traffic("posv"), name="posv_shift2", shift=2.0,
                   routine="posv_graded", grade=10.0)
    with open(os.path.join(bench, "traffic", "posv_shift2.json"), "w") as fh:
        json.dump(traffic, fh)
    shutil.copy(os.path.join(bench, "limits", "sq512_f32.posv.json"),
                os.path.join(bench, "limits", "sq96_f32.posv_shift2.json"))
    with open(os.path.join(bench, "metrics", "requests_traced.py"),
              "w") as fh:
        fh.write("def read(view):\n    return float(view.requests)\n")
    data = spec.data
    data["configs"].append({"name": "sq96_f32", "source": "test",
                            "file": "bench/configs/sq96_f32.json",
                            "reduced": []})
    data["workloads"].append({"name": "sq96_f32.posv_shift2",
                              "config": "sq96_f32", "traffic": "posv_shift2",
                              "chips": 1, "why": "test"})
    data["per_layer"].append({"name": "requests_traced", "unit": "requests",
                              "better": "higher", "source": "program_counter",
                              "layer": "linalg", "moves": "tflops",
                              "workloads": ["sq96_f32.posv_shift2"]})
    with open(os.path.join(str(tmp_path), "BENCHMARK.json"), "w") as fh:
        json.dump(data, fh)
    spec = harness.Spec(str(tmp_path), bench)
    out = _run(spec, "sq96_f32.posv_shift2", trace=True)
    assert out["correct"] is True
    assert out["metrics"]["requests_traced"]["value"] >= \
        harness.TRACE_MIN_REQUESTS


def test_nothing_loads_jax_or_the_jax_package(tmp_path):
    """A whole run, in a process of its own: no module whose top-level
    name is jax, jaxlib, flax, repro or benchmarks is loaded."""
    _tiny_copy(str(tmp_path))
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{os.path.join(ROOT, 'src')!r}, {ROOT!r}]\n"
        "from bench import harness\n"
        f"spec = harness.Spec({str(tmp_path)!r}, "
        f"{os.path.join(str(tmp_path), 'bench')!r})\n"
        "for cell in ('sq512_f32.posv', 'tall512x256_f32.gels'):\n"
        "    for trace in (False, True):\n"
        f"        out, banned = harness.run(cell, 5, {SECONDS}, trace, "
        "torch.device('cpu'), time.perf_counter(), spec)\n"
        "        assert out['correct'], out\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=str(tmp_path))
    assert done.returncode == 0, done.stderr[-2000:]
    top = set(json.loads(done.stdout.strip().splitlines()[-1]
                         .replace("'", '"')))
    assert "repro_torch" in top and "bench" in top
    assert not top & set(harness.BANNED)


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = subprocess.run(
        [sys.executable, os.path.join("bench", "run.py"), "--workload",
         CELLS[0], "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert done.returncode != 0
    assert "{" not in done.stdout
    assert "no CUDA device" in done.stderr


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        data = json.load(fh)
    assert set(data) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert data["paths"] == ["bench"] and data["command"][1] == "bench/run.py"
    assert 1 <= data["run_seconds"] <= 51
    names = set()
    configs = {c["name"] for c in data["configs"]}
    for c in data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and os.path.exists(
            os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    used = set()
    for w in data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        assert os.path.exists(os.path.join(HERE, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(HERE, "limits",
                                           w["name"] + ".json"))
        used.add(w["config"])
    assert used == configs
    e2e = {m["name"] for m in data["end_to_end"]}
    assert "setup_s" in e2e
    for m in data["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in data["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
    for m in data["end_to_end"] + data["per_layer"]:
        assert m["better"] in ("lower", "higher") and UNIT.match(m["unit"])
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in data["workloads"]}
    for entry in data["configs"] + data["workloads"] + data["end_to_end"] \
            + data["per_layer"]:
        assert NAME.match(entry["name"]) and entry["name"] not in names
        names.add(entry["name"])
