"""The port's five examples (``examples/torch/``) against the reference's
(``examples/``), each run as a script on the CPU at a small size.

Each pair runs at the same size, the port's with ``--device cpu``; all
ten processes start at once (the module's fixture). What is compared:
the exact integers each prints (the PE simulation's CPI / TPI lines, the
eq.-7 depths, the plans' tiles and panel widths, the machine table,
the served requests' lengths, the model's parameters and steps), and each
residual within the float32 tolerance of ``tests/conftest.py`` of the
reference's. The port's examples run on the card by default (on a host
without one they raise); ``chip_smoke.py`` runs ``quickstart`` and
``factorization_demo`` there at their default sizes.
"""
import concurrent.futures
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from conftest import dtype_tolerances

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> the arguments both sides take (small sizes)
RUNS = {
    "quickstart": [],
    "factorization_demo": ["24"],
    "codesign_sweep": ["8"],
    "serve_lm": ["--max-new", "4"],
    "train_lm": ["--steps", "12", "--batch", "2", "--seq", "32"],
}
_NUM = r"[-+]?\d+\.\d+(?:e[-+]\d+)?"


def _run(side, name, args, tmp):
    script = os.path.join(ROOT, "examples", *(("torch",) if side == "port"
                                              else ()), name + ".py")
    argv = list(args)
    if name == "train_lm":
        argv += ["--ckpt-dir", os.path.join(tmp, side + "_ckpt")]
    if side == "port":
        argv += ["--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script, *argv], cwd=tmp, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, (side, name, r.stderr[-3000:])
    return r.stdout


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """{(side, name): stdout} of all ten runs, made at once."""
    tmp = str(tmp_path_factory.mktemp("examples"))
    jobs = [(side, name) for name in RUNS for side in ("reference", "port")]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {job: pool.submit(_run, *job, RUNS[job[1]], tmp)
                   for job in jobs}
        return {job: f.result() for job, f in futures.items()}


def _lines(text):
    """The output's lines, the port's device tags taken out."""
    return [re.sub(r", cpu(?=\))| \(cpu\)$", "", ln)
            for ln in text.splitlines()]


def _residuals(text, pattern):
    """Every number ``pattern``'s groups catch in ``text``, in order."""
    found = re.findall(pattern, text)
    return [float(v) for m in found
            for v in (m if isinstance(m, tuple) else (m,))]


def _close(port, ref):
    assert len(port) == len(ref) > 0, (port, ref)
    rtol, atol = dtype_tolerances("float32")
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)


def test_each_example_mirrors_the_reference():
    names = {f[:-3] for f in os.listdir(os.path.join(ROOT, "examples"))
             if f.endswith(".py")}
    assert names == set(RUNS)
    for name in names:
        with open(os.path.join(ROOT, "examples", "torch", name + ".py")) as f:
            src = f.read()
        assert not re.search(r"(import|from)\s+(jax|repro)(\.|\s|$)", src)
        assert "repro_torch" in src


def test_quickstart(outputs):
    port = _lines(outputs["port", "quickstart"])
    ref = _lines(outputs["reference", "quickstart"])
    # steps 1-3: the census, eq. 7 and every PE simulation line
    cut = next(i for i, ln in enumerate(ref) if ln.startswith("4)"))
    assert port[:cut] == ref[:cut]
    # step 4: U* and the plan's integers (the CPU's machine is tpu-like)
    ints = lambda ls, i: re.findall(r"\d+", ls[i].split("(")[-1]
                                    if "blocks" in ls[i] else ls[i])
    for i in (cut + 1, cut + 2):
        assert ints(port, i) == ints(ref, i), (port[i], ref[i])
    assert port[cut] == "4) tpu-like adaptation: eq. 3 -> accumulator " \
                        "count / GEMM tiling"
    # step 5: the dot product and the gemm's error against their oracles
    text = [outputs[s, "quickstart"] for s in ("port", "reference")]
    dots = [_residuals(t, rf"dotp kernel: ({_NUM}) vs oracle ({_NUM})")
            for t in text]
    _close(*dots)
    _close(*[_residuals(t, rf"max err vs oracle: ({_NUM})") for t in text])
    assert port[-1] == ref[-1] == "OK"


def test_factorization_demo(outputs):
    text = {s: outputs[s, "factorization_demo"]
            for s in ("port", "reference")}
    res = {s: _residuals(t, rf"= ({_NUM})") for s, t in text.items()}
    assert len(res["port"]) == 7
    _close(res["port"], res["reference"])
    plan = {s: re.search(r"NB=(\d+), panel_fraction=(\S+)", t).groups()
            for s, t in text.items()}
    assert plan["port"] == plan["reference"]
    # the census: fx_census's counts differ from jaxpr_census's by design
    # (tests/test_torch_census.py); the port prints one for each class
    census = re.findall(r"^\s+(\w+): N_I=", text["port"], re.M)
    assert census and set(census) <= {"mul", "add", "div", "sqrt", "exp"}
    assert "census[dgeqrf]:" in text["port"]


def test_codesign_sweep(outputs):
    assert _lines(outputs["port", "codesign_sweep"]) == \
        _lines(outputs["reference", "codesign_sweep"])


def test_serve_lm(outputs):
    port, ref = (outputs[s, "serve_lm"].splitlines()
                 for s in ("port", "reference"))
    assert [ln for ln in port if ln.startswith("req")] == \
        [ln for ln in ref if ln.startswith("req")] != []
    steps = [re.search(r"'steps': (\d+)", t[-1]).group(1) for t in (port, ref)]
    assert steps[0] == steps[1]


def test_train_lm(outputs):
    port, ref = (outputs[s, "train_lm"].splitlines()
                 for s in ("port", "reference"))
    assert port[0] == ref[0]                      # the model and its size
    over = [re.search(r"over (\d+) steps", t[-2]).group(1)
            for t in (port, ref)]
    assert over == [RUNS["train_lm"][1]] * 2
    assert port[-1] == ref[-1] == "OK"            # the loss went down
