"""repro_torch.obs's exporters: round trips, the summary, and the
reference's validator.

A traced port QR (CPU) is written in both formats, read back, and checked
by ``scripts/trace_report.py --validate`` (the reference's schema gate,
in a subprocess), which must report no problem. The schema constants
equal the reference's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro import obs as jobs
from repro_torch import linalg as tl
from repro_torch import obs as tobs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def traced():
    """A trace of one blocked QR (3 panels) and one gemm on the CPU."""
    a = np.random.default_rng(0).normal(size=(40, 24)).astype(np.float32)
    with tobs.trace("port-qr") as tr, tl.use(device="cpu", policy="model"):
        tl.qr(a, block=8)
        tl.gemm(a.T, a)
        tobs.event("marker", cat="instant", note="after")
    return tr


def test_schema_is_the_reference_s():
    assert tobs.SCHEMA_VERSION == jobs.SCHEMA_VERSION
    assert tobs.EVENT_FIELDS == jobs.EVENT_FIELDS


def test_chrome_and_jsonl_round_trip(traced, tmp_path):
    chrome = tobs.save_chrome_trace(traced, str(tmp_path / "t.json"))
    lines = tobs.save_jsonl(traced, str(tmp_path / "t.jsonl"))
    with open(chrome) as f:
        blob = json.load(f)
    assert blob == json.loads(json.dumps(tobs.to_chrome_trace(traced)))
    assert blob["otherData"]["schema_version"] == tobs.SCHEMA_VERSION
    assert blob["otherData"]["trace_name"] == "port-qr"
    events = blob["traceEvents"]
    assert len(events) == len(traced.events)
    ts = [e["ts"] for e in events]
    assert ts == sorted(ts)
    assert {e["ph"] for e in events} == {"X", "i"}
    by_id = {e.id: e for e in traced.events}
    for e in events:
        span = by_id[e["args"]["id"]]
        assert (e["name"], e["cat"], e["args"]["parent"]) == (
            span.name, span.cat, span.parent)
    with open(lines) as f:
        recs = [json.loads(line) for line in f]
    assert recs[0] == {"kind": "header", "schema_version":
                       tobs.SCHEMA_VERSION, "trace_name": "port-qr"}
    assert recs[-1] == {"kind": "counters", "counters": traced.counters}
    body = recs[1:-1]
    assert all(r.pop("kind") == "event" for r in body)
    assert all(tuple(r) == tobs.EVENT_FIELDS for r in body)
    assert sorted(r["id"] for r in body) == sorted(by_id)
    assert [r["name"] for r in body if r["parent"] is None] == [
        "linalg.qr", "linalg.gemm", "marker"]
    qr_id = next(r["id"] for r in body if r["name"] == "linalg.qr")
    assert sum(r["name"] == "geqrf.panel" and r["parent"] == qr_id
               for r in body) == 3


def test_summary_names_the_routines(traced):
    text = tobs.summary(traced)
    assert text.startswith(f"trace 'port-qr': {len(traced.events)} events "
                           f"(schema v{tobs.SCHEMA_VERSION})")
    for name in ("linalg.qr", "linalg.gemm", "geqrf.panel",
                 "geqrf.trailing", "marker"):
        assert name in text


def test_reference_validator_accepts_port_traces(traced, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    for path in (tobs.save_chrome_trace(traced, str(tmp_path / "t.json")),
                 tobs.save_jsonl(traced, str(tmp_path / "t.jsonl"))):
        r = subprocess.run([sys.executable, "scripts/trace_report.py", path,
                            "--validate"], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, f"{path}\n{r.stdout}\n{r.stderr}"
        assert r.stdout.startswith("trace OK"), r.stdout
