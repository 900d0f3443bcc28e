"""The dry run's two scripts: ``python -m repro_torch.tools.hillclimb``
and ``python -m repro_torch.tools.reanalyze`` (ports of
``scripts/hillclimb.py`` and ``scripts/reanalyze.py``).

A tiny cell (minitron-8b cut to 2 layers of d_model 128, a decode step
of 4 sequences over 64 cache slots) on the (data 2, model 2) debug mesh:
the hillclimb's rows against ``lower_cell``'s own (run beside it in a
subprocess of its own fake world), its cache, and the reanalysis of its
rows from their per-op tables, untouched and re-priced.
"""
import copy
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from repro_torch import arch
from repro_torch.tools import hillclimb, reanalyze

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, SHAPE, MESH = "minitron-8b", "decode_32k", "debug:2x2"
TINY = {"n_layers": 2, "d_model": 128}
VARIANTS = [{"name": "two", "overrides": TINY, "global_batch": 4,
             "seq_len": 64},
            {"name": "one", "overrides": {**TINY, "n_layers": 1},
             "global_batch": 4, "seq_len": 64}]

_LOWER = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun
    from repro_torch.tools import hillclimb
    variant = json.loads(sys.argv[1])
    dryrun.init_fake_world(hillclimb.world_of(sys.argv[2]))
    kw = {k: v for k, v in variant.items() if k != "name"}
    _, row = dryrun.lower_cell("%s", "%s", hillclimb.build_mesh(sys.argv[2]),
                               **kw)
    print(json.dumps(row.to_dict()))
""" % (ARCH, SHAPE))


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


@pytest.fixture(scope="module")
def climbed(tmp_path_factory):
    """(rows directory, the hillclimb's stdout, lower_cell's row of the
    first variant), the three processes run at once."""
    out = str(tmp_path_factory.mktemp("hillclimb"))
    cmd = [sys.executable, "-m", "repro_torch.tools.hillclimb", ARCH, SHAPE,
           "--mesh", MESH, "--out", out, *map(json.dumps, VARIANTS)]
    climb = subprocess.Popen(cmd, env=_env(), cwd=ROOT, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    direct = subprocess.Popen([sys.executable, "-c", _LOWER,
                               json.dumps(VARIANTS[0]), MESH], env=_env(),
                              cwd=ROOT, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
    c_out, c_err = climb.communicate(timeout=600)
    d_out, d_err = direct.communicate(timeout=600)
    assert climb.returncode == 0, c_err[-3000:]
    assert direct.returncode == 0, d_err[-3000:]
    return out, c_out, json.loads(d_out.strip().splitlines()[-1])


def _untimed(row):
    row = copy.deepcopy(row)
    row["extra"].pop("trace_s")
    return row


def test_hillclimb_rows_are_lower_cells(climbed):
    out, stdout, direct = climbed
    names = [v["name"] for v in VARIANTS]
    assert [ln.split()[1] for ln in stdout.splitlines()
            if ln.startswith("LOWER")] == [f"{ARCH}"] * 2
    for name in names:
        path = hillclimb.row_path(out, ARCH, SHAPE, name)
        assert os.path.exists(path.replace(".json", ".ops.json.gz"))
        with open(path) as f:
            row = json.load(f)
        assert hillclimb.line(name, row) in stdout
        assert row["mesh"] == "data2xmodel2" and row["chips"] == 4
    with open(hillclimb.row_path(out, ARCH, SHAPE, names[0])) as f:
        assert _untimed(json.load(f)) == _untimed(direct)
    with open(hillclimb.row_path(out, ARCH, SHAPE, names[1])) as f:
        one = json.load(f)
    assert 0 < one["hlo_flops"] < direct["hlo_flops"]


def test_hillclimb_prints_cached_rows(climbed, capsys):
    out, stdout, _ = climbed
    hillclimb.main([ARCH, SHAPE, "--mesh", MESH, "--out", out,
                    *map(json.dumps, VARIANTS)])
    got = capsys.readouterr().out.splitlines()
    assert got[:2] == ["CACHED two", "CACHED one"]
    assert not any(ln.startswith("LOWER") for ln in got)
    assert got[2:] == [ln for ln in stdout.splitlines()
                       if ln.startswith("  [")]


def test_hillclimb_refuses_an_unknown_mesh_and_twin_names(tmp_path):
    with pytest.raises(ValueError, match="debug:DxM"):
        hillclimb.main([ARCH, SHAPE, "--mesh", "tiny"])
    with pytest.raises(ValueError, match="differ"):
        hillclimb.hillclimb(ARCH, SHAPE, [VARIANTS[0], VARIANTS[0]],
                            MESH, str(tmp_path))


def test_reanalyze_reproduces_untouched_rows(climbed, tmp_path, capsys):
    out, _, _ = climbed
    work = str(tmp_path / "rows")
    shutil.copytree(out, work)
    with open(os.path.join(work, "stray.json"), "w") as f:
        json.dump({"no": "table"}, f)            # no table beside: skipped
    reanalyze.main([work])
    printed = capsys.readouterr().out.splitlines()
    assert printed == [f"reanalyzed {ARCH}__{SHAPE}__{n}.json"
                       for n in sorted(v["name"] for v in VARIANTS)]
    for v in VARIANTS:
        name = os.path.basename(hillclimb.row_path(out, ARCH, SHAPE,
                                                   v["name"]))
        with open(os.path.join(out, name)) as f, \
                open(os.path.join(work, name)) as g:
            assert json.load(f) == json.load(g), name


def test_reanalyze_reprices_a_row_whose_machine_changed(climbed, tmp_path):
    out, _, _ = climbed
    work = str(tmp_path / "rows")
    shutil.copytree(out, work)
    path = hillclimb.row_path(work, ARCH, SHAPE, VARIANTS[0]["name"])
    with open(path) as f:
        row = json.load(f)
    stale = dict(row, machine="tpu-like")        # priced on h100 so far
    with open(path, "w") as f:
        json.dump(stale, f)
    reanalyze.reanalyze(work)
    with open(path) as f:
        got = json.load(f)
    tpu = arch.get("tpu-like")
    assert got["machine"] == "tpu-like"
    assert got["compute_s"] == row["hlo_flops"] / tpu.pe.peak_flops
    assert got["memory_s"] == row["hlo_bytes"] / tpu.memory.hbm_bw
    assert got["collective_s"] == row["coll_bytes"] / tpu.memory.ici_bw
    assert got["compute_s"] != row["compute_s"]
    for k in ("hlo_flops", "hlo_bytes", "coll_bytes", "coll_breakdown",
              "extra", "model_flops", "bytes_per_device"):
        assert got[k] == row[k], k
