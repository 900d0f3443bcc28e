"""``repro_torch.tools.roofline_table`` (the port of
``scripts/make_roofline_table.py`` onto the dry run's rows) renders two
synthetic rows: the reference's columns with an 80 GB "fits" column, the
advice lines, and a before / after comparison of the same cells."""
import json

from repro_torch.core.roofline import Roofline
from repro_torch.tools import roofline_table as rt

GIB = 2 ** 30


def _row(arch, shape, flops, peak_gib, mesh=rt.POD):
    return Roofline(arch=arch, shape=shape, mesh=mesh, chips=256,
                    hlo_flops=flops, hlo_bytes=1e12, coll_bytes=1e9,
                    coll_breakdown={"all-gather": 10**9},
                    model_flops=2.56e16, bytes_per_device=peak_gib * GIB,
                    extra={"kind": "train"}, machine="h100").to_dict()


def _write(d, rows):
    d.mkdir()
    for r in rows:
        (d / f"{r['arch']}__{r['shape']}__pod.json").write_text(
            json.dumps(r))


def test_renders_two_rows(tmp_path, capsys):
    before = [_row("hymba-1.5b", "train_4k", 1e15, 86.3),
              _row("minitron-8b", "train_4k", 2e15, 168.0)]
    after = [_row("hymba-1.5b", "train_4k", 2.5e14, 40.0),
             _row("minitron-8b", "train_4k", 2.5e14, 60.0)]
    _write(tmp_path / "old", before)
    _write(tmp_path / "new", after)
    rt.main([str(tmp_path / "new")])
    out = capsys.readouterr().out.splitlines()
    table = [ln for ln in out if ln.startswith("| hymba") or
             ln.startswith("| minitron")]
    assert len(table) == 2
    assert table[0].endswith("| 40.00 | yes |")
    assert "fits 80 GB" in "\n".join(out)
    useful = 2.56e16 / (256 * 2.5e14)
    assert f"| {useful:.3f} |" in table[0]
    assert sum(ln.startswith("* **") for ln in out) == 2
    rt.main([str(tmp_path / "new"), "--before", str(tmp_path / "old")])
    out = capsys.readouterr().out.splitlines()
    rows = [ln for ln in out if ln.startswith("| hymba") or
            ln.startswith("| minitron")]
    assert rows[1] == ("| minitron-8b | train_4k | 0.0500 -> 0.4000 | "
                       "168.00 -> 60.00 | **NO** -> yes |")
