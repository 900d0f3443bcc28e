"""Re-derive dry-run rows from their saved per-op tables, without tracing
again (port of ``scripts/reanalyze.py``, which re-reads saved HLO)::

    PYTHONPATH=src python -m repro_torch.tools.reanalyze [DIR]

For each ``*.json`` row in ``DIR`` (default ``results/dryrun``) that has
its ``.ops.json.gz`` beside it (written by ``python -m
repro_torch.launch.dryrun`` and :mod:`repro_torch.tools.hillclimb`), the
table's counts (:func:`repro_torch.core.aten_cost.cost_of_table`) give
``hlo_flops``, ``hlo_bytes`` (the fused-traffic model), the collective
bytes by kind and ``extra["bytes_unfused"]``, and
:class:`repro_torch.core.roofline.Roofline` prices them on the row's
machine as registered now: the three terms, the dominant one, the
useful-flop ratio, the roofline fraction, the step time. The row is
written back. An untouched row comes back as it was; a row whose
machine's prices changed comes back re-priced.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import sys
from typing import Dict

from repro_torch.core import aten_cost
from repro_torch.core import roofline as rl

# the row's fields the counts do not change
_KEPT = ("arch", "shape", "mesh", "chips", "model_flops", "bytes_per_device",
         "extra", "machine")


def reanalyze_row(row: Dict, ops: Dict) -> Dict:
    """``row`` re-derived from its per-op table ``ops``."""
    cost = aten_cost.cost_of_table(ops)
    kept = {k: row[k] for k in _KEPT}
    r = rl.from_trace(kept["arch"], kept["shape"], kept["mesh"],
                      kept["chips"], cost, kept["model_flops"],
                      kept["bytes_per_device"], extra=kept["extra"],
                      machine=kept["machine"])
    return {**row, **r.to_dict()}


def reanalyze(d: str) -> list:
    """Re-derive every row of ``d`` that has its per-op table; returns the
    paths written."""
    done = []
    for jpath in sorted(glob.glob(os.path.join(d, "*.json"))):
        opath = jpath[:-len(".json")] + ".ops.json.gz"
        if not os.path.exists(opath):
            continue
        with open(jpath) as f:
            row = json.load(f)
        with gzip.open(opath, "rt") as f:
            ops = json.load(f)
        with open(jpath, "w") as f:
            json.dump(reanalyze_row(row, ops), f, indent=1)
        print(f"reanalyzed {os.path.basename(jpath)}")
        done.append(jpath)
    return done


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    reanalyze(argv[0] if argv else "results/dryrun")


if __name__ == "__main__":
    main()
