"""Lower one dry-run cell under variant configurations and print the three
roofline terms of each (port of ``scripts/hillclimb.py`` onto
:mod:`repro_torch.launch.dryrun`)::

    PYTHONPATH=src python -m repro_torch.tools.hillclimb <arch> <shape> \\
        '{"name": "dots", "overrides": {"remat_policy": "dots"}}' ...

A variant is ``{"name": ..., "overrides": {...}}``; any other key passes
through to :func:`repro_torch.launch.dryrun.lower_cell` (``accum``,
``model_axis_residual``, ``fsdp``, ``seq_shard_cache``, ``global_batch``,
``seq_len``, ``extra_tags``). With no variant the cell runs once as
``baseline``. The cell is lowered on the production mesh (``--mesh pod``,
the default, or ``multipod``; ``debug:DxM`` is the (data D, model M)
debug mesh), each variant in a child process of its own that joins a fake
world of the mesh's size (:func:`~repro_torch.launch.dryrun.init_fake_world`),
so the caller's process keeps its default group; the children run at once.

Each variant's row is cached as ``<out>/<arch>__<shape>__<name>.json``
(default ``results/hillclimb``) with its per-op table beside it
(``.ops.json.gz``, which :mod:`repro_torch.tools.reanalyze` re-prices);
a row already there prints ``CACHED`` and is not lowered again. Then one
line a variant: the compute, memory and collective ms, the dominant term,
the roofline fraction, the useful-flop ratio and GiB a rank.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
from typing import Dict, List

_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def world_of(mesh: str) -> int:
    """The ranks of ``mesh`` (``pod``, ``multipod`` or ``debug:DxM``)."""
    from repro_torch.launch import dryrun
    if mesh in dryrun.WORLD:
        return dryrun.WORLD[mesh]
    data, model = _debug_shape(mesh)
    return data * model


def _debug_shape(mesh: str) -> tuple:
    if not mesh.startswith("debug:"):
        raise ValueError(f"mesh {mesh!r}: expected pod, multipod or "
                         f"debug:DxM")
    data, model = (int(v) for v in mesh[len("debug:"):].split("x"))
    return data, model


def build_mesh(mesh: str):
    """The ``DeviceMesh`` of ``mesh`` in the current (fake) world."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    if mesh in dryrun.WORLD:
        return dryrun._mesh_for(mesh)
    return make_debug_mesh(*_debug_shape(mesh),
                           device_type=dryrun.trace_device().type)


def row_path(out: str, arch: str, shape: str, name: str) -> str:
    return os.path.join(out, f"{arch}__{shape}__{name}.json")


def lower_variant(arch: str, shape: str, mesh: str, variant: Dict,
                  out: str) -> Dict:
    """In a fake world of ``mesh``'s size (this process joins it): lower
    the cell under ``variant``, write its row and per-op table under
    ``out``; returns the row."""
    from repro_torch.launch import dryrun
    dryrun.init_fake_world(world_of(mesh))
    kw = {k: v for k, v in variant.items() if k != "name"}
    trace, row = dryrun.lower_cell(arch, shape, build_mesh(mesh), **kw)
    path = row_path(out, arch, shape, variant.get("name", "variant"))
    with gzip.open(path.replace(".json", ".ops.json.gz"), "wt") as f:
        json.dump(trace.ops, f, indent=0)
    d = row.to_dict()
    with open(path, "w") as f:
        json.dump(d, f, indent=1)
    return d


def _child(arch: str, shape: str, mesh: str, variant: Dict,
           out: str) -> subprocess.Popen:
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=_SRC + (os.pathsep + path if path
                                              else ""))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.tools.hillclimb", arch, shape,
         "--mesh", mesh, "--out", out, "--child", json.dumps(variant)],
        env=env)


def line(name: str, d: Dict) -> str:
    """The reference's line for one variant's row."""
    return (f"  [{name:24s}] compute={d['compute_s'] * 1e3:9.2f}ms "
            f"memory={d['memory_s'] * 1e3:9.2f}ms "
            f"coll={d['collective_s'] * 1e3:9.2f}ms dom={d['dominant']:10s} "
            f"frac={d['roofline_fraction']:.4f} "
            f"useful={d['useful_flop_ratio']:.3f} "
            f"GiB/dev={d['bytes_per_device'] / 2 ** 30:.2f}")


def hillclimb(arch: str, shape: str, variants: List[Dict], mesh: str = "pod",
              out: str = "results/hillclimb") -> Dict[str, Dict]:
    """Each variant's row ({name: row}), lowering the uncached ones in
    child processes at once; prints ``CACHED`` / ``LOWER`` and each row's
    line."""
    os.makedirs(out, exist_ok=True)
    names = [v.get("name", "variant") for v in variants]
    if len(set(names)) != len(names):
        raise ValueError(f"variant names must differ: {names}")
    children = []
    for v, name in zip(variants, names):
        if os.path.exists(row_path(out, arch, shape, name)):
            print(f"CACHED {name}", flush=True)
        else:
            print(f"LOWER {arch} x {shape} [{name}] ...", flush=True)
            children.append((name, _child(arch, shape, mesh, v, out)))
    failed = [name for name, c in children if c.wait()]
    if failed:
        raise SystemExit(f"hillclimb: lowering failed for {failed}")
    rows = {}
    for name in names:
        with open(row_path(out, arch, shape, name)) as f:
            rows[name] = json.load(f)
        print(line(name, rows[name]), flush=True)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="lower one dry-run cell under variant configurations")
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("variants", nargs="*",
                    help='JSON, e.g. \'{"name": "dots", "overrides": '
                         '{"remat_policy": "dots"}}\'')
    ap.add_argument("--mesh", default="pod",
                    help="pod (default), multipod or debug:DxM")
    ap.add_argument("--out", default="results/hillclimb")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    # the variants may follow the options (argparse's plain parse stops a
    # positional list at the first option on some Python releases)
    args = ap.parse_intermixed_args(argv)
    world_of(args.mesh)                       # refuse an unknown mesh early
    if args.child:
        lower_variant(args.arch, args.shape, args.mesh,
                      json.loads(args.child), args.out)
        return
    variants = [json.loads(v) for v in args.variants] or [
        {"name": "baseline"}]
    hillclimb(args.arch, args.shape, variants, args.mesh, args.out)


if __name__ == "__main__":
    main()
