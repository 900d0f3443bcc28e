"""Render the dry run's roofline tables from its rows (port of
``scripts/make_roofline_table.py`` onto ``repro_torch.launch.dryrun``'s
``<arch>__<shape>__<mesh>.json`` rows), with the card's 80 GB in place of
v5e's 16 GiB in the "fits" column.

    PYTHONPATH=src python -m repro_torch.tools.roofline_table [DIR]
    PYTHONPATH=src python -m repro_torch.tools.roofline_table DIR \\
        --before OLD_DIR

The first form prints the single-pod and multi-pod tables and each
single-pod cell's advice; with ``--before`` it prints the single-pod
cells beside another run's rows of the same cells (``useful_flop_ratio``
and GiB a rank, before and after).
"""
import argparse
import glob
import json
import os

from repro_torch.core.roofline import Roofline, advice

CARD_BYTES = 80 * 10 ** 9             # an H100's 80 GB
POD, MULTIPOD = "data16xmodel16", "pod2xdata16xmodel16"
_FIELDS = ("arch", "shape", "mesh", "chips", "hlo_flops", "hlo_bytes",
           "coll_bytes", "coll_breakdown", "model_flops", "bytes_per_device",
           "extra", "machine")


def rows(d):
    """The dry run's row dicts in ``d`` (``*.json``, in name order)."""
    out = []
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out


def _fits(r) -> str:
    return "yes" if r["bytes_per_device"] <= CARD_BYTES else "**NO**"


def fmt(rs, mesh):
    sel = [r for r in rs if r["mesh"] == mesh]
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "MODEL_FLOPS | useful ratio | roofline frac | GiB/dev | fits 80 GB |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(sel, key=lambda r: (r["arch"], r["shape"])):
        gib = r["bytes_per_device"] / 2 ** 30
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
            f"{r['dominant']} | {r['model_flops']:.3e} | "
            f"{r['useful_flop_ratio']:.3f} | {r['roofline_fraction']:.3f} | "
            f"{gib:.2f} | {_fits(r)} |")
    return "\n".join(lines)


def compare(before, after, mesh):
    """One mesh's cells of ``after`` beside the same cells of ``before``:
    useful-flop ratio and GiB a rank, each before -> after."""
    old = {(r["arch"], r["shape"]): r for r in before if r["mesh"] == mesh}
    lines = ["| arch | shape | useful ratio | GiB/dev | fits 80 GB |",
             "|---|---|---|---|---|"]
    for r in sorted((r for r in after if r["mesh"] == mesh),
                    key=lambda r: (r["arch"], r["shape"])):
        o = old.get((r["arch"], r["shape"]))
        ratio, gib = (f"{r['useful_flop_ratio']:.4f}",
                      f"{r['bytes_per_device'] / 2 ** 30:.2f}")
        fits = _fits(r)
        if o is not None:
            ratio = f"{o['useful_flop_ratio']:.4f} -> {ratio}"
            gib = f"{o['bytes_per_device'] / 2 ** 30:.2f} -> {gib}"
            fits = f"{_fits(o)} -> {fits}"
        lines.append(f"| {r['arch']} | {r['shape']} | {ratio} | {gib} | "
                     f"{fits} |")
    return "\n".join(lines)


def advice_lines(rs, mesh):
    sel = [r for r in rs if r["mesh"] == mesh]
    out = []
    for r in sorted(sel, key=lambda x: (x["arch"], x["shape"])):
        ro = Roofline(**{k: r[k] for k in _FIELDS if k in r})
        out.append(f"* **{r['arch']} × {r['shape']}** — {advice(ro)}")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("dir", nargs="?", default="results/dryrun")
    ap.add_argument("--before", help="another run's rows, set beside")
    args = ap.parse_args(argv)
    rs = rows(args.dir)
    if args.before:
        print(f"### {POD}: {args.before} -> {args.dir}\n")
        print(compare(rows(args.before), rs, POD))
        return
    print("### Single-pod (16×16 = 256 chips) — baseline, every defined "
          "cell\n")
    print(fmt(rs, POD))
    print("\n### Multi-pod (2×16×16 = 512 chips)\n")
    print(fmt(rs, MULTIPOD))
    print("\n### Per-cell bottleneck advice (single-pod)\n")
    print(advice_lines(rs, POD))


if __name__ == "__main__":
    main()
