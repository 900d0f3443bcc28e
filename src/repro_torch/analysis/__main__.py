"""Static analysis of the repro_torch.linalg surface, as a gate.

Sweeps every public (arg-synthesizable) ``repro_torch.linalg`` routine
over the acceptance grid - policies x dtypes x {no mesh, SURFACE_MESHES}
plus the direct ``pdgemm`` / ``pdtrsm`` entry points and the BY001
dispatcher-bypass lint - and exits 1 on any unsuppressed ``error``
finding or any skipped case. Warnings print but do not fail. The no-mesh
legs are fake traces (no card needed: ``--device cuda``, the default,
traces the card route on fake CUDA tensors; ``--device cpu`` the plain
route); the mesh legs run for real on as many spawned gloo ranks as the
largest mesh has (on the card when there is one, else on the CPU).

Usage:
    python -m repro_torch.analysis
    python -m repro_torch.analysis --device cpu --workers 4
    python -m repro_torch.analysis --routines gemm,qr --no-mesh
    python -m repro_torch.analysis --spmd-only
    python -m repro_torch.analysis --write-bypass-allowlist PATH
"""
import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--routines", metavar="A,B,...",
                    help="comma-separated subset (default: every "
                         "checkable linalg.__all__ routine)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the no-mesh legs' trace device (default cuda: "
                         "the card route, fake tensors, no card needed)")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes for the no-mesh legs")
    ap.add_argument("--allowlist", metavar="PATH",
                    help="JSON allowlist of suppressed findings (default: "
                         "the committed repro_torch/analysis/allowlist.json)")
    ap.add_argument("--out", metavar="PATH",
                    help="also save the merged AnalysisReport as JSON")
    ap.add_argument("--no-mesh", action="store_true",
                    help="skip the mesh and direct distributed legs")
    ap.add_argument("--spmd-only", action="store_true",
                    help="run only the mesh and direct distributed legs")
    ap.add_argument("--no-bypass", action="store_true",
                    help="skip the BY001 dispatcher-bypass lint")
    ap.add_argument("--write-bypass-allowlist", metavar="PATH",
                    help="regenerate the BY001 burn-down allowlist from "
                         "the current bypass set and exit")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print every routine as it is checked")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.analysis import bypass_lint, report, sweep

    if args.write_bypass_allowlist:
        sites, _ = bypass_lint.collect_bypass_sites(
            progress=(print if args.verbose else None))
        path = bypass_lint.save_bypass_allowlist(
            sites, args.write_bypass_allowlist)
        print(f"wrote {len(sites)} BY001 site(s) to {path}")
        return 0

    t0 = time.perf_counter()
    routines = args.routines.split(",") if args.routines else None
    allowlist = args.allowlist or sweep.DEFAULT_ALLOWLIST_PATH
    reports = []
    if not args.spmd_only:
        reports.append(sweep.base_legs(
            routines, device=args.device, workers=args.workers,
            allowlist_path=allowlist,
            progress=(lambda n: print(f"  {n}", flush=True))
            if args.verbose else None))
    if not args.no_mesh:
        reports.append(sweep.mesh_legs(
            routines, device="cuda" if torch.cuda.is_available() else "cpu",
            allowlist_path=allowlist))
    if not (args.no_bypass or args.spmd_only):
        reports.append(bypass_lint.lint_bypass())
    rep = report.merge_reports(reports, target="linalg-surface")
    print(rep.summary())
    skipped = [c for c in rep.cases if "skipped" in c]
    print(f"{len(rep.cases)} case(s) ({len(skipped)} skipped) in "
          f"{time.perf_counter() - t0:.1f} s")
    if args.out:
        rep.save(args.out)
    return 0 if rep.ok and not skipped else 1


if __name__ == "__main__":
    sys.exit(main())
