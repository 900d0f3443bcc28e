"""The surface sweep across processes: the no-mesh legs in a pool of worker
processes (one routine at a time), the mesh legs and the direct
distributed entry points on spawned gloo ranks (SPMD), and the merge.

``python -m repro_torch.analysis`` runs them; the no-mesh legs are fake
traces, CPU-bound, so ``workers`` processes take about ``1 / workers`` of
one process's time. Each spawned process pins one intra-op thread (a
pool's through its initializer); the calling process keeps its own count.
"""
from __future__ import annotations

import os
import pickle
import tempfile
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.analysis import report as _report
from repro_torch.analysis.rules import load_allowlist

DEFAULT_ALLOWLIST_PATH = os.path.join(os.path.dirname(__file__),
                                      "allowlist.json")


def _base_worker(routine: str, policies, dtypes, device: str,
                 allowlist_path: Optional[str]):
    from repro_torch import linalg
    with linalg.use(device=device):
        return _report.check_surface(
            routines=[routine], policies=policies, dtypes=dtypes,
            meshes=(), allowlist=load_allowlist(allowlist_path),
            distributed=False)


def submit_base_legs(pool, routines: Optional[Sequence[str]] = None,
                     device: str = "cuda",
                     allowlist_path: Optional[str] = DEFAULT_ALLOWLIST_PATH
                     ) -> List:
    """Submit the no-mesh legs of the surface grid to ``pool`` (an
    executor, best with one intra-op thread a worker), one task per
    (routine, dtype); returns the futures in the grid's order."""
    names = list(routines) if routines is not None \
        else _report.surface_routines()
    return [pool.submit(_base_worker, name, _report.SURFACE_POLICIES,
                        (dtype,), device, allowlist_path)
            for name in names for dtype in _report.SURFACE_DTYPES]


def base_legs(routines: Optional[Sequence[str]] = None,
              device: str = "cuda", workers: int = 1,
              allowlist_path: Optional[str] = DEFAULT_ALLOWLIST_PATH,
              progress: Optional[Callable] = None
              ) -> _report.AnalysisReport:
    """The no-mesh legs of the surface grid on ``device`` (``"cuda"``: the
    card route on fake CUDA tensors, no card needed), one (routine, dtype)
    per task over ``workers`` spawned processes (1: in this process);
    cases in the grid's order."""
    names = list(routines) if routines is not None \
        else _report.surface_routines()
    if workers <= 1:
        reports = []
        for name in names:
            if progress is not None:
                progress(name)
            reports.append(_base_worker(name, _report.SURFACE_POLICIES,
                                        _report.SURFACE_DTYPES, device,
                                        allowlist_path))
    else:
        import concurrent.futures as cf
        import multiprocessing as mp
        with cf.ProcessPoolExecutor(
                workers, mp_context=mp.get_context("spawn"),
                initializer=torch.set_num_threads, initargs=(1,)) as pool:
            futures = submit_base_legs(pool, names, device, allowlist_path)
            reports = [f.result() for f in futures]
    return _report.merge_reports(reports, target="linalg-surface")


def _rank_main(rank: int, world: int, directory: str, kw: dict) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{directory}/rdv",
                            rank=rank, world_size=world)
    try:
        from repro_torch import linalg
        with linalg.use(device=kw.pop("device")):
            rep = _report.check_surface(
                allowlist=load_allowlist(kw.pop("allowlist_path")), **kw)
        if rank == 0:
            with open(os.path.join(directory, "report.pkl"), "wb") as f:
                pickle.dump(rep, f)
    finally:
        dist.barrier()
        dist.destroy_process_group()


def mesh_legs(routines: Optional[Sequence[str]] = None,
              device: str = "cpu",
              allowlist_path: Optional[str] = DEFAULT_ALLOWLIST_PATH,
              timeout_s: float = 1800.0) -> _report.AnalysisReport:
    """The mesh legs of the surface grid (and, for the whole surface, the
    direct ``pdgemm`` / ``pdtrsm`` entries) on as many spawned gloo
    processes as the largest of :data:`~repro_torch.analysis.report.
    SURFACE_MESHES` has ranks, every one calling
    :func:`~repro_torch.analysis.check_surface` with ``base_leg=False`` on
    ``device``; rank 0's report. Raises if a rank fails or the ranks
    outlast ``timeout_s``; every process is stopped."""
    import multiprocessing as mp
    ranks = max(px * py for px, py in _report.SURFACE_MESHES)
    kw = {"routines": None if routines is None else list(routines),
          "meshes": _report.SURFACE_MESHES, "base_leg": False,
          "distributed": routines is None, "device": device,
          "allowlist_path": allowlist_path}
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank_main, args=(r, ranks, d, dict(kw)))
                 for r in range(ranks)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"analysis mesh ranks failed: {bad}")
        with open(os.path.join(d, "report.pkl"), "rb") as f:
            return pickle.load(f)
