"""Measured config sweeps, seeded by the analytical model - not brute force.

Port of ``repro.tune.search``. Candidate generation asks
:mod:`repro_torch.core.codesign` for the model's own pick plus its
feasible neighbours and ranks them with the repo's two models
(:func:`model_score`): the roofline (a candidate's rate is
``min(PEAK, arithmetic_intensity * HBM_BW)`` at its tiling) and, under the
reference's machines, the paper's eq. 2 pricing the grid pipeline's
per-step overhead. Only the ``top_k`` model-ranked candidates are measured
(:func:`repro_torch.tune.measure.measure`, each rep synchronised on the
card), and the measured winner is recorded in the registry; dispatch then
launches it. Model proposes, measurement disposes.

Under a GPU spec (``"h100"``, the machine of CUDA tensors) the candidates
are the compiled CTA tiles of the dtype's tiled variant
(:data:`repro_torch.core.codesign.HOPPER_TILES`) that fit the shared
memory, seeded by the model's pick, and a candidate's modeled time also
pays for the wave it leaves part-empty; B1 launches each candidate's own
tile, and the registry's winner is the tile ``linalg.gemm`` then launches
under ``policy="tuned"``. The sweeps run on the card unless ``device="cpu"``
asks for the CPU (where the kernels' plain versions run). The backend
component of every recorded key is the device type.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import _dtype
from repro_torch import arch as _arch
from repro_torch.arch import MachineSpec
from repro_torch.core import codesign as _cd
from repro_torch.core import pipeline_model
from repro_torch.core.codesign import (GemmPlan, plan_from_blocks,
                                       plan_fused_chain, plan_gemm, plan_trsm)
from repro_torch.tune import measure as _measure
from repro_torch.tune.registry import KernelConfig, Registry, default_registry

# machine resolution + registry-key component (recording here and lookup in
# dispatch must agree on the namespace rule)
_mach = _arch.resolve_machine
_mach_key = _arch.machine_key_component


def _block_grid(mach: MachineSpec) -> Tuple[int, ...]:
    """Sweep neighbourhood: 1x / 2x / 4x the machine's matrix-unit edge."""
    return (mach.pe.mxu, 2 * mach.pe.mxu, 4 * mach.pe.mxu)


def model_score(plan: GemmPlan, m: int, n: int, k: int,
                dtype_bytes: int,
                machine: Optional[MachineSpec] = None) -> float:
    """Modeled seconds for one GEMM at this tiling (lower is better).

    Under a GPU spec: the roofline time over the share of the last wave's
    SMs the grid fills (one CTA per SM at a time). Else the reference's:
    the roofline time against the grid pipeline through eq. 2 (steps are
    instructions, the K-carried accumulator dependence the hazard, DMA
    time the logic delay, the per-step fill the latch overhead; depth 2 =
    double buffering)."""
    mach = _mach(machine)
    flops = 2.0 * m * n * k
    roofline_rate = min(mach.pe.peak_flops,
                        plan.arithmetic_intensity * mach.memory.hbm_bw)
    compute_s = flops / roofline_rate
    g0, g1, g2 = plan.grid
    if _cd.is_gpu(mach):
        ctas, sms = g0 * g1, mach.pe.sm_count
        filled = ctas / (-(-ctas // sms) * sms)
        return compute_s / filled
    steps = max(g0 * g1 * g2, 1)
    hazards = g0 * g1 * max(g2 - 1, 0)
    t_dma = (plan.bm * plan.bk + plan.bk * plan.bn) * dtype_bytes \
        / mach.memory.hbm_bw
    per_step = float(pipeline_model.tpi(
        2.0, n_i=float(steps), n_h=float(hazards), gamma=0.5, t_p=t_dma,
        t_o=mach.memory.pipeline_fill_s))
    return max(compute_s, per_step * steps)


def gemm_candidates(m: int, n: int, k: int, dtype_bytes: int = 4,
                    max_candidates: int = 8,
                    vmem_budget: Optional[int] = None,
                    machine: Optional[MachineSpec] = None) -> List[GemmPlan]:
    """Model pick first, then its scratch-feasible neighbours, ranked by
    :func:`model_score`. Never empty; the model's pick always survives the
    cut. Under a GPU spec the neighbours are the variant's other compiled
    tiles."""
    mach = _mach(machine)
    vmem_budget = mach.memory.vmem_bytes if vmem_budget is None \
        else vmem_budget
    seed = plan_gemm(m, n, k, dtype_bytes=dtype_bytes, machine=mach)
    seen = {(seed.bm, seed.bn, seed.bk)}
    cands = [seed]
    if _cd.is_gpu(mach):
        blocks = [t[:3] for t in _cd.hopper_tiles(dtype_bytes)]
    else:
        grid = _block_grid(mach)
        blocks = [(bm, bn, bk) for bm in grid for bn in grid for bk in grid]
    for bm, bn, bk in blocks:
        p = plan_from_blocks(m, n, k, bm, bn, bk, dtype_bytes=dtype_bytes,
                             machine=mach)
        key = (p.bm, p.bn, p.bk)
        if key in seen or p.vmem_bytes > vmem_budget:
            continue
        seen.add(key)
        cands.append(p)
    ranked = sorted(cands, key=lambda p: model_score(p, m, n, k, dtype_bytes,
                                                     machine=mach))
    top = ranked[:max_candidates]
    if seed not in top:
        top[-1] = seed
    return top


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Trajectory record of one tuned op: every measured candidate plus the
    winner that went into the registry."""

    op: str
    shape: Tuple[int, ...]
    dtype: str
    backend: str
    measured: Tuple[dict, ...]          # [{params..., seconds}] model order
    best: KernelConfig
    model_params: dict                  # what the model alone would pick

    def to_json(self) -> dict:
        return {"op": self.op, "shape": list(self.shape), "dtype": self.dtype,
                "backend": self.backend, "measured": list(self.measured),
                "best": self.best.to_json(), "model_params": self.model_params}


measure_wall_time = _measure.measure_wall_time


def _device(device) -> torch.device:
    """The sweep's device: ``cuda`` unless the caller asks for the CPU; a
    CUDA device with no card raises (a sweep never carries on on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the sweeps run on 'cuda' by default and no CUDA "
                           "device is available; pass device='cpu' to run "
                           "the kernels' plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def _normal(rng: np.random.Generator, shape, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """Standard normal float32 draws from ``rng``, cast to ``dtype`` on
    ``device`` (the reference's inputs, bit for bit before the cast)."""
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return x.to(device=device, dtype=dtype)


def tune_gemm(m: int, n: int, k: int, dtype=torch.float32,
              registry: Optional[Registry] = None, top_k: int = 3,
              reps: int = 2, seed: int = 0,
              machine: Optional[MachineSpec] = None,
              device="cuda") -> SweepResult:
    """Sweep B1's tiles for one (m, n, k, dtype); record the measured winner
    in the registry keyed by the shape bucket, the device type and (for a
    machine other than the device's own) the machine. Each measured row
    names the variant and tile B1 launched."""
    from repro_torch.kernels import gemm as _gk     # lazy: import cycle
    dev = _device(device)
    mach = _mach(machine, dev)
    reg = registry if registry is not None else default_registry()
    dtype = _dtype.to_torch(dtype)
    db = _dtype.itemsize(dtype)
    model_pick = plan_gemm(m, n, k, dtype_bytes=db, machine=mach)
    cands = gemm_candidates(m, n, k, dtype_bytes=db,
                            max_candidates=max(top_k, 1), machine=mach)
    rng = np.random.default_rng(seed)
    a = _normal(rng, (m, k), dtype, dev)
    b = _normal(rng, (k, n), dtype, dev)
    measured = []
    best_i, best_t = 0, None
    for i, plan in enumerate(cands):
        ms = _measure.measure(lambda x, y, p=plan: _gk.gemm(x, y, plan=p),
                              a, b, min_reps=reps, max_reps=2 * reps)
        launch = _gk.gemm.last_launch
        t = ms.seconds_median
        model_s = model_score(plan, m, n, k, db, machine=mach)
        measured.append({"bm": plan.bm, "bn": plan.bn, "bk": plan.bk,
                         "variant": launch["variant"], "tile": launch["tile"],
                         "tile_source": launch["tile_source"],
                         "seconds": t, **ms.row_fields(),
                         "model_s": model_s,
                         "model_residual": _measure.model_residual(model_s, t)})
        if best_t is None or t < best_t:
            best_i, best_t = i, t
    win = cands[best_i]
    cfg = reg.record("gemm", (m, n, k), dtype, dev.type,
                     {"bm": win.bm, "bn": win.bn, "bk": win.bk},
                     source="sweep", measured_s=best_t,
                     machine=_mach_key(mach, dev))
    return SweepResult("gemm", (m, n, k), _dtype.name(dtype), dev.type,
                       tuple(measured), cfg,
                       {"bm": model_pick.bm, "bn": model_pick.bn,
                        "bk": model_pick.bk})


def tune_fused_gemm(m: int, n: int, k: int, epilogue: str = "relu",
                    dtype=torch.float32, has_bias: bool = True,
                    registry: Optional[Registry] = None, reps: int = 2,
                    seed: int = 0, machine: Optional[MachineSpec] = None,
                    device="cuda") -> SweepResult:
    """Measure B3 (GEMM + epilogue in one launch) against the staged chain
    (B1, then the epilogue as a separate pass) at the chain plan's tiling,
    and record the winner under ``gemm+epilogue`` with a ``fused`` flag
    (0/1) that dispatch honours under ``policy="tuned"``. The chain
    model's ``fused_wins`` verdict is reported as ``model_params``."""
    from repro_torch.kernels import fused as _fk    # lazy: import cycle
    from repro_torch.kernels import gemm as _gk
    dev = _device(device)
    mach = _mach(machine, dev)
    reg = registry if registry is not None else default_registry()
    dtype = _dtype.to_torch(dtype)
    db = _dtype.itemsize(dtype)
    chain = plan_fused_chain("gemm+epilogue", m, n, k, dtype_bytes=db,
                             epilogue=epilogue, has_bias=has_bias,
                             machine=mach)
    plan = chain.gemm
    rng = np.random.default_rng(seed)
    a = _normal(rng, (m, k), dtype, dev)
    b = _normal(rng, (k, n), dtype, dev)
    bias = _normal(rng, (n,), dtype, dev) if has_bias else None

    def staged(x, y, bb):
        return _fk.apply_epilogue(_gk.gemm(x, y, plan=plan), epilogue, bb)

    def fused_fn(x, y, bb):
        return _fk.gemm_bias_act(x, y, bias=bb, epilogue=epilogue, plan=plan)

    measured = []
    best_i, best_t = 0, None
    for i, (name, fn) in enumerate((("staged", staged), ("fused", fused_fn))):
        ms = _measure.measure(fn, a, b, bias, min_reps=reps,
                              max_reps=2 * reps)
        t = ms.seconds_median
        measured.append({"variant": name, "fused": int(name == "fused"),
                         "bm": plan.bm, "bn": plan.bn, "bk": plan.bk,
                         "seconds": t, **ms.row_fields(),
                         "model_s": (chain.fused_time if name == "fused"
                                     else chain.unfused_time)})
        if best_t is None or t < best_t:
            best_i, best_t = i, t
    fused_won = int(measured[best_i]["fused"])
    cfg = reg.record("gemm+epilogue", (m, n, k), dtype, dev.type,
                     {"bm": plan.bm, "bn": plan.bn, "bk": plan.bk,
                      "fused": fused_won},
                     source="sweep", measured_s=best_t,
                     machine=_mach_key(mach, dev))
    return SweepResult("gemm+epilogue", (m, n, k), _dtype.name(dtype),
                       dev.type, tuple(measured), cfg,
                       {"bm": plan.bm, "bn": plan.bn, "bk": plan.bk,
                        "fused": int(chain.fused_wins)})


def seed_registry_from_model(registry: Optional[Registry] = None,
                             gemm_shapes: Sequence[Tuple[int, int, int]] = (),
                             trsm_shapes: Sequence[Tuple[int, int]] = (),
                             dtypes: Sequence = (torch.float32,),
                             backend: Optional[str] = None,
                             machine: Optional[MachineSpec] = None) -> int:
    """Record the model's pick for every (op, shape, dtype) as a registry
    entry (``source="model"``, unmeasured), under ``backend`` (default
    ``"cuda"``) priced for ``machine`` (default: that device's machine).
    A later measured sweep overwrites the entry in place. Returns the
    number of entries recorded."""
    backend = backend or "cuda"
    mach = _mach(machine, backend)
    mkey = _mach_key(mach, backend)
    reg = registry if registry is not None else default_registry()
    count = 0
    for dtype in dtypes:
        dt = _dtype.to_torch(dtype)
        db = _dtype.itemsize(dt)
        for m, n, k in gemm_shapes:
            p = plan_gemm(m, n, k, dtype_bytes=db, machine=mach)
            reg.record("gemm", (m, n, k), dt, backend,
                       {"bm": p.bm, "bn": p.bn, "bk": p.bk}, source="model",
                       machine=mkey)
            count += 1
        for n, nrhs in trsm_shapes:
            p = plan_trsm(n, nrhs, dtype_bytes=db, machine=mach)
            reg.record("trsm", (n, nrhs), dt, backend,
                       {"block": p.block}, source="model", machine=mkey)
            count += 1
    return count


def trsm_candidates(n: int, nrhs: int, dtype_bytes: int = 4,
                    blocks: Sequence[int] = (16, 32, 64, 128),
                    machine: Optional[MachineSpec] = None) -> List[int]:
    """Model pick first, then the remaining distinct feasible widths."""
    seedb = plan_trsm(n, nrhs, dtype_bytes=dtype_bytes,
                      machine=machine).block
    out = [seedb]
    for b in blocks:
        b_ = min(int(b), max(int(n), 1))
        if b_ not in out:
            out.append(b_)
    return out


def tune_trsm(n: int, nrhs: int = 8, dtype=torch.float32,
              registry: Optional[Registry] = None, reps: int = 2,
              blocks: Sequence[int] = (16, 32, 64, 128),
              seed: int = 0, machine: Optional[MachineSpec] = None,
              device="cuda") -> SweepResult:
    """Sweep the blocked-TRSM diagonal width; record the measured winner.
    Measured on the reference inner-GEMM path, as the reference does (the
    trade-off - serial substitution against the off-diagonal update - is
    the same on both paths)."""
    from repro_torch.blas import level3             # lazy: import cycle
    dev = _device(device)
    mach = _mach(machine, dev)
    reg = registry if registry is not None else default_registry()
    dtype = _dtype.to_torch(dtype)
    db = _dtype.itemsize(dtype)
    rng = np.random.default_rng(seed)
    t_np = np.tril(rng.normal(size=(n, n))).astype(np.float32) \
        + 4.0 * np.eye(n, dtype=np.float32)
    t = torch.from_numpy(t_np).to(device=dev, dtype=dtype)
    b = _normal(rng, (n, nrhs), dtype, dev)
    cands = trsm_candidates(n, nrhs, dtype_bytes=db, blocks=blocks,
                            machine=mach)
    measured = []
    best_i, best_t = 0, None
    for i, blk in enumerate(cands):
        ms = _measure.measure(lambda tt, bb, nb=blk: level3.trsm(
            tt, bb, lower=True, block=nb, policy="reference"), t, b,
            min_reps=reps, max_reps=2 * reps)
        sec = ms.seconds_median
        model_s = plan_trsm(n, nrhs, dtype_bytes=db, candidates=(blk,),
                            machine=mach).modeled_time
        measured.append({"block": blk, "seconds": sec, **ms.row_fields(),
                         "model_s": model_s,
                         "model_residual": _measure.model_residual(model_s,
                                                                   sec)})
        if best_t is None or sec < best_t:
            best_i, best_t = i, sec
    cfg = reg.record("trsm", (n, nrhs), dtype, dev.type,
                     {"block": cands[best_i]}, source="sweep",
                     measured_s=best_t, machine=_mach_key(mach, dev))
    return SweepResult("trsm", (n, nrhs), _dtype.name(dtype), dev.type,
                       tuple(measured), cfg, {"block": cands[0]})
