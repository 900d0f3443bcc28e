"""The paper's codesign planners (port of ``repro.core.codesign``).

The planners turn the paper's pipeline-depth equation into software knobs:
the accumulator count U of a reduction (:func:`optimal_accumulators`),
GEMM block shapes (:func:`plan_gemm`), the TRSM diagonal width
(:func:`plan_trsm`), the factorization panel width
(:func:`plan_factorization`) and the fused-vs-staged decision for the two
streamed chains (:func:`plan_fused_chain`). Each takes ``machine=`` (a
:class:`repro_torch.arch.MachineSpec`; ``None`` = the ambient machine) and
returns bit-for-bit what the reference returns for the same machine, so
the dispatcher resolves the same plans on both sides.

Under a GPU spec (one with ``pe.sm_count``, the ``"h100"`` machine of CUDA
tensors) the planners price what the card's kernels hold instead of the
TPU's double-buffered VMEM blocks: :func:`plan_gemm` and
:func:`plan_from_blocks` return CTA tiles of ``csrc/gemm.cu``
(:data:`HOPPER_TILES`; the stages of A and B in shared memory within
``vmem_bytes``, the accumulator tile in registers within ``vreg_budget``,
enough CTAs for a wave of ``sm_count`` SMs), which B1 and B3 launch, and
:func:`plan_fused_chain` prices B2's real per-CTA shared memory
(:func:`trsm_gemm_smem`, the one formula ``kernels/fused.py`` uses) and B3
on B1's tile. Under the reference's machines every plan is the
reference's, field for field. The model kernels' planners
(:func:`plan_attention`, :func:`plan_ssd`) are ported with the serving
slice. :func:`plan_pdgemm` prices SUMMA on a (px, py) mesh: its local plan
is :func:`plan_gemm`'s (a CTA tile under a GPU spec), its collective term
the ring broadcasts' bytes over the machine's ``ici_bw``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from repro_torch import _dtype
from repro_torch import arch as _arch
from repro_torch.arch import MachineSpec

_machine = _arch.resolve_machine
_TPU = _arch.get(_arch.DEFAULT_MACHINE)

# csrc/gemm.cu's compiled CTA tiles of each operand width's tiled variant
# (2 bytes: bf16 "wgmma", 4: f32 "ffma", 8: f64 "dmma"), the default first:
# (bm, bn, bk, stages, threads holding the accumulator tile)
HOPPER_TILES = {
    2: ("wgmma", ((128, 256, 64, 4, 256), (128, 128, 64, 6, 256))),
    4: ("ffma", ((128, 128, 16, 3, 256), (64, 128, 16, 3, 128))),
    8: ("dmma", ((128, 128, 32, 3, 256), (64, 128, 32, 3, 128))),
}

# csrc/trsm_gemm.cu's shapes (B2): solve widths (X columns per block), the
# update tile (BM, BN, BK) and its stages, the transpose tile
TRSM_GEMM_WIDTHS = (32, 16, 8, 4, 2, 1)
TRSM_GEMM_TILE = (128, 128, 16)
TRSM_GEMM_STAGES, TRSM_GEMM_TT = 3, 32


def is_gpu(mach: MachineSpec) -> bool:
    """Does ``mach`` describe a GPU (its planners price CTA tiles)?"""
    return mach.pe.sm_count is not None


def resolve_dtype_bytes(dtype=None, dtype_bytes: Optional[int] = None,
                        machine: Optional[MachineSpec] = None) -> int:
    """The shared dtype-width default: an explicit ``dtype`` (itemsize),
    then an explicit ``dtype_bytes``, then the machine's native dtype."""
    if dtype is not None:
        return _dtype.itemsize(dtype)
    if dtype_bytes is not None:
        return int(dtype_bytes)
    return _machine(machine).dtype_bytes()


def reduction_cost(n: float, u: int, latency: Optional[float] = None,
                   overhead: Optional[float] = None,
                   machine: Optional[MachineSpec] = None) -> float:
    """Issue-slot cost of reducing n elements with u parallel accumulators:
    ``n*max(1, L/u) + L*ceil(log2 u) + c_o*u``."""
    m = _machine(machine)
    latency = m.fpu.add_latency if latency is None else latency
    overhead = m.fpu.acc_overhead if overhead is None else overhead
    u = max(1, int(u))
    steady = n * max(1.0, latency / u)
    combine = latency * math.ceil(math.log2(u)) if u > 1 else 0.0
    return steady + combine + overhead * u


def optimal_accumulators(n: float, latency: Optional[float] = None,
                         overhead: Optional[float] = None,
                         max_u: Optional[int] = None,
                         power_of_two: bool = True,
                         machine: Optional[MachineSpec] = None) -> int:
    """U minimizing :func:`reduction_cost` - the eq.-3 analogue."""
    m = _machine(machine)
    latency = m.fpu.add_latency if latency is None else latency
    overhead = m.fpu.acc_overhead if overhead is None else overhead
    max_u = m.pe.vreg_budget // 2 if max_u is None else max_u
    candidates = range(1, max_u + 1)
    if power_of_two:
        candidates = [1 << k for k in range(0, max_u.bit_length()) if (1 << k) <= max_u]
    best = min(candidates, key=lambda u: reduction_cost(n, u, latency, overhead))
    return int(best)


def _acc_bytes(dtype_bytes: int) -> int:
    """Accumulator bytes/elem: f64 operands -> f64, narrower -> f32."""
    return 8 if dtype_bytes >= 8 else 4


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def hopper_tiles(dtype_bytes: int) -> Tuple[Tuple[int, ...], ...]:
    """The compiled tiles (bm, bn, bk, stages, threads) of the tiled
    variant that takes ``dtype_bytes``-wide operands, the default first."""
    if dtype_bytes not in HOPPER_TILES:
        raise ValueError(f"no tiled GEMM variant takes {dtype_bytes}-byte "
                         f"operands; widths {tuple(HOPPER_TILES)}")
    return HOPPER_TILES[dtype_bytes][1]


def cta_smem_bytes(dtype_bytes: int, bm: int, bn: int, bk: int,
                   stages: int) -> int:
    """Dynamic shared memory of one csrc/gemm.cu tiled-variant CTA: the
    stages of A and B ("ffma" pads A's rows by four floats), plus the
    mbarriers and the 1024-byte alignment of the TMA variants."""
    if dtype_bytes == 4:
        return stages * (bm * (bk + 4) + bk * bn) * 4
    return stages * (bm * bk + bk * bn) * dtype_bytes + 2 * stages * 8 + 1024


def accumulator_registers(dtype_bytes: int, bm: int, bn: int,
                          threads: int) -> int:
    """32-bit registers per thread that hold a CTA's accumulator tile."""
    return bm * bn * _acc_bytes(dtype_bytes) // 4 // threads


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """GEMM tiling picked by the model (same fields as the reference)."""

    bm: int
    bn: int
    bk: int
    accumulators: int             # U for the k-loop partials
    grid: Tuple[int, int, int]
    vmem_bytes: int
    arithmetic_intensity: float   # flops / HBM byte at this tiling
    ridge: float = _TPU.pe.peak_flops / _TPU.memory.hbm_bw

    @property
    def compute_bound(self) -> bool:
        return self.arithmetic_intensity >= self.ridge


def plan_gemm(m: int, n: int, k: int, dtype_bytes: Optional[int] = None,
              vmem_budget: Optional[int] = None,
              min_grid_steps: int = 4, dtype=None,
              machine: Optional[MachineSpec] = None) -> GemmPlan:
    """Choose (bm, bn, bk) for C[m,n] += A[m,k] B[k,n]: matrix-unit
    aligned blocks, double-buffered blocks + accumulator within the
    scratch budget, at least ``min_grid_steps`` grid steps, maximal
    arithmetic intensity then bk. Under a GPU spec: a compiled CTA tile
    (:func:`_plan_gemm_gpu`; ``min_grid_steps`` gives way to a wave of
    CTAs)."""
    mach = _machine(machine)
    dtype_bytes = resolve_dtype_bytes(dtype, dtype_bytes, mach)
    vmem_budget = mach.memory.vmem_bytes if vmem_budget is None else vmem_budget
    if is_gpu(mach):
        return _plan_gemm_gpu(m, n, k, dtype_bytes, vmem_budget, mach)
    mxu = mach.pe.mxu
    ridge = mach.pe.peak_flops / mach.memory.hbm_bw
    pm, pn, pk = (_round_up(max(d, 1), mxu) for d in (m, n, k))
    best: Optional[GemmPlan] = None
    cands = [mxu, 2 * mxu, 4 * mxu, 8 * mxu]
    for bm in cands:
        if bm > pm and bm != mxu:
            continue
        for bn in cands:
            if bn > pn and bn != mxu:
                continue
            for bk in (4 * mxu, 8 * mxu, 16 * mxu, 2 * mxu, mxu):
                if bk > pk and bk != mxu:
                    continue
                bm_, bn_, bk_ = min(bm, pm), min(bn, pn), min(bk, pk)
                vmem = 2 * (bm_ * bk_ + bk_ * bn_) * dtype_bytes \
                    + bm_ * bn_ * _acc_bytes(dtype_bytes)
                if vmem > vmem_budget:
                    continue
                grid = (-(-m // bm_), -(-n // bn_), -(-k // bk_))
                steps = grid[0] * grid[1] * grid[2]
                if steps < min_grid_steps and (bm_, bn_, bk_) != (mxu, mxu, mxu):
                    continue
                ai = (2 * bm_ * bn_ * bk_) / ((bm_ * bk_ + bk_ * bn_) * dtype_bytes
                                              + bm_ * bn_ * dtype_bytes / max(grid[2], 1))
                cand = GemmPlan(bm_, bn_, bk_,
                                optimal_accumulators(bk_ // mxu, max_u=8,
                                                     machine=mach),
                                grid, vmem, ai, ridge)
                key = (cand.arithmetic_intensity, bk_)
                if best is None or key > (best.arithmetic_intensity, best.bk):
                    best = cand
    if best is None:  # degenerate tiny problem: single matrix-unit tile
        bm_, bn_, bk_ = min(mxu, pm), min(mxu, pn), min(mxu, pk)
        vmem = 2 * (bm_ * bk_ + bk_ * bn_) * dtype_bytes \
            + bm_ * bn_ * _acc_bytes(dtype_bytes)
        ai = (2 * bm_ * bn_ * bk_) / ((bm_ * bk_ + bk_ * bn_ + bm_ * bn_) * dtype_bytes)
        best = GemmPlan(bm_, bn_, bk_, 1,
                        (-(-m // bm_), -(-n // bn_), -(-k // bk_)), vmem, ai,
                        ridge)
    return best


def _gpu_plan(m: int, n: int, k: int, bm: int, bn: int, bk: int,
              stages: int, dtype_bytes: int, mach: MachineSpec) -> GemmPlan:
    """The GemmPlan of one CTA tile: the kernel's shared memory as its
    footprint, the reference's intensity formula."""
    grid = (-(-m // bm), -(-n // bn), -(-k // bk))
    ai = (2 * bm * bn * bk) / ((bm * bk + bk * bn) * dtype_bytes
                               + bm * bn * dtype_bytes / max(grid[2], 1))
    return GemmPlan(bm, bn, bk,
                    optimal_accumulators(max(bk // mach.pe.mxu, 1), max_u=8,
                                         machine=mach),
                    grid, cta_smem_bytes(dtype_bytes, bm, bn, bk, stages), ai,
                    mach.pe.peak_flops / mach.memory.hbm_bw)


def _plan_gemm_gpu(m: int, n: int, k: int, dtype_bytes: int,
                   vmem_budget: int, mach: MachineSpec) -> GemmPlan:
    """A compiled tile of the dtype's tiled variant: among those whose
    stages fit ``vmem_budget`` and whose accumulator fits the register
    budget, the most CTAs up to one per SM (a wave), then the highest
    arithmetic intensity, then the deepest k step. When none fits, the
    tile with the smallest footprint."""
    m, n, k = (max(int(d), 1) for d in (m, n, k))
    tiles = hopper_tiles(dtype_bytes)
    fits = [t for t in tiles
            if cta_smem_bytes(dtype_bytes, *t[:4]) <= vmem_budget
            and accumulator_registers(dtype_bytes, t[0], t[1], t[4])
            <= mach.pe.vreg_budget]
    if not fits:
        fits = [min(tiles, key=lambda t: cta_smem_bytes(dtype_bytes, *t[:4]))]
    plans = [_gpu_plan(m, n, k, *t[:4], dtype_bytes, mach) for t in fits]
    sms = mach.pe.sm_count
    return max(plans, key=lambda p: (min(p.grid[0] * p.grid[1], sms),
                                     p.arithmetic_intensity, p.bk))


def plan_from_blocks(m: int, n: int, k: int, bm: int, bn: int, bk: int,
                     dtype_bytes: Optional[int] = None, dtype=None,
                     machine: Optional[MachineSpec] = None) -> GemmPlan:
    """Rebuild a full :class:`GemmPlan` from explicit block dims (registry
    entries), deriving grid, footprint and intensity as :func:`plan_gemm`
    (under a GPU spec, the footprint of that CTA tile)."""
    mach = _machine(machine)
    dtype_bytes = resolve_dtype_bytes(dtype, dtype_bytes, mach)
    bm_, bn_, bk_ = (max(int(b), 1) for b in (bm, bn, bk))
    if is_gpu(mach):
        # the stages of that compiled tile, else of the variant's default
        tiles = hopper_tiles(dtype_bytes)
        stages = next((t[3] for t in tiles if t[:3] == (bm_, bn_, bk_)),
                      tiles[0][3])
        return _gpu_plan(m, n, k, bm_, bn_, bk_, stages, dtype_bytes, mach)
    grid = (-(-m // bm_), -(-n // bn_), -(-k // bk_))
    vmem = 2 * (bm_ * bk_ + bk_ * bn_) * dtype_bytes \
        + bm_ * bn_ * _acc_bytes(dtype_bytes)
    ai = (2 * bm_ * bn_ * bk_) / ((bm_ * bk_ + bk_ * bn_) * dtype_bytes
                                  + bm_ * bn_ * dtype_bytes / max(grid[2], 1))
    return GemmPlan(bm_, bn_, bk_,
                    optimal_accumulators(bk_ // mach.pe.mxu, max_u=8,
                                         machine=mach),
                    grid, vmem, ai, mach.pe.peak_flops / mach.memory.hbm_bw)


# ----------------------------- distributed GEMM ----------------------------

@dataclasses.dataclass(frozen=True)
class PdgemmPlan:
    """SUMMA pdgemm schedule on a (px, py) mesh: per-step local tiling plus
    the roofline extended with a per-hop collective term (the reference's
    fields)."""

    px: int
    py: int
    steps: int                    # SUMMA panel steps = px * py
    k_fine: int                   # k-panel width per step
    local: GemmPlan               # tiling of one local panel update
    compute_s: float              # per-device GEMM flops under the roofline
    collective_s: float           # per-device ring-broadcast bytes / ici_bw
    collective_bytes: int         # on-wire bytes per device, all steps

    @property
    def modeled_time(self) -> float:
        return max(self.compute_s, self.collective_s)

    @property
    def collective_bound(self) -> bool:
        return self.collective_s > self.compute_s


def plan_pdgemm(m: int, n: int, k: int, px: int, py: int,
                dtype_bytes: Optional[int] = None, dtype=None,
                machine: Optional[MachineSpec] = None) -> PdgemmPlan:
    """Plan the SUMMA ``pdgemm`` on a (px, py) mesh.

    Per step (one of ``px * py`` fine k-panels) each rank receives an
    A-panel over a ``py``-ring and a B-panel over a ``px``-ring
    (:func:`repro_torch.distributed.collectives.ring_bcast`), then runs a
    local ``(m/px, k_fine) @ (k_fine, n/py)`` update on B1. The collective
    term sums the per-hop bytes of both rings over all steps against the
    machine's ``ici_bw``; the compute term is the local flops under the
    single-device roofline at the ``local`` tiling plus a pipeline fill
    per step. ``modeled_time`` is their max (overlap assumed)."""
    from repro_torch.distributed.collectives import ring_bcast_bytes
    mach = _machine(machine)
    dtype_bytes = resolve_dtype_bytes(dtype, dtype_bytes, mach)
    px, py = max(int(px), 1), max(int(py), 1)
    steps = px * py
    m_l = -(-max(m, 1) // px)
    n_l = -(-max(n, 1) // py)
    k_f = max(-(-max(k, 1) // steps), 1)
    local = plan_gemm(m_l, n_l, k_f, dtype_bytes=dtype_bytes, machine=mach)
    flops = 2.0 * m_l * n_l * k_f * steps
    rate = min(mach.pe.peak_flops,
               local.arithmetic_intensity * mach.memory.hbm_bw)
    compute_s = flops / rate + steps * mach.memory.pipeline_fill_s
    a_panel = m_l * k_f * dtype_bytes
    b_panel = k_f * n_l * dtype_bytes
    coll_bytes = steps * (ring_bcast_bytes(a_panel, py)
                          + ring_bcast_bytes(b_panel, px))
    return PdgemmPlan(px, py, steps, k_f, local, compute_s,
                      coll_bytes / mach.memory.ici_bw, coll_bytes)


# ------------------------- blocked-factorization plans ----------------------
# Serial-chain cycles exposed per panel column, priced at the machine's
# per-class pipeline depths (potrf: sqrt then div; getrf: pivot-compare +
# div; geqrf: norm-sqrt, alpha-add, div scale, tau div).
def _panel_chain_cycles(mach: MachineSpec) -> Dict[str, int]:
    d = mach.fpu.depths
    return {"potrf": d["sqrt"] + d["div"],
            "getrf": d["add"] + d["div"],
            "geqrf": d["sqrt"] + d["add"] + 2 * d["div"]}


# flops(n) ~ coeff * n^3 for the square factorization
FACTOR_FLOP_COEFF = {"potrf": 1.0 / 3.0, "getrf": 2.0 / 3.0, "geqrf": 4.0 / 3.0}


@dataclasses.dataclass(frozen=True)
class FactorizationPlan:
    """Panel width + trailing-update GEMM tiling for a blocked factorization."""

    kind: str                     # "potrf" | "getrf" | "geqrf"
    block: int                    # panel width nb (the LAPACK NB)
    gemm: GemmPlan                # plan for the widest trailing update
    panel_time: float             # modeled seconds in serial panels
    trailing_time: float          # modeled seconds in GEMM trailing updates
    batch: int = 1

    @property
    def modeled_time(self) -> float:
        return self.panel_time + self.trailing_time

    @property
    def panel_fraction(self) -> float:
        t = self.modeled_time
        return self.panel_time / t if t > 0 else 0.0


def _factorization_time(n: int, nb: int, kind: str, dtype_bytes: int,
                        batch: int, mach: MachineSpec) -> Tuple[float, float]:
    """(panel_s, trailing_s) for one size-n factorization at panel width
    nb: hazard-bound panels plus roofline-priced trailing GEMMs, one
    pipeline fill per panel step."""
    chain = _panel_chain_cycles(mach)[kind] / mach.pe.mxu_clock
    coeff = FACTOR_FLOP_COEFF[kind]
    fill = mach.memory.pipeline_fill_s
    panel_s = 0.0
    trailing_s = 0.0
    for j0 in range(0, n, nb):
        b = min(nb, n - j0)
        m = n - j0
        panel_s += b * chain + (coeff * 3.0) * m * b * b / mach.pe.vpu_flops \
            + fill
        rest = n - j0 - b
        if rest <= 0:
            continue
        gf = 2.0 if kind == "geqrf" else 1.0
        flops = gf * 2.0 * rest * b * rest
        bytes_moved = gf * (2 * rest * b + 2 * rest * rest) * dtype_bytes
        ai = flops / bytes_moved
        rate = min(mach.pe.peak_flops, ai * mach.memory.hbm_bw)
        trailing_s += flops / rate + fill
    return batch * panel_s, batch * trailing_s


def plan_factorization(n: int, kind: str = "potrf",
                       dtype_bytes: Optional[int] = None,
                       batch: int = 1,
                       candidates: Tuple[int, ...] = (8, 16, 32, 64, 128),
                       dtype=None,
                       machine: Optional[MachineSpec] = None) -> FactorizationPlan:
    """Pick the panel width NB minimizing modeled panel + trailing time -
    the software analogue of eq. 3's p_opt."""
    if kind not in FACTOR_FLOP_COEFF:
        raise ValueError(f"unknown factorization kind: {kind!r}")
    mach = _machine(machine)
    dtype_bytes = resolve_dtype_bytes(dtype, dtype_bytes, mach)
    n = max(int(n), 1)
    best_nb, best_t = None, None
    for nb in candidates:
        if nb > n and best_nb is not None:
            continue
        nb_ = min(nb, n)
        p, t = _factorization_time(n, nb_, kind, dtype_bytes, batch, mach)
        if best_t is None or p + t < best_t:
            best_nb, best_t = nb_, p + t
    rest = max(n - best_nb, 1)
    gemm = plan_gemm(rest, rest, best_nb, dtype_bytes=dtype_bytes,
                     machine=mach)
    p, t = _factorization_time(n, best_nb, kind, dtype_bytes, batch, mach)
    return FactorizationPlan(kind, best_nb, gemm, p, t, batch=batch)


@dataclasses.dataclass(frozen=True)
class TrsmPlan:
    """Diagonal-block width for the blocked triangular solve."""

    block: int
    panel_time: float             # modeled seconds in serial substitutions
    trailing_time: float          # modeled seconds in off-diagonal GEMMs

    @property
    def modeled_time(self) -> float:
        return self.panel_time + self.trailing_time


def plan_trsm(n: int, nrhs: int = 1, dtype_bytes: Optional[int] = None,
              candidates: Tuple[int, ...] = (16, 32, 64, 128),
              dtype=None,
              machine: Optional[MachineSpec] = None) -> TrsmPlan:
    """Pick the diagonal-block width for the blocked TRSM: serial
    substitution chain vs off-diagonal GEMMs under the roofline."""
    mach = _machine(machine)
    dtype_bytes = resolve_dtype_bytes(dtype, dtype_bytes, mach)
    n = max(int(n), 1)
    nrhs = max(int(nrhs), 1)
    chain = _panel_chain_cycles(mach)["getrf"] / mach.pe.mxu_clock
    fill = mach.memory.pipeline_fill_s
    best: Optional[TrsmPlan] = None
    for b in candidates:
        b_ = min(b, n)
        steps = -(-n // b_)
        panel = n * chain + 2.0 * n * b_ * nrhs / mach.pe.vpu_flops \
            + steps * fill
        flops = max(n - b_, 0) * n * nrhs
        if flops > 0:
            bytes_moved = (max(n - b_, 0) * b_ + 2 * n * nrhs) * dtype_bytes
            ai = flops / max(bytes_moved, 1)
            rate = min(mach.pe.peak_flops, ai * mach.memory.hbm_bw)
            trailing = flops / rate + steps * fill
        else:
            trailing = 0.0
        cand = TrsmPlan(b_, panel, trailing)
        if best is None or cand.modeled_time < best.modeled_time:
            best = cand
        if b_ >= n:
            break
    return best


# ------------------------------- fused chains -------------------------------

FUSED_CHAIN_KINDS = ("gemm+epilogue", "trsm+gemm")

# extra vector flops per output element (the bias add is priced separately)
EPILOGUE_FLOP_COST = {"none": 0, "relu": 1, "gelu": 8}


@dataclasses.dataclass(frozen=True)
class FusedChainPlan:
    """Fused vs. staged pricing of one two-stage tile chain."""

    kind: str                     # one of FUSED_CHAIN_KINDS
    form: str                     # epilogue name | "lu" | "syrk"
    gemm: GemmPlan                # tiling of the GEMM stage
    block: int                    # fused-kernel row-block height
    vmem_bytes: int               # fused kernel's resident scratch footprint
    fits_vmem: bool               # vmem_bytes <= the machine budget
    unfused_hbm_bytes: int        # modeled HBM traffic, staged execution
    fused_hbm_bytes: int          # modeled HBM traffic, streamed execution
    unfused_time: float           # roofline seconds, staged (2 fills)
    fused_time: float             # roofline seconds, streamed (1 fill)

    @property
    def hbm_bytes_saved(self) -> int:
        return max(self.unfused_hbm_bytes - self.fused_hbm_bytes, 0)

    @property
    def fused_wins(self) -> bool:
        """Fuse iff the streamed kernel fits the scratch budget and the
        model says it is no slower."""
        return self.fits_vmem and self.fused_time <= self.unfused_time


def _stage_time(flops: float, bytes_moved: float, mach: MachineSpec) -> float:
    """Roofline seconds of one kernel stage (compute vs. HBM stream max)."""
    return max(flops / mach.pe.peak_flops,
               bytes_moved / mach.memory.hbm_bw)


def plan_fused_chain(kind: str, m: int, n: int, k: int,
                     dtype_bytes: Optional[int] = None, dtype=None,
                     epilogue: str = "none", has_bias: bool = True,
                     form: str = "lu",
                     machine: Optional[MachineSpec] = None) -> FusedChainPlan:
    """Price a two-stage tile chain fused vs. staged.

    ``"gemm+epilogue"``: (m, n, k) is the GEMM problem. ``"trsm+gemm"``:
    the trailing update C[m, n] consuming X = L11^{-1} AP with panel
    width k; ``form="lu"`` reads a separate B[m, k], ``form="syrk"``
    reuses X as both GEMM operands.
    """
    if kind not in FUSED_CHAIN_KINDS:
        raise ValueError(f"unknown fused chain {kind!r}; "
                         f"expected one of {FUSED_CHAIN_KINDS}")
    mach = _machine(machine)
    db = resolve_dtype_bytes(dtype, dtype_bytes, mach)
    fill = mach.memory.pipeline_fill_s
    budget = mach.memory.vmem_bytes
    m, n, k = max(int(m), 1), max(int(n), 1), max(int(k), 1)
    g = plan_gemm(m, n, k, dtype_bytes=db, machine=mach)
    if kind == "gemm+epilogue":
        if epilogue not in EPILOGUE_FLOP_COST:
            raise ValueError(f"unknown epilogue {epilogue!r}; expected one "
                             f"of {tuple(EPILOGUE_FLOP_COST)}")
        bias_bytes = n * db if has_bias else 0
        gemm_bytes = (m * k + k * n + m * n) * db
        epi_flops = (EPILOGUE_FLOP_COST[epilogue]
                     + (1 if has_bias else 0)) * m * n
        epi_bytes = 2 * m * n * db + bias_bytes
        unfused_b = gemm_bytes + epi_bytes
        fused_b = gemm_bytes + bias_bytes
        unfused_t = _stage_time(2.0 * m * n * k, gemm_bytes, mach) \
            + _stage_time(epi_flops, epi_bytes, mach) + 2 * fill
        fused_t = _stage_time(2.0 * m * n * k + epi_flops, fused_b, mach) \
            + fill
        # B3 runs on B1's tile; the bias is read in the epilogue, from
        # device memory, on the card
        vmem = g.vmem_bytes if is_gpu(mach) else g.vmem_bytes + g.bn * db
        return FusedChainPlan(kind, epilogue, g, g.bm, int(vmem),
                              vmem <= budget, int(unfused_b), int(fused_b),
                              unfused_t, fused_t)
    if form not in ("lu", "syrk"):
        raise ValueError(f"unknown trsm+gemm form {form!r}; "
                         f"expected 'lu' or 'syrk'")
    t = plan_trsm(k, n, dtype_bytes=db, machine=mach)
    x_bytes = k * n * db
    solve_bytes = k * k * db + k * n * db + x_bytes
    b_bytes = 0 if form == "syrk" else m * k * db
    x_reread = 2 * x_bytes if form == "syrk" else x_bytes
    gemm_flops = 2.0 * m * n * k
    unfused_gemm_b = x_reread + b_bytes + 2 * m * n * db
    fused_gemm_b = b_bytes + 2 * m * n * db
    solve_t = t.modeled_time
    unfused_t = solve_t + _stage_time(gemm_flops, unfused_gemm_b, mach) \
        + 2 * fill
    fused_t = solve_t + _stage_time(gemm_flops, fused_gemm_b, mach) + fill
    acc = _acc_bytes(db)
    if is_gpu(mach):
        # B2's own shared memory per CTA, not the TPU kernel's resident
        # panel: the footprint of its solve block and update stages
        fp = trsm_gemm_footprint(acc, k, budget)
        bm = TRSM_GEMM_TILE[0]
        vmem = fp[2] if fp is not None else trsm_gemm_smem(acc, k, 1, False)
        fits = fp is not None
    else:
        bm = min(g.bm, _round_up(m, max(mach.pe.sublane, 1)))
        vmem = (k * k + k * n) * db + k * n * acc + k * n * db \
            + bm * n * (db + acc) + (bm * k * db if form == "lu" else 0)
        fits = vmem <= budget
    return FusedChainPlan(kind, form, g, bm, int(vmem), fits,
                          int(solve_bytes + unfused_gemm_b),
                          int(solve_bytes + fused_gemm_b),
                          unfused_t, fused_t)


def trsm_gemm_smem(acc_bytes: int, nb: int, width: int, l_smem: bool) -> int:
    """csrc/trsm_gemm.cu::smem_bytes, B2's dynamic shared memory per CTA:
    the larger of the solve phase (an X block of ``width`` columns, L11
    beside it when ``l_smem``) and the update phase (its stages)."""
    bm, _, bk = TRSM_GEMM_TILE
    nbp = -(-nb // bk) * bk
    xs = max(nbp * (width + 1), TRSM_GEMM_TT * (TRSM_GEMM_TT + 1))
    solve = (xs + (nb * nb if l_smem else 0)) * acc_bytes
    stage_ld = bm + 4 if acc_bytes == 8 else bm
    return max(solve, TRSM_GEMM_STAGES * 2 * bk * stage_ld * acc_bytes)


def trsm_gemm_footprint(acc_bytes: int, nb: int,
                        budget: int) -> Optional[Tuple[int, bool, int]]:
    """(width, l_smem, bytes) of B2 at panel width ``nb``: the widest solve
    width (:data:`TRSM_GEMM_WIDTHS`) whose X block fits ``budget``, then
    L11 beside it if it still fits; ``None`` when no width fits."""
    for width in TRSM_GEMM_WIDTHS:
        if trsm_gemm_smem(acc_bytes, nb, width, False) <= budget:
            l_smem = trsm_gemm_smem(acc_bytes, nb, width, True) <= budget
            return width, l_smem, trsm_gemm_smem(acc_bytes, nb, width, l_smem)
    return None


# ------------------------------- model kernels ------------------------------

@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    """Flash-attention tiling: KV blocks stream through on-chip memory; the
    online softmax running (m, l, o) triple is the dependent accumulator
    chain."""

    block_q: int
    block_k: int
    grid_kv: int
    vmem_bytes: int


def plan_attention(seq_q: int, seq_k: int, head_dim: int,
                   dtype_bytes: int = 2,
                   vmem_budget: Optional[int] = None,
                   machine: Optional[MachineSpec] = None) -> AttentionPlan:
    """KV/Q block sizes for the streaming-softmax kernel: a larger
    ``block_k`` amortizes the per-block rescale (the serial hazard) at the
    cost of scratch; ``block_q`` adds independent rows."""
    mach = _machine(machine)
    vmem_budget = mach.memory.vmem_bytes if vmem_budget is None else vmem_budget
    lane, sublane = mach.pe.lane, mach.pe.sublane
    hd = _round_up(head_dim, lane)
    block_q = min(_round_up(min(seq_q, 512), sublane),
                  _round_up(seq_q, sublane))

    def footprint(block_k):
        # q, k, v blocks (double-buffered k/v) + scores + fp32 o/m/l
        return (block_q * hd * dtype_bytes
                + 2 * 2 * block_k * hd * dtype_bytes
                + block_q * block_k * 4 + block_q * (hd + 2) * 4)

    block_k = 1024
    while block_k > 128 and footprint(block_k) > vmem_budget:
        block_k //= 2
    block_k = min(block_k, _round_up(seq_k, lane))
    return AttentionPlan(block_q, block_k, -(-seq_k // block_k),
                         footprint(block_k))


@dataclasses.dataclass(frozen=True)
class SSDPlan:
    """Mamba-2 SSD chunking: the cross-chunk state recurrence is the serial
    hazard chain; the chunk trades recurrence steps against the quadratic
    within-chunk term."""

    chunk: int
    n_chunks: int
    vmem_bytes: int


def plan_ssd(seq: int, heads: int, head_dim: int, state: int,
             dtype_bytes: int = 2, vmem_budget: Optional[int] = None,
             machine: Optional[MachineSpec] = None) -> SSDPlan:
    """Chunk length for the SSD scan: the largest of 256/128/64 whose
    footprint fits the scratch budget, clamped to the sequence."""
    mach = _machine(machine)
    vmem_budget = mach.memory.vmem_bytes if vmem_budget is None else vmem_budget
    sublane = mach.pe.sublane

    def footprint(c):
        return (c * head_dim * dtype_bytes * 3 + c * c * 4
                + head_dim * state * 4 + c * state * dtype_bytes * 2)

    best_c = 256
    for c in (256, 128, 64):
        if footprint(c) <= vmem_budget and c <= max(seq, 64):
            best_c = c
            break
    best_c = min(best_c, max(_round_up(seq, sublane), sublane))
    return SSDPlan(best_c, -(-seq // best_c), footprint(best_c))
