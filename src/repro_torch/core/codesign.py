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

The CUDA kernels take their CTA tiles from their own sources, not from
these plans: a plan sized for the TPU's VMEM cannot be a CTA tile. The
kernel wrappers record the plan they were handed beside the tile they
launched with. The model kernels' planners (:func:`plan_attention`,
:func:`plan_ssd`) are ported with the serving slice; ``plan_pdgemm``
comes with the distributed slice.
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
    arithmetic intensity then bk."""
    mach = _machine(machine)
    dtype_bytes = resolve_dtype_bytes(dtype, dtype_bytes, mach)
    vmem_budget = mach.memory.vmem_bytes if vmem_budget is None else vmem_budget
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


def plan_from_blocks(m: int, n: int, k: int, bm: int, bn: int, bk: int,
                     dtype_bytes: Optional[int] = None, dtype=None,
                     machine: Optional[MachineSpec] = None) -> GemmPlan:
    """Rebuild a full :class:`GemmPlan` from explicit block dims (registry
    entries), deriving grid, footprint and intensity as :func:`plan_gemm`."""
    mach = _machine(machine)
    dtype_bytes = resolve_dtype_bytes(dtype, dtype_bytes, mach)
    bm_, bn_, bk_ = (max(int(b), 1) for b in (bm, bn, bk))
    grid = (-(-m // bm_), -(-n // bn_), -(-k // bk_))
    vmem = 2 * (bm_ * bk_ + bk_ * bn_) * dtype_bytes \
        + bm_ * bn_ * _acc_bytes(dtype_bytes)
    ai = (2 * bm_ * bn_ * bk_) / ((bm_ * bk_ + bk_ * bn_) * dtype_bytes
                                  + bm_ * bn_ * dtype_bytes / max(grid[2], 1))
    return GemmPlan(bm_, bn_, bk_,
                    optimal_accumulators(bk_ // mach.pe.mxu, max_u=8,
                                         machine=mach),
                    grid, vmem, ai, mach.pe.peak_flops / mach.memory.hbm_bw)


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
        vmem = g.vmem_bytes + g.bn * db
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
    bm = min(g.bm, _round_up(m, max(mach.pe.sublane, 1)))
    acc = _acc_bytes(db)
    vmem = (k * k + k * n) * db + k * n * acc + k * n * db \
        + bm * n * (db + acc) + (bm * k * db if form == "lu" else 0)
    return FusedChainPlan(kind, form, g, bm, int(vmem), vmem <= budget,
                          int(solve_bytes + unfused_gemm_b),
                          int(solve_bytes + fused_gemm_b),
                          unfused_t, fused_t)


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
