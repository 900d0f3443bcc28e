"""B3 and B2: the streamed kernel chains on hand-written Hopper kernels.

``gemm_bias_act`` (B3, ``csrc/gemm.cu``, entry ``repro_gemm_bias_act``)
    Replaces ``repro/kernels/fused.py::gemm_bias_act``
    (``_gemm_epilogue_kernel``). C = act(A B + bias) in one launch: B1's
    tiled product with the bias add and the activation applied to the
    register accumulator, in the accumulator type, before the single
    store, so C is written to device memory once. It runs on B1's main
    loop, in the variant :func:`~repro_torch.kernels.gemm.gemm_variant`
    picks (bf16 on the tensor cores, f32 on FFMA, f64 on DMMA), at the CTA
    tile of the plan it is handed when that tile is compiled (as B1,
    :func:`~repro_torch.kernels.gemm.launch_tile`). Bound by operations at
    the main path's shapes, like B1; the epilogue adds n bias reads and a
    few flops per output. A batch, (B, m, k) @ (B, k, n) with either side
    2-D and broadcast and one length-n bias shared by every item (``vmap``
    of the TPU kernel with the bias unmapped, as the reference's
    ``linalg.gemm_bias_act`` calls it), is one launch on B1's batched
    loops; item i is bitwise the 2-D launch on item i.

``trsm_gemm`` (B2, ``csrc/trsm_gemm.cu``)
    Replaces ``repro/kernels/fused.py::trsm_gemm`` (``_trsm_gemm_kernel``).
    X = L11^{-1} AP, then C - BL X (``form="lu"``, getrf) or C - X^T X
    (``form="syrk"``, potrf). The TPU kernel solved X once at grid step 0
    and let later, ordered steps read it from VMEM. Here one cooperative
    launch (every CTA co-resident) does the same in two phases around a
    grid barrier: the CTAs solve X's column blocks, each exactly once
    (blocked substitution in shared memory, :func:`trsm_gemm_plan` picks
    the block width), and write X at the accumulator width into a padded
    workspace (with BL transposed beside it for ``"lu"``); then they walk
    C's 128 x 128 tiles with B1's ``ffma`` micro-tile (f32, bf16) or
    ``dmma`` mma.sync shape (f64) over K = nb. Bound by operations; see the
    note in ``csrc/trsm_gemm.cu``. Its shared memory per CTA is
    :func:`repro_torch.core.codesign.trsm_gemm_smem`, the formula the
    chain planner prices it with. A batch of updates (every operand with
    a leading (B,) axis: the batched drivers' lockstep trailing updates,
    ``vmap`` of the TPU kernel in the reference) is one launch of a kernel
    of its own, with no grid barrier: CTAs claim tasks from one list by
    ticket (item i's solve blocks ahead of its C tiles), and a tile waits
    only for its own item's X (a counter per item, in a zeroed workspace,
    ``sync``: one fill launch beside the kernel). It reads BL in place,
    solves :data:`TRSM_GEMM_BATCHED_WIDTHS` columns a block
    (:func:`trsm_gemm_batched_plan`) and asks its own occupancy; item i is
    bitwise the launch on item i alone.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (:func:`gemm_bias_act_plain`, :func:`trsm_gemm_plain`)
for CPU tensors, with no other path. ``.launches`` counts kernel launches
on the card (the CPU route counts nothing); ``.last_launch`` records each
call on either route.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs as _obs
from repro_torch.core.codesign import (TRSM_GEMM_STAGES, TRSM_GEMM_TILE,
                                       TRSM_GEMM_TT, TRSM_GEMM_WIDTHS,
                                       GemmPlan, trsm_gemm_footprint)
from repro_torch.kernels import _build
from repro_torch.kernels import launch_record as _rec
from repro_torch.kernels.gemm import (DTYPE_CODES, accumulator_dtype,
                                      batch_of, batch_stride, check_operands,
                                      default_plan, gemm_plain, gemm_variant,
                                      launch, record_call, reset_launches)

EPILOGUES = ("none", "relu", "gelu")     # index = csrc/common.cuh code
SMEM_LIMIT = 232448                      # dynamic shared memory per block
# csrc/trsm_gemm.cu's padding of the workspaces; its solve widths, update
# tile and shared-memory formula live in core/codesign.py, which prices B2
# with them (trsm_gemm_smem)
_TRSM_PAD = 128


def apply_epilogue(x: torch.Tensor, epilogue: str,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The shared epilogue definition: bias add (broadcast over rows),
    then the activation (relu keeps NaN; gelu is the tanh form)."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; "
                         f"expected one of {EPILOGUES}")
    if bias is not None:
        x = x + bias
    if epilogue == "relu":
        x = torch.maximum(x, torch.zeros_like(x))
    elif epilogue == "gelu":
        x = F.gelu(x, approximate="tanh")
    return x


def fused_span(name: str, chain, **attrs):
    """An obs span for one fused launch, carrying the chain plan's saved
    HBM bytes."""
    return _obs.span("fused." + name, cat="fused",
                     hbm_bytes_saved=chain.hbm_bytes_saved,
                     fused_hbm_bytes=chain.fused_hbm_bytes,
                     unfused_hbm_bytes=chain.unfused_hbm_bytes, **attrs)


# ------------------------------ gemm + epilogue ------------------------------

def gemm_bias_act_plain(a: torch.Tensor, b: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        epilogue: str = "none",
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version: the epilogue on the accumulator-width product (2-D
    operands or a batch, the bias shared by every item)."""
    acc = accumulator_dtype(a.dtype)
    out = apply_epilogue(gemm_plain(a, b, acc), epilogue,
                         None if bias is None else bias.to(acc))
    return out.to(out_dtype or a.dtype)


def gemm_bias_act(a: torch.Tensor, b: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  epilogue: str = "none", plan: Optional[GemmPlan] = None,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = act(A @ B + bias) in one launch (CUDA) or its plain version
    (CPU). (m, k) @ (k, n), or a batch (B, m, k) @ (B, k, n) with either
    side 2-D and broadcast: (B, m, n), one launch. ``bias`` is a length-n
    vector of a's dtype, shared by every item; ``plan`` (one item's) picks
    the CTA tile and is recorded beside the variant and the tile, as in B1
    (:func:`repro_torch.kernels.gemm.gemm`)."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; "
                         f"expected one of {EPILOGUES}")
    out_dtype = check_operands(a, b, out_dtype)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = batch_of(a, b)
    shape = (m, n) if batch is None else (batch, m, n)
    if bias is not None and (bias.shape != (n,) or bias.dtype != a.dtype
                             or bias.device != a.device):
        raise ValueError(f"bias must be ({n},) {a.dtype} on {a.device}; got "
                         f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")
    if plan is None:
        plan = default_plan(a, b)
    if m == 0 or n == 0 or batch == 0:
        return torch.empty(shape, dtype=out_dtype, device=a.device)
    variant = gemm_variant(a, b)
    tile = record_call(gemm_bias_act, plan, variant, a.device)
    if a.device.type == "cpu":
        return gemm_bias_act_plain(a, b, bias, epilogue, out_dtype)
    c = torch.empty(shape, dtype=out_dtype, device=a.device)
    bias = None if bias is None else bias.contiguous()   # held past launch
    launch(gemm_bias_act, "repro_gemm_bias_act", variant, tile, a, b, c,
           None if bias is None else _rec.address(bias),
           EPILOGUES.index(epilogue))
    return c


reset_launches(gemm_bias_act)
gemm_bias_act.last_launch = None


# -------------------------------- trsm -> gemm -------------------------------

def row_times(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """v @ m for a row v (k,) and m (k, n), or for each item of a batch,
    v (B, k) and m (B, k, n)."""
    return v @ m if v.ndim == 1 else (v.unsqueeze(-2) @ m).squeeze(-2)


def _forward_substitution(l: torch.Tensor, ap: torch.Tensor,
                          unit_diag: bool) -> torch.Tensor:
    """X = L^{-1} AP, row by row (the serial divider chain), on one
    panel or a batch of them."""
    x = torch.zeros_like(ap)
    for r in range(l.shape[-1]):
        s = ap[..., r, :] - row_times(l[..., r, :r], x[..., :r, :])
        x[..., r, :] = s if unit_diag else s / l[..., r, r].unsqueeze(-1)
    return x


def trsm_gemm_plain(l11: torch.Tensor, a_panel: torch.Tensor,
                    b_left: Optional[torch.Tensor], c: torch.Tensor,
                    form: str = "lu",
                    unit_diag: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the solve and the update at the accumulator width
    (2-D operands, or a batch of them)."""
    acc = accumulator_dtype(c.dtype)
    x = _forward_substitution(l11.to(acc), a_panel.to(acc), unit_diag)
    upd = (x.mT if form == "syrk" else b_left.to(acc)) @ x
    return x.to(c.dtype), (c.to(acc) - upd).to(c.dtype)


class TrsmGemmPlan(NamedTuple):
    """One B2 launch's shapes (a pure function of dtype, nb and form)."""
    width: int             # X columns per solve task
    l_in_smem: bool        # L11 staged in shared memory (else via the cache)
    nb_padded: int         # K of the update: nb rounded up to BK
    smem_bytes: int        # dynamic shared memory of the launch
    update: str            # the update's main loop: "ffma" | "dmma"
    a_operand: str         # the update's A: "X^T" (syrk) | "BL" (lu)


def trsm_gemm_plan(dtype: torch.dtype, nb: int, form: str) -> TrsmGemmPlan:
    """The widest solve width (:data:`TRSM_GEMM_WIDTHS`) whose X block
    fits the shared memory, then L11 beside it if it still fits (else the
    kernel reads L11 through the cache):
    :func:`repro_torch.core.codesign.trsm_gemm_footprint`."""
    fp = trsm_gemm_footprint(accumulator_dtype(dtype).itemsize, nb,
                             SMEM_LIMIT)
    if fp is None:
        raise ValueError(f"trsm_gemm: panel width nb={nb} leaves no room for "
                         f"a one-column X block in {SMEM_LIMIT} bytes of "
                         f"shared memory ({dtype})")
    width, l_smem, smem = fp
    bk = TRSM_GEMM_TILE[2]
    return TrsmGemmPlan(width, l_smem, -(-nb // bk) * bk, smem,
                        "dmma" if dtype == torch.float64 else "ffma",
                        "X^T" if form == "syrk" else "BL")


def trsm_gemm_grid(co_resident: int, plan: TrsmGemmPlan, m: int, n: int,
                   form: str, batch: int = 1) -> int:
    """CTAs of one launch: as many as fit on the card at once
    (``co_resident``), but no more than it has tasks. One item (the 2-D
    kernel) has the larger phase's: solve blocks plus BL transpose tiles,
    or C tiles. A batch (the batched kernel) has one list: every item's
    solve blocks and C tiles (:data:`TRSM_GEMM_BATCHED_TILE`)."""
    pad = lambda v: -(-v // _TRSM_PAD) * _TRSM_PAD
    solve = pad(n) // plan.width
    bm, bn, _ = (TRSM_GEMM_BATCHED_TILE[plan.update] if batch > 1
                 else TRSM_GEMM_TILE)
    update = -(-m // bm) * -(-n // bn)
    if batch > 1:
        return max(1, min(co_resident, batch * (solve + update)))
    if form == "lu":
        solve += -(-plan.nb_padded // TRSM_GEMM_TT) * (pad(m) // TRSM_GEMM_TT)
    return max(1, min(co_resident, max(solve, update)))


# The batched kernel's update tile by variant: 64 x 128 for f32 and bf16
# (B1's "ffma" 64 x 128 x 16), 128 x 128 for f64 ("dmma"). Its solve widths
# (X columns a block) and L11's place (staged in shared memory or read
# through the cache), in the order its plan tries them, as csrc/trsm_gemm.cu
# instantiates them. Its shared memory per CTA
# (csrc/trsm_gemm.cu::batched_smem_bytes): the larger of the solve (an X
# block of width + 2 columns a row, and L11 staged beside it as a packed
# lower triangle, each row padded to a multiple of 4) and the update (syrk:
# A's and B's rings; lu: B's ring, one A stage and a ring of BL's raw
# [rows][BK] windows, rows of BK * 8 + 16 bytes; and the C tile its epilogue
# reads, beside them in f32 and bf16, over them in f64), then a 16-byte
# ticket slot
TRSM_GEMM_BATCHED_TILE = {"ffma": (64, 128, 16), "dmma": (128, 128, 16)}
TRSM_GEMM_BATCHED_WIDTHS = ((64, True), (64, False), (32, False))


def _packed_rows(r: int) -> int:
    """csrc/trsm_gemm.cu::l_row: where row r of the packed L11 starts."""
    return 4 * (r // 4 + 1) * (2 * (r // 4) + r % 4)


def trsm_gemm_batched_smem(acc_bytes: int, nb: int, width: int,
                           l_smem: bool) -> int:
    bm, bn, bk = TRSM_GEMM_BATCHED_TILE["dmma" if acc_bytes == 8 else "ffma"]
    nbp = -(-nb // bk) * bk
    solve = (nbp * (width + 2) + (_packed_rows(nbp) if l_smem else 0)) \
        * acc_bytes
    ring_a = bk * (bm + 4 if acc_bytes == 8 else bm) * acc_bytes
    ring_b = bk * (bn + 4 if acc_bytes == 8 else bn) * acc_bytes
    stages = TRSM_GEMM_STAGES
    rings = max(stages * (ring_a + ring_b),
                stages * ring_b + ring_a + stages * bm * (bk * 8 + 16))
    ctile = bm * bn * acc_bytes       # beside the rings (f32, bf16) or over
    update = rings + ctile if acc_bytes == 4 else max(rings, ctile)
    return max(solve, update) + 16


def trsm_gemm_batched_plan(dtype: torch.dtype, nb: int,
                           form: str) -> TrsmGemmPlan:
    """The batched kernel's plan: the first of
    :data:`TRSM_GEMM_BATCHED_WIDTHS` that fits the shared memory (64
    columns of X with L11 staged, then 64 or 32 with L11 read through the
    cache); raises when not even 32 columns of X fit (nb past about 1700
    f32 / 850 f64)."""
    acc = accumulator_dtype(dtype).itemsize
    bk = TRSM_GEMM_TILE[2]
    for width, l_smem in TRSM_GEMM_BATCHED_WIDTHS:
        smem = trsm_gemm_batched_smem(acc, nb, width, l_smem)
        if smem <= SMEM_LIMIT:
            return TrsmGemmPlan(width, l_smem, -(-nb // bk) * bk, smem,
                                "dmma" if dtype == torch.float64 else "ffma",
                                "X^T" if form == "syrk" else "BL")
    raise ValueError(f"trsm_gemm: a batch at panel width nb={nb} leaves no "
                     f"room for a 32-column X block in {SMEM_LIMIT} bytes of "
                     f"shared memory ({dtype})")


# registers per thread of csrc/trsm_gemm.cu's kernels (ptxas, sm_90a): the
# 2-D kernel's by dtype, the batched kernel's by dtype, solve width, L11's
# place and form (its A operand); and the H100 SM's limits the occupancy query
# applies: what co_resident_ctas, the query's Python counterpart, needs.
# chip_smoke.py's analysis phase holds it to the card's answers.
TRSM_GEMM_REGISTERS = {torch.float32: 128, torch.bfloat16: 128,
                       torch.float64: 246}
TRSM_GEMM_BATCHED_REGISTERS = {
    (dtype, width, l_smem, a_operand): regs
    for dtype, table in (
        (torch.float32, {(True, "X^T"): 123, (False, "X^T"): 105,
                         (True, "BL"): 128, (False, "BL"): 128}),
        (torch.bfloat16, {(True, "X^T"): 107, (False, "X^T"): 95,
                          (True, "BL"): 128, (False, "BL"): 128}),
        (torch.float64, {(True, "X^T"): 255, (False, "X^T"): 254,
                         (True, "BL"): 250, (False, "BL"): 254}))
    for (l_smem, a_operand), regs in table.items()
    for width in ((64,) if l_smem else (64, 32))}
_SM_REGISTERS, _SM_SMEM, _SM_THREADS, _SM_CTAS = 65536, 233472, 2048, 32
_REG_UNIT, _SMEM_RESERVED, _TRSM_THREADS = 256, 1024, 256


def trsm_gemm_registers(dtype: torch.dtype,
                        plan: Optional[TrsmGemmPlan] = None) -> int:
    """Registers per thread of the 2-D kernel (``plan`` None) or of the
    batched kernel that runs ``plan``."""
    if plan is None:
        return TRSM_GEMM_REGISTERS[dtype]
    return TRSM_GEMM_BATCHED_REGISTERS[dtype, plan.width, plan.l_in_smem,
                                       plan.a_operand]


def co_resident_ctas(dtype: torch.dtype, smem: int, sms: int,
                     plan: Optional[TrsmGemmPlan] = None) -> int:
    """CTAs of B2 that fit on an H100 of ``sms`` SMs at once with ``smem``
    bytes of dynamic shared memory: the occupancy query in Python, of the
    2-D kernel (``repro_trsm_gemm_co_resident``) or, given a batched
    ``plan``, of the batched kernel that runs it
    (``repro_trsm_gemm_batched_co_resident``); bounded per SM by registers
    (allocated per warp in units of 256), shared memory (1 KB reserved per
    CTA), threads and 32 CTAs."""
    regs = trsm_gemm_registers(dtype, plan)
    warp_regs = -(-regs * 32 // _REG_UNIT) * _REG_UNIT
    warps = _TRSM_THREADS // 32
    per_sm = min(_SM_REGISTERS // (warp_regs * warps),
                 _SM_SMEM // (smem + _SMEM_RESERVED),
                 _SM_THREADS // _TRSM_THREADS, _SM_CTAS)
    return sms * per_sm


_co_resident = {}


def _trsm_co_resident(lib, device: torch.device, dtype: torch.dtype,
                      plan: TrsmGemmPlan, batched: bool) -> int:
    """CTAs of the kernel that runs ``plan`` (the batched one when
    ``batched``) that fit on ``device`` at once (its occupancy query),
    cached per (device, kernel, dtype, plan); raises if the query
    failed."""
    key = (device.index, batched, dtype, plan)
    if key not in _co_resident:
        code = DTYPE_CODES[dtype]
        got = lib.repro_trsm_gemm_batched_co_resident(
            code, plan.width, int(plan.l_in_smem),
            int(plan.a_operand == "X^T"), plan.smem_bytes) \
            if batched else lib.repro_trsm_gemm_co_resident(
                code, plan.smem_bytes)
        if got < 1:
            raise RuntimeError(f"trsm_gemm: occupancy query gave {got} "
                               f"({'batched ' if batched else ''}"
                               f"plan {plan}, {dtype})")
        _co_resident[key] = got
    return _co_resident[key]


def trsm_gemm_attributes(dtype: torch.dtype,
                         plan: Optional[TrsmGemmPlan] = None
                         ) -> Tuple[int, int]:
    """(registers, local-memory bytes) per thread of the 2-D kernel
    (``plan`` None) or of the batched kernel that runs ``plan``, as the
    card's ``cudaFuncGetAttributes`` reports them (builds the library)."""
    out = (ctypes.c_int * 2)()
    lib = _build.library("trsm_gemm")
    err = lib.repro_trsm_gemm_attributes(
        int(plan is not None), DTYPE_CODES[dtype],
        0 if plan is None else plan.width,
        0 if plan is None else int(plan.l_in_smem),
        0 if plan is None else int(plan.a_operand == "X^T"), out)
    _build.check(err, "repro_trsm_gemm_attributes")
    return out[0], out[1]


def trsm_gemm(l11: torch.Tensor, a_panel: torch.Tensor,
              b_left: Optional[torch.Tensor], c: torch.Tensor,
              form: str = "lu", unit_diag: bool = False,
              row_block: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused X = L11^{-1} AP then C -= (B X | X^T X): one launch (CUDA) or
    the plain version (CPU).

    l11 : (nb, nb) lower triangle; a_panel : (nb, n); b_left : (m, nb)
    for ``form="lu"``, ``None`` (and m == n) for ``form="syrk"``; c :
    (m, n). Any strides. A batch gives every operand a leading (B,) axis
    and is still one launch. ``row_block`` (the chain plan's block) is
    recorded beside the launch's :func:`trsm_gemm_plan` (either route) and
    its grid (the card).
    Returns (x (nb, n), c_out (m, n)) (with the batch axis for a batch),
    both new contiguous tensors.
    """
    if form not in ("lu", "syrk"):
        raise ValueError(f"unknown trsm+gemm form {form!r}; "
                         f"expected 'lu' or 'syrk'")
    nb, n, m = l11.shape[-1], a_panel.shape[-1], c.shape[-2]
    operands = [l11, a_panel, c] + ([] if b_left is None else [b_left])
    lead = tuple(c.shape[:-2])           # () or the batch, (B,)
    if c.ndim not in (2, 3) or any(t.ndim != c.ndim for t in operands) \
            or l11.shape != (*lead, nb, nb) \
            or a_panel.shape != (*lead, nb, n):
        raise ValueError(f"trsm_gemm shapes: l11 {tuple(l11.shape)}, "
                         f"a_panel {tuple(a_panel.shape)}, c {tuple(c.shape)}")
    if form == "syrk" and (b_left is not None or m != n):
        raise ValueError("form='syrk' takes b_left=None and a square c")
    if form == "lu" and (b_left is None or b_left.shape != (*lead, m, nb)):
        raise ValueError(f"form='lu' needs b_left of shape "
                         f"{(*lead, m, nb)}")
    if any(t.dtype != c.dtype or t.device != c.device for t in operands) \
            or c.dtype not in DTYPE_CODES:
        raise ValueError("trsm_gemm operands must share one device and one "
                         f"of {tuple(DTYPE_CODES)}")
    if c.device.type not in ("cpu", "cuda"):
        raise ValueError(f"trsm_gemm runs on cuda or cpu, not {c.device}")
    if n == 0 or 0 in lead:
        return (torch.empty((*lead, nb, n), dtype=c.dtype, device=c.device),
                torch.empty((*lead, m, n), dtype=c.dtype, device=c.device))
    batch = lead[0] if lead else 1
    batched = batch > 1
    plan = (trsm_gemm_batched_plan if batched else trsm_gemm_plan)(
        c.dtype, nb, form)
    trsm_gemm.last_launch = {"row_block": row_block, "form": form,
                             "device": c.device.type, "plan": plan,
                             "batch": lead[0] if lead else None}
    if c.device.type == "cpu":
        return trsm_gemm_plain(l11, a_panel, b_left, c, form, unit_diag)
    recording = _rec.active()
    fake = recording and _rec.is_fake(c)
    ptr = _rec.address if fake else torch.Tensor.data_ptr
    acc = accumulator_dtype(c.dtype)
    pad = lambda v: -(-v // _TRSM_PAD) * _TRSM_PAD
    x = torch.empty((*lead, nb, n), dtype=c.dtype, device=c.device)
    c_out = torch.empty((*lead, m, n), dtype=c.dtype, device=c.device)
    xw = torch.empty((*lead, plan.nb_padded, pad(n)), dtype=acc,
                     device=c.device)
    blt = torch.empty((*lead, plan.nb_padded, pad(m)), dtype=acc,
                      device=c.device) \
        if form == "lu" and m and not batched else None
    # the batched kernel's ticket and per-item solve counts, zeroed (one
    # fill launch)
    sync = torch.zeros(1 + batch, dtype=torch.int32, device=c.device) \
        if batched else None
    bl = c if b_left is None else b_left             # unread when syrk
    ops = (l11, a_panel, bl, c, x, c_out, xw, blt, sync)
    if fake:
        grid = trsm_gemm_grid(co_resident_ctas(
            c.dtype, plan.smem_bytes, _rec.h100().pe.sm_count,
            plan if batched else None), plan, m, n, form, batch)
        trsm_gemm.last_launch["grid"] = grid
        _trsm_record(_trsm_args(plan, form, unit_diag, ops, grid, ptr, None),
                     plan, grid, (l11, a_panel, b_left, c), True)
        return x, c_out
    lib = _build.library("trsm_gemm")
    with torch.cuda.device(c.device):
        grid = trsm_gemm_grid(_trsm_co_resident(lib, c.device, c.dtype,
                                                plan, batched),
                              plan, m, n, form, batch)
        trsm_gemm.last_launch["grid"] = grid
        call = _trsm_args(plan, form, unit_diag, ops, grid, ptr,
                          torch.cuda.current_stream().cuda_stream)
        err = lib.repro_trsm_gemm(*call)
    _build.check(err, "repro_trsm_gemm")
    trsm_gemm.launches += 1
    if recording:
        _trsm_record(call, plan, grid, (l11, a_panel, b_left, c), False)
    return x, c_out


def _trsm_args(plan, form, unit_diag, ops, grid, ptr, stream) -> tuple:
    """The C call's arguments of one :func:`trsm_gemm` launch (``ops``:
    L11, the panel, B_left, C, then the outputs and scratch; ``ptr`` reads
    each one's address); the batch (1 for 2-D operands) and the inputs'
    batch strides go in ``long long`` slots, the batched kernel's ``sync``
    workspace (None for one item) last before the stream."""
    l11, a_panel, bl, c, x, c_out, xw, blt, sync = ops
    return (DTYPE_CODES[c.dtype], int(form == "syrk"), int(unit_diag),
            ptr(l11), l11.stride(-2), l11.stride(-1),
            ptr(a_panel), a_panel.stride(-2), a_panel.stride(-1),
            ptr(bl), bl.stride(-2), bl.stride(-1),
            ptr(c), c.stride(-2), c.stride(-1),
            ptr(x), ptr(c_out), ptr(xw),
            None if blt is None else ptr(blt), l11.shape[-1], c.shape[-2],
            c.shape[-1], plan.width, int(plan.l_in_smem), plan.smem_bytes,
            grid, c.shape[0] if c.ndim == 3 else 1,
            *(batch_stride(t) for t in (l11, a_panel, bl, c)),
            None if sync is None else ptr(sync), stream)


def _trsm_record(call, plan, grid, operands, fake):
    batched = operands[-1].ndim == 3 and operands[-1].shape[0] > 1
    _rec.emit(__name__, "trsm_gemm", "trsm_gemm", "repro_trsm_gemm", call,
              variant=plan.update,
              tile=(TRSM_GEMM_BATCHED_TILE[plan.update] if batched
                    else TRSM_GEMM_TILE), grid=(grid,),
              smem_bytes=plan.smem_bytes,
              operands=[t for t in operands if t is not None], fake=fake)


trsm_gemm.launches = 0
trsm_gemm.last_launch = None
