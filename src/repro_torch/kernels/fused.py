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
    few flops per output.

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
    ``vmap`` of the TPU kernel in the reference) is the same one launch,
    the item folded into both phases' task indices; item i is bitwise the
    launch on item i alone.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (:func:`gemm_bias_act_plain`, :func:`trsm_gemm_plain`)
for CPU tensors, with no other path. ``.launches`` counts kernel launches
on the card (the CPU route counts nothing); ``.last_launch`` records each
call on either route.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs as _obs
from repro_torch.core.codesign import (TRSM_GEMM_TILE, TRSM_GEMM_TT,
                                       TRSM_GEMM_WIDTHS, GemmPlan,
                                       trsm_gemm_footprint)
from repro_torch.kernels import _build
from repro_torch.kernels import launch_record as _rec
from repro_torch.kernels.gemm import (DTYPE_CODES, accumulator_dtype,
                                      batch_stride, check_operands,
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
    """Plain version: the epilogue on the accumulator-width product."""
    acc = accumulator_dtype(a.dtype)
    out = apply_epilogue(gemm_plain(a, b, acc), epilogue,
                         None if bias is None else bias.to(acc))
    return out.to(out_dtype or a.dtype)


def gemm_bias_act(a: torch.Tensor, b: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  epilogue: str = "none", plan: Optional[GemmPlan] = None,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = act(A @ B + bias) in one launch (CUDA) or its plain version
    (CPU). ``bias`` is a length-n vector of a's dtype; ``plan`` picks the
    CTA tile and is recorded beside the variant and the tile, as in B1
    (:func:`repro_torch.kernels.gemm.gemm`)."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; "
                         f"expected one of {EPILOGUES}")
    out_dtype = check_operands(a, b, out_dtype)
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"gemm_bias_act takes 2-D operands (no batch "
                         f"axis); got {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if bias is not None and (bias.shape != (n,) or bias.dtype != a.dtype
                             or bias.device != a.device):
        raise ValueError(f"bias must be ({n},) {a.dtype} on {a.device}; got "
                         f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")
    if plan is None:
        plan = default_plan(a, b)
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=out_dtype, device=a.device)
    variant = gemm_variant(a, b)
    tile = record_call(gemm_bias_act, plan, variant, a.device)
    if a.device.type == "cpu":
        return gemm_bias_act_plain(a, b, bias, epilogue, out_dtype)
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
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
    """CTAs of the cooperative launch: as many as fit on the card at once
    (``co_resident``), but no more than the larger phase has tasks (solve
    blocks plus BL transpose tiles, or C tiles) over the ``batch`` items;
    a larger batch costs more strides, never a refused launch."""
    pad = lambda v: -(-v // _TRSM_PAD) * _TRSM_PAD
    solve = pad(n) // plan.width
    if form == "lu":
        solve += -(-plan.nb_padded // TRSM_GEMM_TT) * (pad(m) // TRSM_GEMM_TT)
    bm, bn, _ = TRSM_GEMM_TILE
    update = -(-m // bm) * -(-n // bn)
    return max(1, min(co_resident, batch * max(solve, update)))


# registers per thread of csrc/trsm_gemm.cu's kernels (ptxas, sm_90a; the
# larger of the 2-D and the batched kernel's, whose fewer co-resident CTAs
# the query answers) and the H100 SM's limits the occupancy query applies:
# what co_resident_ctas, the query's Python counterpart, needs.
# chip_smoke.py's analysis phase holds it to the card's answer.
TRSM_GEMM_REGISTERS = {torch.float32: 128, torch.bfloat16: 128,
                       torch.float64: 254}
_SM_REGISTERS, _SM_SMEM, _SM_THREADS, _SM_CTAS = 65536, 233472, 2048, 32
_REG_UNIT, _SMEM_RESERVED, _TRSM_THREADS = 256, 1024, 256


def co_resident_ctas(dtype: torch.dtype, smem: int, sms: int) -> int:
    """CTAs of B2 that fit on an H100 of ``sms`` SMs at once with ``smem``
    bytes of dynamic shared memory: the occupancy query
    (``repro_trsm_gemm_co_resident``) in Python, bounded per SM by
    registers (allocated per warp in units of 256), shared memory (1 KB
    reserved per CTA), threads and 32 CTAs."""
    warp_regs = -(-TRSM_GEMM_REGISTERS[dtype] * 32 // _REG_UNIT) * _REG_UNIT
    warps = _TRSM_THREADS // 32
    per_sm = min(_SM_REGISTERS // (warp_regs * warps),
                 _SM_SMEM // (smem + _SMEM_RESERVED),
                 _SM_THREADS // _TRSM_THREADS, _SM_CTAS)
    return sms * per_sm


_co_resident = {}


def _trsm_co_resident(lib, device: torch.device, dtype: torch.dtype,
                      smem: int) -> int:
    """CTAs of B2 that fit on ``device`` at once (the occupancy query),
    cached per (device, dtype, smem); raises if the query failed."""
    key = (device.index, dtype, smem)
    if key not in _co_resident:
        got = lib.repro_trsm_gemm_co_resident(DTYPE_CODES[dtype], smem)
        if got < 1:
            raise RuntimeError(f"trsm_gemm: occupancy query gave {got} "
                               f"(smem {smem} bytes, {dtype})")
        _co_resident[key] = got
    return _co_resident[key]


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
    plan = trsm_gemm_plan(c.dtype, nb, form)
    batch = lead[0] if lead else 1
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
                      device=c.device) if form == "lu" and m else None
    bl = c if b_left is None else b_left             # unread when syrk
    ops = (l11, a_panel, bl, c, x, c_out, xw, blt)
    if fake:
        grid = trsm_gemm_grid(co_resident_ctas(
            c.dtype, plan.smem_bytes, _rec.h100().pe.sm_count),
            plan, m, n, form, batch)
        trsm_gemm.last_launch["grid"] = grid
        _trsm_record(_trsm_args(plan, form, unit_diag, ops, grid, ptr, None),
                     plan, grid, (l11, a_panel, b_left, c), True)
        return x, c_out
    lib = _build.library("trsm_gemm")
    with torch.cuda.device(c.device):
        grid = trsm_gemm_grid(_trsm_co_resident(lib, c.device, c.dtype,
                                                plan.smem_bytes),
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
    batch strides go in ``long long`` slots."""
    l11, a_panel, bl, c, x, c_out, xw, blt = ops
    return (DTYPE_CODES[c.dtype], int(form == "syrk"), int(unit_diag),
            ptr(l11), l11.stride(-2), l11.stride(-1),
            ptr(a_panel), a_panel.stride(-2), a_panel.stride(-1),
            ptr(bl), bl.stride(-2), bl.stride(-1),
            ptr(c), c.stride(-2), c.stride(-1),
            ptr(x), ptr(c_out), ptr(xw),
            None if blt is None else ptr(blt), l11.shape[-1], c.shape[-2],
            c.shape[-1], plan.width, int(plan.l_in_smem), plan.smem_bytes,
            grid, c.shape[0] if c.ndim == 3 else 1,
            *(batch_stride(t) for t in (l11, a_panel, bl, c)), stream)


def _trsm_record(call, plan, grid, operands, fake):
    _rec.emit(__name__, "trsm_gemm", "trsm_gemm", "repro_trsm_gemm", call,
              variant=plan.update, tile=TRSM_GEMM_TILE, grid=(grid,),
              smem_bytes=plan.smem_bytes,
              operands=[t for t in operands if t is not None], fake=fake)


trsm_gemm.launches = 0
trsm_gemm.last_launch = None
