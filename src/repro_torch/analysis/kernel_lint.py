"""Kernel-launch lint (rules KL001-KL004) over launch records and recorded
dispatch resolutions (port of ``repro.analysis.kernel_lint``).

Two views of the same launch contract, as in the reference:

* **launch view** - the record every kernel wrapper writes of a launch,
  real on the card or fake in the analyzer's trace
  (:mod:`repro_torch.kernels.launch_record`), the counterpart of a traced
  ``pallas_call`` equation: the CTA tile must be one the variant is
  compiled for and the operands must meet the variant's layout condition
  (KL001), the dynamic shared memory must fit the card's per-CTA budget
  (KL002), every value passed through a ``c_int`` slot must fit 32 bits
  (KL003: the card's form of the reference's 64-bit index crash), and no
  launch may see a zero-sized operand or grid (KL004).
* **plan view** - :func:`repro_torch.tune.dispatch.record_resolutions`
  captures every Resolution a call produced; the resolved GemmPlan tiles
  and fused-chain verdicts are checked against the ambient machine's
  budget before any kernel exists, which catches a poisoned registry entry
  (e.g. a hand-edited ``bm``) the kernels would run.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.analysis.rules import Finding, make_finding

INT32 = (-2 ** 31, 2 ** 31 - 1)


def operand_tensor(op) -> torch.Tensor:
    """A ``meta`` tensor of a record's operand (shape, dtype, strides,
    address mod 16): its ``data_ptr()`` is the recorded address, so the
    wrappers' own layout predicates can judge it."""
    shape, dtype, strides, align = op
    dt = getattr(torch, dtype)
    offset = align // dt.itemsize
    span = offset + 1 + sum((size - 1) * st
                            for size, st in zip(shape, strides) if size)
    return torch.empty(span, dtype=dt, device="meta").as_strided(
        shape, strides, offset)


def _layout_refusal(rec: Dict) -> Optional[str]:
    """Why ``rec``'s tile or operands do not fit its variant, or None: the
    tile against those the variant is compiled for, the operands through
    the variant choice the wrapper makes (``gemm_variant``,
    ``attention_variant``)."""
    from repro_torch.core.codesign import TRSM_GEMM_TILE
    from repro_torch.kernels import flash_attention as _fa
    from repro_torch.kernels.gemm import TILE_SETS, gemm_variant
    kernel, variant, tile = rec["kernel"], rec["variant"], rec["tile"]
    ops = rec["operands"]
    if kernel in ("gemm", "gemm_bias_act"):
        if tile not in TILE_SETS.get(variant, ()):
            return (f"CTA tile {tile} is not one {variant!r} is compiled "
                    f"for ({TILE_SETS.get(variant, ())})")
        chosen = gemm_variant(*(operand_tensor(o) for o in ops[:2]))
        if variant != "simt" and chosen != variant:
            return (f"operands A {ops[0][0]} strides {ops[0][2]} (address "
                    f"mod 16 {ops[0][3]}), B {ops[1][0]} strides "
                    f"{ops[1][2]} (address mod 16 {ops[1][3]}) take "
                    f"{chosen!r}, not {variant!r}")
    elif kernel == "trsm_gemm":
        from repro_torch.kernels.fused import TRSM_GEMM_BATCHED_TILE
        batched = len(ops[-1][0]) == 3 and ops[-1][0][0] > 1
        want = TRSM_GEMM_BATCHED_TILE[variant] if batched else TRSM_GEMM_TILE
        if tuple(tile) != tuple(want):
            return f"CTA tile {tile} is not B2's {tuple(want)}"
    elif kernel == "attention":
        d = ops[0][0][3]
        if tuple(tile) != tuple(_fa.tile(variant, d)):
            return (f"CTA tile {tile} is not {variant!r}'s "
                    f"{_fa.tile(variant, d)} at head dim {d}")
        if variant == "wgmma" and _fa.attention_variant(
                *(operand_tensor(o) for o in ops[:3])) != "wgmma":
            return (f"'wgmma' needs bf16 q / k / v TMA can read with a head "
                    f"dim <= {_fa.MAX_TC_HEAD_DIM} (a multiple of 8)")
    return None


def lint_launch(rec: Dict, routine: Optional[str] = None) -> List[Finding]:
    """KL001 / KL002 / KL003 / KL004 for one launch record; shared memory
    against the card's budget (``h100``, whatever machine priced the
    plan)."""
    from repro_torch.kernels.launch_record import h100
    mach = h100()
    loc = rec.get("site")
    what = f"{rec['kernel']} ({rec['variant']})"
    findings: List[Finding] = []
    why = _layout_refusal(rec)
    if why is not None:
        findings.append(make_finding(
            "KL001", f"{what} launch: {why}", routine=routine, location=loc))
    budget = mach.memory.vmem_bytes
    smem = rec["smem_bytes"]
    for s in (smem if isinstance(smem, (tuple, list)) else (smem,)):
        if s > budget:
            findings.append(make_finding(
                "KL002", f"{what} launch asks {s} B of dynamic shared "
                f"memory per CTA; the budget is {budget} B ({mach.name})",
                routine=routine, location=loc))
    wide = [v for v in rec["ints"] if not INT32[0] <= v <= INT32[1]]
    if wide:
        findings.append(make_finding(
            "KL003", f"{what} launch passes {wide} through c_int slots of "
            f"{rec['entry']} (outside 32 bits)", routine=routine,
            location=loc))
    grids = rec["grid"]
    grids = grids if grids and isinstance(grids[0], (tuple, list)) \
        else (grids,)
    if any(g == 0 for grid in grids for g in grid):
        findings.append(make_finding(
            "KL004", f"{what} launch with a zero-length grid {rec['grid']} "
            "(empty operand reached the kernel path)", routine=routine,
            location=loc))
    zero = [o[0] for o in rec["operands"] if 0 in o[0]]
    if zero:
        findings.append(make_finding(
            "KL004", f"{what} launch with zero-sized operand(s) {zero}",
            routine=routine, location=loc))
    return findings


def lint_kernel_launches(launches: Sequence[Dict],
                         routine: Optional[str] = None,
                         zero_dim_inputs: bool = False) -> List[Finding]:
    """Every launch record of a trace; with ``zero_dim_inputs`` any launch
    at all is a KL004 (the routine must have taken the plain route)."""
    findings: List[Finding] = []
    for rec in launches:
        if zero_dim_inputs:
            findings.append(make_finding(
                "KL004", f"{rec['kernel']} launch reached with a zero-dim "
                "operand (must route to the plain version)",
                routine=routine, location=rec.get("site")))
        findings.extend(lint_launch(rec, routine=routine))
    return findings


def lint_resolutions(resolutions: Sequence, machine,
                     routine: Optional[str] = None) -> List[Finding]:
    """KL001/KL002 over recorded dispatch Resolutions (the plan view)."""
    findings: List[Finding] = []
    sublane = machine.pe.sublane
    budget = machine.memory.vmem_bytes
    for res in resolutions:
        plan = getattr(res, "gemm_plan", None)
        if plan is not None:
            bad = [b for b in (plan.bm, plan.bn, plan.bk)
                   if b % sublane != 0]
            if bad:
                findings.append(make_finding(
                    "KL001", f"resolved {res.op} plan tile "
                    f"(bm={plan.bm}, bn={plan.bn}, bk={plan.bk}) not "
                    f"aligned to sublane {sublane} (source={res.source})",
                    routine=routine))
            if plan.vmem_bytes > budget:
                findings.append(make_finding(
                    "KL002", f"resolved {res.op} plan VMEM "
                    f"{plan.vmem_bytes} B exceeds budget {budget} B "
                    f"(source={res.source})", routine=routine))
        chain = getattr(res, "chain", None)
        if getattr(res, "fused", False) and chain is not None \
                and not chain.fits_vmem:
            findings.append(make_finding(
                "KL002", f"fused {res.op} chosen although the chain does "
                f"not fit VMEM ({chain.vmem_bytes} B)", routine=routine))
    return findings
