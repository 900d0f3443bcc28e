"""repro_torch.analysis - static verification of the port's linalg stack
(port of ``repro.analysis``).

The paper's core claim is that performance (and correctness hazards) are
readable off static structure; this package holds the port to its own half
of that bargain. ``check`` traces any routine from the
``repro_torch.linalg`` surface on fake tensors with ``make_fx`` - no
execution, no card needed - and verifies the frozen rule vocabulary over
the result:

======  =====================  ========================================
family  rules                  contract
======  =====================  ========================================
KL      KL001 KL002 KL003      kernel launch records: tiles the variant
        KL004                  is compiled for and its layout
                               condition, shared memory within the
                               card's budget (and the FusedChainPlan
                               veto), c_int arguments within 32 bits,
                               zero-dim operands on the plain route
DF      DF001 DF002 DF003      dtype flow over the aten graph: no
        DF004                  silent f64, f64 accumulators for f64
                               operands, no narrowing round-trips, no
                               host reads or device-to-host copies
CM      CM001 CM002 CM003      cost-model drift: span flops/bytes
                               annotations vs fx_census counts within
                               declared tolerance; trace stability
CC      CC001 CC002 CC003      collective schedules on the mesh: each
                               ring assembled from what the ranks did
                               is one bijective cycle; ring hop counts
                               are size - 1 and match the loops and
                               the obs counters; bytes sent agree with
                               the counters and plan_pdgemm's term
SH      SH001 SH002 SH003      sharding discipline: recorded operand
                               partitions consistent with shapes and
                               mesh; ragged batches identity-padded to
                               rank-count multiples; no gathers inside
                               a mesh routine's body
BY      BY001                  dispatcher bypass: raw mm/bmm/addmm/
                               baddbmm/convolution and B5/B6 launches
                               reachable from models, kernels, or
                               serving that never pass
                               tune.dispatch.resolve - burn-down
                               allowlisted, new sites fail the sweep
======  =====================  ========================================

Typical use::

    from repro_torch import analysis, linalg

    rep = analysis.check(linalg.gemm, a, b)     # the card route, no card
    assert rep.ok, rep.summary()

    with linalg.use(device="cpu"):              # the plain route
        rep = analysis.check(linalg.qr, a)

    rep = analysis.check_surface()              # the acceptance grid
    rep.save("analysis_report.json")

    with analysis.allow("CM002", routine="qr"):  # scoped suppression
        rep = analysis.check(linalg.qr, a)

``python -m repro_torch.analysis`` sweeps the surface (and the mesh legs
on spawned ranks) and exits non-zero on any unsuppressed ``error``. Where
the port's analyzer differs from the reference's, and why, is in the
modules' notes: fake-card launch records in place of ``pallas_call``
equations, no x64 mode, the CC / SH rules on run-time records, the
result gather not an SH003 finding, and the stand-in value at a host read.
"""
from repro_torch.analysis.bypass_lint import (collect_bypass_sites,
                                              lint_bypass,
                                              load_bypass_allowlist)
from repro_torch.analysis.report import (AnalysisReport, check,
                                         check_distributed, check_routine,
                                         check_surface, merge_reports,
                                         surface_routines)
from repro_torch.analysis.rules import (RULES, Allowlist, Finding, allow,
                                        load_allowlist)

__all__ = [
    "RULES", "Finding", "AnalysisReport",
    "check", "check_routine", "check_surface", "check_distributed",
    "surface_routines", "merge_reports", "allow", "Allowlist",
    "load_allowlist",
    "lint_bypass", "collect_bypass_sites", "load_bypass_allowlist",
]
