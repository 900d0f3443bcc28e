"""Workload characterization of BLAS and LAPACK (paper section 4; port of
``repro.core.characterization``).

For each routine the paper characterizes, this module produces the parameters
the analytical model of :mod:`repro_torch.core.pipeline_model` needs, per
floating-point operation class K = {mul, add, sqrt, div}:

  * ``N_iI`` - instruction count issued to pipe ``i``,
  * ``N_iH`` - dependency-hazard count seen by pipe ``i``,
  * ``gamma_i`` - mean exposed fraction of the pipe delay per hazard.

The counts are *symbolic* (closed-form in the problem size), mirroring the
paper's DAG arguments:

  ddot(n)      n muls, all independent (N_HM = 0); n-1 adds. With a tree
               schedule the adds form ceil(log2 n) dependent levels; with the
               naive sequential accumulation every add depends on the previous
               one (N_HA = n-2 back-to-back dependences). Both schedules are
               exposed - the schedule is exactly the knob the TPU adaptation
               turns (accumulator count U interpolates between them).
  dgemv(m,n)   m inner products of length n.
  dgemm(m,n,k) m*n inner products of length k; the paper notes compiler
               optimizations (register blocking / unrolling) reduce the
               dependency hazards -> we model an unroll factor ``u`` that
               divides the add-chain hazards.
  dgeqrf(n)    Householder QR: ~4/3 n^3 mul+add (GEMM-dominated trailing
               update), O(n^2) div, O(n) sqrt on the critical panel path; the
               sqrt/div streams are serial (hazard ratio ~ 1).
  dgetrf(n)    LU with partial pivoting: ~1/3 n^3 muls and adds, n(n-1)/2 divs
               (column scaling, serial per column step), no sqrt.
  dpotrf(n)    Cholesky: ~1/6 n^3 mul+add, n(n+1)/2 div, n sqrt, serial
               sqrt/div chain (every step waits on the diagonal sqrt).

These feed (a) the optimum-pipeline-depth solver (eq. 7), (b) the PE
instruction-stream compilers in :mod:`repro_torch.core.isa` (which realize
the same DAGs literally, so the symbolic counts are testable against the
enumerated streams), and (c) the codesign layer.

Pure host arithmetic: the counts are Python floats, the eq.-7 optima come
from :mod:`repro_torch.core.pipeline_model` (torch tensors, read back as
Python numbers), equal to the reference's (``tests/test_torch_characterization.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch import arch as _arch
from repro_torch.arch import FPUSpec
from repro_torch.core.pipeline_model import (OP_CLASSES, PipeParams, p_opt,
                                             p_opt_int)

# Default technology constants (relative units) = the "paper-pe" machine's
# FPUSpec.  t_p is the latch-free logic delay of each unit; double-precision
# div/sqrt logic is much deeper than mul/add (iterative units); t_o is
# per-stage latch overhead. Values follow the FO4-style ratios used by
# Hartstein-Puzak [19]. Every characterize_* function takes ``fpu=`` (an
# :class:`repro_torch.arch.FPUSpec`) to characterize against a different machine.
_PAPER_FPU = _arch.get("paper-pe").fpu
T_O = _PAPER_FPU.t_o            # latch overhead (FO4)
T_P = dict(_PAPER_FPU.t_p)


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """Per-op-class (N_iI, N_iH, gamma_i) census of one routine instance."""

    name: str
    pipes: Dict[str, PipeParams]
    flops: float                      # useful FLOPs of the routine
    critical_path: float              # dependent-op chain length (for info)

    def optimal_depths(self, p_min: int = 1, p_max: int = 64) -> Dict[str, int]:
        """Integer optimal depth per pipe via direct eq.-2 evaluation."""
        out = {}
        for k, pp in self.pipes.items():
            if pp.n_i <= 0:
                continue
            out[k] = p_opt_int(pp, p_min=p_min, p_max=p_max)
        return out

    def popt_closed_form(self) -> Dict[str, float]:
        """Closed-form eq.-7 optimum per pipe (inf where hazard-free)."""
        return {
            k: float(
                p_opt(n_i=pp.n_i, n_h=pp.n_h, gamma=pp.gamma, t_p=pp.t_p, t_o=pp.t_o)
            )
            for k, pp in self.pipes.items()
            if pp.n_i > 0
        }

    def hazard_ratios(self) -> Dict[str, float]:
        return {
            k: (pp.n_h / pp.n_i if pp.n_i else 0.0) for k, pp in self.pipes.items()
        }


def _pipes(nm=0, hm=0, na=0, ha=0, nd=0, hd=0, ns=0, hs=0, gamma=0.5,
           fpu: FPUSpec = None) -> Dict[str, PipeParams]:
    """Per-class PipeParams at a census; ``fpu`` supplies the technology
    constants (t_p / t_o), defaulting to the paper-pe spec."""
    f = fpu if fpu is not None else _PAPER_FPU
    g = gamma if isinstance(gamma, dict) else {k: gamma for k in OP_CLASSES}
    return {
        k: PipeParams(n_i=n, n_h=h, gamma=g[k], t_p=f.t_p[k], t_o=f.t_o)
        for k, n, h in (("mul", nm, hm), ("add", na, ha),
                        ("div", nd, hd), ("sqrt", ns, hs))
    }


# ---------------------------------------------------------------------------
# BLAS level 1-3 (paper section 4.1)
# ---------------------------------------------------------------------------

def characterize_ddot(n: int, schedule: str = "tree", accumulators: int = 1,
                      fpu: FPUSpec = None) -> WorkloadProfile:
    """Inner product of two n-vectors (paper fig. 5).

    muls: n, all independent -> N_HM = 0 ("considering only dependency
    hazards, there will be no hazards in the multiplier pipeline").
    adds: n-1.  ``schedule``:
      * 'tree'       - balanced reduction: hazards only along the ceil(log2 n)
                       levels whose operands are produced by the level below.
      * 'sequential' - single running sum: every add waits on the previous one.
      * 'strided'    - ``accumulators`` parallel partial sums (the TPU/codesign
                       schedule): the serial chain shrinks by the accumulator
                       count; a final tree of size U combines the partials.
    """
    if n < 2:
        raise ValueError("n >= 2 required")
    n_mul, n_add = n, n - 1
    if schedule == "tree":
        # at each tree level every add consumes results of the previous level;
        # the *stall-relevant* dependences are one per level transition per op
        # stream position -> hazards ~= number of adds whose operands were
        # produced fewer than `depth` issue slots earlier. For the in-order
        # scalar PE this is the adds of all levels above the first.
        h_add = max(n_add - _ceil_div(n, 2), 0)          # adds not in level 0
        crit = math.ceil(math.log2(n)) + 1               # mul + add tree
    elif schedule == "sequential":
        h_add = max(n_add - 1, 0)
        crit = 1 + n_add
    elif schedule == "strided":
        u = max(int(accumulators), 1)
        per_chain = _ceil_div(n, u) - 1                   # adds per partial sum
        h_add = max(u * max(per_chain - 1, 0), 0) + max(u - 1, 0)
        crit = 1 + per_chain + math.ceil(math.log2(max(u, 2)))
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    pipes = _pipes(nm=n_mul, hm=0, na=n_add, ha=h_add, fpu=fpu)
    return WorkloadProfile("ddot", pipes, flops=2.0 * n - 1, critical_path=crit)


def characterize_dgemv(m: int, n: int, schedule: str = "tree", accumulators: int = 1,
                       fpu: FPUSpec = None) -> WorkloadProfile:
    """y = A x, A m-by-n: m independent inner products of length n.

    Independent rows interleave freely, so the *effective* hazard count per
    row is divided by the number of rows that fit in the issue window; the
    paper models this as the compiler-driven hazard reduction. We keep the
    conservative per-row census and expose interleaving via `accumulators`.
    """
    row = characterize_ddot(n, schedule=schedule, accumulators=accumulators,
                            fpu=fpu)
    pipes = {
        k: dataclasses.replace(pp, n_i=pp.n_i * m, n_h=pp.n_h * m)
        for k, pp in row.pipes.items()
    }
    return WorkloadProfile("dgemv", pipes, flops=m * (2.0 * n - 1), critical_path=row.critical_path)


def characterize_dgemm(m: int, n: int, k: int, unroll: int = 4,
                       fpu: FPUSpec = None) -> WorkloadProfile:
    """C = A B: m*n inner products of length k (paper eq. 10).

    "due to compiler optimizations the dependency hazards reduce" [23]: with
    register blocking of ``unroll`` independent C elements in flight, only a
    1/unroll fraction of the add-chain dependences can stall the adder pipe.
    """
    n_mul = m * n * k
    n_add = m * n * (k - 1)
    base_h = m * n * max(k - 2, 0)          # sequential chains per C element
    h_add = base_h / max(unroll, 1)
    pipes = _pipes(nm=n_mul, hm=0, na=n_add, ha=h_add, fpu=fpu)
    return WorkloadProfile("dgemm", pipes, flops=2.0 * m * n * k, critical_path=1 + (k - 1))


# ---------------------------------------------------------------------------
# LAPACK (paper section 4.2)
# ---------------------------------------------------------------------------

def characterize_dgeqrf(n: int, unroll: int = 4,
                        fpu: FPUSpec = None) -> WorkloadProfile:
    """Householder QR of an n-by-n matrix (DGEQRF).

    Counts (standard, e.g. Golub & Van Loan):
      mul/add ~ 4/3 n^3 (dominated by trailing-matrix GEMM updates),
      div ~ n^2/2 (vector scaling per panel column), sqrt ~ 2n (column norm +
      Householder beta per column).  The panel path is serial: every column's
      sqrt depends on the norm reduction, every scale div depends on the sqrt
      -> hazard ratio ~1 for sqrt and high for div (paper: "There is always
      dependency in the square root operation that stalls the program
      execution. The ratios N_HD/N_ID and N_HS/N_IS are observed to be high").
    """
    nf = float(n)
    n_mul = (4.0 / 3.0) * nf**3
    n_add = (4.0 / 3.0) * nf**3
    n_div = nf * nf / 2.0
    n_sqrt = 2.0 * nf
    h_add = (n_mul - n_add / 2) / max(unroll, 1) * 0.5   # GEMM-like chains
    h_div = 0.8 * n_div                                   # panel-serial
    h_sqrt = max(n_sqrt - 1.0, 0.0)                       # fully serial
    pipes = _pipes(nm=n_mul, hm=0, na=n_add, ha=h_add, nd=n_div, hd=h_div,
                   ns=n_sqrt, hs=h_sqrt,
                   gamma=dict((fpu or _PAPER_FPU).gamma), fpu=fpu)
    return WorkloadProfile("dgeqrf", pipes, flops=(4.0 / 3.0) * nf**3,
                           critical_path=3.0 * nf)


def characterize_dgetrf(n: int, unroll: int = 4,
                        fpu: FPUSpec = None) -> WorkloadProfile:
    """LU with partial pivoting (DGETRF): ~n^3/3 mul+add, n(n-1)/2 serial divs.

    "the occurrence of division instruction in the program is similar to the
    square root/divider in the QR factorization" - same hazard structure for
    the divider, no sqrt pipe.
    """
    nf = float(n)
    n_mul = nf**3 / 3.0
    n_add = nf**3 / 3.0
    n_div = nf * (nf - 1) / 2.0
    h_add = n_add * 0.5 / max(unroll, 1)
    h_div = 0.8 * n_div
    pipes = _pipes(nm=n_mul, hm=0, na=n_add, ha=h_add, nd=n_div, hd=h_div,
                   gamma=dict((fpu or _PAPER_FPU).gamma), fpu=fpu)
    return WorkloadProfile("dgetrf", pipes, flops=(2.0 / 3.0) * nf**3,
                           critical_path=2.0 * nf)


def characterize_dpotrf(n: int, unroll: int = 4,
                        fpu: FPUSpec = None) -> WorkloadProfile:
    """Cholesky (DPOTRF): ~n^3/6 mul+add, n(n+1)/2 div, n serial sqrts."""
    nf = float(n)
    n_mul = nf**3 / 6.0
    n_add = nf**3 / 6.0
    n_div = nf * (nf + 1) / 2.0
    n_sqrt = nf
    pipes = _pipes(nm=n_mul, hm=0, na=n_add, ha=n_add * 0.5 / max(unroll, 1),
                   nd=n_div, hd=0.8 * n_div, ns=n_sqrt, hs=max(n_sqrt - 1, 0),
                   gamma=dict((fpu or _PAPER_FPU).gamma), fpu=fpu)
    return WorkloadProfile("dpotrf", pipes, flops=nf**3 / 3.0, critical_path=2.0 * nf)


ROUTINES = {
    "ddot": characterize_ddot,
    "dgemv": characterize_dgemv,
    "dgemm": characterize_dgemm,
    "dgeqrf": characterize_dgeqrf,
    "dgetrf": characterize_dgetrf,
    "dpotrf": characterize_dpotrf,
}


def characterization_table(n: int = 100) -> Dict[str, Dict[str, float]]:
    """The paper's section-4 summary: hazard ratios + optimal depths per routine."""
    profiles = {
        "ddot": characterize_ddot(n * n),
        "dgemv": characterize_dgemv(n, n),
        "dgemm": characterize_dgemm(n, n, n),
        "dgeqrf": characterize_dgeqrf(n),
        "dgetrf": characterize_dgetrf(n),
        "dpotrf": characterize_dpotrf(n),
    }
    table = {}
    for name, prof in profiles.items():
        row: Dict[str, float] = {}
        ratios = prof.hazard_ratios()
        depths = prof.optimal_depths()
        for k in OP_CLASSES:
            row[f"NH/NI_{k}"] = ratios.get(k, 0.0)
            row[f"popt_{k}"] = float(depths.get(k, float("nan")))
        table[name] = row
    return table


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)
