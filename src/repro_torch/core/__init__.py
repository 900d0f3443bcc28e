"""repro_torch.core - the paper's contribution (port of ``repro.core``).

Analytical pipeline-depth model (eqs 1-7), BLAS/LAPACK workload
characterization, the instruction streams and the configurable-depth PE
simulator (its scoreboard a card kernel), the synthesis model (Tables 1-2),
the op-class census over aten graphs, and the codesign planners.
``roofline`` (with ``Roofline``, ``collective_bytes``, ``from_compiled``)
reads an XLA-compiled step and waits for ``launch/dryrun`` (ROADMAP.md
A.11).
"""
from repro_torch.core import characterization, codesign, fx_census, isa, pe
from repro_torch.core import pipeline_model, synthesis
from repro_torch.core.characterization import (WorkloadProfile,
                                               characterize_ddot,
                                               characterize_dgemm,
                                               characterize_dgemv,
                                               characterize_dgeqrf,
                                               characterize_dgetrf,
                                               characterize_dpotrf)
from repro_torch.core.codesign import (optimal_accumulators, plan_attention,
                                       plan_gemm, plan_ssd)
from repro_torch.core.fx_census import census_of
from repro_torch.core.pipeline_model import PipeParams, p_opt, p_opt_int, tpi
