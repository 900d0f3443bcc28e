"""repro_torch.core - the paper's contribution (port of ``repro.core``).

Analytical pipeline-depth model (eqs 1-7), BLAS/LAPACK workload
characterization, the instruction streams and the configurable-depth PE
simulator (its scoreboard a card kernel), the synthesis model (Tables 1-2),
the op-class census over aten graphs, and the codesign planners.
The dry run is ported (``repro_torch.launch.dryrun``): ``aten_cost``
prices a traced step's aten ops (the counterpart of ``hlo_cost``) and
``roofline`` turns the counts into the reference's rows (``Roofline``,
``from_trace`` in place of ``from_compiled``, ``collective_bytes``).
"""
from repro_torch.core import aten_cost, characterization, codesign
from repro_torch.core import fx_census, isa, pe, pipeline_model, roofline
from repro_torch.core import synthesis
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
from repro_torch.core.roofline import Roofline, collective_bytes, from_trace
