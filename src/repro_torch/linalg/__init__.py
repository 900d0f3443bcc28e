"""repro_torch.linalg - the dtype-generic, context-scoped front-end.

Port of ``repro.linalg``: one set of routine names (``gemm``, ``gemv``,
``syrk``, ``trsm``, ``axpy``, ``dot``, ..., ``cholesky``, ``lu``,
``qr``, ``solve``, ``lstsq`` and their batched forms) over float32 /
float64 (bfloat16 storage on the GEMM paths). The execution - policy,
registry, accumulation dtype, machine, device - is carried by a scoped
:class:`ExecutionContext`::

    from repro_torch import linalg

    with linalg.use(policy="model"):       # kernels on the card (default)
        c = linalg.gemm(a, b)              # numpy in, cuda tensor out
        q, r = linalg.qr(a)
        res = linalg.batched_cholesky(spd_batch)
        x = linalg.batched_solve(res, rhs)

    with linalg.use(device="cpu", policy="model"):
        c = linalg.gemm(a, b)              # the kernels' plain versions

    # every rank of a torch.distributed process group of 4 ranks:
    with linalg.use(policy="model", mesh=(2, 2)):
        c = linalg.gemm(a, b)              # SUMMA pdgemm, the global C
        res = linalg.batched_cholesky(spd_batch)   # batch-sharded

The old d-prefixed routines (``repro_torch.blas.dgemm``, ...) survive as
warn-once shims that forward here.
"""
from repro_torch.lapack.batched import FactorizationResult
from repro_torch.linalg.blas import (asum, axpy, dot, gemm, gemm_bias_act,
                                     gemv, ger, iamax, nrm2, rot, scal, syrk,
                                     trsm, trsv)
from repro_torch.linalg.context import (UNSET, ExecutionContext, get_context,
                                        reset_context, set_context, use)
from repro_torch.linalg.lapack import (batched_cholesky, batched_lu,
                                       batched_qr, batched_solve, cholesky,
                                       lstsq, lu, qr, solve)

__all__ = [
    # context machinery
    "ExecutionContext", "use", "get_context", "set_context", "reset_context",
    # BLAS level 1
    "axpy", "dot", "scal", "nrm2", "asum", "iamax", "rot",
    # BLAS level 2
    "gemv", "ger", "trsv",
    # BLAS level 3
    "gemm", "gemm_bias_act", "syrk", "trsm",
    # LAPACK
    "cholesky", "lu", "qr", "solve", "lstsq",
    # batched LAPACK
    "batched_cholesky", "batched_lu", "batched_qr", "batched_solve",
    "FactorizationResult",
]
