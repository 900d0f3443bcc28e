"""repro_torch.linalg - the dtype-generic, context-scoped front-end.

Port of ``repro.linalg`` for BLAS levels 2-3 and the Cholesky/LU/solve
drivers. The execution - policy, registry, accumulation dtype, machine,
device - is carried by a scoped :class:`ExecutionContext`::

    from repro_torch import linalg

    with linalg.use(policy="model"):       # kernels on the card (default)
        c = linalg.gemm(a, b)              # numpy in, cuda tensor out
        l = linalg.cholesky(spd)

    with linalg.use(device="cpu", policy="model"):
        c = linalg.gemm(a, b)              # the kernels' plain versions

Level 1, QR/least squares, the batched drivers, the mesh routes and the
d-prefixed shims are later work.
"""
from repro_torch.linalg.blas import (gemm, gemm_bias_act, gemv, ger, syrk,
                                     trsm, trsv)
from repro_torch.linalg.context import (UNSET, ExecutionContext, get_context,
                                        reset_context, set_context, use)
from repro_torch.linalg.lapack import cholesky, lu, solve

__all__ = [
    "ExecutionContext", "use", "get_context", "set_context", "reset_context",
    "gemv", "ger", "trsv",
    "gemm", "gemm_bias_act", "syrk", "trsm",
    "cholesky", "lu", "solve",
]
