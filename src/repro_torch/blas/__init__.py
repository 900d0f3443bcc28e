"""repro_torch.blas - BLAS level-1/2/3 cores and the deprecated
d-prefixed shims (port of ``repro.blas``); SUMMA ``pdgemm`` / ``pdtrsm``
on a mesh are :mod:`repro_torch.blas.distributed`. The public,
context-scoped front-end is :mod:`repro_torch.linalg`.
"""
from repro_torch.blas import level1, level2, level3
from repro_torch.blas.level1 import (asum, axpy, dasum, daxpy, ddot, dnrm2,
                                     dot, drot, dscal, iamax, idamax, nrm2,
                                     rot, scal)
from repro_torch.blas.level2 import dgemv, dger, dtrsv, gemv, ger, trsv
from repro_torch.blas.level3 import dgemm, dsyrk, dtrsm, gemm, syrk, trsm
from repro_torch.blas import distributed
from repro_torch.blas.distributed import (make_blas_mesh, mesh_key, pdgemm,
                                          pdtrsm)
