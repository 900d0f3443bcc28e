"""repro_torch.lapack - blocked Cholesky, LU and QR, the solves on them,
and the batched drivers (port of ``repro.lapack``); their batch-sharded
forms on a mesh are :mod:`repro_torch.lapack.distributed`."""
from repro_torch.lapack import batched, cholesky, lu, qr, solve
from repro_torch.lapack.batched import (FactorizationResult, batched_geqrf,
                                        batched_getrf, batched_potrf,
                                        batched_solve, reconstruct)
from repro_torch.lapack.cholesky import potrf, potrf_unblocked
from repro_torch.lapack.lu import getrf, getrf_unblocked, lu_reconstruct
from repro_torch.lapack.qr import geqrf, geqrf_unblocked, q_from_geqrf
from repro_torch.lapack.solve import gesv, lstsq_qr
from repro_torch.lapack import distributed
