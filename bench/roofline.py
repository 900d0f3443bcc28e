"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W power limit) and the roofline bound of one launch.

Frozen copy of ``chip_smoke.py``'s ``PEAK_FLOPS`` / ``HBM_BYTES_PER_S`` /
``bound()``, keyed by dtype name so that it needs no card: the least time
is the larger of the operations at the dtype's peak and the bytes at the
HBM rate, each input byte read once and each output byte written once.
"""
from __future__ import annotations

from typing import Tuple

# FP32 outside the tensor cores, FP64 on the tensor cores, bf16 tensor
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2}


def bound(flops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """(least seconds, what bounds it: "operations" or "bytes")."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _numel(operand) -> int:
    n = 1
    for d in operand[0]:
        n *= d
    return n


def launch_cost(record) -> Tuple[float, float, str]:
    """(flops, bytes, dtype) of one launch record of the port
    (``repro_torch.kernels.launch_record``), from its operands' shapes:
    (shape, dtype, strides, address mod 16) each.

    - B1 ``gemm`` (a (m, k), b (k, n), c (m, n), any with a batch axis):
      2 m n k flops an item; a, b and c each moved once.
    - B2 ``trsm_gemm`` (L11 (nb, nb), AP (nb, n), C (m, n), and BL (m, nb)
      for the ``lu`` form): the solve nb^2 n and the update 2 m n nb an
      item; L11, AP, BL read once, X written, C read and written.
    """
    ops = record["operands"]
    dtype = ops[0][1]
    size = ITEMSIZE[dtype]
    if record["kernel"] == "gemm":
        a, b, c = ops
        m, n = c[0][-2:]
        k = a[0][-1]
        items = c[0][0] if len(c[0]) == 3 else 1
        return (2.0 * items * m * n * k,
                float(_numel(a) + _numel(b) + _numel(c)) * size, dtype)
    if record["kernel"] == "trsm_gemm":
        l11, ap, c = ops[:3]
        nb, n = ap[0][-2:]
        m = c[0][-2]
        items = c[0][0] if len(c[0]) == 3 else 1
        bl = items * m * nb if len(ops) == 4 else 0
        return (items * (nb * nb * n + 2.0 * m * n * nb),
                float(items * (nb * nb + 2 * nb * n + 2 * m * n) + bl) * size,
                dtype)
    raise ValueError(f"no cost model for kernel {record['kernel']!r}")


def roofline_share(view, kernel: str, stem: str):
    """Percent of the least time that the traced launches of ``kernel``
    (launch records) could take, over the device time of the kernels of
    ``csrc/<stem>.cu``; None when the trace holds neither."""
    least = sum(bound(*launch_cost(r))[0] for r in view.launches
                if r["kernel"] == kernel and not r["fake"])
    device = sum(s for name, (s, _) in view.kernels.items()
                 if view.classify(name) == stem)
    if least <= 0 or device <= 0:
        return None
    return 100.0 * least / device
