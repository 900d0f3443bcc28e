"""``b2_roofline``: B2 (``csrc/trsm_gemm.cu``) against its roofline: the
least time of each traced launch, from its recorded operand shapes, over
the device time of B2's kernels, in percent."""
from bench.roofline import roofline_share


def read(view):
    return roofline_share(view, "trsm_gemm", "trsm_gemm")
