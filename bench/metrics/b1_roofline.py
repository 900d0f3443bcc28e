"""``b1_roofline``: B1 (``csrc/gemm.cu``: the tiled ``ffma`` and the
``gemv`` launches) against its roofline: the least time of each traced
launch, from its recorded operand shapes, over the device time of
gemm.cu's kernels, in percent."""
from bench.roofline import roofline_share


def read(view):
    return roofline_share(view, "gemm", "gemm")
