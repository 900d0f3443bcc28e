"""``lapack_mfu``: the window's unprofiled requests' LAWN 41 flops over
their span on the host clock, first start to last end, as a percent of
the dtype's peak (67 TFLOP/s for float32, FFMA outside the tensor cores,
at 700 W). Read in the traced run after its profiler has closed, which
slows the host."""
from bench.roofline import PEAK_FLOPS


def read(view):
    lat = view.untraced_latencies_s
    if not lat or view.untraced_span_s <= 0:
        return None
    return 100.0 * len(lat) * view.flops_per_request / view.untraced_span_s \
        / PEAK_FLOPS[view.dtype]
