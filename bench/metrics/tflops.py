"""``tflops``: the LAWN 41 flops of every request in the window over the
time from the first request's start to the last one's end."""


def read(view):
    return len(view.latencies_s) * view.flops_per_request / view.span_s / 1e12
