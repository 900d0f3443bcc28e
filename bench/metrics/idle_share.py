"""``idle_share``: the percent of a request's time in which no operation
runs on the device: 1 - (device busy time per profiled request) / (mean
time of the window's unprofiled requests). The busy time is the union of
device activity in the profiled part; the request's time is taken
without the profiler, which slows the host and not the device. The
result line's ``busy_s`` / ``window_s`` are both of the profiled part."""


def read(view):
    lat = view.untraced_latencies_s
    if view.busy_s <= 0 or view.requests == 0 or not lat:
        return None
    return 100.0 * (1.0 - view.busy_s / view.requests / (sum(lat) / len(lat)))
