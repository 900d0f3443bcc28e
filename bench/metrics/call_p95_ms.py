"""``call_p95_ms``: the 95th percentile of every request's latency in the
window (``statistics.quantiles``, inclusive, over all requests)."""
import statistics


def read(view):
    lat = view.latencies_s
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
