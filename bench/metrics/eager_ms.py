"""``eager_ms``: device milliseconds per traced request in the operations
that ``eager_launches`` counts."""


def read(view):
    s = sum(t for name, (t, _) in view.kernels.items()
            if view.classify(name) is None)
    if not view.kernels or view.requests == 0:
        return None
    return 1e3 * s / view.requests
