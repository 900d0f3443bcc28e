"""``eager_launches``: device operations per traced request that are none
of the port's hand-written kernels (the drivers' panels, swaps, copies
and fills)."""


def read(view):
    n = sum(c for name, (_, c) in view.kernels.items()
            if view.classify(name) is None)
    if not view.kernels or view.requests == 0:
        return None
    return n / view.requests
