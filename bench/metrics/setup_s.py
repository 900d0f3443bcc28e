"""``setup_s``: process start to the first timed request (CUDA start,
loading or building the port's libraries, the inputs, the warm-up)."""


def read(view):
    return view.setup_s
