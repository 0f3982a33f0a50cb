"""Process start to the window's start: imports, the kernels' build and
load, weights, the traffic's pool and the warm-up steps."""


def read(run):
    return run.setup_s
