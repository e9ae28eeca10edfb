"""Process start to the window's start: imports, the weights' draw, the
CUDA library's load (its build in a checkout's first run) and the two
captures of the warm batch (host clock)."""


def read(run):
    return run.setup_s
