"""``setup_s``: process start to the window's start: imports, the CUDA
context, the kernels' load (their build on a checkout's first run), the
tables drawn on the card and one warm call of the cell's shape (on the
first run also the launch tuner's timings)."""


def read(run):
    return run.setup_s
