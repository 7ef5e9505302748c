"""Seconds from the process's start to the window's: imports, CUDA start,
weights drawn, the pool, warm-up of the cell's shapes, and the traffic's
ramp."""


def read(run):
    return run.setup_s
