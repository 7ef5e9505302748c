"""Engine core: sequences in a decoding step, on average over the
window's decoding steps (``serving.batch.occupancy`` sum over count)."""

from . import delta


def read(run):
    steps = delta(run, "occupancy_count")
    return delta(run, "occupancy_sum") / steps if steps else None
