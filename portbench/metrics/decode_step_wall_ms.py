"""Engine core: host wall of one decoding step, the program's
``serving.phase.decode_s`` over the window divided by its decoding steps
(the count of ``serving.batch.occupancy``).  The sampler's copy to the
host synchronises each step, so this is the step's whole wall."""

from . import delta


def read(run):
    steps = delta(run, "occupancy_count")
    return 1e3 * delta(run, "decode_s") / steps if steps else None
