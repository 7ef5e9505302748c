"""Runner: host time to enqueue one batched decode call (the program's
``runner.decode.dispatch_ms``, its exact sum over its count in the
window; not device time)."""

from . import delta


def read(run):
    n = delta(run, "decode_dispatch_count")
    return delta(run, "decode_dispatch_ms_sum") / n if n else None
