"""Model step: device time of the operations launched inside the
benchmark's decode range (one ``ModelRunner.decode`` call, every layer),
per call, over the traced slice."""

from . import owned_ops


def read(run):
    calls = owned_ops(run, "decode")
    busy = [sum(op.end - op.start for op in ops) for ops in calls.values()
            if ops]
    return sum(busy) / len(busy) * 1e-6 if busy else None
