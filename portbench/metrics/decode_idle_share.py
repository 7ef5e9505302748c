"""Device: share of the decode ranges' host wall (from a
``ModelRunner.decode`` call's entry to its return) in which no device
operation ran, over the traced slice."""

from ..tracing import union_ns


def read(run):
    if run.trace is None:
        return None
    spans = [(op.start, op.end) for op, _ in run.trace.ops]
    wall = busy = 0
    for name, start, end in run.trace.ranges.values():
        if name.split("#")[0].endswith("decode"):
            wall += end - start
            busy += union_ns(spans, start, end)
    return 100.0 * (1 - busy / wall) if wall else None
