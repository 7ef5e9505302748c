"""Model step: device time of the operations launched inside the
benchmark's prefill ranges (``ModelRunner.prefill_chunk`` calls), per
thousand prompt tokens they prefilled, over the traced slice."""

from . import owned_ops


def read(run):
    calls = owned_ops(run, "prefill")
    ns = tokens = 0
    for i, ops in calls.items():
        if ops:
            ns += sum(op.end - op.start for op in ops)
            tokens += int(run.trace.ranges[i][0].rsplit(":", 1)[1])
    return ns * 1e-6 / (tokens / 1e3) if tokens else None
