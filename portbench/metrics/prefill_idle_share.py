"""Device: share of the program's prefill spans' host wall in which no
device operation ran, over the traced slice: the twin of
``decode_idle_share`` for prefill.  A span is one
``repro_torch.core.prefill`` (one prefill chunk of an engine step, and
the first token's sampling after a prompt's last chunk).  None where the
program opens no such span."""

from ..tracing import union_ns

SPAN = "repro_torch.core.prefill"


def read(run):
    if run.trace is None:
        return None
    spans = [(op.start, op.end) for op, _ in run.trace.ops]
    wall = busy = 0
    for h in run.trace.host:
        if h.name == SPAN:
            wall += h.end - h.start
            busy += union_ns(spans, h.start, h.end)
    return 100.0 * (1 - busy / wall) if wall else None
