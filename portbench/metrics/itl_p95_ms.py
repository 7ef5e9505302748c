"""95th percentile of the gap between consecutive output tokens, over
every gap of every request whose two tokens are both stamped inside the
window."""

from . import percentile


def read(run):
    gaps = [b - a for r in run.records for a, b in zip(r.stamps, r.stamps[1:])
            if run.t_w0 <= a and b < run.t_w1]
    return percentile(gaps, 95) * 1e3 if gaps else None
