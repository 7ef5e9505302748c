"""90th percentile of the time to first token over the requests due in
the open-loop chat cell's window, from that moment; a request without a
first token when the window closes counts with its wait so far, a failed
one as never served.  The 90th: ~8 of the ~75 due lie beyond it.  Reported
per layer: host stalls spread it too widely across runs for an
end-to-end bound (PERF.md, section 6)."""

import math

from . import percentile, started_in_window


def read(run):
    vals = []
    for r in started_in_window(run):
        if r.failed:
            vals.append(math.inf)
        elif r.stamps and r.stamps[0] < run.t_w1:
            vals.append(r.stamps[0] - r.t_start)
        else:
            vals.append(run.t_w1 - r.t_start)
    return percentile(vals, 90) * 1e3 if vals else None
