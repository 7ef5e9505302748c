"""Scheduler and KV pool: 90th percentile of the wait from a request's
due (or sent) time to the step that gave it a slot (the program's
``Completion.t_sched`` stamp), over the requests due or sent in the
window; one still queued when the window closes counts with its wait so
far."""

from . import percentile, started_in_window


def read(run):
    vals = []
    for r in started_in_window(run):
        t = r.t_sched if r.t_sched is not None else run.t_w1
        vals.append(max(min(t, run.t_w1) - r.t_start, 0.0))
    return percentile(vals, 90) * 1e3 if vals else None
