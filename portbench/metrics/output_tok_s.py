"""Output tokens per second: every output token stamped inside the
window, over the window's length (host clock)."""


def read(run):
    n = sum(1 for r in run.records for s in r.stamps
            if run.t_w0 <= s < run.t_w1)
    return n / (run.t_w1 - run.t_w0)
