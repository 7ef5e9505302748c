"""Metric readers, one file each (``portbench/metrics/<name>.py``), found
by the metric's name in ``BENCHMARK.json``.  Each defines ``read(run)``,
which returns the metric's value, or None where the run holds nothing to
read (the harness then leaves the metric out of the result line).

``run`` is the harness's :class:`portbench.harness.Run`: the window
[``t_w0``, ``t_w1``) on ``time.perf_counter``, the benchmark's records of
every request it sent, the program's counters before and after the
window, and in a traced run the reduced profiler slice and the runner
calls.  The helpers below are shared arithmetic.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100), linear between closest ranks (as
    numpy's default); +inf values sort last."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of nothing")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def started_in_window(run) -> List:
    """Records of the requests due (open loop) or sent (closed loop) in
    the window."""
    return [r for r in run.records if run.t_w0 <= r.t_start < run.t_w1]


def decode_tokens(run, lo: float, hi: float) -> Iterator[Tuple[object, int,
                                                              float]]:
    """(record, token index, stamp) of every token stamped in [lo, hi)
    that a decode step produced: every token after a request's first."""
    for r in run.records:
        for k in range(1, len(r.stamps)):
            if lo <= r.stamps[k] < hi:
                yield r, k, r.stamps[k]


def delta(run, key: str) -> float:
    return run.after[key] - run.before[key]


def owned_ops(run, kind: str):
    """{call index: [device op intervals]} of the traced slice's ranges of
    ``kind`` ("decode" or "prefill"), every range of that kind in the
    slice included."""
    if run.trace is None:
        return {}
    out = {i: [] for i, (name, _, _) in run.trace.ranges.items()
           if name.split("#")[0].endswith(kind)}
    for op, owner in run.trace.ops:
        if owner in out:
            out[owner].append(op)
    return out
