"""Traced runs: ranges around the runner's calls, a profiler slice in the
middle of the window, and its reduction to device intervals.

Only a run with ``--trace 1`` installs any of this.  The ranges come from
the benchmark's own files: :func:`install_ranges` wraps the engine's
``ModelRunner.decode`` and ``prefill_chunk`` (instance attributes, the
program's code untouched) in ``torch.profiler.record_function`` ranges
named ``portbench.decode#<i>`` and ``portbench.prefill#<i>:<tokens>``
and keeps each call's host stamps.  The same wrappers start and stop a
torch.profiler slice (CPU and CUDA activity) on the engine's stepper
thread, the thread whose host operations the profiler then records, at
the first call after each of the two times asked for; the slice is
reduced to intervals and nothing is written to disk.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

RANGE = "portbench."


@dataclasses.dataclass
class Call:
    kind: str            # "decode" | "prefill"
    index: int
    t_enter: float       # perf_counter
    t_exit: float
    tokens: int          # prefill: real tokens of the chunk


class Ranges:
    """The wrapped runner's calls, in order, and the profiler slice."""

    def __init__(self) -> None:
        self.calls: List[Call] = []
        self.t_start = self.t_stop = float("inf")
        self.prof = None
        self.stopped = threading.Event()

    def profile_between(self, t_start: float, t_stop: float) -> None:
        """Profile from the first runner call at or after ``t_start``
        (perf_counter) to the first at or after ``t_stop``."""
        self.t_start, self.t_stop = t_start, t_stop

    def _tick(self) -> None:
        now = time.perf_counter()
        if self.prof is None and now >= self.t_start:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
        elif (self.prof is not None and not self.stopped.is_set()
              and now >= self.t_stop):
            self.prof.stop()
            self.stopped.set()

    def reduced(self, timeout: float) -> "Reduced":
        """The slice, once the stepper has stopped it."""
        if not self.stopped.wait(timeout):
            raise RuntimeError("the profiler slice was not stopped: no "
                               "runner call came after its end")
        return reduce_events(self.prof.profiler.kineto_results.events())


def install_ranges(engine) -> Ranges:
    from torch.profiler import record_function

    runner = engine.core.runner
    ranges = Ranges()
    decode, prefill = runner.decode, runner.prefill_chunk

    def traced_decode(fed, pos):
        ranges._tick()
        i = len(ranges.calls)
        t0 = time.perf_counter()
        with record_function(f"{RANGE}decode#{i}"):
            out = decode(fed, pos)
        ranges.calls.append(Call("decode", i, t0, time.perf_counter(), 0))
        return out

    def traced_prefill(tokens, *, slot, start, fresh):
        ranges._tick()
        i = len(ranges.calls)
        t0 = time.perf_counter()
        with record_function(f"{RANGE}prefill#{i}:{len(tokens)}"):
            out = prefill(tokens, slot=slot, start=start, fresh=fresh)
        ranges.calls.append(Call("prefill", i, t0, time.perf_counter(),
                                 len(tokens)))
        return out

    runner.decode = traced_decode
    runner.prefill_chunk = traced_prefill
    return ranges


@dataclasses.dataclass
class Interval:
    name: str
    start: int            # ns, the profiler's clock
    end: int


@dataclasses.dataclass
class Reduced:
    """A profiled slice, reduced: the benchmark's ranges, every device
    operation with the range that launched it (None outside any), and
    the stepper thread's top-level host operations."""

    window_ns: Tuple[int, int]
    ranges: Dict[int, Tuple[str, int, int]]          # call index -> range
    ops: List[Tuple[Interval, Optional[int]]]
    host: List[Interval]
    attributed: int = 0

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9


def union_ns(spans: List[Tuple[int, int]], lo: int, hi: int) -> int:
    """Length of the union of ``spans`` clipped to [lo, hi)."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(spans):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce_events(events) -> Reduced:
    """Reduce profiler events (objects with ``name()``, ``start_ns()``,
    ``duration_ns()``, ``device_type()``, ``correlation_id()``,
    ``linked_correlation_id()``, ``start_thread_id()``: torch's kineto
    events) to a :class:`Reduced`.

    A device operation is attributed to the range whose span holds the
    host stamp of its launch: the runtime call with the operation's
    correlation id, else the host operation its linked correlation id
    names (the innermost op or range open at the launch).  The window is
    the span of all events: the profiler's clock, from its first event
    to its last."""
    from torch.autograd import DeviceType

    ranges: Dict[int, Tuple[str, int, int]] = {}
    range_tid = None
    cpu_start: Dict[int, int] = {}
    runtime_start: Dict[int, int] = {}
    device = []
    cpu_ops = []
    for e in events:
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            corr = e.correlation_id()
            if name.startswith(RANGE):
                idx = int(name[len(RANGE):].split("#")[1].split(":")[0])
                ranges[idx] = (name, start, end)
                range_tid = e.start_thread_id()
            elif name.startswith(("cuda", "cu")) and corr:
                runtime_start[corr] = start
                continue
            if corr:
                cpu_start[corr] = start
            cpu_ops.append((e.start_thread_id(), name, start, end))
        elif e.device_type() == DeviceType.CUDA:
            if name.startswith(RANGE) or e.duration_ns() <= 0:
                continue                    # GPU-side copies of ranges
            device.append((name, start, end, e.correlation_id(),
                           e.linked_correlation_id()))
    spans = [(s, e) for _, _, s, e in cpu_ops] + [(s, e) for _, s, e, _, _
                                                   in device]
    window_ns = (min(s for s, _ in spans), max(e for _, e in spans))
    order = sorted(ranges.items(), key=lambda kv: kv[1][1])
    starts = [r[1] for _, r in order]
    ops: List[Tuple[Interval, Optional[int]]] = []
    attributed = 0
    for name, start, end, corr, linked in device:
        launch = runtime_start.get(corr)
        if launch is None:
            launch = cpu_start.get(linked)
        owner = None
        if launch is not None:
            j = bisect.bisect_right(starts, launch) - 1
            if j >= 0 and launch <= order[j][1][2]:
                owner = order[j][0]
                attributed += 1
        ops.append((Interval(name, start, end), owner))
    # the stepper's outermost host operations, for naming idle gaps
    host = []
    if range_tid is not None:
        mine = sorted((s, e, n) for tid, n, s, e in cpu_ops
                      if tid == range_tid and not n.startswith(RANGE))
        last_end = None
        for s, e, n in mine:
            if last_end is None or s >= last_end:
                host.append(Interval(n, s, e))
                last_end = e
    return Reduced(window_ns=window_ns, ranges=ranges, ops=ops, host=host,
                   attributed=attributed)
