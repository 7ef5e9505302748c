"""Spans: named intervals at the layer boundaries of the serving step, on
the host's clock and, while a profiler records, in its trace.

A :class:`Span` wraps one boundary (a ``with`` block) on the thread that
owns it, such as the async engine's stepper:

* given a registry instrument, every pass adds its host wall, read from
  the clock the span was given (the engine's injected clock), to that
  instrument: a histogram observes milliseconds (exact sum and count), a
  counter sums seconds.  The instrument is resolved once, where the span
  is built; under :class:`~repro_torch.obs.metrics.NullRegistry` it is
  dropped there, and the span reads no clock;
* only while a ``torch.profiler`` session records on the calling thread,
  it opens a profiler range named ``repro_torch.<name>``.  The range then
  sits on the profiler's clock, in the same trace as the host operations
  and the device operations launched inside it.

The :func:`traced` decorator is the form for functions that any thread
may run, dozens of times a step (the model's attention and FFN, the MoE
FFN's stages): ranges only, never timed.  With no profiler on, the
wrapper tests a flag and calls the function.  No flag or environment
variable switches any of it: tracing is on exactly while a profiler
records.  With none on anywhere in the process, each test is of torch's
process-wide "a profiler is on" flag; with one on, the thread-local
state that decides whether a range records anything is asked too.

The range is a function-scope ``RecordFunction`` (torch's
``_RecordFunctionFast``, as torch's generated code opens), not
``torch.profiler.record_function``'s user scope: the profiler copies a
user-scope range onto the device's timeline, over the kernels launched
inside it, and a reduction of the trace would take each copy for a
device operation.  On the host's timeline the two are the same event.

``docs/spans.md`` lists the spans and how to read them.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from .metrics import _NullBound

#: every range a span opens is named with this prefix
PREFIX = "repro_torch."

#: the range: a function-scope RecordFunction, entered as a context
_Range = torch._C._profiler._RecordFunctionFast
#: True while a profiler records on the calling thread
_thread_profiling: Callable[[], bool] = torch._C._autograd._profiler_enabled


def traced(name: str) -> Callable[[Callable], Callable]:
    """Decorator: the function runs inside the range ``repro_torch.<name>``
    while a profiler records on the calling thread, and as it is
    otherwise.  It keeps no state, so any thread may call it."""
    full = PREFIX + name

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def traced_fn(*args, **kwargs):
            if _autograd_profiler._is_profiler_enabled and _thread_profiling():
                with _Range(full):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return traced_fn
    return wrap


class Span:
    """A reusable span owned by one thread (see the module docstring).

    ``ms``: a bound histogram that observes each pass in milliseconds;
    ``seconds``: a bound counter that sums each pass in seconds; at most
    one of them.  ``now`` is the clock both read.  A pass that raises
    writes nothing to the instrument."""

    __slots__ = ("name", "_write", "_scale", "_now", "_t0", "_range")

    def __init__(self, name: str, *, ms=None, seconds=None,
                 now: Callable[[], float] = time.perf_counter) -> None:
        if ms is not None and seconds is not None:
            raise ValueError(f"span {name}: give ms= or seconds=, not both")
        inst = ms if ms is not None else seconds
        self.name = PREFIX + name
        self._write: Optional[Callable[[float], None]] = None
        if inst is not None and not isinstance(inst, _NullBound):
            self._write = inst.observe if ms is not None else inst.inc
        self._scale = 1e3 if ms is not None else 1.0
        self._now = now
        self._t0 = 0.0
        self._range = None

    def __enter__(self) -> "Span":
        if _autograd_profiler._is_profiler_enabled and _thread_profiling():
            self._range = _Range(self.name)
            self._range.__enter__()
        if self._write is not None:
            self._t0 = self._now()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._write is not None and exc_type is None:
            self._write((self._now() - self._t0) * self._scale)
        if self._range is not None:
            rng, self._range = self._range, None
            rng.__exit__(exc_type, exc, tb)
