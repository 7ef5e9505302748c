"""Async serving front-end (``AsyncEngine``): live submit/stream/poll.

Counterpart of ``repro.serving.async_engine`` over the port's
:class:`~repro_torch.serving.core.EngineCore`; the same host code, with
device work on the stepper thread (see "Device" below).

Top of the three-layer serving stack (runner / core / async): a
background **stepper thread** loops :meth:`EngineCore.step` against a
lock-guarded inbox, so callers submit, poll, stream and cancel *while
the engine is stepping* — the live-traffic regime the batch-mode
``generate(arrivals=)`` loop can only simulate.  The shape follows
what production engines converge on (vLLM's AsyncLLMEngine over its
EngineCore, arXiv:2309.06180; Orca's iteration-level scheduling,
OSDI '22): all device work stays on one thread, all cross-thread state
is plain host data under one lock.

Request lifecycle (per-handle terminal-state machine)::

    QUEUED ──► PREFILLING ──► DECODING ──► FINISHED
      │             │             │
      │ preempted ◄─┴─────────────┤ (back to QUEUED; recompute restart)
      │             │             │
      └──────┬──────┴─────────────┘
             ▼
      CANCELLED / FAILED                 (terminal)

``cancel`` frees the slot and every KV page reference immediately,
mid-prefill included.  A per-request error (e.g. an oversized prompt,
validated on the stepper) fails only that handle; an unexpected
exception anywhere in the step loop marks the engine dead, fails every
live handle, and re-raises to the *callers*: the next ``poll`` /
``stream`` / ``submit`` raises :class:`AsyncEngineError` chaining the
stepper's exception — background threads must never swallow errors.

The stepper **parks** (condition-variable wait) whenever the core has
no work and the inbox is empty: an idle engine costs zero CPU, and
``submit`` wakes it.  ``shutdown()`` stops the loop, joins the thread,
and cancels whatever was still in flight.

Tensor parallelism (``mesh=``, forwarded to the core): every rank
builds an ``AsyncEngine``; callers submit, poll and cancel on rank 0,
the **leader**.  Each iteration of the leader's stepper broadcasts one
step record — the requests it takes in, the cancellations, the handles
a callback failed, its clock reading and whether it is still up — and
the other ranks' steppers (**followers**) apply that record and step,
so every rank's core takes the same decisions.  An idle leader parks
for at most ``TP_HEARTBEAT_S`` before it sends an empty record (its
followers wait in that broadcast, and no rank steps on it); its
``shutdown`` sends the record that stops them, and a follower's
``shutdown`` waits for it.

Device: torch keeps the current CUDA device and stream per thread, so
the stepper makes the runner's device current itself before its first
step.  A CUDA error raised on the stepper (a failed launch included)
is an exception like any other: the engine dies and the callers see
:class:`AsyncEngineError` chaining it.  Nothing carries on on the CPU.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from ..models.transformer import Model
from ..obs.spans import Span
from .core import Clock, EngineCore
from .engine import Completion, Request
from .scheduler import Sequence


#: longest a tensor-parallel leader's stepper parks idle before it sends
#: its followers an empty step record
TP_HEARTBEAT_S = 1.0


class RequestState(enum.Enum):
    QUEUED = "queued"            # submitted / waiting for a slot
    PREFILLING = "prefilling"    # prompt KV becoming resident
    DECODING = "decoding"        # generating tokens
    FINISHED = "finished"        # eos / token budget / max_len
    CANCELLED = "cancelled"      # by caller or shutdown
    FAILED = "failed"            # per-request or engine error


TERMINAL_STATES = frozenset(
    {RequestState.FINISHED, RequestState.CANCELLED, RequestState.FAILED})


class AsyncEngineError(RuntimeError):
    """Raised to callers when the stepper thread died; the original
    exception is chained as ``__cause__``."""


class CancelledError(RuntimeError):
    """``result()`` called on a request that was cancelled."""


class DeadlineExceededError(RuntimeError):
    """The request's ``deadline_s`` budget ran out before it finished:
    the scheduler shed it (queued or running, pages drained) and the
    handle FAILED with this as its cause.  Deliberately not retryable —
    the client's budget is spent no matter who retries."""


@dataclasses.dataclass(eq=False)    # identity semantics: one handle is
class RequestHandle:                # one in-flight request, never a value
    """Caller's view of one in-flight request.  All mutable fields are
    written by the stepper under the engine lock; read them through
    ``poll``/``stream``/``result``, not directly, unless the engine is
    shut down."""

    uid: int
    request: Request
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    completion: Optional[Completion] = None
    error: Optional[BaseException] = None
    #: per-token push callback (``submit(on_token=)``) — invoked by the
    #: stepper thread OUTSIDE the engine lock, once per sampled token
    on_token: Optional[Callable[[int], None]] = None
    _seq: Optional[Sequence] = None          # set once the stepper admits
    _n_polled: int = 0

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES


@dataclasses.dataclass
class PollResult:
    """One ``poll``'s delta: tokens sampled since the previous poll,
    the current state, and the completion once terminal."""

    state: RequestState
    new_tokens: List[int]
    completion: Optional[Completion] = None

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES


class AsyncEngine:
    """Live submit/stream/poll over a background ``EngineCore`` stepper.

    Constructor keywords mirror ``ContinuousServingEngine`` (they are
    forwarded to :class:`EngineCore`).  Use as a context manager or
    call :meth:`shutdown` explicitly — the stepper is a daemon thread,
    but an orderly join is what tests and servers want.
    """

    def __init__(self, model: Model, params: Any, *,
                 clock: Optional[Clock] = None, **core_kwargs) -> None:
        self.core = EngineCore(model, params, clock=clock, **core_kwargs)
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)    # stepper parks
        self._update = threading.Condition(self._lock)  # pollers park
        self._inbox: List[RequestHandle] = []
        self._cancels: List[RequestHandle] = []
        self._handles: Dict[int, RequestHandle] = {}
        self._uids = itertools.count()
        self._alive = True
        self._error: Optional[BaseException] = None
        self._clock0 = self.core.clock.now()
        mesh = self.core.mesh
        #: tensor-parallel ranks: rank 0 leads, the others follow its
        #: step records (see the module docstring)
        self._tp = mesh is not None and mesh.size > 1
        self._follower = self._tp and mesh.rank != 0
        #: uids whose handle a callback failed since the last record
        self._tp_failed: List[int] = []
        # stepper telemetry (core.registry; bound handles — the loop
        # never touches the registry itself)
        reg = self.core.registry
        self._c_submitted = reg.counter(
            "async.submitted", "requests accepted by submit()").labels()
        self._c_cancelled = reg.counter(
            "async.cancelled", "requests torn down by cancel()").labels()
        self._c_failed = reg.counter(
            "async.failed", "handles failed (bad request, callback "
            "error, engine death)").labels()
        self._g_inbox = reg.gauge(
            "async.inbox_depth",
            "submitted-but-not-yet-scheduled requests at the last "
            "stepper drain").labels()
        # the stepper's own spans around the core's step (obs.spans):
        # ranges only, which name a trace's idle gaps
        self._span_intake = Span("async.intake")
        self._span_publish = Span("async.publish")
        self._thread = threading.Thread(
            target=self._step_loop, name="engine-stepper", daemon=True)
        self._thread.start()

    # observability surfaces (owned by the core)
    registry = property(lambda self: self.core.registry)
    tracer = property(lambda self: self.core.tracer)

    # ------------------------------------------------------------------
    # caller API
    # ------------------------------------------------------------------
    def submit(self, request: Request, *,
               on_token: Optional[Callable[[int], None]] = None,
               ) -> RequestHandle:
        """Queue a request for admission; returns immediately.  The
        engine assigns its own uid (``handle.uid``) so concurrent
        clients can never collide.

        ``on_token`` is a push-style streaming hook for transports that
        cannot poll (SSE writers, websockets, queues): the stepper
        thread calls it once per sampled token, in order, **outside**
        the engine lock (so it may safely call back into the engine).
        Keep it fast — it runs on the stepper, so a slow callback slows
        every request.  A raising callback fails *this* handle (its
        sequence is torn down, pages freed), never the engine.
        """
        if self._follower:
            raise RuntimeError("submit on rank 0 of a tensor-parallel "
                               "mesh: the other ranks follow its steps")
        with self._wake:
            self._check_alive()
            uid = next(self._uids)
            handle = RequestHandle(
                uid=uid, request=dataclasses.replace(request, uid=uid),
                on_token=on_token)
            self._handles[uid] = handle
            self._inbox.append(handle)
            self._c_submitted.inc()
            self._wake.notify_all()
        return handle

    def poll(self, handle: RequestHandle) -> PollResult:
        """Non-blocking progress check: tokens sampled since the last
        ``poll`` of this handle, current state, completion when done.
        Raises :class:`AsyncEngineError` if the stepper died, or the
        per-request error if this handle FAILED."""
        with self._update:
            self._raise_if_failed(handle)
            new = handle.tokens[handle._n_polled:]
            handle._n_polled = len(handle.tokens)
            return PollResult(state=handle.state, new_tokens=list(new),
                              completion=handle.completion)

    def stream(self, handle: RequestHandle, *,
               timeout: Optional[float] = None) -> Iterator[int]:
        """Yield ``handle``'s tokens as the stepper samples them;
        returns at a terminal state (raises on FAILED).  ``timeout``
        bounds each wait for the *next* token, not the whole stream."""
        cursor = 0
        while True:
            with self._update:
                # deadline per *token*, not per notification: other
                # requests' steps also notify, and must not reset it
                if not self._update.wait_for(
                        lambda: len(handle.tokens) > cursor or handle.done,
                        timeout=timeout):
                    raise TimeoutError(
                        f"request {handle.uid}: no token within "
                        f"{timeout} s")
                self._raise_if_failed(handle)
                new = handle.tokens[cursor:]
                cursor += len(new)
                done = handle.done
            yield from new
            if done:
                return

    def result(self, handle: RequestHandle, *,
               timeout: Optional[float] = None) -> Completion:
        """Block until ``handle`` is terminal; return its completion
        (raises on FAILED, and on CANCELLED there is no completion —
        a ``CancelledError`` is raised instead)."""
        with self._update:
            if not self._update.wait_for(lambda: handle.done,
                                         timeout=timeout):
                raise TimeoutError(
                    f"request {handle.uid} not done within {timeout} s")
            self._raise_if_failed(handle)
            if handle.state is RequestState.CANCELLED:
                raise CancelledError(f"request {handle.uid} was cancelled")
            return handle.completion

    def cancel(self, handle: RequestHandle) -> bool:
        """Request cancellation; the stepper tears the sequence down
        (slot + all KV pages) before its next step.  Returns False when
        the handle is already terminal."""
        with self._wake:
            if handle.done or handle in self._cancels:
                return False
            self._cancels.append(handle)
            self._wake.notify_all()
        return True

    def shutdown(self, *, timeout: Optional[float] = 30.0) -> None:
        """Stop the stepper, join its thread, and cancel every request
        still in flight.  Idempotent.  A tensor-parallel follower's
        stepper stops when the leader's does: this waits for that."""
        with self._wake:
            if not self._follower:
                self._alive = False
            self._wake.notify_all()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError("stepper thread did not stop")
        # thread is dead: tear down the leftovers single-threaded
        with self._update:
            for h in self._handles.values():
                if not h.done:
                    if h._seq is not None:
                        self.core.cancel(h._seq)
                    h.state = RequestState.CANCELLED
            self._handles.clear()
            self._inbox.clear()
            self._cancels.clear()
            self._update.notify_all()

    def __enter__(self) -> "AsyncEngine":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.shutdown()

    # ------------------------------------------------------------------
    # stepper thread
    # ------------------------------------------------------------------
    def _intake(self):
        """Park until there is work (a tensor-parallel leader at most
        ``TP_HEARTBEAT_S``), then take the inbox and the cancellations;
        returns (alive, inbox, cancels)."""
        park = TP_HEARTBEAT_S if self._tp else None
        with self._wake:
            while (self._alive and not self._inbox
                   and not self._cancels and not self.core.has_work()):
                # park: an idle engine costs 0 CPU
                if not self._wake.wait(park) and self._tp:
                    break                       # heartbeat record
            inbox, self._inbox = self._inbox, []
            cancels, self._cancels = self._cancels, []
            self._g_inbox.set(len(inbox))
            return self._alive, inbox, cancels

    def _follow(self):
        """A follower's intake: the leader's next step record, applied
        to this rank's handles; returns (alive, inbox, cancels, now,
        whether the record took in and cancelled nothing)."""
        rec = self.core.shared(None)
        with self._update:
            for uid in rec["failed"]:
                handle = self._handles.pop(uid, None)
                if handle is not None and handle._seq is not None:
                    self.core.cancel(handle._seq, trace_event=None)
            inbox = []
            for uid, request in rec["submit"]:
                handle = RequestHandle(uid=uid, request=request)
                self._handles[uid] = handle
                inbox.append(handle)
            cancels = [self._handles[uid] for uid in rec["cancel"]
                       if uid in self._handles]
        return (rec["alive"], inbox, cancels, rec["now"],
                not rec["submit"] and not rec["cancel"])

    def _step_loop(self) -> None:
        core = self.core
        try:
            if core.runner.device.type == "cuda":
                torch.cuda.set_device(core.runner.device)
            while True:
                with self._span_intake:         # parking included
                    if self._follower:
                        alive, inbox, cancels, now, empty = self._follow()
                    else:
                        alive, inbox, cancels = self._intake()
                        now = core.clock.now() - self._clock0
                        empty = not inbox and not cancels
                        if self._tp:
                            failed, self._tp_failed = self._tp_failed, []
                            core.shared({
                                "alive": alive, "now": now,
                                "failed": failed,
                                "submit": [(h.uid, h.request)
                                           for h in inbox],
                                "cancel": [h.uid for h in cancels]})
                if not alive:
                    return
                if self._tp and empty and not core.has_work():
                    continue            # a heartbeat: every rank skips it
                for handle in cancels:
                    if handle.done:     # finished/failed while queued
                        continue        # for cancel: keep that state
                    if handle._seq is not None:
                        core.cancel(handle._seq)
                    self._c_cancelled.inc()
                    with self._update:
                        handle.state = RequestState.CANCELLED
                        self._handles.pop(handle.uid, None)
                        self._update.notify_all()
                for handle in inbox:
                    if handle.done:             # cancelled while queued
                        continue
                    try:
                        handle._seq = core.submit(handle.request,
                                                  arrival=now)
                    except ValueError as e:     # bad request, engine fine
                        # never reached core.submit's QUEUED stamp: give
                        # the trace a complete (if instant) lifecycle
                        t = core.clock.now()
                        core.tracer.event(handle.uid, "QUEUED", t)
                        core.tracer.event(handle.uid, "FAILED", t,
                                          error=str(e))
                        self._c_failed.inc()
                        with self._update:
                            handle.state = RequestState.FAILED
                            handle.error = e
                            self._handles.pop(handle.uid, None)
                            self._update.notify_all()
                res = core.step(now=now)
                with self._span_publish:
                    self._publish(res)
        except BaseException as e:              # noqa: BLE001 — must
            self._die(e)                        # reach the callers

    def _publish(self, res) -> None:
        callbacks: List[tuple] = []
        with self._update:
            for uid, tok in res.emitted:
                handle = self._handles.get(uid)
                if handle is not None:
                    handle.tokens.append(tok)
                    if handle.on_token is not None:
                        callbacks.append((handle, tok))
            self._update.notify_all()       # pollers see the new tokens
        # push-stream outside the lock: a callback may poll/cancel/submit
        # without deadlocking, and a slow one never blocks pollers.  This
        # runs BEFORE completions publish, so (a) by the time result()
        # returns, every on_token fired — a transport can close its
        # stream on result() without losing the tail — and (b) a
        # raising final-token callback still fails its handle (the
        # handle is not FINISHED yet)
        for handle, tok in callbacks:
            try:
                handle.on_token(tok)
            except BaseException as e:      # noqa: BLE001 — a client
                self._fail_handle(handle, e)   # bug fails ITS handle only
        with self._update:
            for uid in res.expired:
                # the scheduler already drained slot + pages and the
                # core already traced FAILED — only the handle is left
                handle = self._handles.pop(uid, None)
                if handle is not None and not handle.done:
                    handle.error = DeadlineExceededError(
                        f"request {uid} missed its deadline "
                        f"({handle.request.deadline_s} s budget)")
                    handle.state = RequestState.FAILED
                    self._c_failed.inc()
            for comp in res.finished:
                # terminal handles leave the registry (the caller keeps
                # its own reference) so a long-lived engine's per-step
                # state walk and memory track LIVE requests, not every
                # request ever served
                handle = self._handles.pop(comp.uid, None)
                if handle is not None and not handle.done:
                    handle.completion = comp
                    handle.state = RequestState.FINISHED
            for handle in self._handles.values():
                if handle.done or handle._seq is None:
                    continue
                seq = handle._seq
                if seq.slot < 0:
                    handle.state = RequestState.QUEUED
                elif seq.is_prefilling:
                    handle.state = RequestState.PREFILLING
                else:
                    handle.state = RequestState.DECODING
            self._update.notify_all()

    def _fail_handle(self, handle: RequestHandle,
                     exc: BaseException) -> None:
        """Fail one handle from the stepper thread (bad ``on_token``):
        tear its sequence down, free its pages, leave the engine up."""
        with self._update:
            if handle.done:     # cancelled/failed concurrently
                return
            if handle._seq is not None:
                self.core.cancel(handle._seq, trace_event=None)
            self.core.tracer.event(handle.uid, "FAILED",
                                   self.core.clock.now(), error=str(exc))
            self._c_failed.inc()
            handle.state = RequestState.FAILED
            handle.error = exc
            self._handles.pop(handle.uid, None)
            if self._tp:                # the followers cancel it too
                self._tp_failed.append(handle.uid)
            self._update.notify_all()

    def _die(self, exc: BaseException) -> None:
        with self._update:
            self._error = exc
            self._alive = False
            t = self.core.clock.now()
            for h in self._handles.values():
                if not h.done:
                    if h._seq is not None:  # queued-in-core: close trace
                        self.core.tracer.event(h.uid, "FAILED", t,
                                               error="engine died")
                    self._c_failed.inc()
                    h.state = RequestState.FAILED
                    h.error = exc
            self._handles.clear()
            self._update.notify_all()

    # ------------------------------------------------------------------
    def _check_alive(self) -> None:
        if self._error is not None:
            raise AsyncEngineError(
                "engine stepper died") from self._error
        if not self._alive:
            raise RuntimeError("engine is shut down")

    def _raise_if_failed(self, handle: RequestHandle) -> None:
        if handle.state is RequestState.FAILED:
            if handle.error is self._error and self._error is not None:
                raise AsyncEngineError(
                    "engine stepper died") from self._error
            raise AsyncEngineError(
                f"request {handle.uid} failed") from handle.error
