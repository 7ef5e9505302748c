"""Per-request trace spans for the serving stack.

Every request served by the paged engines walks the lifecycle
``QUEUED -> PREFILLING -> DECODING -> FINISHED`` (or ``CANCELLED`` /
``FAILED``, with ``PREEMPTED`` bouncing back to ``QUEUED``).  The
:class:`RequestTracer` records that walk as an append-only stream of
**events** — one ``(uid, name, t, attrs)`` tuple per state transition
or annotation, stamped from the engine's injected
:class:`~repro_torch.serving.core.Clock` so tests trace in virtual time and
production traces in monotonic wall seconds.

Event names (``docs/observability.md`` "Trace schema"):

=============  ========================================================
state events   ``QUEUED``, ``PREFILLING``, ``DECODING``, ``FINISHED``,
               ``CANCELLED``, ``FAILED`` — each opens the span the
               next state event closes
annotations    ``PREFILL_CHUNK`` (one per chunk: ``start``/``n``
               attrs), ``PREEMPTED`` (recompute restart — next state
               event is a fresh ``PREFILLING``), ``COW`` (page clones
               applied before this request's chunk resumed)
=============  ========================================================

Export is JSONL — one ``{"uid":…, "event":…, "t":…, …attrs}`` object
per line, keyed by request uid (:meth:`RequestTracer.to_jsonl`) —
chosen over a nested document so a long-running server can append and
rotate.  :func:`reconstruct_spans` folds an event stream back into
per-uid ``(state, t_start, t_end)`` spans; :func:`validate_events`
checks the invariants the acceptance bench asserts (per-uid monotone
stamps, lifecycle starts at QUEUED and reaches a terminal state).

:class:`NullTracer` is the no-op twin (tracing disabled / overhead
baseline).  ``event()`` appends one tuple to a list — O(1), no
formatting — so tracing sits inside the <= 3% observability budget.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, IO, Iterable, List, Optional, Tuple

STATE_EVENTS = ("QUEUED", "PREFILLING", "DECODING", "FINISHED",
                "CANCELLED", "FAILED")
TERMINAL_EVENTS = ("FINISHED", "CANCELLED", "FAILED")
ANNOTATION_EVENTS = ("PREFILL_CHUNK", "PREEMPTED", "COW")


class TraceEvent(Tuple[int, str, float, dict]):
    """Lightweight view: ``(uid, name, t, attrs)`` named accessors."""

    __slots__ = ()

    @property
    def uid(self) -> int:
        return self[0]

    @property
    def name(self) -> str:
        return self[1]

    @property
    def t(self) -> float:
        return self[2]

    @property
    def attrs(self) -> dict:
        return self[3]


class RequestTracer:
    """Append-only per-request event recorder (see module docstring).

    Writes come from one engine thread (the core's driver or the async
    stepper); reads (``events``/``to_jsonl``) may come from another, so
    the buffer is guarded by a lock taken only on read and on the
    rare-by-design append (one tuple per state change, not per token).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: List[TraceEvent] = []

    def __len__(self) -> int:
        return len(self._events)

    @property
    def enabled(self) -> bool:
        return True

    def event(self, uid: int, name: str, t: float, **attrs: object) -> None:
        with self._lock:
            self._events.append(TraceEvent((uid, name, t, attrs)))

    # -- read side --------------------------------------------------------
    def events(self, uid: Optional[int] = None) -> List[TraceEvent]:
        with self._lock:
            evs = list(self._events)
        if uid is None:
            return evs
        return [e for e in evs if e.uid == uid]

    def spans(self, uid: int) -> List[Tuple[str, float, float]]:
        """This uid's reconstructed ``(state, t_start, t_end)`` spans
        (the last span's end repeats its start when still open)."""
        return reconstruct_spans(self.events(uid)).get(uid, [])

    def to_jsonl(self, f: IO[str]) -> int:
        """Write every event as one JSON object per line; returns the
        number of lines written."""
        evs = self.events()
        for e in evs:
            doc = {"uid": e.uid, "event": e.name, "t": e.t}
            doc.update(e.attrs)
            f.write(json.dumps(doc, sort_keys=True) + "\n")
        return len(evs)

    def write_jsonl(self, path: str) -> int:
        with open(path, "w") as f:
            return self.to_jsonl(f)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


class NullTracer(RequestTracer):
    """No-op twin: tracing disabled (and the overhead baseline)."""

    @property
    def enabled(self) -> bool:
        return False

    def event(self, uid: int, name: str, t: float, **attrs: object) -> None:
        pass


def load_jsonl(path: str) -> List[TraceEvent]:
    """Read a ``to_jsonl`` export back into events."""
    out: List[TraceEvent] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            doc = json.loads(line)
            attrs = {k: v for k, v in doc.items()
                     if k not in ("uid", "event", "t")}
            out.append(TraceEvent(
                (int(doc["uid"]), str(doc["event"]), float(doc["t"]),
                 attrs)))
    return out


def reconstruct_spans(events: Iterable[TraceEvent],
                      ) -> Dict[int, List[Tuple[str, float, float]]]:
    """Fold a (time-ordered per uid) event stream into per-uid spans:
    each *state* event opens a span the next state event closes;
    annotations never open spans.  A terminal state is a zero-length
    span marking the end stamp."""
    out: Dict[int, List[Tuple[str, float, float]]] = {}
    open_span: Dict[int, Tuple[str, float]] = {}
    for e in events:
        if e.name not in STATE_EVENTS:
            continue
        prev = open_span.get(e.uid)
        if prev is not None:
            out.setdefault(e.uid, []).append((prev[0], prev[1], e.t))
        open_span[e.uid] = (e.name, e.t)
    for uid, (name, t) in open_span.items():
        out.setdefault(uid, []).append((name, t, t))
    return out


def validate_events(events: Iterable[TraceEvent],
                    require_terminal: bool = True) -> List[str]:
    """Lifecycle invariants; returns human-readable problems (empty =
    valid).  Checks, per uid: stamps monotone non-decreasing in stream
    order, first state event is QUEUED, nothing follows a terminal
    event, and (``require_terminal``) the lifecycle reaches FINISHED /
    CANCELLED / FAILED."""
    problems: List[str] = []
    last_t: Dict[int, float] = {}
    first_state: Dict[int, str] = {}
    terminal: Dict[int, str] = {}
    seen: Dict[int, int] = {}
    for e in events:
        seen[e.uid] = seen.get(e.uid, 0) + 1
        if e.name not in STATE_EVENTS + ANNOTATION_EVENTS:
            problems.append(f"uid {e.uid}: unknown event {e.name!r}")
        if e.uid in last_t and e.t < last_t[e.uid] - 1e-12:
            problems.append(
                f"uid {e.uid}: non-monotone stamp {e.t!r} after "
                f"{last_t[e.uid]!r} ({e.name})")
        last_t[e.uid] = e.t
        if e.uid in terminal:
            problems.append(
                f"uid {e.uid}: event {e.name} after terminal "
                f"{terminal[e.uid]}")
        if e.name in STATE_EVENTS and e.uid not in first_state:
            first_state[e.uid] = e.name
        if e.name in TERMINAL_EVENTS:
            terminal[e.uid] = e.name
    for uid, name in first_state.items():
        if name != "QUEUED":
            problems.append(f"uid {uid}: lifecycle starts at {name}, "
                            "not QUEUED")
    if require_terminal:
        for uid in seen:
            if uid not in terminal:
                problems.append(f"uid {uid}: no terminal event")
    return problems
