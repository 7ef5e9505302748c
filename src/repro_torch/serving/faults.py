"""Deterministic fault injection for the serving stack.

Chaos testing needs *injectable* failure, not flaky tests: the robust
paths in this repo (worker-death failover, circuit breaking, load
shedding, deadline expiry) only execute when something goes wrong, so
the test suite and the ``tools/check.sh`` chaos smoke lane must be able
to make things go wrong **on demand and deterministically**.  This
module is that switchboard — dependency-free (stdlib only) and
**zero-cost when disarmed**: every instrumented call site guards on the
module-level :data:`ACTIVE` flag, so production pays one attribute load
and a falsy check.

A *fault point* is a string name with a float value; what the value
means is the call site's contract (documented in
``docs/robustness.md`` "Fault points"):

===================  ==================================================
``step.latency_ms``  :meth:`EngineCore.step` sleeps this many
                     milliseconds at the top of every step — a slow /
                     overloaded worker.
``http.drop_sse``    the HTTP front-end silently drops every N-th
                     token frame it would have streamed (the ``done``
                     frame still reports the true count, so the router
                     detects the mismatch) — a lossy worker stream.
``pool.exhaust``     every N-th *fresh admission* page grant fails as
                     if the KV pool were out of pages — memory
                     pressure without building a tiny pool.
``http.scrape_ms``   ``GET /metrics.json`` sleeps this many
                     milliseconds before answering — a slow load-probe
                     target for the router's TTL cache.
===================  ==================================================

Arming:

* in-process (tests): :func:`arm` / :func:`reset`;
* across processes (chaos smoke): the ``REPRO_FAULTS`` environment
  variable — ``"step.latency_ms=40,http.drop_sse=3"`` — parsed by
  :func:`load_env`, which an engine worker process calls at startup.
  Supervisor-spawned workers inherit the parent environment, so
  exporting ``REPRO_FAULTS`` before ``--http --replicas N`` arms every
  worker in the fleet.

Every firing is counted (:func:`hits`), so tests can assert a fault
actually fired rather than passing vacuously.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict

#: fast-path guard: call sites check ``faults.ACTIVE`` before anything
#: else, so a disarmed registry costs one attribute load per site
ACTIVE = False

_ARMED: Dict[str, float] = {}
_HITS: Dict[str, int] = {}
_FIRE_COUNTS: Dict[str, int] = {}       # every-N-th bookkeeping
_LOCK = threading.Lock()

ENV_VAR = "REPRO_FAULTS"


def arm(name: str, value: float) -> None:
    """Arm one fault point.  ``value`` semantics are per-point (a
    latency in ms, an every-N-th period, ...)."""
    global ACTIVE
    with _LOCK:
        _ARMED[str(name)] = float(value)
        ACTIVE = True


def disarm(name: str) -> None:
    global ACTIVE
    with _LOCK:
        _ARMED.pop(name, None)
        _FIRE_COUNTS.pop(name, None)
        ACTIVE = bool(_ARMED)


def reset() -> None:
    """Disarm everything and zero the hit counters (test teardown)."""
    global ACTIVE
    with _LOCK:
        _ARMED.clear()
        _HITS.clear()
        _FIRE_COUNTS.clear()
        ACTIVE = False


def armed(name: str) -> bool:
    return name in _ARMED


def value(name: str, default: float = 0.0) -> float:
    return _ARMED.get(name, default)


def hits(name: str) -> int:
    """How many times fault ``name`` actually fired."""
    return _HITS.get(name, 0)


def _record(name: str) -> None:
    with _LOCK:
        _HITS[name] = _HITS.get(name, 0) + 1


# ----------------------------------------------------------------------
# call-site helpers
# ----------------------------------------------------------------------
def maybe_sleep(name: str) -> None:
    """Sleep ``value(name)`` milliseconds when armed (latency faults)."""
    ms = _ARMED.get(name)
    if ms is None or ms <= 0:
        return
    _record(name)
    time.sleep(ms / 1e3)


def should_fire(name: str) -> bool:
    """Every-N-th firing: with ``value(name) == N`` (>= 1), returns
    True on the N-th, 2N-th, ... call since arming.  Deterministic by
    construction — no randomness, so chaos tests replay exactly."""
    n = _ARMED.get(name)
    if n is None or n < 1:
        return False
    with _LOCK:
        c = _FIRE_COUNTS.get(name, 0) + 1
        _FIRE_COUNTS[name] = c
        fire = c % int(n) == 0
    if fire:
        _HITS[name] = _HITS.get(name, 0) + 1
    return fire


def load_env(env: str = ENV_VAR) -> int:
    """Arm fault points from ``$REPRO_FAULTS`` (comma-separated
    ``name=value`` pairs); returns how many were armed.  Unparseable
    entries are skipped — a typo in a chaos run must not take the
    worker down with an unrelated error."""
    spec = os.environ.get(env, "")
    n = 0
    for part in spec.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, val = part.partition("=")
        if not name.strip():
            continue
        try:
            arm(name.strip(), float(val))
            n += 1
        except ValueError:
            continue
    return n
