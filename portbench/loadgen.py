"""The load generator: submits a run's requests to the engine, open loop
(on each request's due time, from one thread) or closed loop (each client
sends its next request from the last one's final-token callback), and
stamps every output token with ``time.perf_counter`` in ``on_token``.

A request's latency clock starts when it was due (open loop) or sent
(closed loop), so a stall that delays later submissions counts against
them; how late the open-loop thread ran is kept per request.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from .mixes import Req, Traffic


@dataclasses.dataclass(eq=False)
class Record:
    """What the benchmark knows of one request it sent."""

    req: Req
    #: perf_counter when it was due (open loop) or sent (closed loop)
    t_start: float
    #: perf_counter when submit() was called
    t_submit: float = 0.0
    stamps: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    handle: object = None
    #: filled once the window closes: the handle FAILED, and the
    #: perf_counter of the step that gave it a slot (None: still queued)
    failed: bool = False
    t_sched: Optional[float] = None

    @property
    def finished(self) -> bool:
        return len(self.tokens) >= self.req.out_len


class LoadGen:
    """Drives ``traffic`` into ``engine`` from ``t0`` (perf_counter) until
    ``t_stop``: no request is due or sent from ``t_stop`` on."""

    def __init__(self, engine, traffic: Traffic,
                 make_request: Callable[[Req], object]) -> None:
        self.engine = engine
        self.traffic = traffic
        self.make_request = make_request
        self.records: List[Record] = []
        self._lock = threading.Lock()
        self._next = 0
        self._t_stop = 0.0
        self._thread: Optional[threading.Thread] = None
        self.errors: List[BaseException] = []

    # -- submission ------------------------------------------------------
    def _submit(self, req: Req, t_start: float) -> Record:
        rec = Record(req=req, t_start=t_start)
        closed = self.traffic.loop == "closed"

        def on_token(tok: int, rec=rec) -> None:
            now = time.perf_counter()
            rec.stamps.append(now)
            rec.tokens.append(tok)
            if closed and len(rec.tokens) == rec.req.out_len:
                self._send_next(now)

        with self._lock:
            self.records.append(rec)
        rec.t_submit = time.perf_counter()
        rec.handle = self.engine.submit(self.make_request(req),
                                        on_token=on_token)
        return rec

    def _take(self) -> Optional[Req]:
        with self._lock:
            if self._next >= len(self.traffic.requests):
                return None
            req = self.traffic.requests[self._next]
            self._next += 1
            return req

    def _send_next(self, now: float) -> None:
        if now >= self._t_stop:
            return
        req = self._take()
        if req is None:
            self.errors.append(RuntimeError(
                "closed loop ran out of requests; raise "
                "CLOSED_POOL_PER_CLIENT"))
            return
        self._submit(req, now)

    def _open_loop(self, t0: float) -> None:
        try:
            while True:
                req = self._take()
                if req is None:
                    self.errors.append(RuntimeError(
                        "open loop ran out of arrivals before its stop"))
                    return
                due = t0 + req.due
                if due >= self._t_stop:
                    return
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                self._submit(req, due)
        except BaseException as e:      # noqa: BLE001 — reported by join
            self.errors.append(e)

    # -- control -----------------------------------------------------------
    def start(self, t0: float, t_stop: float) -> None:
        self._t_stop = t_stop
        if self.traffic.loop == "open":
            self._thread = threading.Thread(target=self._open_loop,
                                            args=(t0,), name="loadgen",
                                            daemon=True)
            self._thread.start()
        else:
            for _ in range(self.traffic.clients):
                self._send_next(t0)

    def join(self, timeout: float) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError("load generator did not stop")
        if self.errors:
            raise RuntimeError("load generator failed") from self.errors[0]

    def lateness_s(self) -> List[float]:
        """How late each open-loop submission ran after its due time."""
        if self.traffic.loop != "open":
            return []
        return [r.t_submit - r.t_start for r in self.records]


def _series(snap: Dict, kind: str, name: str, **labels) -> Dict:
    """One series of a registry snapshot; raises where the program's
    registry has none, so a renamed or missing counter stops the run
    instead of reading as 0."""
    want = {k: str(v) for k, v in labels.items()}
    for e in snap[kind]:
        if e["name"] == name and e["labels"] == want:
            return e
    raise KeyError(f"the program's registry has no {kind[:-1]} {name} "
                   f"{want or ''}: the metrics that read it cannot be read")


def counters(registry) -> Dict[str, float]:
    """The program's counters the per-layer metrics read, at one moment."""
    snap = registry.snapshot()
    occ = _series(snap, "histograms", "serving.batch.occupancy")
    disp = _series(snap, "histograms", "runner.decode.dispatch_ms",
                   shards=1)
    return {
        "decode_s": _series(snap, "counters",
                            "serving.phase.decode_s")["value"],
        "occupancy_sum": occ["sum"], "occupancy_count": occ["count"],
        "decode_dispatch_ms_sum": disp["sum"],
        "decode_dispatch_count": disp["count"],
    }


class PoolSampler:
    """Pages of the KV pool in use, from the pool's gauges (set by the
    engine after every step), read by :meth:`sample` during the window:
    ``live`` pages held by sequences, ``held`` those plus the retained
    pages that cache finished prompts' prefixes.  The pool itself is
    reserved whole at set-up, so ``memory_peak_bytes`` counts it full."""

    def __init__(self, registry) -> None:
        snap = registry.snapshot()
        self.total = int(_series(snap, "gauges",
                                 "kv_pool.pages_total")["value"])
        pb = [e["value"] for e in snap["gauges"]
              if e["name"] == "kv_pool.page_bytes"]
        if len(pb) != 1:
            raise KeyError("the program's registry has no single gauge "
                           "kv_pool.page_bytes")
        self.page_bytes = pb[0]
        _series(snap, "gauges", "kv_pool.pages_retained")
        self._free_labels = [e["labels"] for e in snap["gauges"]
                             if e["name"] == "kv_pool.pages_free"
                             and e["labels"].get("shard") == "0"]
        if not self._free_labels:
            raise KeyError("the program's registry has no gauge "
                           "kv_pool.pages_free")
        self._free = registry.get("kv_pool.pages_free")
        self._retained = registry.get("kv_pool.pages_retained")
        self.live_peak = self.held_peak = self.samples = 0

    def sample(self) -> None:
        free = sum(self._free.value(**lab) for lab in self._free_labels)
        held = self.total - 1 - int(free)      # page 0 is the scratch page
        live = held - int(self._retained.value())
        self.live_peak = max(self.live_peak, live)
        self.held_peak = max(self.held_peak, held)
        self.samples += 1

    def report(self) -> Dict[str, float]:
        return {"pages_total": self.total, "live_peak": self.live_peak,
                "held_peak": self.held_peak,
                "live_peak_share": 100.0 * self.live_peak / self.total,
                "live_peak_bytes": self.live_peak * self.page_bytes,
                "samples": self.samples}
