"""Prefix-affinity multi-replica router over engine-worker processes.

The port's counterpart of ``repro.serving.router``, with the same
placement, failure semantics, wire format and ``router.*`` metric names.
A **front door** spreads live traffic over N engine replicas, each its
own process with its own ``AsyncEngine``, KV page pool and CUDA context
(spawned by ``repro_torch.serving.supervisor``, served by
``repro_torch.serving.worker``).  The state that matters is *which
replica already holds a request's prefix pages*, so routing is
**prefix-affine**:

* every request's prompt is keyed by :func:`~repro_torch.serving.kv_pool.
  prefix_chain_key` — the same chain hash ``PrefixCache`` indexes
  pages by, capped at the first ``affinity_blocks`` full blocks (the
  shared system prompt, not the per-user tail);
* keyed requests route through an :class:`AffinityRing` — rendezvous
  (highest-random-weight) hashing over the live replicas — so equal
  prefixes always land on the replica whose pool already holds those
  pages, and a replica's death remaps *only its own* keyspace
  (minimal, deterministic redistribution);
* unkeyed requests (no full block) fall back to **least-loaded with
  power-of-two choices**: sample two live replicas, take the less
  loaded one.  Load is a TTL-cached scrape of each worker's
  ``/metrics.json`` — queue depth first (``scheduler.queue_depth``),
  then KV pressure (fewer ``kv_pool.pages_free``) — so a replica
  drowning in long prompts loses ties even when its in-flight count
  looks identical; when the scrape fails (worker mid-death, fake
  clients without a metrics endpoint) the score falls back to the
  router's own in-flight counts.

Robustness semantics:

* each request is driven by its own router thread streaming SSE frames
  from its worker over HTTP, bounded by an idle **timeout** per frame;
* a worker that dies (SIGKILL, OOM, crash) breaks its sockets: every
  in-flight request on it surfaces FAILED with the death as chained
  cause, the replica is drained from the ring (its keys redistribute
  to survivors) — detection is connection-level plus the supervisor's
  process monitor (:meth:`Router.mark_dead`);
* a request that died with **zero tokens received** (never reached
  PREFILLING on the worker, or prefilled but never sampled — recompute
  is idempotent either way) retries on a surviving replica, bounded by
  ``max_retries`` AND by the request's remaining ``deadline_s`` budget
  — the router never dispatches an attempt that has already blown its
  SLO, and each attempt forwards only the *remaining* budget as the
  wire field ``deadline_ms``;
* a replica that is *alive but failing* (timeouts, error frames, lossy
  streams) trips a per-replica **circuit breaker** after
  ``breaker_threshold`` consecutive failures: it leaves the ring and
  the fallback pool, and after ``breaker_probation_s`` the next pick
  issues a ``healthy()`` probe and readmits it on success.

The router exposes the ``AsyncEngine`` caller surface (``submit`` /
``stream`` / ``result`` / ``cancel`` / ``shutdown`` / ``registry``),
so :class:`~repro_torch.serving.http.HttpFrontend` serves a Router and a
local engine identically.  Router metrics (``router.*``): per-replica
in-flight gauges and request counters, affinity keyed/hit counters,
retry/failure/death counters.  Nothing here touches a device.
"""

from __future__ import annotations

import dataclasses
import http.client
import itertools
import json
import random
import threading
import time
from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    Optional, Tuple)

from .async_engine import (CancelledError, DeadlineExceededError,
                           RequestState)
from .engine import Completion, Request
from .kv_pool import prefix_chain_key


class RouterError(RuntimeError):
    """A request failed at the routing layer; the underlying error is
    chained as ``__cause__``."""


class WorkerDiedError(RouterError):
    """The worker serving a request died (connection broken / process
    gone) before the stream completed."""


class NoReplicasError(RouterError):
    """Every replica is dead — nothing left to route to."""


# ----------------------------------------------------------------------
# rendezvous hashing
# ----------------------------------------------------------------------
_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """SplitMix64-style finalizer: deterministic (no ``PYTHONHASHSEED``
    dependence beyond int hashing, which is identity), well-mixed, and
    cheap — the weight function rendezvous hashing ranks replicas by."""
    x &= _M64
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & _M64
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & _M64
    x ^= x >> 33
    return x


class AffinityRing:
    """Rendezvous (highest-random-weight) hash over live replica ids.

    ``pick(key)`` is a pure function of ``(key, live set)``: the same
    key always lands on the same live replica, and removing a replica
    remaps exactly the keys that were on it — the minimal,
    deterministic redistribution a prefix-page cache wants (a surviving
    replica's warm pages never move).
    """

    def __init__(self, replica_ids: Iterable[int]) -> None:
        self._live = set(int(r) for r in replica_ids)

    def live(self) -> Tuple[int, ...]:
        return tuple(sorted(self._live))

    def __contains__(self, rid: int) -> bool:
        return rid in self._live

    def add(self, rid: int) -> None:
        self._live.add(int(rid))

    def remove(self, rid: int) -> None:
        self._live.discard(int(rid))

    def pick(self, key: int) -> int:
        """The live replica with the highest weight for ``key``
        (ties — vanishingly rare 64-bit collisions — break on id)."""
        if not self._live:
            raise NoReplicasError("no live replicas in the ring")
        return max(sorted(self._live),
                   key=lambda rid: _mix64(key ^ _mix64(rid + 1)))


def pick_least_loaded(live: List[int], load: Any,
                      rng: random.Random) -> int:
    """Power-of-two-choices fallback for unkeyed requests: sample two
    live replicas, take the one with the lower load score (ties break
    on id).  ``load`` is either a dict of in-flight counts (the legacy
    signal) or a callable ``rid -> sortable score`` (the router passes
    its TTL-cached ``/metrics.json`` scrape).  Only ever sees ``live``,
    so it cannot pick a dead replica by construction."""
    if not live:
        raise NoReplicasError("no live replicas")
    score = load if callable(load) else (lambda r: load.get(r, 0))
    cands = rng.sample(live, 2) if len(live) >= 2 else list(live)
    return min(cands, key=lambda r: (score(r), r))


# ----------------------------------------------------------------------
# worker client (HTTP/SSE wire to one replica)
# ----------------------------------------------------------------------
def _iter_sse(resp) -> Iterator[Dict[str, Any]]:
    """Parse ``data:`` frames off an open SSE response; returns at
    ``[DONE]``.  EOF before ``[DONE]`` means the worker went away."""
    while True:
        line = resp.readline()
        if not line:
            raise WorkerDiedError("connection closed mid-stream")
        line = line.strip()
        if not line or not line.startswith(b"data:"):
            continue
        payload = line[len(b"data:"):].strip()
        if payload == b"[DONE]":
            return
        yield json.loads(payload)


class HttpWorkerClient:
    """Router-side client for one engine-worker's HTTP endpoint.

    ``stream_completion`` is a generator of parsed SSE event dicts
    (token frames, the ``done`` frame, worker-side ``error`` frames);
    closing it mid-stream closes the connection, which the worker's
    frontend turns into an engine-side ``cancel()``.  ``proc`` is the
    supervisor's process handle, consulted to tell a dead worker from
    a transient network error.
    """

    def __init__(self, host: str, port: int, *, proc: Any = None) -> None:
        self.host, self.port = host, int(port)
        self.proc = proc

    def alive(self) -> bool:
        return self.proc is None or self.proc.poll() is None

    def describe(self) -> str:
        return f"{self.host}:{self.port}"

    def stream_completion(self, body: Dict[str, Any], *,
                          timeout: float) -> Iterator[Dict[str, Any]]:
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout)
        try:
            try:
                conn.request(
                    "POST", "/v1/completions",
                    json.dumps({**body, "stream": True}),
                    headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
            except TimeoutError as e:
                raise TimeoutError(
                    f"worker {self.describe()}: no response within "
                    f"{timeout} s") from e
            except (ConnectionError, OSError) as e:
                raise WorkerDiedError(
                    f"worker {self.describe()} unreachable: {e}") from e
            if resp.status != 200:
                raise RouterError(
                    f"worker {self.describe()} rejected the request: "
                    f"HTTP {resp.status} {resp.read()[:300]!r}")
            try:
                yield from _iter_sse(resp)
            except TimeoutError as e:
                raise TimeoutError(
                    f"worker {self.describe()}: no frame within "
                    f"{timeout} s") from e
            except WorkerDiedError:
                raise
            except (ConnectionError, OSError) as e:
                raise WorkerDiedError(
                    f"worker {self.describe()} dropped the stream: "
                    f"{e}") from e
        finally:
            conn.close()

    def metrics(self, *, timeout: float = 0.5) -> Optional[Dict[str, Any]]:
        """One ``/metrics.json`` snapshot (the worker registry's
        ``snapshot()`` document), or None when the worker is
        unreachable — the router's load signal treats None as
        "fall back to in-flight counts".  The short default timeout
        bounds how long a mid-death worker can stall the load probe."""
        try:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=timeout)
            try:
                conn.request("GET", "/metrics.json")
                resp = conn.getresponse()
                if resp.status != 200:
                    return None
                return json.loads(resp.read())
            finally:
                conn.close()
        except (OSError, ValueError):
            return None

    def healthy(self, *, timeout: float = 2.0) -> bool:
        try:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=timeout)
            try:
                conn.request("GET", "/healthz")
                return conn.getresponse().status == 200
            finally:
                conn.close()
        except OSError:
            return False


# ----------------------------------------------------------------------
# router
# ----------------------------------------------------------------------
@dataclasses.dataclass(eq=False)        # identity semantics, like
class RouterHandle:                     # async_engine.RequestHandle
    """Caller's view of one routed request.  Mutable fields are written
    by the request's router thread under the router lock."""

    uid: int
    request: Request
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    completion: Optional[Completion] = None
    error: Optional[BaseException] = None
    replica: Optional[int] = None       # current / last attempted
    n_retries: int = 0
    on_token: Optional[Callable[[int], None]] = None
    _cancel: bool = False

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED,
                              RequestState.CANCELLED, RequestState.FAILED)


class Router:
    """Front-door load balancer over N engine-worker replicas (see the
    module docstring for the routing + failure semantics).

    ``workers`` maps replica id -> a worker client
    (:class:`HttpWorkerClient`, or any object with the same
    ``stream_completion``/``alive``/``describe`` surface — tests inject
    in-process fakes).
    """

    def __init__(self, workers: Dict[int, Any], *, page_size: int = 16,
                 affinity_blocks: int = 2, timeout_s: float = 120.0,
                 max_retries: int = 1, load_ttl: float = 0.5,
                 breaker_threshold: int = 3,
                 breaker_probation_s: float = 2.0,
                 registry=None, seed: int = 0,
                 tokenizer: Any = None) -> None:
        if not workers:
            raise ValueError("router needs at least one replica")
        if breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        from ..obs.metrics import MetricsRegistry
        self.workers = dict(workers)
        self.page_size = page_size
        self.affinity_blocks = affinity_blocks
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.load_ttl = load_ttl
        #: per-replica circuit breaker: ``breaker_threshold``
        #: CONSECUTIVE worker-attributable failures (death, timeout,
        #: error frame, lossy stream) open the breaker — the replica
        #: leaves the ring and the fallback pool without being declared
        #: dead; after ``breaker_probation_s`` the next pick issues a
        #: ``healthy()`` probe and a passing replica is readmitted.
        #: Catches the "alive but failing" replica the supervisor's
        #: process monitor can't see.
        self.breaker_threshold = breaker_threshold
        self.breaker_probation_s = breaker_probation_s
        self.tokenizer = tokenizer
        self.ring = AffinityRing(self.workers)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._update = threading.Condition(self._lock)
        self._uids = itertools.count()
        self._alive = True
        self._dead: Dict[int, BaseException] = {}
        self._fail_streak: Dict[int, int] = {r: 0 for r in self.workers}
        #: rid -> earliest monotonic time a health probe may run
        self._breaker: Dict[int, float] = {}
        self._inflight: Dict[int, int] = {r: 0 for r in self.workers}
        #: rid -> (expiry monotonic time, score) — the TTL cache in
        #: front of the ``/metrics.json`` load scrape
        self._load_cache: Dict[int, Tuple[float, Tuple]] = {}
        self._affinity_last: Dict[int, int] = {}    # key -> last replica
        self._threads: List[threading.Thread] = []

        reg = self.registry
        c_req = reg.counter("router.requests",
                            "requests dispatched to this replica "
                            "(retries re-count)")
        g_inf = reg.gauge("router.inflight",
                          "requests currently in flight on this replica")
        self._c_req = {r: c_req.labels(replica=r) for r in self.workers}
        self._g_inf = {r: g_inf.labels(replica=r) for r in self.workers}
        self._c_keyed = reg.counter(
            "router.affinity.keyed",
            "requests carrying a prefix-affinity key").labels()
        self._c_hits = reg.counter(
            "router.affinity.hits",
            "keyed requests routed to the same live replica as the "
            "previous request with that key").labels()
        self._c_retries = reg.counter(
            "router.retries",
            "requests re-dispatched to a surviving replica after a "
            "worker death (zero tokens received)").labels()
        self._c_failures = reg.counter(
            "router.failures", "requests that surfaced FAILED").labels()
        self._c_deaths = reg.counter(
            "router.replica_deaths",
            "replicas drained from the ring").labels()
        self._c_readmits = reg.counter(
            "router.readmissions",
            "respawned replicas re-admitted to the ring").labels()
        self._c_load_scrapes = reg.counter(
            "router.load_scrapes",
            "/metrics.json load probes issued (cache misses)").labels()
        self._c_breaker_open = reg.counter(
            "router.breaker_open",
            "circuit breakers opened (consecutive-failure threshold "
            "hit; replica on probation)").labels()
        self._c_breaker_closed = reg.counter(
            "router.breaker_closed",
            "circuit breakers closed after a passing health probe"
            ).labels()
        self._c_breaker_probes = reg.counter(
            "router.breaker_probes",
            "health probes issued for breaker-open replicas").labels()
        self._g_live = reg.gauge(
            "router.replicas_live", "live replicas in the ring").labels()
        self._g_live.set(len(self.workers))

    # ------------------------------------------------------------------
    # caller API (the AsyncEngine surface)
    # ------------------------------------------------------------------
    def submit(self, request: Request, *,
               on_token: Optional[Callable[[int], None]] = None,
               ) -> RouterHandle:
        """Route a request; returns immediately.  A dedicated router
        thread streams it from its worker."""
        with self._lock:
            if not self._alive:
                raise RouterError("router is shut down")
            uid = next(self._uids)
        handle = RouterHandle(
            uid=uid, request=dataclasses.replace(request, uid=uid),
            on_token=on_token)
        t = threading.Thread(target=self._run, args=(handle,),
                             name=f"router-req-{uid}", daemon=True)
        with self._lock:
            self._threads.append(t)
            self._threads = [x for x in self._threads if x.is_alive()
                             or x is t]
        t.start()
        return handle

    def stream(self, handle: RouterHandle, *,
               timeout: Optional[float] = None) -> Iterator[int]:
        """Yield tokens as worker frames arrive; returns at a terminal
        state (raises on FAILED).  ``timeout`` bounds each wait for the
        *next* token."""
        cursor = 0
        while True:
            with self._update:
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

    def result(self, handle: RouterHandle, *,
               timeout: Optional[float] = None) -> Completion:
        with self._update:
            if not self._update.wait_for(lambda: handle.done,
                                         timeout=timeout):
                raise TimeoutError(
                    f"request {handle.uid} not done within {timeout} s")
            self._raise_if_failed(handle)
            if handle.state is RequestState.CANCELLED:
                raise CancelledError(
                    f"request {handle.uid} was cancelled")
            return handle.completion

    def cancel(self, handle: RouterHandle) -> bool:
        """Ask the request's router thread to stop; closing its worker
        connection makes the worker cancel engine-side (slot + pages
        free).  Returns False when already terminal."""
        with self._update:
            if handle.done:
                return False
            handle._cancel = True
            self._update.notify_all()
        return True

    def mark_dead(self, rid: int,
                  cause: Optional[BaseException] = None) -> bool:
        """Drain a replica: out of the ring (its keyspace redistributes
        to survivors), out of the fallback pool.  Called by request
        threads on connection-level detection and by the supervisor's
        process monitor.  Idempotent."""
        with self._lock:
            if rid in self._dead or rid not in self.workers:
                return False
            self._dead[rid] = (cause if cause is not None
                               else WorkerDiedError(f"replica {rid} died"))
            self.ring.remove(rid)
            self._load_cache.pop(rid, None)
            self._c_deaths.inc()
            self._g_live.set(len(self._live_locked()))
        return True

    def readmit(self, rid: int, client: Any = None) -> bool:
        """Re-admit a respawned replica: fresh worker client, back in
        the affinity ring (its old keyspace deterministically returns —
        rendezvous hashing) and the least-loaded pool.  Inverse of
        :meth:`mark_dead`; the launcher wires it to the supervisor's
        ``on_respawn`` hook.  Idempotent on a live replica."""
        with self._lock:
            if rid not in self.workers:
                return False
            if client is not None:
                self.workers[rid] = client
            if rid not in self._dead and rid not in self._breaker:
                return False
            self._dead.pop(rid, None)
            # a respawned worker starts with a clean slate: breaker
            # closed, streak zeroed
            self._breaker.pop(rid, None)
            self._fail_streak[rid] = 0
            self.ring.add(rid)
            self._inflight[rid] = 0
            self._g_inf[rid].set(0)
            self._load_cache.pop(rid, None)
            self._c_readmits.inc()
            self._g_live.set(len(self._live_locked()))
        return True

    def health(self) -> Dict[str, Any]:
        with self._lock:
            return {"replicas": {
                str(r): {"alive": r not in self._dead,
                         "breaker_open": r in self._breaker}
                for r in sorted(self.workers)},
                "live": len(self._live_locked())}

    def shutdown(self, *, timeout: float = 10.0) -> None:
        """Stop accepting, cancel in-flight requests, join request
        threads.  Worker *processes* belong to the supervisor."""
        with self._update:
            self._alive = False
            threads = list(self._threads)
            self._update.notify_all()
        deadline = time.perf_counter() + timeout
        for t in threads:
            t.join(timeout=max(deadline - time.perf_counter(), 0.1))

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.shutdown()

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def _live_locked(self) -> List[int]:
        return [r for r in sorted(self.workers)
                if r not in self._dead and r not in self._breaker]

    # ------------------------------------------------------------------
    # circuit breaker
    # ------------------------------------------------------------------
    def _record_failure(self, rid: int) -> None:
        """One worker-attributable failure (death, timeout, error
        frame, lossy stream).  At ``breaker_threshold`` consecutive
        failures the breaker opens: out of the ring and the fallback
        pool until a probation-gated health probe passes."""
        with self._lock:
            self._fail_streak[rid] = self._fail_streak.get(rid, 0) + 1
            if (self._fail_streak[rid] >= self.breaker_threshold
                    and rid not in self._breaker):
                self._breaker[rid] = (time.monotonic()
                                      + self.breaker_probation_s)
                self.ring.remove(rid)
                self._load_cache.pop(rid, None)
                self._c_breaker_open.inc()
                self._g_live.set(len(self._live_locked()))

    def _record_success(self, rid: int) -> None:
        with self._lock:
            self._fail_streak[rid] = 0

    def _probe_breakers(self) -> None:
        """Readmit breaker-open replicas whose probation elapsed and
        whose ``healthy()`` probe passes.  Probes run OUTSIDE the lock
        (network call); a failing probe re-arms the probation window."""
        now = time.monotonic()
        with self._lock:
            due = [r for r, t in self._breaker.items()
                   if t <= now and r not in self._dead]
        for rid in due:
            probe = getattr(self.workers[rid], "healthy", None)
            self._c_breaker_probes.inc()
            ok = probe(timeout=2.0) if callable(probe) else True
            with self._lock:
                if rid not in self._breaker:    # raced with readmit()
                    continue
                if ok:
                    del self._breaker[rid]
                    self._fail_streak[rid] = 0
                    if rid not in self._dead:
                        self.ring.add(rid)
                    self._load_cache.pop(rid, None)
                    self._c_breaker_closed.inc()
                else:
                    self._breaker[rid] = (time.monotonic()
                                          + self.breaker_probation_s)
                self._g_live.set(len(self._live_locked()))

    def _load_score(self, rid: int) -> Tuple:
        """Load rank for the power-of-two fallback, lower = less
        loaded: ``(queue depth, -free KV pages)`` scraped from the
        worker's ``/metrics.json`` behind a ``load_ttl``-second cache
        (two probes per unkeyed request at most once per TTL).  A
        failed scrape — dead worker, fake client without a metrics
        endpoint — scores by the router's own in-flight count, which
        compares sanely against scraped scores (queued requests vs
        dispatched requests, same scale)."""
        now = time.monotonic()
        hit = self._load_cache.get(rid)
        if hit is not None and hit[0] > now:
            return hit[1]
        score: Optional[Tuple] = None
        fn = getattr(self.workers[rid], "metrics", None)
        if fn is not None:
            self._c_load_scrapes.inc()
            snap = fn()
            if snap:
                queue = free = None
                for g in snap.get("gauges", ()):
                    if g.get("name") == "scheduler.queue_depth":
                        queue = (queue or 0.0) + float(g["value"])
                    elif g.get("name") == "kv_pool.pages_free":
                        free = (free or 0.0) + float(g["value"])
                if queue is not None or free is not None:
                    score = (queue or 0.0, -(free or 0.0))
        if score is None:
            score = (float(self._inflight.get(rid, 0)), 0.0)
        self._load_cache[rid] = (now + self.load_ttl, score)
        return score

    def affinity_key(self, prompt: List[int]) -> Optional[int]:
        return prefix_chain_key(prompt, self.page_size,
                                max_blocks=self.affinity_blocks)

    def _pick(self, key: Optional[int]) -> int:
        if self._breaker:       # probation over? probe + readmit
            self._probe_breakers()
        with self._lock:
            live = self._live_locked()
            if not live:
                raise NoReplicasError(
                    "all replicas are dead or breaker-open: "
                    + "; ".join(f"{r}: {e}"
                                for r, e in sorted(self._dead.items()))
                    + (f"; breaker-open: {sorted(self._breaker)}"
                       if self._breaker else ""))
            if key is not None:
                rid = self.ring.pick(key)
                self._c_keyed.inc()
                if self._affinity_last.get(key) == rid:
                    self._c_hits.inc()
                self._affinity_last[key] = rid
            else:
                rid = pick_least_loaded(live, self._load_score, self._rng)
            self._inflight[rid] += 1
            self._g_inf[rid].set(self._inflight[rid])
            self._c_req[rid].inc()
            return rid

    # ------------------------------------------------------------------
    # per-request driver thread
    # ------------------------------------------------------------------
    def _run(self, handle: RouterHandle) -> None:
        req = handle.request
        key = self.affinity_key(req.prompt)
        sp = req.sampling
        body = {"prompt": list(req.prompt),
                "max_tokens": sp.max_new_tokens,
                "temperature": sp.temperature, "top_k": sp.top_k,
                "eos_id": sp.eos_id}
        if req.priority != "interactive":
            body["priority"] = req.priority
        t0 = time.perf_counter()
        # the deadline budget is anchored at router ingress; each
        # attempt forwards only the *remaining* budget, so a retry
        # after a slow first attempt cannot overrun the caller's SLO
        deadline_abs = (t0 + req.deadline_s
                        if req.deadline_s is not None else None)
        while True:
            if handle._cancel or not self._alive:
                self._terminate(handle, RequestState.CANCELLED)
                return
            if deadline_abs is not None:
                remaining = deadline_abs - time.perf_counter()
                if remaining <= 0:
                    self._fail(handle, DeadlineExceededError(
                        f"request {handle.uid} spent its "
                        f"{req.deadline_s} s budget at the router "
                        f"(after {handle.n_retries} retries)"))
                    return
                body["deadline_ms"] = remaining * 1e3
            try:
                rid = self._pick(key)
            except NoReplicasError as e:
                self._fail(handle, e)
                return
            with self._update:
                handle.replica = rid
                handle.state = RequestState.PREFILLING
                self._update.notify_all()
            done_info: Optional[Dict[str, Any]] = None
            t_first: Optional[float] = None
            try:
                try:
                    gen = self.workers[rid].stream_completion(
                        body, timeout=self.timeout_s)
                    for ev in gen:
                        if handle._cancel or not self._alive:
                            gen.close()     # -> conn close -> worker
                            self._terminate(handle,   # cancels engine-side
                                            RequestState.CANCELLED)
                            return
                        if "token" in ev:
                            if t_first is None:
                                t_first = time.perf_counter()
                            self._emit(handle, int(ev["token"]))
                        elif "error" in ev:
                            err = ev["error"]
                            raise RouterError(
                                f"worker {rid} failed the request: "
                                f"{err.get('type')}: {err.get('message')}"
                                + (f" (cause: {err['cause']})"
                                   if err.get("cause") else ""))
                        elif "done" in ev:
                            done_info = ev["done"]
                finally:
                    self._release(rid)
            except WorkerDiedError as e:
                alive = self.workers[rid].alive()
                self._record_failure(rid)
                self.mark_dead(rid, cause=e)
                can_retry = (not handle.tokens
                             and handle.n_retries < self.max_retries
                             and (deadline_abs is None
                                  or time.perf_counter() < deadline_abs))
                if can_retry:
                    handle.n_retries += 1
                    self._c_retries.inc()
                    continue
                err = WorkerDiedError(
                    f"replica {rid} died "
                    f"{'mid-stream' if handle.tokens else 'mid-queue'} "
                    f"(process alive={alive})")
                err.__cause__ = e
                self._fail(handle, err)
                return
            except BaseException as e:          # noqa: BLE001 — timeout,
                if isinstance(e, (TimeoutError, RouterError)):
                    self._record_failure(rid)   # worker-attributable
                self._fail(handle, e)           # worker reject, client bug
                return
            t1 = time.perf_counter()
            comp = Completion(
                uid=handle.uid, prompt_len=len(req.prompt),
                tokens=list(handle.tokens), latency_s=t1 - t0,
                prefill_s=max((t_first or t1) - t0, 0.0), t0=t0, t1=t1,
                t_first=t_first if t_first is not None else t1,
                t_sched=t0)
            if done_info is not None:
                n = done_info.get("completion_tokens")
                if n is not None and n != len(handle.tokens):
                    self._record_failure(rid)   # lossy stream
                    self._fail(handle, RouterError(
                        f"worker {rid} reported {n} tokens but "
                        f"{len(handle.tokens)} frames arrived"))
                    return
            self._record_success(rid)
            with self._update:
                handle.completion = comp
                handle.state = RequestState.FINISHED
                self._update.notify_all()
            return

    def _emit(self, handle: RouterHandle, tok: int) -> None:
        with self._update:
            handle.tokens.append(tok)
            if handle.state is RequestState.PREFILLING:
                handle.state = RequestState.DECODING
            self._update.notify_all()
        if handle.on_token is not None:
            handle.on_token(tok)    # outside the lock, like AsyncEngine

    def _release(self, rid: int) -> None:
        with self._lock:
            self._inflight[rid] = max(self._inflight[rid] - 1, 0)
            self._g_inf[rid].set(self._inflight[rid])

    def _terminate(self, handle: RouterHandle,
                   state: RequestState) -> None:
        with self._update:
            if not handle.done:
                handle.state = state
            self._update.notify_all()

    def _fail(self, handle: RouterHandle, exc: BaseException) -> None:
        self._c_failures.inc()
        with self._update:
            if not handle.done:
                handle.error = exc
                handle.state = RequestState.FAILED
            self._update.notify_all()

    def _raise_if_failed(self, handle: RouterHandle) -> None:
        if handle.state is RequestState.FAILED:
            raise RouterError(
                f"request {handle.uid} failed") from handle.error
