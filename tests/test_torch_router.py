"""The port's router and worker fleet (``repro_torch.serving.router``,
``.supervisor``, ``.worker``) vs the reference.

* Port twins of ``tests/test_router.py`` (``TestAffinityRing``,
  ``TestPrefixChainKey``, ``TestRouterFakeWorkers``,
  ``TestScrapedLoadSignal``) and of ``tests/test_slo.py``'s
  ``TestRouterBreaker`` and ``TestRouterDeadlines``, over in-process fake
  workers.
* Across the packages: the same keys and prompts pick the same replica
  (``_mix64``, ``AffinityRing.pick``, ``Router.affinity_key``,
  ``pick_least_loaded`` on the same seed).
* The fleet over real worker subprocesses on the CPU (``slow``):
  ``Supervisor`` + ``Router`` + ``HttpFrontend`` over two port workers
  serving bench-tiny on the reference's ``PRNGKey(0)`` weights
  (``--params``): greedy tokens over the wire equal the reference's
  in-process ``AsyncEngine``, a re-asked prompt is an affinity hit, a
  SIGKILL mid-stream fails the request with a chained
  ``WorkerDiedError``, a respawn heals the fleet, and no child outlives
  ``shutdown()``.  A worker asked for ``--device cuda`` on a machine
  without a GPU fails before its READY line.
"""

import http.client
import json
import random
import threading
import time

import jax
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st
from test_slo import LossyWorker

import repro.serving.router as jrouter
from repro.serving import prefix_chain_key as jprefix_chain_key
from repro_torch.models.weights import save_params_npz
from repro_torch.serving import (DeadlineExceededError, HttpFrontend,
                                 NoReplicasError, Request, RouterError,
                                 SamplingParams, Supervisor,
                                 WorkerDiedError, WorkerStartupError,
                                 prefix_chain_key)
from repro_torch.serving.async_engine import RequestState
from repro_torch.serving.router import (AffinityRing, Router, _mix64,
                                        pick_least_loaded)

KEYS = st.integers(min_value=0, max_value=(1 << 64) - 1)
RIDS = st.lists(st.integers(min_value=0, max_value=31), min_size=1,
                max_size=8)
KEYED = list(range(1, 33))      # two full 16-token blocks -> keyed
UNKEYED = [1, 2, 3]             # < one full block: least-loaded fallback


def _req(prompt, max_new=3, **kw):
    return Request(uid=0, prompt=prompt,
                   sampling=SamplingParams(max_new_tokens=max_new), **kw)


# ----------------------------------------------------------------------
# affinity ring
# ----------------------------------------------------------------------
class TestAffinityRing:
    @settings(max_examples=50)
    @given(KEYS, RIDS)
    def test_pick_is_deterministic_across_instances(self, key, rids):
        a, b = AffinityRing(rids), AffinityRing(reversed(rids))
        assert a.pick(key) == b.pick(key)
        assert a.pick(key) in a.live()

    @settings(max_examples=30)
    @given(st.lists(KEYS, min_size=1, max_size=40), RIDS)
    def test_death_remaps_only_the_dead_replicas_keys(self, keys, rids):
        ring = AffinityRing(rids)
        before = {k: ring.pick(k) for k in keys}
        victim = sorted(set(rids))[0]
        ring.remove(victim)
        if not ring.live():
            return
        for k in keys:
            after = ring.pick(k)
            if before[k] != victim:
                assert after == before[k]
            else:
                assert after != victim and after in ring.live()

    @settings(max_examples=30)
    @given(st.lists(KEYS, min_size=1, max_size=40), RIDS)
    def test_rejoin_restores_the_original_map(self, keys, rids):
        ring = AffinityRing(rids)
        before = {k: ring.pick(k) for k in keys}
        victim = max(rids)
        ring.remove(victim)
        ring.add(victim)
        assert {k: ring.pick(k) for k in keys} == before

    def test_empty_ring_raises(self):
        ring = AffinityRing([1])
        ring.remove(1)
        with pytest.raises(NoReplicasError):
            ring.pick(123)

    def test_mix64_spreads_consecutive_keys(self):
        picks = {AffinityRing(range(4)).pick(k) for k in range(64)}
        assert picks == set(range(4))
        assert len({_mix64(x) for x in range(1000)}) == 1000

    @settings(max_examples=50)
    @given(RIDS, st.lists(st.integers(min_value=0, max_value=31),
                          max_size=4),
           st.integers(min_value=0, max_value=999))
    def test_least_loaded_never_picks_a_dead_replica(self, rids, dead,
                                                     seed):
        live = sorted(set(rids) - set(dead))
        if not live:
            return
        inflight = {r: r % 3 for r in set(rids) | set(dead)}
        assert pick_least_loaded(live, inflight,
                                 random.Random(seed)) in live

    def test_least_loaded_prefers_the_lighter_of_two(self):
        rng = random.Random(0)
        assert all(pick_least_loaded([0, 1], {0: 5, 1: 0}, rng) == 1
                   for _ in range(20))

    def test_least_loaded_accepts_a_score_callable(self):
        rng = random.Random(0)
        score = {0: (3.0, -2.0), 1: (0.0, -9.0)}
        assert all(pick_least_loaded([0, 1], lambda r: score[r], rng) == 1
                   for _ in range(20))


class TestAgainstReference:
    @settings(max_examples=50)
    @given(KEYS, RIDS)
    def test_same_key_same_replica(self, key, rids):
        assert _mix64(key) == jrouter._mix64(key)
        assert (AffinityRing(rids).pick(key)
                == jrouter.AffinityRing(rids).pick(key))

    @settings(max_examples=30)
    @given(st.lists(st.integers(min_value=0, max_value=258), min_size=0,
                    max_size=70),
           st.integers(min_value=1, max_value=5))
    def test_same_prompt_same_key_and_replica(self, prompt, n):
        ids = list(range(n))
        t = Router({r: FakeWorker() for r in ids}, page_size=16)
        j = jrouter.Router({r: FakeWorker() for r in ids}, page_size=16)
        key = t.affinity_key(prompt)
        assert key == j.affinity_key(prompt)
        assert key == jprefix_chain_key(prompt, 16, max_blocks=2)
        if key is not None:
            assert t.ring.pick(key) == j.ring.pick(key)
        t.shutdown()
        j.shutdown()

    @settings(max_examples=30)
    @given(RIDS, st.integers(min_value=0, max_value=999))
    def test_least_loaded_same_pick_on_the_same_seed(self, rids, seed):
        live = sorted(set(rids))
        load = {r: (r * 7) % 5 for r in live}
        t, j = random.Random(seed), random.Random(seed)
        for _ in range(5):
            assert (pick_least_loaded(live, load, t)
                    == jrouter.pick_least_loaded(live, load, j))


class TestPrefixChainKey:
    def test_same_full_blocks_same_key_despite_tail(self):
        a = prefix_chain_key(list(range(32)) + [1, 2], 16)
        b = prefix_chain_key(list(range(32)) + [9], 16)
        assert a == b and a is not None

    def test_short_prompt_has_no_key(self):
        assert prefix_chain_key(list(range(15)), 16) is None

    def test_max_blocks_caps_the_chain(self):
        base = list(range(32))
        a = prefix_chain_key(base + list(range(100, 116)), 16,
                             max_blocks=2)
        b = prefix_chain_key(base + list(range(200, 216)), 16,
                             max_blocks=2)
        assert a == b
        assert (prefix_chain_key(base + list(range(100, 116)), 16)
                != prefix_chain_key(base + list(range(200, 216)), 16))

    def test_matches_prefix_cache_chain_scheme(self):
        from repro_torch.serving.kv_pool import _CHAIN_ROOT
        toks = list(range(16))
        assert prefix_chain_key(toks, 16) == hash((_CHAIN_ROOT,
                                                   tuple(toks)))


# ----------------------------------------------------------------------
# router over in-process fake workers
# ----------------------------------------------------------------------
class FakeWorker:
    """In-process stand-in for HttpWorkerClient: replays a token list,
    optionally 'dying' (broken connection) after ``die_after`` tokens."""

    def __init__(self, tokens=(11, 12, 13), *, die_after=None,
                 delay=0.0):
        self.tokens = list(tokens)
        self.die_after = die_after
        self.delay = delay
        self.bodies = []
        self._alive = True

    def alive(self):
        return self._alive

    def describe(self):
        return "fake"

    def stream_completion(self, body, *, timeout):
        self.bodies.append(body)
        out = self.tokens[:int(body["max_tokens"])]
        for i, t in enumerate(out):
            if self.die_after is not None and i >= self.die_after:
                self._alive = False
                raise WorkerDiedError("fake worker died")
            if self.delay:
                time.sleep(self.delay)
            yield {"index": 0, "text": "", "token": t}
        if self.die_after is not None and self.die_after >= len(out):
            self._alive = False
            raise WorkerDiedError("fake worker died at the end")
        yield {"done": {"prompt_tokens": len(body["prompt"]),
                        "completion_tokens": len(out),
                        "finish_reason": "length"}}


class MetricWorker(FakeWorker):
    """FakeWorker that also serves a ``/metrics.json``-shaped snapshot."""

    def __init__(self, *a, queue=0.0, free=0.0, **kw):
        super().__init__(*a, **kw)
        self.queue, self.free = queue, free
        self.n_scrapes = 0

    def metrics(self):
        self.n_scrapes += 1
        return {"gauges": [
            {"name": "scheduler.queue_depth", "labels": {},
             "value": self.queue},
            {"name": "kv_pool.pages_free",
             "labels": {"node": 0, "shard": 0}, "value": self.free},
            {"name": "kv_pool.pages_free",
             "labels": {"node": 1, "shard": 0}, "value": self.free},
        ]}


class SlowDeathWorker:
    def __init__(self, delay=0.1):
        self.delay = delay
        self.bodies = []

    def alive(self):
        return False

    def describe(self):
        return "slow-death"

    def stream_completion(self, body, *, timeout):
        self.bodies.append(dict(body))
        time.sleep(self.delay)
        raise WorkerDiedError("injected slow death")
        yield  # pragma: no cover — makes this a generator


def _counters(r):
    snap = json.loads(r.registry.snapshot_json())
    return {(c["name"], tuple(sorted(c["labels"].items()))): c["value"]
            for c in snap["counters"]}


class TestRouterFakeWorkers:
    def test_tokens_and_completion_round_trip(self):
        r = Router({0: FakeWorker([5, 6, 7])}, page_size=16)
        h = r.submit(_req(KEYED, max_new=3))
        assert list(r.stream(h, timeout=5)) == [5, 6, 7]
        comp = r.result(h, timeout=5)
        assert comp.tokens == [5, 6, 7]
        assert comp.prompt_len == len(KEYED)
        assert h.state is RequestState.FINISHED
        r.shutdown()

    def test_on_token_fires_per_token(self):
        r = Router({0: FakeWorker([5, 6])}, page_size=16)
        got = []
        h = r.submit(_req(KEYED, max_new=2), on_token=got.append)
        r.result(h, timeout=5)
        assert got == [5, 6]
        r.shutdown()

    def test_same_prefix_same_replica(self):
        r = Router({i: FakeWorker() for i in range(4)}, page_size=16)
        handles = [r.submit(_req(KEYED + t))
                   for t in ([], [77], [88, 89])]
        for h in handles:
            r.result(h, timeout=5)
        assert len({h.replica for h in handles}) == 1
        counters = _counters(r)
        assert counters[("router.affinity.keyed", ())] == 3
        assert counters[("router.affinity.hits", ())] == 2
        r.shutdown()

    def test_unkeyed_uses_least_loaded_fallback(self):
        r = Router({0: FakeWorker(), 1: FakeWorker()}, page_size=16,
                   seed=3)
        h = r.submit(_req(UNKEYED))
        r.result(h, timeout=5)
        assert h.replica in (0, 1)
        assert r.registry.get("router.affinity.keyed").value() == 0
        r.shutdown()

    def test_zero_token_death_retries_on_survivor(self):
        first = AffinityRing([0, 1]).pick(
            prefix_chain_key(KEYED, 16, max_blocks=2))
        workers = {first: FakeWorker(die_after=0),
                   1 - first: FakeWorker([9, 9, 9])}
        r = Router(workers, page_size=16)
        h = r.submit(_req(KEYED))
        assert r.result(h, timeout=5).tokens == [9, 9, 9]
        assert h.n_retries == 1 and h.replica == 1 - first
        assert r.health()["live"] == 1
        assert first not in r.ring
        r.shutdown()

    def test_midstream_death_fails_with_chained_cause(self):
        r = Router({0: FakeWorker(die_after=2)}, page_size=16)
        h = r.submit(_req(KEYED, max_new=5))
        with pytest.raises(RouterError) as ei:
            list(r.stream(h, timeout=5))
        assert h.state is RequestState.FAILED
        cause = ei.value.__cause__
        assert isinstance(cause, WorkerDiedError)
        assert "mid-stream" in str(cause)
        assert isinstance(cause.__cause__, WorkerDiedError)
        r.shutdown()

    def test_retries_are_bounded(self):
        r = Router({i: FakeWorker(die_after=0) for i in range(3)},
                   page_size=16, max_retries=1)
        h = r.submit(_req(KEYED))
        with pytest.raises(RouterError):
            r.result(h, timeout=5)
        assert h.n_retries == 1
        r.shutdown()

    def test_all_dead_surfaces_no_replicas(self):
        r = Router({0: FakeWorker(die_after=0)}, page_size=16,
                   max_retries=5)
        h = r.submit(_req(KEYED))
        with pytest.raises(RouterError) as ei:
            r.result(h, timeout=5)
        assert isinstance(ei.value.__cause__, NoReplicasError)
        r.shutdown()

    def test_cancel_mid_stream(self):
        r = Router({0: FakeWorker([1] * 50, delay=0.02)}, page_size=16)
        h = r.submit(_req(KEYED, max_new=50))
        for _ in r.stream(h, timeout=5):
            assert r.cancel(h)
            break
        t0 = time.time()
        while not h.done and time.time() - t0 < 5:
            time.sleep(0.01)
        assert h.state is RequestState.CANCELLED
        with pytest.raises(Exception):
            r.result(h, timeout=1)
        r.shutdown()

    def test_readmit_restores_a_drained_replica(self):
        r = Router({0: FakeWorker(), 1: FakeWorker()}, page_size=16)
        assert r.mark_dead(0)
        assert r.health()["live"] == 1 and 0 not in r.ring
        fresh = FakeWorker([42, 42])
        assert r.readmit(0, fresh)
        assert r.health()["live"] == 2 and 0 in r.ring
        assert r.workers[0] is fresh
        assert not r.readmit(0)
        assert not r.readmit(99)
        assert r.registry.get("router.readmissions").value() == 1
        assert r.registry.get("router.replicas_live").value() == 2
        r.shutdown()

    def test_readmit_restores_the_original_keyspace(self):
        r = Router({i: FakeWorker() for i in range(3)}, page_size=16)
        key = r.affinity_key(KEYED)
        before = r.ring.pick(key)
        r.mark_dead(before)
        assert r.ring.pick(key) != before
        r.readmit(before, FakeWorker())
        assert r.ring.pick(key) == before
        r.shutdown()

    def test_inflight_gauge_returns_to_zero(self):
        r = Router({0: FakeWorker()}, page_size=16)
        r.result(r.submit(_req(KEYED)), timeout=5)
        snap = json.loads(r.registry.snapshot_json())
        g = [x for x in snap["gauges"] if x["name"] == "router.inflight"]
        assert g and all(x["value"] == 0 for x in g)
        live = [x for x in snap["gauges"]
                if x["name"] == "router.replicas_live"]
        assert live[0]["value"] == 1
        r.shutdown()

    def test_submit_after_shutdown_raises(self):
        r = Router({0: FakeWorker()}, page_size=16)
        r.shutdown()
        with pytest.raises(RouterError):
            r.submit(_req(KEYED))


class TestScrapedLoadSignal:
    def _drive(self, workers, n=8, **kw):
        r = Router(workers, page_size=16, **kw)
        picks = []
        for _ in range(n):
            h = r.submit(_req(UNKEYED))
            r.result(h, timeout=5)
            picks.append(h.replica)
        r.shutdown()
        return picks

    def test_prefers_the_shallower_queue(self):
        workers = {0: MetricWorker(queue=5, free=100),
                   1: MetricWorker(queue=0, free=100)}
        assert set(self._drive(workers, load_ttl=0.0)) == {1}

    def test_kv_pressure_breaks_queue_ties(self):
        workers = {0: MetricWorker(queue=1, free=2),
                   1: MetricWorker(queue=1, free=90)}
        assert set(self._drive(workers, load_ttl=0.0)) == {1}

    def test_scrapes_are_ttl_cached(self):
        workers = {0: MetricWorker(free=10), 1: MetricWorker(free=10)}
        self._drive(workers, n=6, load_ttl=60.0)
        assert workers[0].n_scrapes == 1 and workers[1].n_scrapes == 1
        workers = {0: MetricWorker(free=10), 1: MetricWorker(free=10)}
        self._drive(workers, n=3, load_ttl=0.0)
        assert workers[0].n_scrapes == 3 and workers[1].n_scrapes == 3

    def test_falls_back_to_inflight_without_metrics(self):
        picks = self._drive({0: FakeWorker(), 1: FakeWorker()},
                            load_ttl=0.0)
        assert all(p in (0, 1) for p in picks)

    def test_mark_dead_drops_the_cached_score(self):
        r = Router({0: MetricWorker(), 1: MetricWorker()}, page_size=16,
                   load_ttl=60.0)
        r._load_score(0)
        assert 0 in r._load_cache
        r.mark_dead(0)
        assert 0 not in r._load_cache
        r.shutdown()


# ----------------------------------------------------------------------
# circuit breaker + deadline-aware retry budget (twins of test_slo.py)
# ----------------------------------------------------------------------
class TestRouterBreaker:
    def test_breaker_opens_on_lossy_stream_and_probes_back(self):
        w = LossyWorker()
        r = Router({0: w}, page_size=16, breaker_threshold=1,
                   breaker_probation_s=0.05)
        with pytest.raises(RouterError) as ei:
            r.result(r.submit(_req(KEYED, max_new=3)), timeout=5)
        assert "frames arrived" in str(ei.value.__cause__)
        assert r.registry.get("router.breaker_open").value() == 1
        assert r.health()["replicas"]["0"]["breaker_open"]
        assert r.health()["live"] == 0

        with pytest.raises(RouterError) as ei:
            r.result(r.submit(_req(KEYED, max_new=3)), timeout=5)
        assert "breaker-open" in str(ei.value.__cause__)

        w.lossy = False                 # the replica "heals"
        time.sleep(0.06)                # probation elapses
        comp = r.result(r.submit(_req(KEYED, max_new=3)), timeout=5)
        assert comp.tokens == [21, 22, 23]
        assert w.probed >= 1
        assert r.registry.get("router.breaker_probes").value() >= 1
        assert r.registry.get("router.breaker_closed").value() == 1
        assert not r.health()["replicas"]["0"]["breaker_open"]
        r.shutdown()

    def test_success_resets_the_failure_streak(self):
        w = LossyWorker()
        r = Router({0: w}, page_size=16, breaker_threshold=2,
                   breaker_probation_s=10.0)
        with pytest.raises(RouterError):
            r.result(r.submit(_req(KEYED, max_new=3)), timeout=5)
        w.lossy = False
        r.result(r.submit(_req(KEYED, max_new=3)), timeout=5)
        w.lossy = True
        with pytest.raises(RouterError):
            r.result(r.submit(_req(KEYED, max_new=3)), timeout=5)
        assert r.registry.get("router.breaker_open").value() == 0
        r.shutdown()

    def test_breaker_threshold_validated(self):
        with pytest.raises(ValueError, match="breaker_threshold"):
            Router({0: LossyWorker()}, page_size=16, breaker_threshold=0)


class TestRouterDeadlines:
    def test_slo_fields_ride_the_wire(self):
        w = FakeWorker([5, 6, 7])
        r = Router({0: w}, page_size=16)
        r.result(r.submit(_req(KEYED, priority="batch", deadline_s=5.0,
                               max_new=3)), timeout=5)
        body = w.bodies[0]
        assert body["priority"] == "batch"
        assert 0 < body["deadline_ms"] <= 5000.0
        r.result(r.submit(_req(KEYED, max_new=3)), timeout=5)
        assert "priority" not in w.bodies[1]
        assert "deadline_ms" not in w.bodies[1]
        r.shutdown()

    def test_spent_budget_fails_before_dispatch(self):
        w = FakeWorker()
        r = Router({0: w}, page_size=16)
        h = r.submit(_req(KEYED, deadline_s=1e-9, max_new=3))
        with pytest.raises(RouterError) as ei:
            r.result(h, timeout=5)
        assert isinstance(ei.value.__cause__, DeadlineExceededError)
        assert w.bodies == []
        r.shutdown()

    def test_no_retry_after_the_budget_is_spent(self):
        first = AffinityRing([0, 1]).pick(
            prefix_chain_key(KEYED, 16, max_blocks=2))
        slow = SlowDeathWorker(delay=0.15)
        r = Router({first: slow, 1 - first: FakeWorker([9, 9, 9])},
                   page_size=16, max_retries=3)
        h = r.submit(_req(KEYED, deadline_s=0.05, max_new=3))
        with pytest.raises(RouterError):
            r.result(h, timeout=5)
        assert h.n_retries == 0
        assert 0 < slow.bodies[0]["deadline_ms"] <= 50.0
        r.shutdown()


# ----------------------------------------------------------------------
# the fleet over worker subprocesses on the CPU
# ----------------------------------------------------------------------
def _wire_tokens(fe, prompt, max_new):
    conn = http.client.HTTPConnection(fe.host, fe.port, timeout=120)
    conn.request("POST", "/v1/completions",
                 json.dumps({"prompt": prompt, "max_tokens": max_new,
                             "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    toks = []
    while True:
        line = resp.readline()
        assert line, "stream closed before [DONE]"
        line = line.strip()
        if not line.startswith(b"data:"):
            continue
        payload = line[5:].strip()
        if payload == b"[DONE]":
            break
        ev = json.loads(payload)
        assert "error" not in ev, ev
        if "token" in ev:
            toks.append(ev["token"])
    conn.close()
    return toks


def _wait(cond, seconds=120):
    deadline = time.time() + seconds
    while not cond():
        assert time.time() < deadline, "condition not met in time"
        time.sleep(0.05)


@pytest.mark.slow
def test_fleet_parity_affinity_sigkill_and_respawn(tmp_path, monkeypatch):
    from repro.serving import AsyncEngine as JAsyncEngine
    from repro.serving.worker import build_tiny as jbuild_tiny
    # the workers inherit this: two torch processes beside the suite's
    # own workers must not oversubscribe the machine
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    jm, jp = jbuild_tiny()
    npz = str(tmp_path / "bench-tiny.npz")
    save_params_npz(jax.tree.map(np.asarray, jp), npz)
    prompt, max_new = KEYED, 6
    with JAsyncEngine(jm, jp, max_len=128, page_size=16) as eng:
        ref = list(eng.stream(eng.submit(_req(prompt, max_new=max_new)),
                              timeout=120))

    sup = Supervisor(2, ["--arch", "tiny", "--params", npz, "--device",
                         "cpu"], ready_timeout=120, max_respawns=1,
                     respawn_backoff=0.05)
    clients = sup.start()
    router = Router(clients, page_size=16)
    sup.on_death = lambda rid, rc: router.mark_dead(rid)
    sup.on_respawn = lambda rid, c: router.readmit(rid, c)
    fe = HttpFrontend(router).start()
    try:
        # greedy parity over two HTTP hops; the re-ask is an affinity hit
        wire = [_wire_tokens(fe, prompt, max_new) for _ in range(2)]
        assert wire[0] == wire[1] == ref, (wire, ref)
        assert router.registry.get("router.affinity.hits").value() >= 1

        # SIGKILL the serving replica mid-stream
        victim = router.ring.pick(router.affinity_key(prompt))
        old_proc = sup.procs[victim]
        killed = threading.Event()

        def kill_after_3(tok, _n=[0]):
            _n[0] += 1
            if _n[0] == 3 and not killed.is_set():
                sup.kill(victim)
                killed.set()

        a = router.submit(_req(prompt, max_new=400), on_token=kill_after_3)
        with pytest.raises(RouterError) as ei:
            router.result(a, timeout=120)
        assert a.state is RequestState.FAILED and a.replica == victim
        assert isinstance(ei.value.__cause__, WorkerDiedError)
        assert "mid-stream" in str(ei.value.__cause__)

        # the supervisor respawns it and the router readmits it
        _wait(lambda: sup.respawns().get(victim) == 1
              and router.health()["live"] == 2)
        assert sup.procs[victim] is not old_proc and sup.alive()[victim]
        assert router.registry.get("router.readmissions").value() == 1
        h = router.submit(_req(prompt, max_new=max_new))
        assert router.result(h, timeout=120).tokens == ref
        assert h.replica == victim
    finally:
        fe.close()
        router.shutdown()
        sup.shutdown()
    assert all(p.poll() is not None for p in sup.procs.values())
    assert sup._retired and all(p.poll() is not None for p in sup._retired)


def test_cuda_worker_without_a_gpu_fails_before_ready(monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: a --device cuda worker serves")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    sup = Supervisor(1, ["--arch", "tiny", "--device", "cuda"],
                     ready_timeout=120)
    with pytest.raises(WorkerStartupError) as ei:
        sup.start()
    assert "exited before READY" in str(ei.value)
    assert "CUDA" in str(ei.value)
    assert all(p.poll() not in (None, 0) for p in sup.procs.values())


def test_build_tiny_draws_the_same_weights_in_every_process():
    """The port worker's bench-tiny weights come from a seeded
    ``torch.Generator``, so two draws (as two workers make) agree bit for
    bit and another seed differs."""
    import torch

    from repro_torch.configs import BENCH_TINY
    from repro_torch.models.weights import tree_leaves_with_path
    from repro_torch.serving.worker import build_tiny
    (m, a), (_, b), (_, c) = (build_tiny(s, "cpu") for s in (0, 0, 1))
    assert m.cfg == BENCH_TINY
    la, lb, lc = (tree_leaves_with_path(t) for t in (a, b, c))
    assert [p for p, _ in la] == [p for p, _ in lb]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    assert not all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lc))
