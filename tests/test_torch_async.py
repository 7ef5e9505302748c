"""The port's async engine and observability validator vs the reference.

* Port twins of ``tests/test_async_serving.py``'s ``TestAsyncEngine`` and
  ``TestStreamInteractive``: async greedy tokens against the port's sync
  and bucket engines and the reference's async engine (shared weights,
  bridged from the reference ``Model.init``), with and without
  speculative decoding; streaming, the state machine, live cancel
  freeing every page, a stepper exception surfacing on ``poll``,
  per-request failures, ``shutdown``, ``on_token`` push callbacks, and
  ``stream_interactive``'s verdicts.
* ``repro_torch.obs.validate``: the failure modes of ``tests/test_obs.py``
  against both packages, and the CLI on a port engine's exports.
"""

import dataclasses
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.serving as jserving
import repro_torch.obs as tobs
import repro_torch.serving as tserving
from repro.models import ModelConfig as JModelConfig
from repro.models import build_model as jbuild
from repro_torch.launch.serve import stream_interactive
from repro_torch.models import ModelConfig, build_model
from repro_torch.models.weights import params_from_numpy
from repro_torch.obs.validate import require_counter, require_gauge
from repro_torch.serving import (AsyncEngine, AsyncEngineError,
                                 ContinuousServingEngine, EngineCore,
                                 Request, RequestState, SamplingParams,
                                 ServingEngine, VirtualClock)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def tiny():
    """The reference's async-test tiny model in both packages:
    (reference model, reference params, port model, port params)."""
    jcfg = JModelConfig(name="tiny", arch_type="dense", n_layers=2,
                        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                        vocab_size=259, dtype=jnp.float32)
    jm = jbuild(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JModelConfig)}
    fields["dtype"] = torch.float32
    return (jm, jax.tree.map(jnp.asarray, tree),
            build_model(ModelConfig(**fields)), params_from_numpy(tree, "cpu"))


MIXED_PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13, 14, 15, 16],
                 [5, 4, 3], [9, 9, 2, 1]]
#: repetitive prompts, so prompt lookup drafts
REP = [[7, 8, 9, 7, 8, 9, 7, 8], [3, 4, 3, 4, 3, 4, 3, 4, 3],
       [5, 6, 7, 5, 6, 7, 5, 6, 7, 5]]


def _reqs(S, prompts=MIXED_PROMPTS, max_new=5):
    return [S.Request(uid=i, prompt=p,
                      sampling=S.SamplingParams(max_new_tokens=max_new))
            for i, p in enumerate(prompts)]


def _wait(cond, seconds=60):
    deadline = time.perf_counter() + seconds
    while not cond():
        assert time.perf_counter() < deadline
        time.sleep(0.002)


# ----------------------------------------------------------------------
# AsyncEngine
# ----------------------------------------------------------------------

def test_async_matches_sync_bucket_and_the_reference(tiny):
    jm, jparams, tm, tparams = tiny
    bc = ServingEngine(tm, tparams, max_len=48, **CPU).generate(
        _reqs(tserving), max_batch=4)
    sc = ContinuousServingEngine(tm, tparams, max_len=48, max_running=3,
                                 page_size=4, **CPU).generate(
        _reqs(tserving))
    with AsyncEngine(tm, tparams, max_len=48, max_running=3, page_size=4,
                     **CPU) as eng:
        handles = [eng.submit(r) for r in _reqs(tserving)]
        ac = [eng.result(h, timeout=120) for h in handles]
    with jserving.AsyncEngine(jm, jparams, max_len=48, max_running=3,
                              page_size=4) as jeng:
        handles = [jeng.submit(r) for r in _reqs(jserving)]
        jc = [jeng.result(h, timeout=300) for h in handles]
    assert [c.tokens for c in bc] == [c.tokens for c in sc]
    assert [c.tokens for c in sc] == [c.tokens for c in ac]
    assert [c.tokens for c in ac] == [c.tokens for c in jc]


@pytest.mark.parametrize("k", [2, 4])
def test_async_speculative_tokens_match_k0_and_return_pages(tiny, k):
    _, _, tm, tparams = tiny
    toks = {}
    for kk in (0, k):
        with AsyncEngine(tm, tparams, max_len=64, max_running=3,
                         page_size=4, spec_decode=kk, **CPU) as eng:
            free0 = eng.core.pool.n_free()
            handles = [eng.submit(r)
                       for r in _reqs(tserving, REP, max_new=12)]
            toks[kk] = [eng.result(h, timeout=120).tokens for h in handles]
            _wait(lambda: not eng.core.has_work())
            assert eng.core.pool.n_free() == free0
            if kk:
                assert eng.registry.get("spec.drafted").value() > 0
    assert toks[k] == toks[0]


def test_stream_delivers_every_token_incrementally(tiny):
    _, _, tm, tparams = tiny
    req = Request(uid=0, prompt=[1, 2, 3, 4, 5],
                  sampling=SamplingParams(max_new_tokens=6))
    with AsyncEngine(tm, tparams, max_len=32, max_running=2, page_size=4,
                     **CPU) as eng:
        h = eng.submit(req)
        streamed = list(eng.stream(h, timeout=120))
        comp = eng.result(h, timeout=10)
    assert streamed == comp.tokens and len(streamed) == 6


def test_states_progress_through_the_machine(tiny):
    _, _, tm, tparams = tiny
    req = Request(uid=0, prompt=list(range(1, 14)),
                  sampling=SamplingParams(max_new_tokens=5))
    with AsyncEngine(tm, tparams, max_len=32, max_running=2, page_size=4,
                     prefill_chunk=2, **CPU) as eng:
        h = eng.submit(req)
        seen = {h.state}
        while True:
            res = eng.poll(h)
            seen.add(res.state)
            if res.done:
                break
            time.sleep(0.005)
    assert res.state is RequestState.FINISHED
    assert res.completion is not None
    legal = {RequestState.QUEUED, RequestState.PREFILLING,
             RequestState.DECODING, RequestState.FINISHED}
    assert seen <= legal and RequestState.FINISHED in seen


def test_cancel_frees_pages_and_is_terminal(tiny):
    """Cancel a long chunked prefill while the stepper is live: the
    handle ends CANCELLED and the pool drains completely."""
    _, _, tm, tparams = tiny
    long_req = Request(uid=0, prompt=list(range(1, 40)),
                       sampling=SamplingParams(max_new_tokens=50))
    with AsyncEngine(tm, tparams, max_len=64, max_running=2, page_size=4,
                     prefill_chunk=2, prefix_cache=False, **CPU) as eng:
        h = eng.submit(long_req)
        _wait(lambda: eng.poll(h).state is not RequestState.QUEUED)
        assert eng.cancel(h)
        _wait(lambda: eng.poll(h).done)
        assert eng.poll(h).state is RequestState.CANCELLED
        # stepper idle now: pool state is stable to assert on
        assert eng.core.pool.n_live() == 0
        assert eng.core.pool.n_free() == eng.core.pool.cfg.n_pages - 1
        assert eng.core.pool.pending_copies == []
        assert not eng.cancel(h)                 # already terminal


def test_stepper_exception_surfaces_on_poll(tiny):
    _, _, tm, tparams = tiny
    eng = AsyncEngine(tm, tparams, max_len=32, max_running=2, page_size=4,
                      **CPU)
    boom = RuntimeError("injected stepper failure")

    def exploding_step(now=0.0):
        raise boom

    eng.core.step = exploding_step
    h = eng.submit(Request(uid=0, prompt=[1, 2, 3]))
    deadline = time.perf_counter() + 30
    while True:
        assert time.perf_counter() < deadline
        try:
            res = eng.poll(h)
        except AsyncEngineError as e:
            assert e.__cause__ is boom
            break
        assert not res.done
        time.sleep(0.002)
    assert h.state is RequestState.FAILED
    with pytest.raises(AsyncEngineError):      # submit fails too
        eng.submit(Request(uid=1, prompt=[1]))
    eng.shutdown()
    assert not eng._thread.is_alive()


def test_device_error_on_the_stepper_kills_the_engine(tiny):
    """An error of the device step itself (here: the runner's verify
    forward) is no different: the engine dies, every caller sees it
    chained, nothing goes on."""
    _, _, tm, tparams = tiny
    eng = AsyncEngine(tm, tparams, max_len=64, max_running=2, page_size=4,
                      spec_decode=2, **CPU)
    boom = RuntimeError("CUDA error: an illegal memory access")

    def failing_verify(*args, **kw):
        raise boom

    eng.core.runner.verify = failing_verify
    h = eng.submit(Request(uid=0, prompt=REP[0],
                           sampling=SamplingParams(max_new_tokens=8)))
    with pytest.raises(AsyncEngineError) as ei:
        eng.result(h, timeout=120)
    assert ei.value.__cause__ is boom
    with pytest.raises(AsyncEngineError):
        eng.poll(h)
    eng.shutdown()


def test_oversized_prompt_fails_only_that_request(tiny):
    _, _, tm, tparams = tiny
    with AsyncEngine(tm, tparams, max_len=16, max_running=2, page_size=4,
                     **CPU) as eng:
        bad = eng.submit(Request(uid=0, prompt=[1] * 17))
        good = eng.submit(Request(uid=1, prompt=[1, 2, 3],
                                  sampling=SamplingParams(max_new_tokens=3)))
        comp = eng.result(good, timeout=120)
        assert len(comp.tokens) == 3
        with pytest.raises(AsyncEngineError, match="failed"):
            eng.result(bad, timeout=10)
        assert bad.state is RequestState.FAILED
        assert bad.uid not in eng._handles
        assert good.uid not in eng._handles


def test_prompt_exceeding_page_budget_fails_only_that_request(tiny):
    _, _, tm, tparams = tiny
    with AsyncEngine(tm, tparams, max_len=32, max_running=2, page_size=4,
                     n_pages=4, **CPU) as eng:             # 3 usable
        bad = eng.submit(Request(uid=0, prompt=[1] * 14))  # 4 pages
        good = eng.submit(Request(uid=1, prompt=[1, 2, 3],
                                  sampling=SamplingParams(max_new_tokens=3)))
        assert len(eng.result(good, timeout=120).tokens) == 3
        with pytest.raises(AsyncEngineError, match="failed"):
            eng.result(bad, timeout=10)


def test_shutdown_joins_thread_and_cancels_leftovers(tiny):
    _, _, tm, tparams = tiny
    eng = AsyncEngine(tm, tparams, max_len=48, max_running=2, page_size=4,
                      prefill_chunk=1, prefix_cache=False, **CPU)
    h = eng.submit(Request(uid=0, prompt=list(range(1, 40)),
                           sampling=SamplingParams(max_new_tokens=40)))
    eng.shutdown()
    assert not eng._thread.is_alive()
    assert h.state in (RequestState.CANCELLED, RequestState.FINISHED)
    assert eng.core.pool.n_live() == 0
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit(Request(uid=1, prompt=[1]))
    eng.shutdown()                               # idempotent


def test_on_token_callbacks_and_a_raising_one(tiny):
    """``submit(on_token=)`` pushes every token in order; a raising
    callback (also on the final token) fails only its own handle and
    its pages drain."""
    _, _, tm, tparams = tiny
    pushed = []
    seen = []

    def last_tok_boom(t):
        seen.append(t)
        if len(seen) == 3:
            raise RuntimeError("final-token transport died")

    with AsyncEngine(tm, tparams, max_len=32, max_running=3, page_size=4,
                     **CPU) as eng:
        ok = eng.submit(Request(uid=0, prompt=[1, 2, 3],
                                sampling=SamplingParams(max_new_tokens=6)),
                        on_token=pushed.append)
        bad = eng.submit(Request(uid=0, prompt=[4, 5],
                                 sampling=SamplingParams(max_new_tokens=4)),
                         on_token=lambda t: 1 / 0)
        late = eng.submit(Request(uid=0, prompt=[9, 9],
                                  sampling=SamplingParams(max_new_tokens=3)),
                          on_token=last_tok_boom)
        assert pushed == eng.result(ok, timeout=120).tokens
        with pytest.raises(AsyncEngineError) as ei:
            eng.result(bad, timeout=120)
        assert isinstance(ei.value.__cause__, ZeroDivisionError)
        with pytest.raises(AsyncEngineError) as ei2:
            eng.result(late, timeout=120)
        assert isinstance(ei2.value.__cause__, RuntimeError)
        assert len(seen) == 3
        _wait(lambda: not eng.core.has_work())
        assert eng.core.pool.n_live() == 0


def test_emitted_feed_matches_generated_under_speculation(tiny):
    """StepResult.emitted is the async delivery feed: with verify steps
    emitting several tokens a lane, it still equals each sequence's
    generated list, in order."""
    _, _, tm, tparams = tiny
    core = EngineCore(tm, tparams, max_len=64, max_running=2, page_size=4,
                      spec_decode=2, clock=VirtualClock(), **CPU)
    seqs = [core.submit(Request(uid=i, prompt=REP[i],
                                sampling=SamplingParams(max_new_tokens=10)))
            for i in range(2)]
    per_uid = {0: [], 1: []}
    while core.has_work():
        for uid, tok in core.step().emitted:
            per_uid[uid].append(tok)
    for s in seqs:
        assert per_uid[s.uid] == s.generated and len(s.generated) == 10
    assert core.registry.get("spec.drafted").value() > 0


# ----------------------------------------------------------------------
# stream_interactive (the --interactive glue)
# ----------------------------------------------------------------------

def test_interactive_failed_handle_prints_chained_cause():
    class FakeEng:
        def stream(self, handle, timeout=None):
            yield 5
            err = AsyncEngineError("request 0 failed")
            err.__cause__ = ValueError("page budget exceeded")
            raise err

    class H:
        state = RequestState.FAILED

    out = []
    assert stream_interactive(FakeEng(), H(), out.append) == "failed"
    text = "".join(out)
    assert "5" in text and "request 0 failed" in text
    assert "ValueError" in text and "page budget exceeded" in text


def test_interactive_timeout_cancels_and_reports_failed():
    class FakeEng:
        cancelled = []

        def stream(self, handle, timeout=None):
            raise TimeoutError("no token within 1 s")
            yield  # pragma: no cover

        def cancel(self, handle):
            self.cancelled.append(handle)
            return True

    class H:
        state = RequestState.DECODING

    eng, h, out = FakeEng(), H(), []
    assert stream_interactive(eng, h, out.append) == "failed"
    assert eng.cancelled == [h]
    assert "timed out" in "".join(out)


def test_interactive_real_failed_and_cancelled_handles(tiny):
    _, _, tm, tparams = tiny
    with AsyncEngine(tm, tparams, max_len=16, max_running=2, page_size=4,
                     **CPU) as eng:
        bad = eng.submit(Request(uid=0, prompt=[1] * 17))
        out = []
        assert stream_interactive(eng, bad, out.append,
                                  timeout=120) == "failed"
    assert bad.state is RequestState.FAILED
    assert "caused by" in "".join(out) and "ValueError" in "".join(out)
    with AsyncEngine(tm, tparams, max_len=64, max_running=2, page_size=4,
                     prefill_chunk=1, prefix_cache=False, **CPU) as eng:
        h = eng.submit(Request(uid=0, prompt=list(range(1, 40)),
                               sampling=SamplingParams(max_new_tokens=50)))
        eng.cancel(h)
        out = []
        assert stream_interactive(eng, h, out.append,
                                  timeout=120) == "cancelled"
    assert "cancelled" in "".join(out)


# ----------------------------------------------------------------------
# obs.validate
# ----------------------------------------------------------------------

@pytest.mark.parametrize("obs", [jobs, tobs], ids=["repro", "repro_torch"])
def test_snapshot_validation_failure_modes(obs):
    reg = obs.MetricsRegistry()
    reg.counter("a.b").inc(2)
    reg.gauge("c.d").set(1, node=0)
    reg.histogram("e.f").observe(3.0)
    assert obs.validate_snapshot(reg.snapshot()) == []
    assert obs.validate_snapshot([]) != []                  # not an object
    assert any("version" in p for p in obs.validate_snapshot(
        {"version": 99, "counters": [], "gauges": [], "histograms": []}))
    assert any("missing or not a list" in p for p in obs.validate_snapshot(
        {"version": 1, "counters": [], "gauges": []}))
    bad_hist = {"version": 1, "counters": [], "gauges": [],
                "histograms": [{"name": "h", "labels": {},
                                "buckets": [1.0], "counts": [1, 0, 0],
                                "sum": 1.0, "count": 1}]}
    assert any("buckets" in p for p in obs.validate_snapshot(bad_hist))
    bad_counter = {"version": 1, "gauges": [], "histograms": [],
                   "counters": [{"name": "", "labels": {}, "value": "x"}]}
    probs = obs.validate_snapshot(bad_counter)
    assert any("missing name" in p for p in probs)
    assert any("numeric value" in p for p in probs)


def _ev(obs, uid, name, t, **attrs):
    return obs.TraceEvent((uid, name, t, attrs))


@pytest.mark.parametrize("obs", [jobs, tobs], ids=["repro", "repro_torch"])
def test_validate_events_failure_modes(obs):
    ve = obs.validate_events
    assert any("non-monotone" in p for p in ve(
        [_ev(obs, 1, "QUEUED", 2.0), _ev(obs, 1, "FINISHED", 1.0)]))
    assert any("starts at" in p for p in ve(
        [_ev(obs, 1, "DECODING", 0.0), _ev(obs, 1, "FINISHED", 1.0)]))
    assert any("after terminal" in p for p in ve(
        [_ev(obs, 1, "QUEUED", 0.0), _ev(obs, 1, "CANCELLED", 1.0),
         _ev(obs, 1, "DECODING", 2.0)]))
    evs = [_ev(obs, 1, "QUEUED", 0.0)]
    assert any("no terminal" in p for p in ve(evs))
    assert ve(evs, require_terminal=False) == []
    assert any("unknown event" in p for p in ve(
        [_ev(obs, 1, "QUEUED", 0.0), _ev(obs, 1, "WAT", 1.0),
         _ev(obs, 1, "FINISHED", 2.0)]))


def test_require_series_and_files(tmp_path):
    reg = tobs.MetricsRegistry()
    reg.gauge("kv_pool.pages_free").set(3, node=0, shard=1)
    reg.counter("router.requests").inc(replica=0)
    snap = reg.snapshot()
    assert require_gauge(snap, "kv_pool.pages_free", ["node", "shard"]) == []
    assert require_gauge(snap, "kv_pool.pages_free",
                         ["node", "shard", "rack"]) != []
    assert require_counter(snap, "router.requests", ["replica"]) == []
    assert require_counter(snap, "nope", []) != []
    missing = str(tmp_path / "nope.json")
    assert any("unreadable" in p for p in tobs.validate_snapshot_file(missing))
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert any("no trace events" in p
               for p in tobs.validate_trace_file(str(empty)))


def test_async_engine_exports_validate_with_the_cli(tiny, tmp_path):
    """A port engine's metrics snapshot and trace (a finished and a
    failed request, speculative decoding on) pass the port's validator,
    in process and through ``python -m repro_torch.obs.validate``."""
    _, _, tm, tparams = tiny
    tracer = tobs.RequestTracer()
    eng = AsyncEngine(tm, tparams, max_len=32, max_running=2, page_size=8,
                      spec_decode=2, tracer=tracer, **CPU)
    try:
        ok = eng.submit(Request(uid=0, prompt=REP[0],
                                sampling=SamplingParams(max_new_tokens=4)))
        bad = eng.submit(Request(uid=1, prompt=list(range(1, 64))))
        comp = eng.result(ok, timeout=120)
        assert len(comp.tokens) == 4 and comp.t_sched >= comp.t0
        with pytest.raises(AsyncEngineError):
            eng.result(bad, timeout=120)
    finally:
        eng.shutdown()
    assert eng.registry.counter("async.submitted").value() == 2
    assert eng.registry.counter("async.failed").value() == 1
    snap = eng.registry.snapshot()
    assert tobs.validate_snapshot(snap) == []
    assert tobs.validate_events(tracer.events()) == []
    assert {"FAILED", "FINISHED"} <= {e.name for e in tracer.events()}
    m, t = tmp_path / "m.json", tmp_path / "t.jsonl"
    m.write_text(eng.registry.snapshot_json())
    tracer.write_jsonl(str(t))
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.validate", "--metrics",
         str(m), "--trace", str(t), "--require-counter", "spec.drafted",
         "--require-gauge", "kv_pool.pages_free:node"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "obs-validate: OK" in out.stdout
    m.write_text('{"version": 1}')
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.validate", "--metrics",
         str(m)], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and "FAILED" in out.stdout
