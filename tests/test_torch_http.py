"""The port's HTTP front end (``repro_torch.serving.http``) vs the reference.

* Port twins of ``tests/test_http_serving.py`` (``TestParseBody``,
  ``TestRoutes`` over a fake backend, ``TestRealEngineWire`` on the
  port's ``AsyncEngine(device="cpu")``), of ``tests/test_slo.py``'s
  ``TestHttpOverload`` and of ``tests/test_faults.py``'s
  ``TestDropSseFault``.
* Across the packages: ``parse_completion_body`` and ``error_payload``
  give equal results for the same bodies and exceptions, and the SSE
  frames of the reference ``HttpFrontend`` over the reference
  ``AsyncEngine`` equal, frame for frame, those of the port's over the
  port's, on bench-tiny's ``PRNGKey(0)`` weights carried across with
  ``params_from_numpy`` (only the timing fields ``ttft_ms`` and
  ``latency_ms`` of the ``done`` frame are dropped).
"""

import http.client
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_http_serving import FakeBackend as RefFakeBackend
from test_http_serving import _post, _raw_post, _read_sse, _rst_close

import repro.serving.http as jhttp
import repro_torch.serving.http as thttp
from repro.data.tokenizer import ByteTokenizer as JByteTokenizer
from repro.models import ModelConfig as JModelConfig
from repro.models import build_model as jbuild
from repro.serving import AsyncEngine as JAsyncEngine
from repro_torch.configs import BENCH_TINY
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.models import build_model
from repro_torch.models.weights import params_from_numpy
from repro_torch.obs import MetricsRegistry
from repro_torch.obs.validate import validate_snapshot
from repro_torch.serving import (AsyncEngine, Completion,
                                 DeadlineExceededError, Request,
                                 SamplingParams, faults)
from repro_torch.serving.http import (SSE_DONE, BadRequest, HttpFrontend,
                                      Overloaded, error_payload,
                                      parse_completion_body, sse_frame)


class FakeBackend(RefFakeBackend):
    """The reference tests' engine-shaped fake, on the port's registry
    and completion record."""

    def __init__(self, tokens=(11, 12, 13), *, fail=None, delay=0.0):
        super().__init__(tokens, fail=fail, delay=delay)
        self.registry = MetricsRegistry()

    def result(self, handle, *, timeout=None):
        if self.fail is not None:
            raise self.fail
        out = self._out(handle)
        return Completion(uid=handle.uid,
                          prompt_len=len(handle.request.prompt),
                          tokens=out, latency_s=0.5, prefill_s=0.1,
                          t0=0.0, t1=0.5, t_first=0.1, t_sched=0.0)


class Recording(FakeBackend):
    def submit(self, request, *, on_token=None):
        self.seen = request
        return super().submit(request, on_token=on_token)


@pytest.fixture()
def clean_faults():
    faults.reset()
    yield
    faults.reset()


# ----------------------------------------------------------------------
# body parsing + framing (no server)
# ----------------------------------------------------------------------
REJECTED = [
    b"not json", b"[1,2]", b'{"prompt": []}', b'{"prompt": [1.5]}',
    b'{"prompt": [true, false]}', b'{}',
    b'{"prompt": [1], "max_tokens": 0}',
    b'{"prompt": [1], "max_tokens": "x"}',
    b'{"prompt": [1], "priority": "bulk"}',
    b'{"prompt": [1], "deadline_ms": 0}',
    b'{"prompt": [1], "deadline_ms": "soon"}',
    b'{"prompt": "hi"}',
]
ACCEPTED = [
    b'{"prompt": [1, 2, 3], "max_tokens": 4, "stream": true,'
    b' "temperature": 0.5, "top_k": 7, "eos_id": 2}',
    b'{"prompt": [5], "priority": "batch", "deadline_ms": 250}',
    b'{"prompt": [9, 8]}',
]


class TestParseBody:
    def test_token_id_prompt(self):
        toks, sp, stream, slo = parse_completion_body(ACCEPTED[0])
        assert toks == [1, 2, 3] and stream
        assert slo == {"priority": "interactive", "deadline_ms": None}
        assert (sp.max_new_tokens, sp.temperature, sp.top_k, sp.eos_id) \
            == (4, 0.5, 7, 2)

    def test_string_prompt_needs_tokenizer(self):
        with pytest.raises(BadRequest):
            parse_completion_body(b'{"prompt": "hi"}')
        toks, sp, stream, _ = parse_completion_body(
            b'{"prompt": "hi"}', tokenizer=ByteTokenizer())
        assert toks == ByteTokenizer().encode("hi")
        assert sp.max_new_tokens == 16 and not stream

    @pytest.mark.parametrize("body", REJECTED[:8])
    def test_rejects(self, body):
        with pytest.raises(BadRequest):
            parse_completion_body(body)

    def test_sse_frame_bytes_are_deterministic(self):
        assert sse_frame({"b": 1, "a": 2}) == b'data: {"a":2,"b":1}\n\n'
        assert SSE_DONE == jhttp.SSE_DONE

    def test_error_payload_carries_cause(self):
        try:
            try:
                raise ValueError("root cause")
            except ValueError as root:
                raise RuntimeError("outer") from root
        except RuntimeError as e:
            doc = error_payload(e)
        assert doc["error"]["type"] == "RuntimeError"
        assert doc["error"]["cause"] == "ValueError: root cause"


class TestAgainstReference:
    @pytest.mark.parametrize("body", ACCEPTED)
    def test_parse_accepts_equal(self, body):
        for tok in (None, (ByteTokenizer(), JByteTokenizer())):
            got = thttp.parse_completion_body(
                body, tok[0] if tok else None)
            want = jhttp.parse_completion_body(
                body, tok[1] if tok else None)
            assert got[0] == want[0] and got[2:] == want[2:]
            assert vars(got[1]) == vars(want[1])

    @pytest.mark.parametrize("body", REJECTED)
    def test_parse_rejects_equal(self, body):
        with pytest.raises(thttp.BadRequest) as got:
            thttp.parse_completion_body(body)
        with pytest.raises(jhttp.BadRequest) as want:
            jhttp.parse_completion_body(body)
        assert str(got.value) == str(want.value)

    def test_string_prompt_equal(self):
        body = b'{"prompt": "the kv cache streams"}'
        got = thttp.parse_completion_body(body, ByteTokenizer())
        want = jhttp.parse_completion_body(body, JByteTokenizer())
        assert got[0] == want[0]

    @staticmethod
    def _errors(pkg, engine_pkg):
        root = OSError("disk gone")
        chained = RuntimeError("request 0 failed")
        chained.__cause__ = root
        late = RuntimeError("boom")
        late.__cause__ = engine_pkg.DeadlineExceededError("late")
        return [pkg.Overloaded("full"), pkg.BadRequest("bad"),
                TimeoutError("slow"), chained, late, ValueError("plain")]

    def test_error_payload_equal(self):
        import repro.serving as jserving
        import repro_torch.serving as tserving
        for g, w in zip(self._errors(thttp, tserving),
                        self._errors(jhttp, jserving)):
            assert thttp.error_payload(g) == jhttp.error_payload(w)
            assert (thttp.error_payload(g, retryable=True)
                    == jhttp.error_payload(w, retryable=True))


# ----------------------------------------------------------------------
# routes over a fake backend
# ----------------------------------------------------------------------
class TestRoutes:
    @pytest.fixture()
    def fe(self):
        with HttpFrontend(FakeBackend()) as fe:
            yield fe

    def test_healthz(self, fe):
        conn = http.client.HTTPConnection(fe.host, fe.port, timeout=10)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert r.status == 200
        assert json.loads(r.read()) == {"status": "ok",
                                        "backend": "FakeBackend"}
        conn.close()

    def test_metrics_prometheus_and_json(self, fe):
        _post(fe, {"prompt": [1] * 4, "max_tokens": 2})[1].read()
        conn = http.client.HTTPConnection(fe.host, fe.port, timeout=10)
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        assert r.status == 200 and "text/plain" in r.headers["Content-Type"]
        prom = r.read().decode()
        assert "http_requests 1" in prom.replace("  ", " ")
        conn.request("GET", "/metrics.json")
        doc = json.loads(conn.getresponse().read())
        assert validate_snapshot(doc) == []
        assert any(c["name"] == "http.requests" and c["value"] == 1
                   for c in doc["counters"])
        assert {g["name"] for g in doc["gauges"]} >= {"http.inflight"}
        conn.close()

    def test_unknown_paths_404(self, fe):
        conn = http.client.HTTPConnection(fe.host, fe.port, timeout=10)
        conn.request("GET", "/nope")
        assert conn.getresponse().status == 404
        conn2, r = _post(fe, {}, path="/v2/other")
        assert r.status == 404
        conn.close()
        conn2.close()

    def test_bad_body_400_and_counted(self, fe):
        conn, r = _post(fe, {"prompt": []})
        assert r.status == 400
        assert json.loads(r.read())["error"]["type"] == "BadRequest"
        assert fe.registry.get("http.bad_requests").value() == 1
        conn.close()

    def test_block_completion_document(self, fe):
        conn, r = _post(fe, {"prompt": [1, 2], "max_tokens": 3})
        assert r.status == 200
        doc = json.loads(r.read())
        assert doc["choices"][0]["tokens"] == [11, 12, 13]
        assert doc["usage"] == {"prompt_tokens": 2,
                                "completion_tokens": 3,
                                "total_tokens": 5}
        assert doc["id"] == "cmpl-0"
        assert doc["timing"] == {"ttft_ms": 100.0, "latency_ms": 500.0}
        conn.close()

    def test_stream_frames_and_done(self, fe):
        conn, r = _post(fe, {"prompt": [1, 2], "max_tokens": 3,
                             "stream": True})
        assert r.status == 200
        assert r.headers["Content-Type"] == "text/event-stream"
        raw, events = _read_sse(r)
        toks = [e["token"] for e in events if "token" in e]
        assert toks == [11, 12, 13]
        for line, t in zip(raw, toks):
            assert line == sse_frame(fe.token_frame(t))
        done = [e["done"] for e in events if "done" in e]
        assert done and done[0]["completion_tokens"] == 3
        assert done[0]["finish_reason"] == "length"
        assert raw[-1] == SSE_DONE
        conn.close()

    def test_backend_failure_is_an_error_frame(self):
        try:
            raise OSError("disk gone")
        except OSError as root:
            fail = RuntimeError("request 0 failed")
            fail.__cause__ = root
        with HttpFrontend(FakeBackend(fail=fail)) as fe:
            conn, r = _post(fe, {"prompt": [1], "max_tokens": 2,
                                 "stream": True})
            raw, events = _read_sse(r)
            errs = [e["error"] for e in events if "error" in e]
            assert errs and errs[0]["type"] == "RuntimeError"
            assert errs[0]["cause"] == "OSError: disk gone"
            assert fe.registry.get("http.failed").value() == 1
            conn.close()

    def test_backend_failure_blocking_is_500(self):
        with HttpFrontend(FakeBackend(fail=RuntimeError("boom"))) as fe:
            conn, r = _post(fe, {"prompt": [1]})
            assert r.status == 500
            assert json.loads(r.read())["error"]["message"] == "boom"
            conn.close()

    def test_blown_deadline_blocking_is_504(self):
        late = RuntimeError("request 0 failed")
        late.__cause__ = DeadlineExceededError("budget spent")
        with HttpFrontend(FakeBackend(fail=late)) as fe:
            conn, r = _post(fe, {"prompt": [1]})
            assert r.status == 504
            assert json.loads(r.read())["error"]["retryable"] is False
            conn.close()

    def test_client_disconnect_cancels_fake_backend(self):
        be = FakeBackend([7] * 200, delay=0.01)
        with HttpFrontend(be) as fe:
            sock, f = _raw_post(fe, {"prompt": [1], "max_tokens": 200,
                                     "stream": True})
            line = f.readline()
            assert line.startswith(b"data:")
            _rst_close(sock, f)
            t0 = time.time()
            while not be.cancelled and time.time() - t0 < 10:
                time.sleep(0.02)
            assert be.cancelled
            assert fe.registry.get(
                "http.client_disconnects").value() == 1

    def test_close_can_shut_backend_down(self):
        be = FakeBackend()
        fe = HttpFrontend(be).start()
        fe.close(shutdown_backend=True)
        assert be.shut_down


# ----------------------------------------------------------------------
# bounded admission + SLO fields (twins of tests/test_slo.py)
# ----------------------------------------------------------------------
class TestHttpOverload:
    def test_inflight_cap_sheds_with_429(self):
        fe = HttpFrontend(FakeBackend(), max_inflight=1,
                          retry_after_s=2.5).start()
        try:
            assert fe._admit()          # occupy the only slot
            conn, resp = _post(fe, {"prompt": [1, 2], "max_tokens": 1})
            assert resp.status == 429
            assert resp.getheader("Retry-After") == "2.5"
            doc = json.loads(resp.read())
            assert doc["error"]["type"] == "Overloaded"
            assert doc["error"]["retryable"] is True
            conn.close()
            fe._release()
            conn, resp = _post(fe, {"prompt": [1, 2], "max_tokens": 1})
            assert resp.status == 200   # slot free again -> serves
            conn.close()
            assert fe.registry.get("http.shed").value() == 1
            # the handler releases its slot after the response is sent,
            # so the client can read the response first
            t0 = time.time()
            while (fe.registry.get("http.inflight").value()
                   and time.time() - t0 < 10):
                time.sleep(0.01)
            assert fe.registry.get("http.inflight").value() == 0
        finally:
            fe.close()

    def test_queue_depth_cap_sheds(self):
        backend = FakeBackend()
        g = backend.registry.gauge("scheduler.queue_depth", "t").labels()
        g.set(3.0)                      # scheduler already backed up
        fe = HttpFrontend(backend, max_queue_depth=3).start()
        try:
            conn, resp = _post(fe, {"prompt": [1, 2], "max_tokens": 1})
            assert resp.status == 429
            conn.close()
            g.set(0.0)
            conn, resp = _post(fe, {"prompt": [1, 2], "max_tokens": 1})
            assert resp.status == 200
            conn.close()
        finally:
            fe.close()

    def test_slo_fields_reach_the_backend_request(self):
        backend = Recording()
        fe = HttpFrontend(backend).start()
        try:
            conn, resp = _post(fe, {"prompt": [1, 2, 3], "max_tokens": 2,
                                    "priority": "batch",
                                    "deadline_ms": 250.0})
            assert resp.status == 200
            conn.close()
        finally:
            fe.close()
        assert backend.seen.priority == "batch"
        assert backend.seen.deadline_s == pytest.approx(0.25)

    def test_slo_headers_apply_when_body_is_silent(self):
        backend = Recording()
        fe = HttpFrontend(backend).start()
        try:
            conn = http.client.HTTPConnection(fe.host, fe.port, timeout=5)
            conn.request("POST", "/v1/completions",
                         json.dumps({"prompt": [1, 2], "max_tokens": 1}),
                         {"Content-Type": "application/json",
                          "X-Priority": "batch",
                          "X-Deadline-Ms": "500"})
            assert conn.getresponse().status == 200
            conn.close()
        finally:
            fe.close()
        assert backend.seen.priority == "batch"
        assert backend.seen.deadline_s == pytest.approx(0.5)

    def test_bad_slo_fields_are_400(self):
        fe = HttpFrontend(FakeBackend()).start()
        try:
            for body in ({"prompt": [1], "priority": "bulk"},
                         {"prompt": [1], "deadline_ms": 0},
                         {"prompt": [1], "deadline_ms": -5}):
                conn, resp = _post(fe, body)
                assert resp.status == 400
                doc = json.loads(resp.read())
                assert doc["error"]["retryable"] is False
                conn.close()
            conn = http.client.HTTPConnection(fe.host, fe.port, timeout=5)
            conn.request("POST", "/v1/completions",
                         json.dumps({"prompt": [1]}),
                         {"X-Priority": "bulk"})
            assert conn.getresponse().status == 400
            conn.close()
        finally:
            fe.close()

    def test_error_payload_retryability(self):
        assert error_payload(Overloaded("x"))["error"]["retryable"]
        assert not error_payload(BadRequest("x"))["error"]["retryable"]
        wrapped = RuntimeError("boom")
        wrapped.__cause__ = DeadlineExceededError("late")
        assert not error_payload(wrapped)["error"]["retryable"]
        assert error_payload(TimeoutError("slow"))["error"]["retryable"]


# ----------------------------------------------------------------------
# the front end's fault points (twins of tests/test_faults.py)
# ----------------------------------------------------------------------
class TestDropSseFault:
    def test_dropped_frames_still_counted_in_done(self, clean_faults):
        faults.arm("http.drop_sse", 2)      # lose every 2nd token frame
        fe = HttpFrontend(FakeBackend([11, 12, 13, 14])).start()
        try:
            conn, resp = _post(fe, {"prompt": [1, 2, 3],
                                    "max_tokens": 4, "stream": True})
            assert resp.status == 200
            _, events = _read_sse(resp)
            conn.close()
        finally:
            fe.close()
        toks = [e["token"] for e in events if "token" in e]
        done = [e for e in events if "done" in e][0]["done"]
        assert toks == [11, 13]
        assert done["completion_tokens"] == 4
        assert faults.hits("http.drop_sse") == 2

    def test_scrape_fault_slows_metrics_endpoint(self, clean_faults):
        faults.arm("http.scrape_ms", 40)
        fe = HttpFrontend(FakeBackend()).start()
        try:
            conn = http.client.HTTPConnection(fe.host, fe.port, timeout=5)
            t0 = time.perf_counter()
            conn.request("GET", "/metrics.json")
            body = conn.getresponse().read()
            assert time.perf_counter() - t0 >= 0.03
            json.loads(body)
            conn.close()
        finally:
            fe.close()
        assert faults.hits("http.scrape_ms") == 1


# ----------------------------------------------------------------------
# the port's AsyncEngine on the CPU behind the front end
# ----------------------------------------------------------------------
def _tiny_pair(jcfg):
    """(reference model, reference params, port model, port params) on
    the reference's ``PRNGKey(0)`` weights for ``jcfg``."""
    import dataclasses

    from repro_torch.models import ModelConfig
    jm = jbuild(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JModelConfig)}
    fields["dtype"] = BENCH_TINY.dtype
    return (jm, jax.tree.map(jnp.asarray, tree),
            build_model(ModelConfig(**fields)),
            params_from_numpy(tree, "cpu"))


@pytest.fixture(scope="module")
def tiny_engine():
    jcfg = JModelConfig(name="tiny", arch_type="dense", n_layers=2,
                        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                        vocab_size=259, dtype=jnp.float32)
    _, _, model, params = _tiny_pair(jcfg)
    # prefix cache off: retained prompt pages would otherwise keep the
    # pages_free gauge below its baseline after a cancel (by design)
    eng = AsyncEngine(model, params, max_len=128, max_running=2,
                      page_size=4, n_pages=64, prefix_cache=False,
                      device="cpu")
    yield eng
    eng.shutdown()


def _scrape(fe):
    conn = http.client.HTTPConnection(fe.host, fe.port, timeout=10)
    conn.request("GET", "/metrics.json")
    doc = json.loads(conn.getresponse().read())
    conn.close()
    counters, gauges = {}, {}
    for c in doc["counters"]:
        counters[c["name"]] = counters.get(c["name"], 0) + c["value"]
    for g in doc["gauges"]:
        gauges[g["name"]] = gauges.get(g["name"], 0) + g["value"]
    return counters, gauges


class TestRealEngineWire:
    def test_sse_wire_parity_with_engine_stream(self, tiny_engine):
        prompt, max_new = [3, 1, 4, 1, 5, 9, 2, 6], 6
        ref = tiny_engine.submit(Request(
            uid=0, prompt=prompt,
            sampling=SamplingParams(max_new_tokens=max_new)))
        ref_tokens = list(tiny_engine.stream(ref, timeout=120))
        assert len(ref_tokens) == max_new

        with HttpFrontend(tiny_engine) as fe:
            conn, r = _post(fe, {"prompt": prompt, "max_tokens": max_new,
                                 "stream": True}, timeout=120)
            raw, events = _read_sse(r)
            conn.close()
        token_frames = [line for line, e in zip(raw, events)
                        if "token" in e]
        expected = [sse_frame(fe.token_frame(t)) for t in ref_tokens]
        assert token_frames == expected

    def test_disconnect_cancels_and_frees_pages(self, tiny_engine):
        with HttpFrontend(tiny_engine) as fe:
            conn, r = _post(fe, {"prompt": [1] * 8, "max_tokens": 2},
                            timeout=120)
            assert r.status == 200 and r.read()
            conn.close()
            c0, g0 = _scrape(fe)
            free0 = g0["kv_pool.pages_free"]
            cancelled0 = c0.get("async.cancelled", 0)
            sock, f = _raw_post(fe, {"prompt": [7] * 12,
                                     "max_tokens": 500, "stream": True})
            for _ in range(2):          # stream is really running
                line = f.readline()
                assert line, "stream ended early"
            _rst_close(sock, f)

            deadline = time.time() + 60
            while time.time() < deadline:
                counters, gauges = _scrape(fe)
                if (counters.get("async.cancelled", 0) > cancelled0
                        and gauges["kv_pool.pages_free"] >= free0):
                    break
                time.sleep(0.05)
            assert counters.get("async.cancelled", 0) == cancelled0 + 1
            assert gauges["kv_pool.pages_free"] >= free0
            assert gauges["http.inflight"] == 0


# ----------------------------------------------------------------------
# across the packages: the same frames on the same weights
# ----------------------------------------------------------------------
def _frames(fe, body):
    """Every SSE event of one streamed completion, with the ``done``
    frame's timing fields dropped."""
    conn, r = _post(fe, dict(body, stream=True), timeout=120)
    assert r.status == 200
    raw, events = _read_sse(r)
    conn.close()
    for e in events:
        if "done" in e:
            del e["done"]["ttft_ms"], e["done"]["latency_ms"]
    return events, raw


def _document(fe, body):
    conn, r = _post(fe, body, timeout=120)
    assert r.status == 200
    doc = json.loads(r.read())
    conn.close()
    del doc["timing"]
    return doc


def test_sse_frames_equal_the_reference_frontend():
    """bench-tiny (the reference's ``build_tiny()``, ``PRNGKey(0)``) in
    both packages, each behind its own package's ``HttpFrontend`` with
    the byte tokenizer: token ids, texts, ``done`` frames and the
    blocking documents agree for token-id and string prompts."""
    from repro.serving.worker import build_tiny as jbuild_tiny
    jm, jp = jbuild_tiny()
    tree = jax.tree.map(np.asarray, jp)
    model = build_model(BENCH_TINY)
    params = params_from_numpy(tree, "cpu")
    kw = dict(max_len=128, max_running=4, page_size=16)
    bodies = [{"prompt": list(range(1, 25)), "max_tokens": 6},
              {"prompt": "the scheduler binds", "max_tokens": 8},
              {"prompt": [7, 8, 9, 7, 8, 9], "max_tokens": 5,
               "priority": "batch"}]
    with JAsyncEngine(jm, jp, **kw) as jeng, \
            AsyncEngine(model, params, device="cpu", **kw) as teng:
        with jhttp.HttpFrontend(jeng, tokenizer=JByteTokenizer()) as jfe, \
                HttpFrontend(teng, tokenizer=ByteTokenizer()) as tfe:
            for body in bodies:
                want, want_raw = _frames(jfe, body)
                got, got_raw = _frames(tfe, body)
                assert got == want
                n = len(body.get("prompt")) if isinstance(
                    body["prompt"], list) else None
                assert sum("token" in e for e in got) == body["max_tokens"]
                if n is not None:
                    assert got[-1]["done"]["prompt_tokens"] == n
                # token frames are byte-equal on the wire too
                assert [f for f in got_raw if b'"token"' in f] == \
                    [f for f in want_raw if b'"token"' in f]
                assert _document(tfe, body) == _document(jfe, body)
