"""HTTP serving front end: OpenAI-style completions over the engine seam.

The port's counterpart of ``repro.serving.http``, with the same routes,
wire format, error documents and ``http.*`` metric names.  Stdlib
``http.server`` threads, and **backend-agnostic**: anything exposing the
``AsyncEngine`` caller surface (``submit(request, on_token=)`` /
``stream`` / ``result`` / ``cancel`` / ``registry`` / ``shutdown``) can
sit behind it: a local :class:`~repro_torch.serving.async_engine.
AsyncEngine` (single-process serving) or a
:class:`~repro_torch.serving.router.Router` fanning out to engine-worker
subprocesses (``launch/serve.py --http --replicas N``).  The handler
threads touch host state only: every device call happens on the engine's
stepper thread (or in a worker process).

Endpoints:

``POST /v1/completions``
    JSON body -> :class:`~repro_torch.serving.engine.Request`.
    ``prompt`` is a string (encoded with the frontend's tokenizer) or a
    raw token id list; ``max_tokens`` / ``temperature`` / ``top_k`` /
    ``eos_id`` map onto :class:`~repro_torch.serving.sampler.
    SamplingParams`; ``priority`` (``interactive``/``batch``) and
    ``deadline_ms`` (remaining latency budget — also accepted as
    ``X-Priority`` / ``X-Deadline-Ms`` headers) feed the SLO-aware
    scheduler.  With ``"stream": true`` the response is Server-Sent
    Events: one ``data:`` frame per sampled token (driven by the
    backend's token feed, so frames leave as the engine samples), a
    ``done`` frame with usage/timing, then ``data: [DONE]``.  Without
    it, the handler blocks on ``result()`` and returns one JSON
    completion document.

``GET /healthz``
    Liveness (and, behind a router, per-replica health).

``GET /metrics`` / ``GET /metrics.json``
    The backend registry's Prometheus text exposition / JSON snapshot
    (``repro_torch.obs`` — the snapshot validates under
    ``repro_torch.obs.validate``).

Failure semantics: a client that disconnects mid-stream triggers
``backend.cancel(handle)`` on the next frame write, so an abandoned
stream frees its engine slot and KV pages.  A FAILED handle surfaces as
an SSE ``error`` frame (streaming) or an HTTP 500 JSON error document
(non-streaming).  Every failure path — 400/429/500/503/504 bodies and
SSE error frames alike — carries the SAME structured shape
(:func:`error_payload`: type, message, chained cause, retryable), and
retryable refusals (429 shed, 503, 504 timeout) add a ``Retry-After``
header.  Overload protection: ``max_inflight`` / ``max_queue_depth``
bound admission and shed excess load with 429 (counted as
``http.shed``) instead of queueing into a latency cliff.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from . import faults
from .async_engine import DeadlineExceededError
from .engine import PRIORITIES, Request
from .sampler import SamplingParams

#: terminal SSE frame — after it the stream holds nothing more
SSE_DONE = b"data: [DONE]\n\n"


def sse_frame(obj: Any) -> bytes:
    """One SSE ``data:`` frame.  Compact separators + sorted keys keep
    the bytes deterministic, so the wire-parity test can byte-compare
    frames against locally rebuilt ones."""
    body = json.dumps(obj, separators=(",", ":"), sort_keys=True)
    return b"data: " + body.encode("utf-8") + b"\n\n"


def _is_retryable(exc: BaseException) -> bool:
    """Would the same request plausibly succeed if re-sent?  Shedding
    and timeouts are transient (yes); bad requests are permanent (no);
    a blown deadline is unretryable *by definition* — the budget is
    spent no matter who retries.  Walks the cause chain so a wrapped
    ``DeadlineExceededError`` keeps its verdict."""
    seen = 0
    e: Optional[BaseException] = exc
    while e is not None and seen < 8:
        if isinstance(e, (BadRequest, DeadlineExceededError)):
            return False
        if isinstance(e, (Overloaded, TimeoutError)):
            return True
        e = e.__cause__
        seen += 1
    return False


def error_payload(exc: BaseException,
                  retryable: Optional[bool] = None) -> Dict[str, Any]:
    """JSON error document — the ONE error shape every HTTP failure
    path returns (non-stream status bodies, SSE ``error`` frames, shed
    responses): type + message + chained cause (worker death, bad
    request, ...) + whether a client should re-send
    (:func:`_is_retryable` unless the caller already knows)."""
    cause = exc.__cause__
    return {"error": {
        "type": type(exc).__name__,
        "message": str(exc),
        "cause": (f"{type(cause).__name__}: {cause}"
                  if cause is not None else None),
        "retryable": (_is_retryable(exc) if retryable is None
                      else bool(retryable)),
    }}


class BadRequest(ValueError):
    """Client error in a completion body (HTTP 400)."""


class Overloaded(RuntimeError):
    """Admission refused by the front-end's bounded-admission gate
    (HTTP 429 + ``Retry-After``): the queue or inflight cap is hit and
    taking one more request would only grow latency for everyone.
    Always retryable — after ``Retry-After`` seconds."""


def parse_completion_body(
        raw: bytes, tokenizer=None,
) -> Tuple[List[int], SamplingParams, bool, Dict[str, Any]]:
    """Parse a ``/v1/completions`` body into ``(prompt token ids,
    SamplingParams, stream?, slo)``.  Raises :class:`BadRequest` on
    anything the engine could never serve.

    ``slo`` carries the request's overload-protection fields:
    ``priority`` (``interactive``/``batch``, default interactive) and
    ``deadline_ms`` (remaining latency budget in milliseconds, or None)
    — the wire always speaks *relative* budgets so hops never need
    synchronised clocks.  A budget that is already <= 0 is rejected
    here (400, not retryable): serving it would only produce an answer
    past its deadline."""
    try:
        doc = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise BadRequest(f"body is not JSON: {e}") from e
    if not isinstance(doc, dict):
        raise BadRequest("body must be a JSON object")
    prompt = doc.get("prompt")
    if isinstance(prompt, str):
        if tokenizer is None:
            raise BadRequest("string prompt needs a tokenizer; send "
                             "token ids")
        tokens = list(tokenizer.encode(prompt))
    elif (isinstance(prompt, list) and prompt
            and all(isinstance(t, int) and not isinstance(t, bool)
                    for t in prompt)):
        tokens = list(prompt)
    else:
        raise BadRequest("prompt must be a non-empty string or a list "
                         "of token ids")
    try:
        sp = SamplingParams(
            temperature=float(doc.get("temperature", 0.0)),
            top_k=int(doc.get("top_k", 0)),
            max_new_tokens=int(doc.get("max_tokens", 16)),
            eos_id=(int(doc["eos_id"])
                    if doc.get("eos_id") is not None else None))
    except (TypeError, ValueError) as e:
        raise BadRequest(f"bad sampling field: {e}") from e
    if sp.max_new_tokens < 1:
        raise BadRequest("max_tokens must be >= 1")
    stream = bool(doc.get("stream", False))
    priority = doc.get("priority", "interactive")
    if priority not in PRIORITIES:
        raise BadRequest(f"priority must be one of {list(PRIORITIES)}, "
                         f"got {priority!r}")
    deadline_ms: Optional[float] = None
    if doc.get("deadline_ms") is not None:
        try:
            deadline_ms = float(doc["deadline_ms"])
        except (TypeError, ValueError) as e:
            raise BadRequest(f"bad deadline_ms: {e}") from e
        if deadline_ms <= 0:
            raise BadRequest("deadline_ms must be > 0 (budget already "
                             "spent)")
    return tokens, sp, stream, {"priority": priority,
                                "deadline_ms": deadline_ms}


class _ServingHTTPServer(ThreadingHTTPServer):
    daemon_threads = True       # in-flight handlers die with the server
    allow_reuse_address = True
    frontend: "HttpFrontend"


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: _ServingHTTPServer

    def log_message(self, *args: Any) -> None:     # quiet by default
        pass

    # -- GET: health + metrics -----------------------------------------
    def do_GET(self) -> None:
        fe = self.server.frontend
        if self.path == "/healthz":
            self._send_json(200, fe.health())
        elif self.path == "/metrics":
            body = fe.registry.to_prometheus().encode("utf-8")
            self._send(200, body,
                       "text/plain; version=0.0.4; charset=utf-8")
        elif self.path == "/metrics.json":
            if faults.ACTIVE:       # chaos: slow load-probe target
                faults.maybe_sleep("http.scrape_ms")
            self._send(200, fe.registry.snapshot_json().encode("utf-8"),
                       "application/json")
        else:
            self._send_json(404, {"error": {"type": "NotFound",
                                            "message": self.path}})

    # -- POST: completions ----------------------------------------------
    def do_POST(self) -> None:
        fe = self.server.frontend
        if self.path != "/v1/completions":
            self._send_json(404, {"error": {"type": "NotFound",
                                            "message": self.path}})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            tokens, sp, stream, slo = parse_completion_body(
                self.rfile.read(n), fe.tokenizer)
            # header fallback for clients that can't touch the body
            # (proxies stamping budgets); body fields win
            if ("priority" not in slo or slo["priority"] == "interactive") \
                    and self.headers.get("X-Priority"):
                prio = self.headers["X-Priority"].strip()
                if prio not in PRIORITIES:
                    raise BadRequest(
                        f"X-Priority must be one of {list(PRIORITIES)}, "
                        f"got {prio!r}")
                slo["priority"] = prio
            if (slo.get("deadline_ms") is None
                    and self.headers.get("X-Deadline-Ms")):
                try:
                    dl = float(self.headers["X-Deadline-Ms"])
                except ValueError as e:
                    raise BadRequest(f"bad X-Deadline-Ms: {e}") from e
                if dl <= 0:
                    raise BadRequest("X-Deadline-Ms must be > 0")
                slo["deadline_ms"] = dl
        except BadRequest as e:
            fe._c_bad.inc()
            self._send_json(400, error_payload(e))
            return
        dl_ms = slo.get("deadline_ms")
        req = Request(uid=0, prompt=tokens, sampling=sp,
                      priority=slo["priority"],
                      deadline_s=dl_ms / 1e3 if dl_ms is not None else None)
        # bounded admission: shed NOW, with a structured 429 the client
        # can act on, instead of queueing into a latency cliff
        if not fe._admit():
            fe._c_shed.inc()
            self._send_json(
                429,
                error_payload(Overloaded(
                    f"admission refused: {fe.admission_state()}"),
                    retryable=True),
                headers={"Retry-After": str(fe.retry_after_s)})
            return
        fe._c_requests.inc()
        try:
            if stream:
                self._stream_completion(fe, req)
            else:
                self._block_completion(fe, req)
        finally:
            fe._release()

    # ------------------------------------------------------------------
    def _stream_completion(self, fe: "HttpFrontend", req: Request) -> None:
        backend = fe.backend
        try:
            handle = backend.submit(req)
        except Exception as e:                      # noqa: BLE001
            # backend refused/unreachable — a later retry may find it
            # healthy again (router readmission, supervisor respawn)
            self._send_json(503, error_payload(e, retryable=True),
                            headers={"Retry-After": str(fe.retry_after_s)})
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        t0 = time.perf_counter()
        t_first: Optional[float] = None
        n_sent = 0
        try:
            for tok in backend.stream(handle, timeout=fe.token_timeout):
                if t_first is None:
                    t_first = time.perf_counter()
                n_sent += 1
                # chaos fault: silently lose this frame while still
                # counting it — the done frame then over-reports and a
                # router downstream detects the mismatch
                if faults.ACTIVE and faults.should_fire("http.drop_sse"):
                    continue
                self.wfile.write(sse_frame(fe.token_frame(tok)))
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            # the CLIENT went away: free the engine slot + KV pages
            backend.cancel(handle)
            fe._c_disconnects.inc()
            return
        except BaseException as e:                  # noqa: BLE001
            # FAILED handle (engine/worker error) or token timeout:
            # surface the cause in-band, then end the stream
            if isinstance(e, TimeoutError):
                backend.cancel(handle)
            fe._c_failed.inc()      # before [DONE]: a client that saw
            self._try_write(        # the frame can already scrape it
                sse_frame(error_payload(e)) + SSE_DONE)
            return
        t1 = time.perf_counter()
        done = {"done": {
            "prompt_tokens": len(req.prompt),
            "completion_tokens": n_sent,
            "finish_reason": "length",
            "ttft_ms": round(((t_first or t1) - t0) * 1e3, 3),
            "latency_ms": round((t1 - t0) * 1e3, 3),
        }}
        self._try_write(sse_frame(done) + SSE_DONE)

    def _block_completion(self, fe: "HttpFrontend", req: Request) -> None:
        backend = fe.backend
        handle = None
        try:
            handle = backend.submit(req)
            comp = backend.result(handle, timeout=fe.request_timeout)
        except TimeoutError as e:
            if handle is not None:
                backend.cancel(handle)
            fe._c_failed.inc()
            self._send_json(504, error_payload(e, retryable=True),
                            headers={"Retry-After": str(fe.retry_after_s)})
            return
        except BaseException as e:                  # noqa: BLE001
            fe._c_failed.inc()
            # a blown deadline is a timeout to the client (504), just
            # never a retryable one; anything else is a plain 500
            cause, n = e, 0
            while (cause is not None and n < 8 and
                   not isinstance(cause, DeadlineExceededError)):
                cause, n = cause.__cause__, n + 1
            status = 504 if isinstance(cause, DeadlineExceededError) \
                else 500
            self._send_json(status, error_payload(e))
            return
        text = (fe.tokenizer.decode(comp.tokens)
                if fe.tokenizer is not None else "")
        self._send_json(200, {
            "id": f"cmpl-{comp.uid}",
            "object": "text_completion",
            "choices": [{"index": 0, "text": text,
                         "tokens": list(comp.tokens),
                         "finish_reason": "length"}],
            "usage": {"prompt_tokens": comp.prompt_len,
                      "completion_tokens": len(comp.tokens),
                      "total_tokens": comp.prompt_len + len(comp.tokens)},
            "timing": {"ttft_ms": round((comp.t_first - comp.t0) * 1e3, 3),
                       "latency_ms": round(comp.latency_s * 1e3, 3)},
        })

    # ------------------------------------------------------------------
    def _send(self, status: int, body: bytes, ctype: str,
              headers: Optional[Dict[str, str]] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, doc: Dict[str, Any],
                   headers: Optional[Dict[str, str]] = None) -> None:
        self._send(status, json.dumps(doc, sort_keys=True).encode("utf-8"),
                   "application/json", headers)

    def _try_write(self, data: bytes) -> None:
        try:
            self.wfile.write(data)
            self.wfile.flush()
        except OSError:
            pass        # client already gone; nothing left to tell it


class HttpFrontend:
    """Threaded HTTP server over one engine-like backend.

    ``start()`` binds and serves on a background thread (``port=0``
    picks a free port — ``self.port`` is the bound one); ``close()``
    stops accepting, joins the server thread and optionally shuts the
    backend down.  One handler thread per connection (stdlib
    ``ThreadingHTTPServer``), so a streaming client parks only its own
    thread while the engine stepper keeps serving everyone else.
    """

    def __init__(self, backend: Any, *, tokenizer: Any = None,
                 host: str = "127.0.0.1", port: int = 0,
                 token_timeout: float = 120.0,
                 request_timeout: float = 600.0,
                 max_inflight: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 retry_after_s: float = 1.0) -> None:
        self.backend = backend
        self.tokenizer = tokenizer
        self.token_timeout = token_timeout
        self.request_timeout = request_timeout
        #: bounded admission (None = unbounded, the pre-SLO behavior):
        #: ``max_inflight`` caps completion requests this frontend is
        #: concurrently serving; ``max_queue_depth`` caps the backend
        #: scheduler's waiting queue (read from the shared registry's
        #: ``scheduler.queue_depth`` gauge — in-process backends only;
        #: a router front door has no scheduler and relies on the
        #: inflight cap)
        if max_inflight is not None and max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if max_queue_depth is not None and max_queue_depth < 0:
            raise ValueError("max_queue_depth must be >= 0")
        self.max_inflight = max_inflight
        self.max_queue_depth = max_queue_depth
        self.retry_after_s = retry_after_s
        self._inflight = 0
        self._admission_lock = threading.Lock()
        self._server = _ServingHTTPServer((host, port), _Handler)
        self._server.frontend = self
        self.host, self.port = self._server.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        reg = self.registry
        self._c_requests = reg.counter(
            "http.requests", "completion requests accepted").labels()
        self._c_bad = reg.counter(
            "http.bad_requests", "completion bodies rejected (400)"
            ).labels()
        self._c_failed = reg.counter(
            "http.failed", "completions that surfaced an error/timeout"
            ).labels()
        self._c_disconnects = reg.counter(
            "http.client_disconnects",
            "streams cancelled because the client went away").labels()
        self._c_shed = reg.counter(
            "http.shed",
            "completion requests refused with 429 by bounded admission"
            ).labels()
        self._g_inflight = reg.gauge(
            "http.inflight",
            "completion requests this frontend is currently serving"
            ).labels()
        self._g_queue_depth = reg.get("scheduler.queue_depth")

    # -- bounded admission ----------------------------------------------
    def _admit(self) -> bool:
        """Take one admission slot, or refuse.  Checks the inflight cap
        (frontend-local) and the scheduler queue-depth cap (in-process
        backends).  The caller MUST pair every True with ``_release``."""
        with self._admission_lock:
            if (self.max_inflight is not None
                    and self._inflight >= self.max_inflight):
                return False
            if (self.max_queue_depth is not None
                    and self._g_queue_depth is not None
                    and self._g_queue_depth.value()
                    >= self.max_queue_depth):
                return False
            self._inflight += 1
            self._g_inflight.set(float(self._inflight))
            return True

    def _release(self) -> None:
        with self._admission_lock:
            self._inflight -= 1
            self._g_inflight.set(float(self._inflight))

    def admission_state(self) -> str:
        """Human-readable gate state for shed messages/logs."""
        q = (self._g_queue_depth.value()
             if self._g_queue_depth is not None else None)
        return (f"inflight={self._inflight}/{self.max_inflight} "
                f"queue_depth={q if q is not None else 'n/a'}"
                f"/{self.max_queue_depth}")

    @property
    def registry(self):
        return self.backend.registry

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def health(self) -> Dict[str, Any]:
        doc = {"status": "ok", "backend": type(self.backend).__name__}
        backend_health = getattr(self.backend, "health", None)
        if callable(backend_health):
            doc.update(backend_health())
        return doc

    def token_frame(self, tok: int) -> Dict[str, Any]:
        """The per-token SSE payload (kept tiny and deterministic)."""
        text = (self.tokenizer.decode([tok])
                if self.tokenizer is not None else "")
        return {"index": 0, "text": text, "token": int(tok)}

    # ------------------------------------------------------------------
    def start(self) -> "HttpFrontend":
        if self._thread is not None:
            raise RuntimeError("frontend already started")
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="http-frontend",
            daemon=True)
        self._thread.start()
        return self

    def close(self, *, shutdown_backend: bool = False) -> None:
        """Stop serving (idempotent).  In-flight handler threads are
        daemons riding the backend's streams; shutting the backend down
        (``shutdown_backend=True``) terminates their handles too."""
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=10.0)
            self._thread = None
        self._server.server_close()
        if shutdown_backend:
            self.backend.shutdown()

    def __enter__(self) -> "HttpFrontend":
        return self.start() if self._thread is None else self

    def __exit__(self, *exc: Any) -> None:
        self.close()
