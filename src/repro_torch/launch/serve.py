"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

The port's counterpart of ``repro.launch.serve``: brings up a serving
engine on a REDUCED variant of the architecture (float32, as the
reference serves reduced configs), serves a batch of byte-level prompts
and prints the completions and the throughput report.  The weights are
drawn from a fixed seed, or loaded with ``--params PATH`` from an
``.npz`` the weight bridge wrote (``repro_torch.models.weights.
save_params_npz``): that is how the port serves the very weights the
reference draws from ``PRNGKey(0)``, since torch cannot draw JAX's.

``--engine bucket`` (the default, as in the reference) is the
length-bucket baseline over the ring cache; it serves every ported
arch, the hybrid RG-LRU stack of ``recurrentgemma-2b`` (the contiguous
decode and RG-LRU scan kernels on the card) and the SSD stack of
``mamba2-370m``, the cross-attention stack of ``llama-3.2-vision-11b``
and the encoder-decoder stack of ``whisper-medium`` included: each of
the last two takes its image or audio input as the reference's numpy
stub (``repro_torch.data.pipeline.stub_image_embeds`` /
``stub_frames``, seed 0) in every request's ``extra``.
``--engine continuous`` is the paged
continuous-batching engine, for uniform self-attention stacks, dense or
MoE (``phi3.5-moe-42b-a6.6b``, ``grok-1-314b``; an SSD, hybrid,
cross-attention or encoder-decoder stack raises ``NotImplementedError``
from the paged cache, as in the reference; MoE archs serve at
a capacity factor of 4.0, as the reference CLI sets); ``--engine async``
serves the same stack through the live ``AsyncEngine`` (submit/stream on
a background stepper thread) — add ``--interactive`` for a stdin demo
that streams each prompt's tokens as they are sampled.

The paged engines take ``--spec-decode K`` (draft up to K tokens per
step by prompt lookup and verify them in one batched forward; greedy
output stays that of K=0, unless an MoE expert's capacity drops a token
differently in the wider verify batch, as in the reference),
``--quant q4`` (Q4_0 attention/MLP projections, the hand-written Q4_0
GEMM on the card; MoE expert stacks stay dense) and ``--kv-dtype int8``
(int8 KV pages with per-row scales).  Observability:
``--metrics-json PATH`` writes the metrics registry snapshot on exit,
``--trace PATH`` the per-request trace spans as JSONL (both checked by
``python -m repro_torch.obs.validate``), ``--stats-every SECS`` prints
a metrics line while the async engine serves.  The bucket engine
refuses these flags, as the reference's does.

Network serving: ``--http`` (async engine) serves ``/v1/completions``
(SSE streaming) + ``/healthz`` + ``/metrics`` instead of running the
batch demo.  ``--replicas 0`` (default) serves the in-process
``AsyncEngine`` (``repro_torch.serving.http``); ``--replicas N`` spawns
N ``repro_torch.serving.worker`` subprocesses under a supervisor
(``--max-respawns`` restarts each dead one) and routes across them with
prefix-affinity placement and a per-replica circuit breaker
(``repro_torch.serving.router``, ``--breaker-threshold``); the workers
get this command's ``--device``, ``--params`` and engine flags.
``--max-inflight`` / ``--max-queue-depth`` shed excess load with 429.
``--port 0`` picks a free port; ``--port-file PATH`` writes the bound
port for scripts.  SIGTERM or SIGINT stops the server (and the fleet).

Before serving, the model is warm-trained for ``--warmup-steps`` steps
(default 40, as in the reference; 0 serves the drawn weights) with the
reference's recipe (:func:`warm_up`), so the outputs are not noise.
``--http --replicas N`` serves its workers' own weights untrained, as the
reference's fleet does.

It runs on the GPU (``--device cuda``, the default) and raises when no
GPU is present; ``--device cpu`` runs it on the CPU.  ``--arch tiny`` is
the benchmark suite's bench-tiny model.  Tensor-parallel serving
(``--tp-shards``) is not ported.

Examples:
    python -m repro_torch.launch.serve --arch recurrentgemma-2b
    python -m repro_torch.launch.serve --arch mamba2-370m
    python -m repro_torch.launch.serve --arch whisper-medium
    python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b \\
        --engine continuous
    python -m repro_torch.launch.serve --arch qwen3-1.7b --engine continuous
    python -m repro_torch.launch.serve --arch qwen3-1.7b --engine async \\
        --spec-decode 2 --metrics-json m.json --trace t.jsonl
    python -m repro_torch.launch.serve --arch qwen3-1.7b --engine continuous \\
        --quant q4 --kv-dtype int8
    python -m repro_torch.launch.serve --arch gemma3-1b --engine continuous \\
        --max-running 4 --page-size 16 --prefill-chunk 8 --device cpu
    python -m repro_torch.launch.serve --arch tiny --engine async --http \\
        --replicas 2 --port 8080
"""

import argparse
import sys


def warm_up(model, params, steps: int, *, log_every: int = 20):
    """The reference CLI's warm-up: ``steps`` AdamW steps (lr 2e-3, 5
    warm-up steps, cosine over ``steps``) on batches of 8 rows of the
    packed synthetic corpus (64 tokens, 1000 documents), with the seed-
    ``step`` image or audio stubs of a cross-attention model.  Trains
    ``params`` in place on their device and returns them (not requiring
    grad) with the loss history."""
    from ..data.pipeline import PackedLMDataset
    from ..training.loop import train
    from ..training.optimizer import AdamWConfig
    from .train import stub_extras
    ds = PackedLMDataset(seq_len=64, n_docs=1000,
                         vocab_size=model.cfg.vocab_size)
    batches = ds.batches(8, extra_fn=stub_extras(model.cfg))
    params, _, hist = train(model, params, batches,
                            AdamWConfig(lr=2e-3, warmup_steps=5,
                                        total_steps=steps),
                            steps=steps, log_every=log_every)
    return params, hist


def stream_interactive(eng, handle, write, *, decode=None,
                       timeout: float = 300.0) -> str:
    """Stream one interactive request through ``write``; returns
    ``"finished"`` / ``"failed"`` / ``"cancelled"``.

    A handle that lands FAILED raises ``AsyncEngineError`` out of
    ``stream()`` with the real error chained as ``__cause__``: the cause
    is printed and the session keeps going.  A stream that times out
    cancels its request.
    """
    from ..serving.async_engine import AsyncEngineError, RequestState
    decode = decode if decode is not None else str
    try:
        for t in eng.stream(handle, timeout=timeout):
            write(decode(t))
    except AsyncEngineError as e:
        cause = e.__cause__
        write(f"\n[request failed: {e}"
              + (f" — caused by {type(cause).__name__}: {cause}"
                 if cause is not None else "") + "]\n")
        return "failed"
    except TimeoutError as e:
        eng.cancel(handle)
        write(f"\n[request timed out: {e}]\n")
        return "failed"
    if handle.state is RequestState.CANCELLED:
        write("\n[request cancelled]\n")
        return "cancelled"
    write("\n")
    return "finished"


def _serve_http(fe, *, port_file=None, supervisor=None) -> int:
    """Run a started frontend until SIGTERM/SIGINT, then drain the
    backend (the engine's stepper is joined) and, behind a router, the
    worker fleet."""
    import signal
    import threading

    from ..serving import faults
    faults.load_env()       # REPRO_FAULTS chaos harness (no-op unset)
    if port_file:
        with open(port_file, "w") as f:
            f.write(str(fe.port))
    print(f"serving http on {fe.url} "
          "(/v1/completions /healthz /metrics)", flush=True)
    stop = threading.Event()
    for s in (signal.SIGTERM, signal.SIGINT):
        signal.signal(s, lambda *_: stop.set())
    stop.wait()
    fe.close(shutdown_backend=True)
    if supervisor is not None:
        supervisor.shutdown()
    print("http serving stopped", flush=True)
    return 0


def _serve_replicated(args) -> int:
    """``--http --replicas N``: the front-door process holds only the
    supervisor + router + frontend — no model is built here; each worker
    subprocess builds its own engine, page pool and CUDA context."""
    from ..data.tokenizer import ByteTokenizer
    from ..serving.http import HttpFrontend
    from ..serving.router import Router
    from ..serving.supervisor import Supervisor
    worker_args = ["--arch", args.arch, "--device", args.device,
                   "--max-running", str(args.max_running), "--page-size",
                   str(args.page_size), "--seed", "0"]
    if args.params:
        worker_args += ["--params", args.params]
    if args.n_pages is not None:
        worker_args += ["--n-pages", str(args.n_pages)]
    if args.prefill_chunk is not None:
        worker_args += ["--prefill-chunk", str(args.prefill_chunk)]
    if args.no_prefix_cache:
        worker_args += ["--no-prefix-cache"]
    if args.quant != "none":
        worker_args += ["--quant", args.quant]
    if args.kv_dtype != "fp32":
        worker_args += ["--kv-dtype", args.kv_dtype]
    if args.spec_decode:
        worker_args += ["--spec-decode", str(args.spec_decode)]
    sup = Supervisor(args.replicas, worker_args, host=args.host,
                     max_respawns=args.max_respawns)
    print(f"starting {args.replicas} engine workers "
          f"(--arch {args.arch} --device {args.device}) ...", flush=True)
    clients = sup.start()
    router = Router(clients, page_size=args.page_size,
                    breaker_threshold=args.breaker_threshold)
    # the self-healing loop: death drains the replica from the ring; a
    # successful respawn re-admits it
    sup.on_death = lambda rid, rc: router.mark_dead(rid)
    sup.on_respawn = lambda rid, client: router.readmit(rid, client)
    for rid, c in sorted(clients.items()):
        print(f"  worker {rid}: {c.describe()} pid {c.proc.pid}",
              flush=True)
    fe = HttpFrontend(router, tokenizer=ByteTokenizer(), host=args.host,
                      port=args.port, max_inflight=args.max_inflight,
                      max_queue_depth=args.max_queue_depth).start()
    return _serve_http(fe, port_file=args.port_file, supervisor=sup)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--prompt", action="append", default=None)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="bucket engine: requests per length bucket")
    ap.add_argument("--engine", choices=("bucket", "continuous", "async"),
                    default="bucket",
                    help="serving engine: the length-bucket baseline over "
                         "the ring cache, the paged continuous-batching "
                         "engine, or the same behind the live async "
                         "front end")
    ap.add_argument("--interactive", action="store_true",
                    help="async engine: read prompts from stdin and "
                         "stream tokens as they are sampled")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; no GPU "
                         "raises instead of falling back to the CPU)")
    ap.add_argument("--params", metavar="PATH", default=None,
                    help="load the weights from this .npz (written by "
                         "repro_torch.models.weights.save_params_npz, e.g. "
                         "from the reference's Model.init) instead of "
                         "drawing them from seed 0")
    ap.add_argument("--max-running", type=int, default=4,
                    help="paged engines: running-batch slots")
    ap.add_argument("--page-size", type=int, default=16,
                    help="paged engines: KV page token slots")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="paged engines: KV pool pages (default: "
                         "no-preemption sizing)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="paged engines: prefill at most this many "
                         "prompt tokens per step (default: one-shot)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="paged engines: disable prompt-prefix "
                         "page sharing")
    ap.add_argument("--quant", choices=("none", "q4"), default="none",
                    help="paged engines: weight format — 'q4' packs "
                         "attention/MLP projections to Q4_0 at load")
    ap.add_argument("--kv-dtype", choices=("fp32", "int8"),
                    default="fp32",
                    help="paged engines: KV page format — 'int8' "
                         "stores quantized pages with per-row scales "
                         "('fp32' keeps the model's dtype)")
    ap.add_argument("--spec-decode", type=int, default=0, metavar="K",
                    help="paged engines: self-speculative decoding — "
                         "draft up to K tokens per step by prompt lookup "
                         "and verify them in one batched forward")
    ap.add_argument("--warmup-steps", type=int, default=40,
                    help="brief LM warm-up so outputs aren't noise "
                         "(0 = random weights)")
    ap.add_argument("--metrics-json", metavar="PATH", default=None,
                    help="paged engines: write the metrics registry "
                         "snapshot (JSON) on exit")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="paged engines: record per-request trace "
                         "spans and write them as JSONL on exit")
    ap.add_argument("--stats-every", type=float, default=0.0,
                    metavar="SECS",
                    help="async engine: print a one-line metrics "
                         "summary every SECS seconds while serving")
    ap.add_argument("--http", action="store_true",
                    help="serve /v1/completions + /healthz + /metrics "
                         "over HTTP instead of the batch demo "
                         "(async engine)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="--http: bind address")
    ap.add_argument("--port", type=int, default=0,
                    help="--http: bind port (0 picks a free one)")
    ap.add_argument("--port-file", metavar="PATH", default=None,
                    help="--http: write the bound port here (scripts)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="--http: engine-worker subprocesses behind a "
                         "prefix-affinity router (0 = serve the "
                         "in-process engine)")
    ap.add_argument("--max-respawns", type=int, default=2,
                    help="--replicas: restarts the supervisor grants "
                         "each dead worker before it stays dead "
                         "(0 disables self-healing)")
    ap.add_argument("--max-inflight", type=int, default=None,
                    help="--http: admission cap — requests in flight "
                         "at the frontend; excess is shed with 429 + "
                         "Retry-After")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="--http: shed with 429 while the scheduler "
                         "queue is this deep (in-process engine only)")
    ap.add_argument("--breaker-threshold", type=int, default=3,
                    help="--replicas: consecutive worker failures that "
                         "open the router's circuit breaker")
    args = ap.parse_args(argv)
    if args.engine == "bucket" and (args.metrics_json or args.trace
                                    or args.stats_every):
        ap.error("--metrics-json/--trace/--stats-every report the paged "
                 "serving stack; use --engine continuous or async")
    if args.engine == "bucket" and (args.quant != "none"
                                    or args.kv_dtype != "fp32"):
        ap.error("--quant/--kv-dtype serve through the paged engines; "
                 "use --engine continuous or async")
    if args.engine == "bucket" and args.spec_decode:
        ap.error("--spec-decode serves through the paged engines; "
                 "use --engine continuous or async")
    if args.spec_decode < 0:
        ap.error("--spec-decode must be >= 0")
    if args.warmup_steps < 0:
        ap.error("--warmup-steps must be >= 0")
    if args.replicas and not args.http:
        ap.error("--replicas needs --http")
    if args.max_respawns < 0:
        ap.error("--max-respawns must be >= 0")
    if args.http:
        if args.engine != "async":
            ap.error("--http serves through the async engine; add "
                     "--engine async")
        if args.interactive:
            ap.error("--http and --interactive are exclusive")
        if args.replicas:
            return _serve_replicated(args)

    import time

    import torch

    from ..configs import list_archs
    from ..data.pipeline import stub_frames, stub_image_embeds
    from ..data.tokenizer import ByteTokenizer
    from ..quant import QuantPolicy
    from ..serving import (AsyncEngine, ContinuousServingEngine, Request,
                           ServingEngine, throughput_report)
    from ..serving.runner import resolve_device
    from ..serving.sampler import SamplingParams
    from ..serving.worker import build_served

    if args.arch != "tiny" and args.arch not in list_archs():
        ap.error(f"unknown arch; choose 'tiny' or one of {list_archs()}")
    device = resolve_device(args.device)
    try:
        # registry archs serve at an MoE capacity factor of 4.0, as the
        # reference CLI sets (its workers keep the config's 1.25)
        model, params = build_served(args.arch, device,
                                     params_path=args.params,
                                     capacity_factor=4.0)
    except ValueError as e:
        ap.error(f"--params {args.params} does not fit arch {args.arch} "
                 f"({e})")
    cfg = model.cfg
    tok = ByteTokenizer()
    print(f"arch={cfg.name} (reduced, {cfg.param_count() / 1e6:.1f}M) "
          f"on {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
          + (f", weights from {args.params}" if args.params else ""))
    if args.warmup_steps:
        print(f"warm-up training ({args.warmup_steps} steps) ...")
        params, _ = warm_up(model, params, args.warmup_steps)

    prompts = args.prompt or ["the scheduler binds", "a numa node",
                              "the kv cache streams", "one thread gathers"]
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        max_new_tokens=args.max_new)
    # the model names the input its cross-attention reads (if any); every
    # request carries that input's seed-0 stub, as the reference CLI does
    stubs = {"frames": lambda: stub_frames(1, cfg.n_audio_frames,
                                           cfg.d_model)[0],
             "image_embeds": lambda: stub_image_embeds(
                 1, cfg.n_image_tokens, cfg.d_model)[0]}
    key = model.memory_input
    reqs = [Request(uid=i, prompt=tok.encode(p), sampling=sp,
                    extra={key: stubs[key]()} if key else {})
            for i, p in enumerate(prompts)]
    max_len = max(len(r.prompt) for r in reqs) + args.max_new + 8
    tracer = None
    if args.trace:
        from ..obs import RequestTracer
        tracer = RequestTracer()
    #: metrics the periodic --stats-every line summarises
    stat_names = ("serving.steps", "scheduler.running",
                  "scheduler.queue_depth", "scheduler.preemptions",
                  "serving.tokens.decode", "kv_pool.pages_free")
    quant = None
    if args.quant != "none" or args.kv_dtype != "fp32":
        quant = QuantPolicy(weights=args.quant, kv_dtype=args.kv_dtype)
        print(f"quant: weights={quant.weights} kv_dtype={quant.kv_dtype}")
    paged_kw = dict(max_running=args.max_running, page_size=args.page_size,
                    n_pages=args.n_pages, prefill_chunk=args.prefill_chunk,
                    prefix_cache=not args.no_prefix_cache, quant=quant,
                    spec_decode=args.spec_decode, tracer=tracer,
                    device=device)
    if args.engine == "async":
        eng = AsyncEngine(
            model, params,
            max_len=max(max_len, 256 + args.max_new)
            if (args.interactive or args.http) else max_len, **paged_kw)
        if args.http:        # --replicas 0: in-process engine over HTTP
            from ..serving.http import HttpFrontend
            fe = HttpFrontend(eng, tokenizer=tok, host=args.host,
                              port=args.port,
                              max_inflight=args.max_inflight,
                              max_queue_depth=args.max_queue_depth
                              ).start()
            return _serve_http(fe, port_file=args.port_file)
        if args.interactive:
            print("interactive async demo — one prompt per line, "
                  "empty line or EOF quits")
            while True:
                try:
                    line = input("> ")
                except EOFError:
                    break
                if not line.strip():
                    break
                handle = eng.submit(Request(uid=0,
                                            prompt=tok.encode(line),
                                            sampling=sp))
                stream_interactive(
                    eng, handle,
                    lambda s: print(s, end="", flush=True),
                    decode=lambda t: tok.decode([t]), timeout=300)
            eng.shutdown()
            return 0
        t_submit = []
        handles = []
        for r in reqs:          # live submission: all clients at once
            t_submit.append(time.perf_counter())
            handles.append(eng.submit(r))
        if args.stats_every:
            next_stat = time.perf_counter() + args.stats_every
            while not all(h.done for h in handles):
                time.sleep(min(0.05, args.stats_every))
                if time.perf_counter() >= next_stat:
                    print("stats:", eng.registry.stats_line(stat_names))
                    next_stat += args.stats_every
        comps = [eng.result(h, timeout=600) for h in handles]
        st = eng.core.pool.stats
        print(f"kv pool: {st['fresh_pages']} pages allocated, "
              f"{st['shared_pages']} shared, {st['cow_copies']} CoW, "
              f"{st['cached_tokens']} prompt tokens from cache, "
              f"{st['retention_hits']} retention hits")
        ttft = sorted(c.t_first - ts for c, ts in zip(comps, t_submit))
        print(f"ttft: p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms, "
              f"max {ttft[-1] * 1e3:.1f} ms")
        # TTFT decomposition: queue-wait (submit -> first slot) +
        # prefill (slot -> first token) — Completion.t_sched
        qw = sorted(c.t_sched - c.t0 for c in comps)
        print(f"queue-wait: p50 {qw[len(qw) // 2] * 1e3:.1f} ms, "
              f"max {qw[-1] * 1e3:.1f} ms")
        eng.shutdown()
    elif args.engine == "continuous":
        eng = ContinuousServingEngine(model, params, max_len=max_len,
                                      **paged_kw)
        comps = eng.generate(reqs)
        st = eng.pool.stats
        print(f"kv pool: {st['fresh_pages']} pages allocated, "
              f"{st['shared_pages']} shared, {st['cow_copies']} CoW, "
              f"{st['cached_tokens']} prompt tokens served from cache")
    else:
        eng = ServingEngine(model, params, max_len=max_len, device=device)
        comps = eng.generate(reqs, max_batch=args.max_batch)
    for c, p in zip(comps, prompts):
        print(f"[{c.uid}] {p!r} -> {tok.decode(c.tokens)!r}")
    # async completions carry t0/t1 stamps; the sync engines report
    # their own phase times
    phase = getattr(eng, "last_phase_s", None) or {}
    rep = throughput_report(comps, **phase)
    print("throughput:", {k: round(v, 2) if isinstance(v, float) else v
                          for k, v in rep.items()})
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            f.write(eng.registry.snapshot_json())
        print(f"metrics snapshot -> {args.metrics_json}")
    if tracer is not None:
        n = tracer.write_jsonl(args.trace)
        print(f"trace: {n} events -> {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
