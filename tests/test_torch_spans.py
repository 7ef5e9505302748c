"""The port's spans (``repro_torch.obs.spans``) and the serving step's
instruments, on the CPU at a tiny size.

* A span's instrument sums and counts exactly on a ``VirtualClock``;
  under ``NullRegistry`` it reads no clock and writes nothing; a pass
  that raises writes nothing.
* Without a profiler no range is entered, on any thread; under a CPU
  ``torch.profiler`` one step of a dense and of an MoE engine shows the
  named ranges, nested as the layers are: ``runner.decode`` inside
  ``core.decode``, the model's ranges inside the runner's, ``moe.*``
  inside ``model.ffn``, and no program range around a phase span;
  ``spec_decode=2`` shows ``runner.verify``; the async stepper shows
  ``async.intake`` and ``async.publish``.
* The instruments the benchmark reads keep their names and counts, and
  the continuous driver serves without the removed gap list.
"""

import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.obs.spans as span_mod
from repro_torch.models import ModelConfig, build_model
from repro_torch.obs import MetricsRegistry, NullRegistry, Span
from repro_torch.serving import (AsyncEngine, ContinuousServingEngine,
                                 EngineCore, Request, SamplingParams,
                                 VirtualClock)

P = span_mod.PREFIX
PHASES = {P + n for n in ("core.schedule", "core.copies", "core.finish",
                          "core.prefill", "core.decode")}
DENSE = dict(name="tiny", arch_type="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=97,
             dtype=torch.float32)
MOE = dict(DENSE, name="tiny-moe", arch_type="moe", n_experts=4,
           experts_per_token=2, capacity_factor=2.0)
PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [8, 9, 10], [11, 12, 13, 14, 15]]
#: repetitive prompts, so prompt lookup drafts
REP = [[7, 8, 9, 7, 8, 9, 7, 8], [3, 4, 3, 4, 3, 4, 3, 4, 3]]


@pytest.fixture(scope="module")
def models():
    out = {}
    for cfg in (DENSE, MOE):
        m = build_model(ModelConfig(**cfg))
        gen = torch.Generator().manual_seed(0)
        out[cfg["name"]] = (m, m.init(gen))
    return out


def reqs(prompts=PROMPTS, max_new=4):
    return [Request(uid=i, prompt=p,
                    sampling=SamplingParams(max_new_tokens=max_new))
            for i, p in enumerate(prompts)]


def core_for(models, name, **kw):
    model, params = models[name]
    kw.setdefault("clock", VirtualClock())
    return EngineCore(model, params, max_len=48, max_running=4,
                      page_size=4, prefill_chunk=8, device="cpu", **kw)


def program_ranges(prof):
    """(name, start, end, thread) of every program range in a trace."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(P)]


def profiled_steps(core, prompts=PROMPTS, max_new=4):
    """Submit ``prompts`` and step the core to the end under a CPU
    profiler; returns the program ranges."""
    for r in reqs(prompts, max_new):
        core.submit(r)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        while core.has_work():
            core.step()
    return program_ranges(prof)


def inside(inner, outer):
    return (inner[3] == outer[3] and outer[1] <= inner[1]
            and inner[2] <= outer[2] and inner != outer)


def enclosing(r, ranges, name):
    return [o for o in ranges if o[0] == P + name and inside(r, o)]


# ----------------------------------------------------------------------
# the span itself
# ----------------------------------------------------------------------
def test_span_sums_and_counts_exactly_on_a_virtual_clock():
    reg, clock = MetricsRegistry(), VirtualClock()
    hist = reg.histogram("t.ms")
    ctr = reg.counter("t.s")
    s_ms = Span("t.ms", ms=hist.labels(), now=clock.now)
    s_s = Span("t.s", seconds=ctr.labels(), now=clock.now)
    for dt in (0.25, 0.5, 0.125):
        with s_ms, s_s:
            clock.advance(dt)
    assert hist.value() == (875.0, 3)       # exact sum (ms) and count
    assert ctr.value() == 0.875             # exact sum (s)
    with pytest.raises(ValueError):
        Span("both", ms=hist.labels(), seconds=ctr.labels())


def test_span_under_null_registry_reads_no_clock_and_writes_nothing():
    reg = NullRegistry()
    reads = []

    def now():
        reads.append(1)
        return 0.0

    s = Span("null", ms=reg.histogram("n.ms").labels(), now=now)
    for _ in range(3):
        with s:
            pass
    assert reads == []
    assert reg.snapshot()["histograms"] == []


def test_a_pass_that_raises_writes_nothing():
    reg, clock = MetricsRegistry(), VirtualClock()
    hist = reg.histogram("r.ms")
    s = Span("r", ms=hist.labels(), now=clock.now)
    with pytest.raises(RuntimeError):
        with s:
            clock.advance(1.0)
            raise RuntimeError("boom")
    with s:
        clock.advance(0.5)
    assert hist.value() == (500.0, 1)


def test_traced_calls_through_and_opens_its_range_only_under_a_profiler():
    @span_mod.traced("t.fn")
    def add(a, *, b):
        """adds"""
        return a + b

    assert (add.__name__, add.__doc__) == ("add", "adds")
    assert add(1, b=2) == 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert add(2, b=3) == 5
    assert [r[0] for r in program_ranges(prof)] == [P + "t.fn"]


def test_no_range_is_entered_without_a_profiler(models, monkeypatch):
    entered = []
    real = span_mod._Range

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(span_mod, "_Range", counting)
    core = core_for(models, "tiny-moe")
    for r in reqs():
        core.submit(r)
    while core.has_work():
        core.step()
    assert entered == []
    # a profiler on another thread opens no range on this one
    started, release = threading.Event(), threading.Event()

    def other():
        with profile(activities=[ProfilerActivity.CPU]):
            started.set()
            release.wait(30)

    t = threading.Thread(target=other)
    t.start()
    try:
        assert started.wait(30)
        core.submit(reqs()[0])
        while core.has_work():
            core.step()
    finally:
        release.set()
        t.join(30)
    assert not t.is_alive()
    assert entered == []
    # and one on this thread does
    profiled_steps(core)
    assert {P + "core.decode", P + "model.attn", P + "moe.route"} <= \
        set(entered)


# ----------------------------------------------------------------------
# the serving step's ranges
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_profiled_step_shows_the_named_ranges(models, name):
    names = {r[0] for r in profiled_steps(core_for(models, name))}
    want = PHASES | {P + n for n in (
        "core.sample", "runner.prefill", "runner.decode", "model.embed",
        "model.attn", "model.ffn", "model.logits")}
    if name == "tiny-moe":
        want |= {P + "moe." + n
                 for n in ("route", "dispatch", "experts", "combine")}
    assert want <= names
    assert not any(n.startswith(P + "moe.") for n in names) \
        or name == "tiny-moe"


def test_ranges_nest_as_the_layers_do(models):
    ranges = profiled_steps(core_for(models, "tiny-moe"))
    by = {}
    for r in ranges:
        by.setdefault(r[0][len(P):], []).append(r)
    for r in by["runner.decode"]:
        assert enclosing(r, ranges, "core.decode")
    for r in by["runner.prefill"]:
        assert enclosing(r, ranges, "core.prefill")
    for r in by["core.sample"]:
        assert enclosing(r, ranges, "core.decode")
    for n in ("model.embed", "model.attn", "model.ffn", "model.logits"):
        for r in by[n]:
            assert (enclosing(r, ranges, "runner.decode")
                    or enclosing(r, ranges, "runner.prefill")), n
    for n in ("route", "dispatch", "experts", "combine"):
        for r in by["moe." + n]:
            assert enclosing(r, ranges, "model.ffn")
    # the phase spans are the outermost program ranges of the step
    for r in ranges:
        if r[0] in PHASES:
            assert not [o for o in ranges if inside(r, o)], r
    # a decode call holds every layer's attention and FFN
    r = by["runner.decode"][0]
    inner = [o[0] for o in ranges if inside(o, r)]
    assert inner.count(P + "model.attn") == DENSE["n_layers"]
    assert inner.count(P + "model.ffn") == DENSE["n_layers"]


def test_spec_decode_shows_runner_verify(models):
    core = core_for(models, "tiny", spec_decode=2)
    ranges = profiled_steps(core, prompts=REP, max_new=8)
    verify = [r for r in ranges if r[0] == P + "runner.verify"]
    assert verify
    for r in verify:
        assert enclosing(r, ranges, "core.decode")
        assert any(o[0] == P + "model.attn" and inside(o, r)
                   for o in ranges)
    assert core.registry.get("spec.drafted").value() > 0


def test_async_stepper_shows_intake_and_publish(models):
    """The profiler runs on the stepper thread (the thread whose ranges
    it records), from the second engine step to the fifth."""
    model, params = models["tiny"]
    eng = AsyncEngine(model, params, max_len=48, max_running=4,
                      page_size=4, device="cpu")
    core, step = eng.core, eng.core.step
    prof = profile(activities=[ProfilerActivity.CPU])
    calls = []

    def traced_step(now):
        calls.append(now)
        if len(calls) == 2:
            prof.start()
        elif len(calls) == 5:
            prof.stop()
        return step(now=now)

    core.step = traced_step
    try:
        hs = [eng.submit(r) for r in reqs(max_new=6)]
        for h in hs:
            eng.result(h, timeout=60)
    finally:
        eng.shutdown()
    assert len(calls) >= 5
    names = {r[0] for r in program_ranges(prof)}
    assert {P + "async.intake", P + "async.publish",
            P + "core.decode"} <= names


# ----------------------------------------------------------------------
# the instruments
# ----------------------------------------------------------------------
def test_benchmark_read_instruments_keep_names_and_counts(models):
    model, params = models["tiny-moe"]
    reg = MetricsRegistry()
    eng = ContinuousServingEngine(model, params, max_len=48, max_running=4,
                                  page_size=4, prefill_chunk=8,
                                  clock=VirtualClock(), registry=reg,
                                  device="cpu")
    eng.generate(reqs(max_new=5), arrivals=[0.0, 0.0, 0.01])
    snap = reg.snapshot()
    hist = {(e["name"], tuple(sorted(e["labels"].items()))): e
            for e in snap["histograms"]}
    ctrs = {e["name"]: e["value"] for e in snap["counters"]}
    gauges = {e["name"] for e in snap["gauges"]}
    occ = hist[("serving.batch.occupancy", ())]
    disp = hist[("runner.decode.dispatch_ms", (("shards", "1"),))]
    sample = hist[("serving.decode.sample_ms", ())]
    sched = hist[("serving.step.schedule_ms", ())]
    assert occ["count"] > 0
    # one decode dispatch, one sampling and one occupancy reading per
    # decoding step; one schedule per engine step
    assert disp["count"] == sample["count"] == occ["count"]
    assert sched["count"] == ctrs["serving.steps"]
    assert "serving.phase.decode_s" in ctrs
    assert "serving.phase.prefill_s" in ctrs
    assert {"kv_pool.pages_free", "kv_pool.pages_retained",
            "kv_pool.pages_total", "kv_pool.page_bytes"} <= gauges
    names = {e["name"] for e in snap["histograms"]}
    assert "serving.prefill.chunk_ms" not in names
    assert ("runner.prefill.dispatch_ms", (("shards", "1"),)) in hist


def test_continuous_generate_serves_without_decode_gaps(models):
    model, params = models["tiny"]
    eng = ContinuousServingEngine(model, params, max_len=48, max_running=4,
                                  page_size=4, clock=VirtualClock(),
                                  device="cpu")
    done = eng.generate(reqs(max_new=4))
    assert [len(c.tokens) for c in done] == [4, 4, 4]
    assert not hasattr(eng, "decode_gaps_s")
    assert not hasattr(eng.core, "decode_gaps_s")
    assert eng.last_phase_s["decode_s"] >= 0.0
