"""Single-step engine core of the serving stack (``EngineCore``).

Counterpart of ``repro.serving.core`` on PyTorch: the same scheduler,
KV-pool and sequence bookkeeping (host code, copied), over the port's
:class:`~repro_torch.serving.runner.ModelRunner`.  Sampling draws from
a ``torch.Generator`` seeded from ``seed`` on the runner's device.
Quantized serving (``quant=``, ``repro_torch.quant.QuantPolicy``) sizes
the pool's pages by the policy's ``kv_dtype`` and hands the rest to the
runner.  Speculative decoding (``spec_decode=k``) drafts up to k tokens
per greedy lane by prompt lookup and verifies them in one batched
forward (``ModelRunner.verify``).

Tensor-parallel serving (``mesh=``, a ``repro_torch.launch.mesh.Mesh``
whose ``"model"`` axis has S ranks): every rank builds the same core and
steps it on the same inputs, the runner running its share of the heads
(rank ≅ NUMA node, as in the reference's mesh mode: the pool's pages
stripe over ``n_nodes`` and split their bytes over S head slices).  What
could differ between ranks is made to agree by construction: the
drivers take rank 0's clock reading for each step (:meth:`shared`), and
every rank's sampler is seeded alike.

Middle of the three-layer split (runner / core / async): one
:meth:`EngineCore.step` call is exactly one iteration of the old
monolithic continuous loop — scheduler step, queued copy-on-write page
copies, prefill chunks, one batched decode, sampling, prefix
registration and finish bookkeeping — with **no loop, no sleeping and
no thread** of its own.  Anyone can drive it:

* the synchronous driver (``ContinuousServingEngine.generate``) loops
  it over a pre-declared arrivals list and must produce byte-identical
  greedy tokens to the pre-split engine;
* the :class:`~repro_torch.serving.async_engine.AsyncEngine` stepper
  thread loops it against a live, lock-guarded inbox;
* tests call it step-by-step and assert on the returned
  :class:`StepResult` without any timing races.

Time is **injected** (:class:`Clock`): the core never calls
``time.perf_counter`` or ``time.sleep`` directly, so a
:class:`VirtualClock` lets arrival-staggered tests run without a
single real sleep (idle waits advance virtual time for free) while the
default :class:`MonotonicClock` gives production wall-clock stamps.

Spans (``repro_torch.obs.spans``): a step's phases, ``core.schedule``,
``core.copies``, ``core.finish``, ``core.prefill`` (one chunk) and
``core.decode`` (``core.sample`` inside it), are its outermost profiler
ranges while a profiler records, and no range wraps the whole step.  The
timed ones write, on the injected clock, ``serving.step.schedule_ms``,
``serving.phase.prefill_s``, ``serving.phase.decode_s`` and
``serving.decode.sample_ms``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.tp import broadcast_object
from ..models.transformer import Model
from ..obs.metrics import MetricsRegistry, NullRegistry
from ..obs.spans import Span
from ..obs.trace import NullTracer, RequestTracer
from ..quant.policy import QuantPolicy
from . import faults
from .engine import Completion, Request
from .kv_pool import KVCachePool, KVPoolConfig
from .runner import ModelRunner, _pad_bucket
from .sampler import sample, sample_grouped
from .scheduler import ContinuousScheduler, Sequence
from .spec import lookahead_for, note_accept, propose


class Clock:
    """Injected time source.  ``now()`` is monotonic seconds;
    ``sleep(dt)`` blocks (or virtually advances) for ``dt`` seconds."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, dt: float) -> None:
        raise NotImplementedError


class MonotonicClock(Clock):
    """Real wall time (``time.perf_counter`` / ``time.sleep``)."""

    def now(self) -> float:
        return time.perf_counter()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)


class VirtualClock(Clock):
    """Deterministic test clock: ``sleep`` advances ``now()`` without
    any wall time passing, so idle engine steps are free and
    arrival-staggered workloads run as fast as the device allows."""

    def __init__(self, start: float = 0.0) -> None:
        self.t = start
        self.slept_s = 0.0

    def now(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        if dt > 0:
            self.t += dt
            self.slept_s += dt

    def advance(self, dt: float) -> None:
        self.t += dt


@dataclasses.dataclass
class StepResult:
    """What one :meth:`EngineCore.step` did.

    ``emitted`` is every (uid, token) sampled this step in emission
    order — the async layer's incremental delivery feed.  ``finished``
    carries completed requests (tokens + timing stamps).  ``idle``
    means no forward pass ran: the driver may park until the next
    arrival/submission.
    """

    finished: List[Completion] = dataclasses.field(default_factory=list)
    emitted: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    #: uids shed this step because their deadline passed (queued or
    #: running) — pages/slots already drained; the async layer fails
    #: the handles with a deadline-exceeded cause
    expired: List[int] = dataclasses.field(default_factory=list)
    n_prefills: int = 0
    n_decodes: int = 0

    @property
    def idle(self) -> bool:
        return self.n_prefills == 0 and self.n_decodes == 0


class EngineCore:
    """Scheduler + runner + sequence bookkeeping, one step at a time."""

    def __init__(self, model: Model, params, *, max_len: int = 1024,
                 max_running: int = 8, page_size: int = 16,
                 n_pages: Optional[int] = None, n_nodes: int = 1,
                 numa: bool = True,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = True,
                 window_override: Optional[int] = None,
                 mesh=None, policy=None, quant=None,
                 spec_decode: int = 0,
                 seed: int = 0, clock: Optional[Clock] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[RequestTracer] = None,
                 device: str = "cuda") -> None:
        cfg = model.cfg
        if spec_decode < 0:
            raise ValueError("spec_decode must be >= 0")
        #: self-speculative decoding lookahead (``--spec-decode k``):
        #: each decode step drafts up to k tokens per greedy lane by
        #: prompt lookup (serving.spec) and verifies them in ONE
        #: batched forward — accepted drafts are decode steps the
        #: device never ran.  0 disables (plain one-token decode).
        self.spec_decode = int(spec_decode)
        if quant is None:
            quant = QuantPolicy()
        #: quantization policy (``repro_torch.quant.QuantPolicy``): the
        #: KV page format sizes the pool here; the runner applies the rest
        self.quant = quant
        self.model = model
        self.mesh = mesh
        self.max_len = max_len
        self.max_running = max_running
        self.page_size = page_size
        if n_pages is None:
            # page 0 scratch + a full pool: every slot can reach max_len.
            # Pass a smaller n_pages to trade memory for preemptions.
            n_pages = 1 + max_running * (-(-max_len // page_size))
        self.n_pages = n_pages
        self.clock = clock if clock is not None else MonotonicClock()
        #: metrics registry every layer below reports into (a private
        #: real registry by default — pass NullRegistry to disable);
        #: tracer defaults to the no-op twin (opt in via --trace)
        self.registry = (registry if registry is not None
                         else MetricsRegistry())
        self.tracer = tracer if tracer is not None else NullTracer()
        # mesh mode: each rank stands in for one NUMA node, so page
        # planning stripes rows across n_nodes AND splits every page's
        # bytes across the ranks' head slices (KVPoolConfig.n_shards)
        n_shards = (int(mesh.shape.get("model", 1))
                    if mesh is not None else 1)
        self.pool = KVCachePool(KVPoolConfig(
            n_pages=n_pages, page_size=page_size, n_layers=cfg.n_layers,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            dtype_bytes=cfg.dtype.itemsize, n_nodes=n_nodes,
            numa=numa, n_shards=n_shards, kv_dtype=quant.kv_dtype),
            prefix_cache=prefix_cache)
        self.pool.bind_registry(self.registry)
        self.scheduler = ContinuousScheduler(
            self.pool, max_running=max_running, max_len=max_len,
            prefill_chunk=prefill_chunk, spec_lookahead=self.spec_decode,
            registry=self.registry)
        self.runner = ModelRunner(
            model, params, max_running=max_running, max_len=max_len,
            page_size=page_size, n_pages=n_pages,
            window_override=window_override, mesh=mesh, policy=policy,
            quant=quant, registry=self.registry, clock=self.clock,
            device=device)
        self.params = self.runner.params          # on the runner's device
        #: sampling generator on the runner's device, seeded like the
        #: reference's ``PRNGKey(seed)`` (different bits, same role)
        self._gen = torch.Generator(device=self.runner.device)
        self._gen.manual_seed(seed)

        self._meta: Dict[int, Dict[str, object]] = {}  # uid -> timing stamps
        self._t_last_decode: Optional[float] = None

        # instruments resolved ONCE here — step() touches only bound
        # handles, never the registry (docs/observability.md budget)
        reg = self.registry
        self._m_phase_prefill = reg.counter(
            "serving.phase.prefill_s",
            "wall seconds spent running prefill chunks (run-scoped)")
        self._m_phase_decode = reg.counter(
            "serving.phase.decode_s",
            "wall seconds spent in batched decode (run-scoped)")
        self._c_prefill_s = self._m_phase_prefill.labels()
        self._c_decode_s = self._m_phase_decode.labels()
        self._m_itl = reg.histogram(
            "serving.decode.itl_ms",
            "inter-token latency: wall gap between consecutive decode "
            "steps (run-scoped)")
        self._h_itl = self._m_itl.labels()
        self._c_steps = reg.counter(
            "serving.steps", "engine steps, idle included").labels()
        self._c_tok_prefill = reg.counter(
            "serving.tokens.prefill", "prompt tokens prefilled").labels()
        self._c_tok_decode = reg.counter(
            "serving.tokens.decode",
            "tokens sampled by batched decode").labels()
        self._h_occupancy = reg.histogram(
            "serving.batch.occupancy",
            "decode-batch occupancy per decoding step",
            buckets=tuple(float(i) for i in range(1, max_running + 1)),
            ).labels()
        # speculative-decoding instruments, bound only when the feature
        # is on so k=0 snapshots stay free of dead spec.* series
        self._c_spec_drafted = self._c_spec_accepted = None
        self._c_spec_rollbacks = self._c_spec_pages = None
        self._c_spec_autooff = None
        self._h_spec_accept = None
        if self.spec_decode:
            self._c_spec_autooff = reg.counter(
                "spec.auto_disabled",
                "sequences whose speculation was turned off after the "
                "windowed accept rate collapsed (spec.note_accept)"
            ).labels()
            self._c_spec_drafted = reg.counter(
                "spec.drafted",
                "draft tokens proposed by the prompt-lookup drafter "
                "and fed to verify").labels()
            self._c_spec_accepted = reg.counter(
                "spec.accepted",
                "draft tokens accepted (each one a decode forward the "
                "device never ran)").labels()
            self._c_spec_rollbacks = reg.counter(
                "spec.rollbacks",
                "verify steps that rejected at least one draft token "
                "for a lane").labels()
            self._c_spec_pages = reg.counter(
                "spec.pages_returned",
                "speculative page grants returned to the pool after a "
                "rejected draft (KVCachePool.truncate_to)").labels()
            self._h_spec_accept = reg.histogram(
                "spec.accept_rate",
                "per-lane fraction of drafted tokens accepted each "
                "verify step",
                buckets=tuple(i / 8 for i in range(1, 9))).labels()
        # spans at the step's layer boundaries (obs.spans): the phase
        # spans are the outermost program ranges of a step, and each
        # timed one writes the one instrument that times its interval
        now = self.clock.now
        self._span_schedule = Span(
            "core.schedule", now=now, ms=reg.histogram(
                "serving.step.schedule_ms",
                "scheduler step plus the expired and preempted handling, "
                "per engine step").labels())
        self._span_copies = Span("core.copies")
        self._span_finish = Span("core.finish")
        self._span_prefill = Span("core.prefill", now=now,
                                  seconds=self._c_prefill_s)
        self._span_decode = Span("core.decode", now=now,
                                 seconds=self._c_decode_s)
        self._span_sample = Span(
            "core.sample", now=now, ms=reg.histogram(
                "serving.decode.sample_ms",
                "sampling after a decode or verify forward, the "
                "device-to-host copy that waits for the step's device "
                "work included").labels())
        # per-(node, shard) pool gauges, sampled after every step; a
        # page's bytes are split across every shard's head-slice pool,
        # so each shard sees the same per-node free count.  Skipped
        # entirely under NullRegistry (no per-step dict build).
        self._pool_gauges: List[Tuple[object, int]] = []
        self._g_retained = None
        if not isinstance(reg, NullRegistry):
            g_free = reg.gauge(
                "kv_pool.pages_free",
                "allocatable pages on this NUMA node as seen by this "
                "TP shard's head-slice pool")
            for node in range(max(self.pool.mm.kv_node_count, 1)):
                for shard in range(n_shards):
                    self._pool_gauges.append(
                        (g_free.labels(node=node, shard=shard), node))
            self._g_retained = reg.gauge(
                "kv_pool.pages_retained",
                "refcount-0 prefix pages parked in the retention LRU",
                ).labels()
            # static capacity facts, set once: together they let a
            # dashboard derive pages-per-byte-budget, the quantity the
            # int8 KV format (--kv-dtype int8) roughly doubles
            reg.gauge(
                "kv_pool.page_bytes",
                "device bytes per KV page across all layers/heads under "
                "the configured kv_dtype").labels(
                    kv_dtype=quant.kv_dtype).set(
                        float(self.pool.cfg.page_bytes))
            reg.gauge(
                "kv_pool.pages_total",
                "total pages in the pool, scratch page 0 included",
                ).labels().set(float(n_pages))

    # ------------------------------------------------------------------
    def _next_key(self) -> torch.Generator:
        """The sampling generator (the reference splits a new key per
        call; one generator advancing per draw plays that role)."""
        return self._gen

    def check_request(self, request: Request) -> None:
        """Reject a request the engine can never serve.  Both limits
        are caught HERE, at submit, so an impossible request fails its
        own handle instead of raising inside the scheduler mid-step
        (which would kill the async stepper for everyone)."""
        if len(request.prompt) >= self.max_len:
            raise ValueError(
                f"request {request.uid}: prompt of {len(request.prompt)} "
                f"tokens does not fit max_len={self.max_len} (needs at "
                "least one decode slot)")
        need = self.pool.cfg.pages_for(len(request.prompt) + 1)
        if need > self.pool.cfg.max_pages_per_seq:
            raise ValueError(
                f"request {request.uid}: prompt needs {need} pages; "
                f"pool only has {self.pool.cfg.max_pages_per_seq}")

    @property
    def phase_s(self) -> Dict[str, float]:
        """Thin parity view over the registry-backed phase counters
        (pre-PR6 callers read ``core.phase_s[...]``).  Zeros under a
        ``NullRegistry``."""
        return {"prefill_s": self._m_phase_prefill.value(),
                "decode_s": self._m_phase_decode.value()}

    def reset_run_stats(self) -> None:
        """Zero the per-run accumulators (phase counters, ITL histogram)
        so back-to-back driver runs report cleanly.  Cumulative series
        (scheduler, pool, dispatch, spans) keep counting."""
        self._t_last_decode = None
        self._m_phase_prefill.reset()
        self._m_phase_decode.reset()
        self._m_itl.reset()

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def shared(self, value):
        """Rank 0's ``value`` on every rank of the mesh (``value`` itself
        without one): a driver passes each step's inputs through it, so
        the ranks' host engines take the same decisions."""
        if self.mesh is None or self.mesh.size == 1:
            return value
        return broadcast_object(value, self.mesh)

    # ------------------------------------------------------------------
    def submit(self, request: Request, *, arrival: float = 0.0,
               t0: Optional[float] = None) -> Sequence:
        """Queue a request with the scheduler.  ``arrival`` is on the
        driver's scheduling timeline (the ``now`` passed to ``step``);
        ``t0`` is the absolute clock stamp latency is measured from
        (defaults to the current clock)."""
        self.check_request(request)
        seq = self.scheduler.submit(request, arrival=arrival)
        t0_abs = t0 if t0 is not None else self.clock.now()
        self._meta[seq.uid] = {"t0": t0_abs, "arrival": arrival}
        self.tracer.event(seq.uid, "QUEUED", t0_abs,
                          prompt_len=len(request.prompt))
        return seq

    def cancel(self, seq: Sequence, *,
               trace_event: Optional[str] = "CANCELLED") -> bool:
        """Tear a sequence down wherever it lives (queued, prefilling
        or decoding): slot and every page reference free immediately.
        Returns False when it already left the scheduler.
        ``trace_event`` names the terminal trace event to emit (the
        async layer passes None when it records FAILED itself)."""
        out = self.scheduler.cancel(seq)
        if out and trace_event is not None:
            self.tracer.event(seq.uid, trace_event, self.clock.now())
        self._meta.pop(seq.uid, None)
        return out

    # ------------------------------------------------------------------
    def _sync_tables(self) -> None:
        """Host block tables -> device cache array."""
        bt = np.zeros((self.max_running, self.runner.max_pages), np.int32)
        for slot, seq in self.scheduler.running.items():
            pages = self.pool.block_table(seq.uid)
            bt[slot, :len(pages)] = pages
        self.runner.set_block_tables(bt)

    def _apply_copies(self) -> None:
        """Apply the pool's queued copy-on-write page copies to the
        device cache.  Must run after scheduling and before this step's
        forwards, so a resumed prefill or decode reads the cloned rows,
        not scratch."""
        copies = self.pool.drain_copies()
        if not copies:
            return
        if self.tracer.enabled:
            # attribute cloned destination pages back to owning uids
            # (only walks block tables on the rare CoW step)
            t = self.clock.now()
            dsts = {d for _, d in copies}
            for seq in self.scheduler.running.values():
                n = sum(1 for p in self.pool.block_table(seq.uid)
                        if p in dsts)
                if n:
                    self.tracer.event(seq.uid, "COW", t, pages=n)
        src, dst = self.pool.copy_row_plan(
            copies, pad_to_pages=_pad_bucket(len(copies), lo=1))
        self.runner.apply_copy_rows(src, dst)

    def _finish(self, seq: Sequence) -> Completion:
        m = self._meta.pop(seq.uid)
        # t_first_sched lives on the driver's scheduling timeline (the
        # ``now`` fed to step); both drivers submit with
        # t0 = clock0 + arrival, so clock0 = t0 - arrival converts it
        # to the absolute clock the other stamps use
        if seq.t_first_sched >= 0:
            t_sched = m["t0"] - m.get("arrival", 0.0) + seq.t_first_sched
        else:
            t_sched = m["t0"]
        self.tracer.event(seq.uid, "FINISHED", m["t1"],
                          n_tokens=len(seq.generated),
                          n_preempts=seq.n_preempts)
        return Completion(
            uid=seq.uid, prompt_len=len(seq.request.prompt),
            tokens=list(seq.generated), latency_s=m["t1"] - m["t0"],
            prefill_s=m.get("prefill", 0.0), t0=m["t0"], t1=m["t1"],
            t_first=m.get("t_first", m["t1"]), t_sched=t_sched)

    # ------------------------------------------------------------------
    def step(self, now: float = 0.0) -> StepResult:
        """One engine step: schedule, apply CoW copies, run prefill
        chunks, run the batched decode, sample, finish.  ``now`` gates
        admission of waiting arrivals (driver-relative seconds)."""
        clock = self.clock
        tracer = self.tracer
        if faults.ACTIVE:       # injected worker latency (chaos tests)
            faults.maybe_sleep("step.latency_ms")
        self._c_steps.inc()
        with self._span_schedule:
            plan = self.scheduler.step(now)
            for seq in plan.expired:
                # scheduler already drained slot + pages; surface the
                # death through the normal terminal vocabulary so trace
                # validation holds, and let the async layer fail the
                # handle
                tracer.event(seq.uid, "FAILED", clock.now(),
                             error="deadline exceeded",
                             n_tokens=len(seq.generated))
                self._meta.pop(seq.uid, None)
            for seq in plan.preempted:
                tracer.event(seq.uid, "PREEMPTED", clock.now(),
                             n_preempts=seq.n_preempts)
                m = self._meta.get(seq.uid)
                if m is not None:   # next admission re-opens PREFILLING
                    m.pop("state", None)
        with self._span_copies:
            self._apply_copies()
        res = StepResult(expired=[s.uid for s in plan.expired],
                         n_prefills=len(plan.prefills),
                         n_decodes=len(plan.decodes))
        with self._span_finish:
            for seq in plan.finished:
                res.finished.append(self._finish(seq))

        if plan.prefills:
            self._sync_tables()
        for seq in plan.prefills:
            with self._span_prefill:
                self._prefill_chunk(seq, res)

        if plan.decodes:
            with self._span_decode:
                n_emitted = self._decode(plan, res)
                t1 = clock.now()
            if self._t_last_decode is not None:
                self._h_itl.observe((t1 - self._t_last_decode) * 1e3)
            self._t_last_decode = t1
            self._c_tok_decode.inc(n_emitted)
            self._h_occupancy.observe(float(len(plan.decodes)))

        with self._span_finish:
            if self._pool_gauges:
                free = self.pool.free_pages_by_node()
                for g, node in self._pool_gauges:
                    g.set(free.get(node, 0))
                self._g_retained.set(self.pool.n_retained())

        return res

    def _prefill_chunk(self, seq: Sequence, res: StepResult) -> None:
        """Run ``seq``'s next prefill chunk; sample its first token after
        the final one."""
        clock, tracer = self.clock, self.tracer
        t0 = clock.now()
        prompt = seq.full_prompt
        start = seq.n_prefilled
        n = self.scheduler.chunk_for(seq)
        fresh = start == 0 and n == seq.prefill_target
        m = self._meta[seq.uid]
        if m.get("state") != "PREFILLING":  # (re-)entered prefill
            m["state"] = "PREFILLING"
            tracer.event(seq.uid, "PREFILLING", t0, start=start,
                         cached=seq.n_cached_tokens)
        tracer.event(seq.uid, "PREFILL_CHUNK", t0, start=start, n=n)
        logits = self.runner.prefill_chunk(
            prompt[start:start + n], slot=seq.slot, start=start,
            fresh=fresh)
        seq.n_prefilled += n
        if not seq.is_prefilling:           # final chunk: sample
            tok = int(sample(logits, seq.request.sampling,
                             self._next_key())[0, 0])
            seq.generated.append(tok)
            res.emitted.append((seq.uid, tok))
            # prompt KV is resident now — index it for reuse
            self.pool.register_prefix(seq.uid, prompt)
            m.setdefault("t_first", clock.now())
            m["state"] = "DECODING"
            tracer.event(seq.uid, "DECODING", clock.now())
        self._c_tok_prefill.inc(n)
        m["prefill"] = m.get("prefill", 0.0) + clock.now() - t0
        if not seq.is_prefilling and seq.is_done(self.max_len):
            m["t1"] = clock.now()

    def _decode(self, plan, res: StepResult) -> int:
        """The step's batched decode (a verify where a lane drafts) and
        its sampling; returns the emitted-token count."""
        self._sync_tables()
        # draft by prompt lookup (greedy lanes only); a step where no
        # lane drafts falls through to plain one-token decode so
        # non-repetitive traffic never pays the (k+1)-wide forward
        drafts: Dict[int, List[int]] = {}
        if self.spec_decode:
            for seq in plan.decodes:
                k_eff = lookahead_for(seq, self.spec_decode, self.max_len)
                if k_eff > 0:
                    d = propose(seq.full_prompt, k_eff)
                    if d:
                        drafts[seq.slot] = d
        if drafts:
            return self._decode_verify(plan, drafts, res)
        pos = np.full((self.max_running,), -1, np.int32)
        fed = np.zeros((self.max_running, 1), np.int32)
        # idle lanes borrow a real lane's params so grouping never
        # depends on dead slots
        sps = [plan.decodes[0].request.sampling] * self.max_running
        for seq in plan.decodes:
            pos[seq.slot] = seq.next_pos - 1      # fed-token position
            fed[seq.slot, 0] = seq.generated[-1]
            sps[seq.slot] = seq.request.sampling
        logits = self.runner.decode(fed, pos)
        with self._span_sample:
            toks = sample_grouped(logits, sps, self._next_key())
        for seq in plan.decodes:
            tok = int(toks[seq.slot, 0])
            seq.generated.append(tok)
            res.emitted.append((seq.uid, tok))
            if seq.is_done(self.max_len):
                self._meta[seq.uid]["t1"] = self.clock.now()
        return len(plan.decodes)

    def _decode_verify(self, plan, drafts: Dict[int, List[int]],
                       res: StepResult) -> int:
        """Speculative decode step: feed every decoding lane its last
        token plus its draft (lanes without one ride along as plain
        decode), verify all positions in one forward, accept each
        lane's longest matching draft prefix plus the model's own token
        at the first mismatch (the "bonus" token).

        Greedy tokens equal k=0's: the verify step scores position j
        with exactly the context sequential decode would see
        (``Model.verify_step``), every emitted token is the model's own
        greedy argmax there, emission stops at ``is_done`` exactly like
        the one-token loop, and the step draws from the sampling
        generator exactly what plain decode draws (draft lanes are
        greedy, so sampling lanes see the identical random stream).
        Unlike the reference's, the bits of column j rest on the matmul
        library giving each row the same sums at M = B·S rows as at M =
        B: so on the CPU (tests/test_torch_spec.py), not on the card,
        where cuBLAS picks its kernel by M and the margin rule applies.
        Returns the emitted-token count.
        """
        clock = self.clock
        S = self.spec_decode + 1
        pos = np.full((self.max_running,), -1, np.int32)
        fed = np.zeros((self.max_running, S), np.int32)
        n_fed = np.ones((self.max_running,), np.int32)
        sps = [plan.decodes[0].request.sampling] * self.max_running
        for seq in plan.decodes:
            pos[seq.slot] = seq.next_pos - 1        # fed-token position
            fed[seq.slot, 0] = seq.generated[-1]
            ds = drafts.get(seq.slot)
            if ds:
                fed[seq.slot, 1:1 + len(ds)] = ds
                n_fed[seq.slot] = 1 + len(ds)
            sps[seq.slot] = seq.request.sampling
        logits = self.runner.verify(fed, pos, n_fed)
        with self._span_sample:
            # the model's greedy choice at every fed position — same
            # argmax (same tie-breaking) sample() runs for greedy lanes
            targets = logits.float().argmax(dim=-1).cpu().numpy()  # (B, S)
            toks = sample_grouped(logits[:, :1], sps, self._next_key())
        n_emitted = 0
        for seq in plan.decodes:
            ds = drafts.get(seq.slot)
            if not ds:                      # plain decode rode along
                tok = int(toks[seq.slot, 0])
                seq.generated.append(tok)
                res.emitted.append((seq.uid, tok))
                n_emitted += 1
                if seq.is_done(self.max_len):
                    self._meta[seq.uid]["t1"] = clock.now()
                continue
            m = len(ds)
            a = 0
            while a < m and ds[a] == int(targets[seq.slot, a]):
                a += 1
            # emit the a accepted drafts + the bonus token, stopping at
            # EOS / max_new exactly where one-token decode would have
            for j in range(a + 1):
                tok = int(targets[seq.slot, j])
                seq.generated.append(tok)
                res.emitted.append((seq.uid, tok))
                n_emitted += 1
                if seq.is_done(self.max_len):
                    self._meta[seq.uid]["t1"] = clock.now()
                    break
            self._c_spec_drafted.inc(m)
            self._c_spec_accepted.inc(a)
            if a < m:
                self._c_spec_rollbacks.inc()
            self._h_spec_accept.observe(a / m)
            # live accept-rate feedback: a lane whose windowed rate has
            # collapsed stops drafting (lookahead_for returns 0) — the
            # (k+1)-wide verify forward is pure loss for it
            if note_accept(seq, a, m):
                self._c_spec_autooff.inc()
            # roll back the worst-case page grant: KV rows past the
            # accepted frontier are garbage; pages past the next write
            # go home (re-granted next step if the lane drafts again)
            returned = self.pool.truncate_to(seq.uid, seq.next_pos)
            if returned:
                self._c_spec_pages.inc(returned)
        return n_emitted
