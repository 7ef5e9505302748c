"""Continuous-batching scheduler (the serving-side ArcLight claim).

The bucket engine (``serving.engine``) runs length-equal batches
strictly sequentially: no request can join mid-decode, and the batch
runs until its *slowest* member finishes.  On CPU servers continuous
batching is the dominant throughput lever (arXiv:2407.00029 §4): keep a
fixed-capacity **running batch** of ``max_running`` slot-indexed
sequences, and at every decode step

* **evict** finished sequences (their slot and KV pages free instantly),
* **admit** waiting requests into free slots when the KV pool can cover
  their prompt (FCFS) — admission is **prefix-aware**: the pool's
  prompt-prefix map is consulted first and matched pages are *shared*,
  not allocated, so cached pages never count against the free-page
  budget and a request whose prompt is mostly cached admits into a
  nearly-full pool;
* run one **prefill chunk** (``prefill_chunk`` tokens) for every
  sequence whose prompt KV is not yet fully resident — long prompts
  spread over many steps instead of stalling the decode batch,
* **grow** each decoding sequence by one token slot, **preempting** the
  youngest-arrival sequence (recompute-style: its pages are freed and
  the whole prefix re-queues) when the pool is exhausted.

Slots are *positions in the device batch*, so membership changes are
pure data (block tables, position vectors) — the compiled decode step
never re-specialises.  The scheduler is deliberately device-free: it
manipulates the :class:`~repro_torch.serving.kv_pool.KVCachePool` and emits
:class:`Schedule` decisions; the engine turns decisions into device
calls.

The base policy is FCFS; SLO awareness is **data-driven** on top of it
(no policy knob): requests carrying a ``priority`` class admit in
``(priority, arrival)`` order and are preempted batch-first, and
requests carrying a ``deadline_s`` budget are shed — queued or running
— the step their deadline passes (``Schedule.expired``), *before* any
more prefill or decode is burned on them.  A workload with uniform
priorities and no deadlines schedules byte-identically to plain FCFS.

Invariants the engine relies on:

* **preemption ordering** — a preempted sequence's pages are released
  *before* anything else allocates in the same step, its ``slot``
  resets to -1, and it re-queues by original arrival time; its restart
  prompt (``full_prompt``) carries previously generated tokens so the
  recompute is exact;
* a sequence appears in exactly one of ``prefills`` / ``decodes`` per
  step, and only sequences with fully-resident prompts decode;
* admission reserves pages for the *whole* prompt plus one decode
  token up front, so a mid-prefill sequence never grows (and a fresh
  admission can never instantly re-preempt itself);
* every page about to be written this step has refcount 1 — shared
  pages are cloned first via ``ensure_writable`` (copy-on-write), and
  the prefix-match cap (``match_prefix`` leaves >= 1 prompt token
  uncached) keeps prompt writes out of shared pages structurally.
"""

from __future__ import annotations

import dataclasses
from typing import Deque, Dict, List, Optional
from collections import deque

from . import faults
from .engine import PRIORITIES, Request
from .kv_pool import KVCachePool
from .spec import lookahead_for

#: admission/victim ordering key per SLO class — lower admits first,
#: higher is preempted first.  Derived from ``engine.PRIORITIES`` so
#: the two stay one source of truth.
PRIORITY_RANK = {name: i for i, name in enumerate(PRIORITIES)}


@dataclasses.dataclass(eq=False)    # identity semantics: a Sequence is
class Sequence:                     # one admission ticket, never a value
    """A request's life inside the scheduler."""

    request: Request
    arrival: float = 0.0
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1                  # -1 = not running
    n_prefilled: int = 0            # tokens whose KV is resident
    prefill_target: int = 0         # prompt length being prefilled
    n_preempts: int = 0
    n_cached_tokens: int = 0        # prefix-cache hits at last admission
    t_first_sched: float = -1.0     # first time it got a slot
    #: absolute deadline on the scheduler's clock (``arrival +
    #: request.deadline_s``, pinned at submit); +inf = no deadline
    deadline: float = float("inf")
    #: verify-step (accepted, drafted) history + auto-off latch for
    #: per-sequence speculation (``spec.note_accept``)
    spec_recent: List = dataclasses.field(default_factory=list)
    spec_disabled: bool = False

    @property
    def uid(self) -> int:
        return self.request.uid

    @property
    def priority_rank(self) -> int:
        return PRIORITY_RANK[self.request.priority]

    @property
    def full_prompt(self) -> List[int]:
        """Prompt for (re-)prefill: original prompt + tokens generated
        before a preemption (recompute-style restart)."""
        return list(self.request.prompt) + self.generated

    @property
    def next_pos(self) -> int:
        """Absolute position of the next token to be fed/decoded."""
        return len(self.request.prompt) + len(self.generated)

    @property
    def is_prefilling(self) -> bool:
        return self.n_prefilled < self.prefill_target

    def is_done(self, max_len: int) -> bool:
        sp = self.request.sampling
        if len(self.generated) >= sp.max_new_tokens:
            return True
        if (sp.eos_id is not None and self.generated
                and self.generated[-1] == sp.eos_id):
            return True
        return self.next_pos >= max_len


@dataclasses.dataclass
class Schedule:
    """One step's decisions, in execution order.

    ``prefills`` holds every sequence that should run one prefill chunk
    this step (``n_prefilled`` -> engine's resume offset); ``decodes``
    holds the fully-prefilled rest of the running batch.
    """

    finished: List[Sequence] = dataclasses.field(default_factory=list)
    preempted: List[Sequence] = dataclasses.field(default_factory=list)
    prefills: List[Sequence] = dataclasses.field(default_factory=list)
    decodes: List[Sequence] = dataclasses.field(default_factory=list)
    #: deadline-expired sequences shed this step — slot and pages are
    #: already released; the engine only has to fail/trace them
    expired: List[Sequence] = dataclasses.field(default_factory=list)


class ContinuousScheduler:
    def __init__(self, pool: KVCachePool, *, max_running: int,
                 max_len: int, policy: str = "fcfs",
                 prefill_chunk: Optional[int] = None,
                 spec_lookahead: int = 0,
                 registry=None) -> None:
        if policy != "fcfs":
            raise ValueError(f"unknown policy {policy!r}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if spec_lookahead < 0:
            raise ValueError("spec_lookahead must be >= 0")
        self.pool = pool
        self.max_running = max_running
        self.max_len = max_len
        self.policy = policy
        self.prefill_chunk = prefill_chunk
        #: worst-case speculative draft tokens per decode step
        #: (``--spec-decode k``): the grow step below reserves pages for
        #: all k possible extra writes up front; the engine returns
        #: unused grants after a rejected draft (``pool.truncate_to``)
        self.spec_lookahead = spec_lookahead
        self.waiting: Deque[Sequence] = deque()
        self.running: Dict[int, Sequence] = {}      # slot -> Sequence
        self._free_slots = list(range(max_running - 1, -1, -1))
        self.n_preemptions = 0
        #: latched True on the first deadline-bearing submit: SLO-free
        #: workloads skip the per-step expiry scans entirely, keeping
        #: the hot path byte-identical to the pre-SLO scheduler
        self._has_deadlines = False
        # observability (optional; instruments resolved once — the
        # scheduler stays device-free, repro_torch.obs is stdlib-only)
        self._m_preempt = self._m_admit = self._m_expired = None
        self._g_queue = self._g_running = None
        if registry is not None:
            self._m_preempt = registry.counter(
                "scheduler.preemptions",
                "recompute-style preemptions (pool pressure)").labels()
            self._m_admit = registry.counter(
                "scheduler.admissions",
                "sequences admitted into the running batch").labels()
            self._m_expired = registry.counter(
                "scheduler.expired",
                "deadline-expired sequences shed before completion"
            ).labels()
            self._g_queue = registry.gauge(
                "scheduler.queue_depth",
                "waiting sequences after the last step").labels()
            self._g_running = registry.gauge(
                "scheduler.running",
                "running-batch occupancy after the last step").labels()

    # ------------------------------------------------------------------
    def submit(self, request: Request, arrival: float = 0.0) -> Sequence:
        if request.priority not in PRIORITY_RANK:
            raise ValueError(
                f"request {request.uid}: unknown priority "
                f"{request.priority!r} (expected one of {PRIORITIES})")
        seq = Sequence(request=request, arrival=arrival)
        if request.deadline_s is not None:
            # pin the relative budget to THIS clock's timeline once, at
            # submit — every later comparison is a plain float check
            seq.deadline = arrival + request.deadline_s
            self._has_deadlines = True
        self._requeue(seq)
        return seq

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def cancel(self, seq: Sequence) -> bool:
        """Remove ``seq`` from the scheduler wherever it lives —
        waiting queue or running batch — releasing its slot and every
        page reference (mid-prefill included: a partially-resident
        prompt frees completely).  Returns False when ``seq`` is not
        known (already finished, cancelled or preempted-and-raced)."""
        if seq.slot >= 0 and self.running.get(seq.slot) is seq:
            del self.running[seq.slot]
            self._free_slots.append(seq.slot)
            self.pool.release(seq.uid)
            seq.slot = -1
            return True
        try:
            self.waiting.remove(seq)
        except ValueError:
            return False
        self.pool.release(seq.uid)      # no-op for queued sequences
        return True

    def chunk_for(self, seq: Sequence) -> int:
        """Tokens the engine should prefill for ``seq`` this step."""
        remaining = seq.prefill_target - seq.n_prefilled
        if self.prefill_chunk is None:
            return remaining
        return min(self.prefill_chunk, remaining)

    def _slot_node(self, slot: int) -> int:
        """Home-node hint: stripe slots across the pool's NUMA nodes so
        each node's threads mostly touch locally-resident KV pages
        (under TP the per-shard pools of one node count once — a page's
        head-slices follow its node)."""
        n = max(self.pool.mm.kv_node_count, 1)
        return slot % n

    def _requeue(self, seq: Sequence) -> None:
        """Priority-then-FCFS insertion (stable): the queue is kept
        sorted by ``(priority_rank, arrival)``, so interactive traffic
        admits ahead of batch and order within a class is arrival
        order.  With uniform priorities this degrades to exactly the
        old FCFS queue — ties insert *after* equals."""
        key = (seq.priority_rank, seq.arrival)
        for i, w in enumerate(self.waiting):
            if (w.priority_rank, w.arrival) > key:
                self.waiting.insert(i, seq)
                return
        self.waiting.append(seq)

    def _admit(self, seq: Sequence, slot: int) -> bool:
        """Reserve KV for ``seq``'s whole prompt + one decode token,
        sharing every prefix-cached page instead of allocating it."""
        if faults.ACTIVE and faults.should_fire("pool.exhaust"):
            return False        # injected memory pressure (chaos tests)
        pool = self.pool
        prompt = seq.full_prompt
        need_total = pool.cfg.pages_for(len(prompt) + 1)
        if need_total > pool.cfg.max_pages_per_seq:
            raise ValueError(
                f"request {seq.uid}: prompt needs {need_total} pages; "
                f"pool only has {pool.cfg.max_pages_per_seq}")
        match = pool.match_prefix(prompt)
        # prefix-aware budget: cached pages are shared, not allocated —
        # but a matched RETAINED page (refcount 0) is itself part of
        # n_free()'s reclaimable count, and adopting it revives it, so
        # it must not be counted as capacity for the uncached tail
        matched_retained = sum(1 for p in match.pages
                               if pool.refcount(p) == 0)
        if need_total - len(match.pages) > pool.n_free() - matched_retained:
            return False
        hint = self._slot_node(slot)
        if not pool.adopt_prefix(seq.uid, match, node_hint=hint):
            return False
        if not pool.grow(seq.uid, len(prompt) + 1, node_hint=hint):
            pool.release(seq.uid)   # roll back the adopted references
            return False
        seq.n_prefilled = match.n_tokens
        seq.n_cached_tokens = match.n_tokens
        seq.prefill_target = len(prompt)
        return True

    # ------------------------------------------------------------------
    def step(self, now: float = 0.0) -> Schedule:
        """Plan one engine step.  Order matters: evict, shed, admit,
        grow."""
        sched = Schedule()

        # 1. evict finished sequences — slot and pages free immediately
        #    (a sequence that completed AT its deadline still counts as
        #    finished: eviction runs before expiry shedding)
        for slot in sorted(self.running):
            seq = self.running[slot]
            if not seq.is_prefilling and seq.is_done(self.max_len):
                del self.running[slot]
                self._free_slots.append(slot)
                self.pool.release(seq.uid)
                seq.slot = -1
                sched.finished.append(seq)

        # 2. shed deadline-expired work: queued requests go *before*
        #    they burn any prefill, running ones before another step is
        #    spent on an answer nobody is waiting for.  Pages drain
        #    through the same release path as cancel/preempt (CoW
        #    pending copies included), so the pool stays clean.
        if self._has_deadlines:
            for seq in [w for w in self.waiting if now >= w.deadline]:
                self.waiting.remove(seq)
                self.pool.release(seq.uid)      # no-op for queued seqs
                sched.expired.append(seq)
            for slot in sorted(self.running):
                seq = self.running[slot]
                if now >= seq.deadline:
                    del self.running[slot]
                    self._free_slots.append(slot)
                    self.pool.release(seq.uid)
                    seq.slot = -1
                    sched.expired.append(seq)
            if sched.expired and self._m_expired is not None:
                self._m_expired.inc(len(sched.expired))

        # 3. admit arrived waiting sequences — the queue is kept in
        #    (priority, arrival) order, so this walk is priority-first;
        #    not-yet-arrived entries are skipped (a future interactive
        #    arrival must not block an already-arrived batch request).
        #    The first failed page reservation stops admission, as
        #    before.
        i = 0
        while self._free_slots and i < len(self.waiting):
            seq = self.waiting[i]
            if seq.arrival > now:
                i += 1
                continue
            slot = self._free_slots[-1]
            if not self._admit(seq, slot):
                break
            del self.waiting[i]
            self._free_slots.pop()
            seq.slot = slot
            if seq.t_first_sched < 0:
                seq.t_first_sched = now
            if self._m_admit is not None:
                self._m_admit.inc()
            self.running[slot] = seq

        # 4. every sequence whose prompt KV is not fully resident runs
        #    one prefill chunk this step (freshly admitted ones included)
        for slot in sorted(self.running):
            if self.running[slot].is_prefilling:
                sched.prefills.append(self.running[slot])

        # 5. grow every decoding sequence for this step's token write;
        #    preempt lowest-priority / youngest arrivals when the pool
        #    runs dry
        for slot in sorted(list(self.running)):
            seq = self.running.get(slot)
            if seq is None:                 # preempted earlier in this loop
                continue
            if seq in sched.prefills:       # reservation made at admission
                continue
            hint = self._slot_node(slot)
            k_eff = (lookahead_for(seq, self.spec_lookahead, self.max_len)
                     if self.spec_lookahead else 0)
            while not (self.pool.grow(seq.uid, seq.next_pos + 1 + k_eff,
                                      node_hint=hint)
                       and self._writable_span(seq, k_eff, hint)):
                victim = self._pick_victim(exclude=seq)
                if victim is None:
                    raise RuntimeError(
                        "KV pool cannot hold a single sequence — "
                        "raise n_pages or lower max_len")
                self._preempt(victim)
                sched.preempted.append(victim)
                if victim in sched.prefills:
                    sched.prefills.remove(victim)

        sched.decodes = [self.running[s] for s in sorted(self.running)
                         if self.running[s] not in sched.prefills]
        if self._g_queue is not None:
            self._g_queue.set(len(self.waiting))
            self._g_running.set(len(self.running))
        return sched

    def _writable_span(self, seq: Sequence, k_eff: int, hint: int) -> bool:
        """Copy-on-write guard for this step's whole write span: plain
        decode writes one row at ``next_pos - 1``; a speculating step
        writes up to ``k_eff`` more (draft rows), which can cross into
        the next page(s).  Clone every shared page the span touches.
        A False mid-loop (pool dry) leaves earlier clones in place —
        they are private refcount-1 pages the retry (or the preemption
        the caller triggers) handles like any owned page."""
        ps = self.pool.cfg.page_size
        first = (seq.next_pos - 1) // ps
        last = (seq.next_pos - 1 + k_eff) // ps
        for li in range(first, last + 1):
            if not self.pool.ensure_writable(seq.uid, li * ps,
                                             node_hint=hint):
                return False
        return True

    # ------------------------------------------------------------------
    def _pick_victim(self, exclude: Sequence) -> Optional[Sequence]:
        """Batch loses before interactive; within a class the youngest
        arrival loses (FCFS fairness for the oldest).  Evicting batch
        first is what bounds interactive TTFT/ITL under pool pressure —
        and with uniform priorities this is exactly the old
        youngest-arrival rule."""
        candidates = [s for s in self.running.values() if s is not exclude]
        if not candidates:
            return None
        return max(candidates,
                   key=lambda s: (s.priority_rank, s.arrival, s.uid))

    def _preempt(self, seq: Sequence) -> None:
        self.n_preemptions += 1
        if self._m_preempt is not None:
            self._m_preempt.inc()
        seq.n_preempts += 1
        del self.running[seq.slot]
        self._free_slots.append(seq.slot)
        self.pool.release(seq.uid)
        seq.slot = -1
        seq.n_prefilled = 0
        seq.prefill_target = 0
        self._requeue(seq)
