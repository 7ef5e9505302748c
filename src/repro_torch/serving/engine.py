"""Serving engine — the length-bucket baseline (``repro.serving.engine``).

Requests are grouped into *length buckets* (equal prompt length, so no
padding), each bucket is prefilled once into a fresh ring cache and
decoded in lockstep with per-request completion tracking.  Buckets run
one after another and no request joins mid-decode; the paged
continuous engine (``repro_torch.serving.continuous``) is the
production path, and both give the same greedy tokens.

A cross-attention model's requests carry its image or audio input as
``Request.extra`` (``{"image_embeds": (M, d)}`` or ``{"frames": (F,
d)}``, numpy arrays or tensors), stacked across the bucket on the batch
axis in their own dtype; the model computes the memory once, at
prefill, and keeps it in the ring cache.

Device execution lives behind :class:`~repro_torch.serving.runner.BucketRunner`
(``device="cuda"`` unless the caller passes ``device="cpu"``).  Sampling
draws from one explicit ``torch.Generator`` on the runner's device,
seeded from ``seed``, where the reference splits a JAX key per call.

This module also holds the request / completion records and the
throughput report that every engine shares.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.transformer import Model
from .sampler import SamplingParams, sample_grouped

#: admission/preemption ordering of the SLO-aware scheduler: lower rank
#: wins.  ``interactive`` traffic (chat turns — humans waiting on TTFT)
#: outranks ``batch`` (offline eval, summarisation pipelines).
PRIORITIES = ("interactive", "batch")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    #: SLO class — one of :data:`PRIORITIES`; the paged scheduler admits
    #: interactive before batch and preempts batch before interactive.
    #: The bucket engine ignores it (no admission queue to order).
    priority: str = "interactive"
    #: latency budget in seconds **from submission** (None = no
    #: deadline).  The scheduler pins it to an absolute deadline on its
    #: own clock at submit time (``arrival + deadline_s``) and sheds the
    #: request — queued or running — once the deadline passes, instead
    #: of burning prefill/decode on an answer nobody is waiting for.
    #: Over HTTP this rides as ``deadline_ms`` (remaining budget,
    #: re-anchored at every hop so clock skew never accumulates).
    deadline_s: Optional[float] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Completion:
    uid: int
    prompt_len: int
    tokens: List[int]
    latency_s: float
    prefill_s: float
    #: absolute engine-clock stamps (the engine clock): work start /
    #: finish — ``throughput_report`` derives true end-to-end wall time
    #: from them instead of the old max(latency) (which under-reported
    #: whenever buckets ran sequentially)
    t0: float = 0.0
    t1: float = 0.0
    #: absolute stamp of the FIRST generated token (TTFT = t_first - t0;
    #: the serving_async bench compares engines on it)
    t_first: float = 0.0
    #: absolute stamp of FIRST scheduling (slot grant): TTFT decomposes
    #: into queue-wait (t_sched - t0) + prefill (t_first - t_sched).
    #: The bucket engine admits instantly, so it stamps t_sched = t0.
    t_sched: float = 0.0


class ServingEngine:
    def __init__(self, model: Model, params: Any, *, max_len: int = 1024,
                 cache_len: Optional[int] = None,
                 window_override: Optional[int] = None,
                 seed: int = 0, device: Any = "cuda") -> None:
        from .runner import BucketRunner
        self.model = model
        self.max_len = max_len
        self.cache_len = cache_len
        self.window_override = window_override
        self.runner = BucketRunner(model, params,
                                   window_override=window_override,
                                   device=device)
        self.params = self.runner.params
        self.device = self.runner.device
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.last_phase_s: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def _buckets(self, requests: Sequence[Request],
                 max_batch: int) -> List[List[Request]]:
        by_len: Dict[int, List[Request]] = {}
        for r in requests:
            by_len.setdefault(len(r.prompt), []).append(r)
        buckets = []
        for _, rs in sorted(by_len.items()):
            for i in range(0, len(rs), max_batch):
                buckets.append(rs[i:i + max_batch])
        return buckets

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def generate(self, requests: Sequence[Request], *,
                 max_batch: int = 8) -> List[Completion]:
        want = self.model.memory_input
        for r in requests:
            if sorted(r.extra) != ([want] if want else []):
                raise ValueError(
                    f"request {r.uid}: extra inputs {sorted(r.extra)}; "
                    f"arch {self.model.cfg.name!r} reads "
                    f"{repr(want) if want else 'none'}")
        out: List[Completion] = []
        wall0 = time.perf_counter()
        prefill_total = 0.0
        for bucket in self._buckets(requests, max_batch):
            comps = self._run_bucket(bucket)
            prefill_total += comps[0].prefill_s
            out.extend(comps)
        #: true phase times of the last generate() call, for
        #: ``throughput_report(comps, **engine.last_phase_s)``
        wall = time.perf_counter() - wall0
        self.last_phase_s = {"wall_s": wall, "prefill_s": prefill_total,
                             "decode_s": max(wall - prefill_total, 0.0)}
        return sorted(out, key=lambda c: c.uid)

    def _run_bucket(self, bucket: List[Request]) -> List[Completion]:
        B = len(bucket)
        plen = len(bucket[0].prompt)
        tokens = torch.tensor([r.prompt for r in bucket], dtype=torch.long,
                              device=self.device)
        batch: Dict[str, Any] = {"tokens": tokens}
        for k in bucket[0].extra:
            batch[k] = _stack([r.extra[k] for r in bucket], self.device)
        cache = self.runner.init_cache(B, self.max_len,
                                       cache_len=self.cache_len)

        t0 = time.perf_counter()
        logits, cache = self.runner.prefill(batch, cache)
        self._sync()
        t_prefill = time.perf_counter() - t0

        max_new = max(r.sampling.max_new_tokens for r in bucket)
        # each request keeps its OWN SamplingParams (temperature/top-k);
        # lanes sharing params still sample in one device call
        sps = [r.sampling for r in bucket]
        done = np.zeros(B, bool)
        generated: List[List[int]] = [[] for _ in range(B)]
        cur = sample_grouped(logits, sps, self._gen)
        t_first = time.perf_counter()
        for step in range(max_new):
            for b, r in enumerate(bucket):
                if done[b]:
                    continue
                t = int(cur[b, 0])
                generated[b].append(t)
                if ((r.sampling.eos_id is not None
                     and t == r.sampling.eos_id)
                        or len(generated[b]) >= r.sampling.max_new_tokens):
                    done[b] = True
            if done.all() or plen + step + 1 >= self.max_len:
                break
            logits, cache = self.runner.decode(
                cache, torch.from_numpy(cur).to(self.device), plen + step)
            cur = sample_grouped(logits, sps, self._gen)
        t1 = time.perf_counter()
        return [Completion(uid=r.uid, prompt_len=plen,
                           tokens=generated[b], latency_s=t1 - t0,
                           prefill_s=t_prefill, t0=t0, t1=t1,
                           t_first=t_first, t_sched=t0)
                for b, r in enumerate(bucket)]


def _stack(values: Sequence[Any], device: torch.device) -> torch.Tensor:
    """One ``extra`` input of a bucket's requests, stacked on a new batch
    axis as a tensor on ``device`` in the inputs' own dtype: tensors as
    they are, anything else through numpy."""
    if all(isinstance(v, torch.Tensor) for v in values):
        return torch.stack([v.to(device) for v in values])
    return torch.from_numpy(np.stack([np.asarray(v) for v in values])).to(
        device)


def throughput_report(completions: Sequence[Completion], *,
                      wall_s: Optional[float] = None,
                      prefill_s: Optional[float] = None,
                      decode_s: Optional[float] = None) -> Dict[str, float]:
    """Phase-consistent throughput summary.

    Engines measure their own phase times (``engine.last_phase_s``) —
    pass them through for exact numbers.  Without them the report falls
    back to the completions' ``t0``/``t1`` stamps: true end-to-end wall
    is ``max(t1) - min(t0)`` (the old ``max(latency)`` under-reported
    whenever buckets ran sequentially, since each bucket's latency
    clock started at its own prefill).  Both phases use the same wall
    so ``prefill_s + decode_s ~= wall_s`` for sequential engines.
    """
    total_new = sum(len(c.tokens) for c in completions)
    stamped = any(c.t1 > 0 for c in completions)
    if wall_s is None:
        if stamped:
            wall_s = (max(c.t1 for c in completions)
                      - min(c.t0 for c in completions))
        else:   # no stamps (hand-built completions): best effort
            wall_s = max(c.latency_s for c in completions)
    if prefill_s is None:
        if stamped:
            # per-bucket prefills share one (t0, prefill_s) pair —
            # dedupe so a bucket isn't counted once per member
            prefill_s = sum(p for _, p in {(c.t0, c.prefill_s)
                                           for c in completions})
        else:   # stamp-less completions are per-request measurements
            prefill_s = sum(c.prefill_s for c in completions)
    if decode_s is None:
        decode_s = max(wall_s - prefill_s, 0.0)
    # a zero-duration phase reports 0.0 tok/s EXPLICITLY: the old
    # max(dt, 1e-9) clamp turned prefill-only runs (and virtual-clock
    # tests, where a phase can legitimately take no time) into
    # astronomical rates instead of admitting "no time was measured"
    prompt_total = sum(c.prompt_len for c in completions)
    return {
        "requests": len(completions),
        "new_tokens": total_new,
        "wall_s": wall_s,
        "decode_tok_per_s": total_new / decode_s if decode_s > 0 else 0.0,
        "prefill_tok_per_s": (prompt_total / prefill_s
                              if prefill_s > 0 else 0.0),
    }
