"""Request / completion records and the throughput report of the
serving stack (the device-free part of ``repro.serving.engine``).

The reference's length-bucket ``ServingEngine`` (the baseline over the
ring cache) is not ported yet; the port serves through the paged
continuous engine (``repro_torch.serving.continuous``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from .sampler import SamplingParams

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
