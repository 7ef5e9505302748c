"""repro_torch.serving — the paged continuous-batching stack on PyTorch.

What this slice of the port has (counterparts of ``repro.serving``):

* :class:`~repro_torch.serving.runner.ModelRunner` — device execution:
  paged KV cache updated in place, prefill / decode, CoW row copies;
* :class:`~repro_torch.serving.core.EngineCore` — one scheduler step +
  runner dispatch + sequence bookkeeping per ``step()``, with an
  injected :class:`~repro_torch.serving.core.Clock`;
* :class:`~repro_torch.serving.continuous.ContinuousServingEngine` —
  the synchronous pre-declared-arrivals driver (what
  ``launch/serve.py --engine continuous`` builds);
* :class:`~repro_torch.serving.async_engine.AsyncEngine` — live
  submit/stream/poll/cancel on a background stepper thread
  (``--engine async``);
* :class:`~repro_torch.serving.engine.ServingEngine` over
  :class:`~repro_torch.serving.runner.BucketRunner` — the length-bucket
  baseline over the ring cache (``--engine bucket``, the CLI default),
  the engine that serves the hybrid RG-LRU stack;
* the host-side KV pool (``kv_pool``), scheduler (``scheduler``),
  sampler, request records and fault switchboard (``faults``).

Both paged engines take ``spec_decode=k`` (prompt-lookup drafts checked
by one batched verify forward) and ``quant=`` (Q4_0 weights, int8 KV
pages).  Not ported yet: the HTTP front end, router and worker fleet,
and tensor-parallel serving.
"""

from . import faults
from .async_engine import (AsyncEngine, AsyncEngineError, CancelledError,
                           DeadlineExceededError, PollResult,
                           RequestHandle, RequestState)
from .continuous import ContinuousServingEngine
from .core import (Clock, EngineCore, MonotonicClock, StepResult,
                   VirtualClock)
from .engine import (PRIORITIES, Completion, Request, ServingEngine,
                     throughput_report)
from .kv_pool import (KVCachePool, KVPoolConfig, PrefixCache, PrefixMatch,
                      prefix_chain_key)
from .runner import BucketRunner, ModelRunner
from .sampler import SamplingParams, sample, sample_grouped
from .scheduler import ContinuousScheduler, Schedule, Sequence

__all__ = [
    "AsyncEngine", "AsyncEngineError", "BucketRunner", "CancelledError",
    "Clock", "Completion", "ContinuousScheduler", "ContinuousServingEngine",
    "DeadlineExceededError", "EngineCore", "KVCachePool", "KVPoolConfig",
    "ModelRunner", "MonotonicClock", "PRIORITIES", "PollResult",
    "PrefixCache", "PrefixMatch", "Request", "RequestHandle",
    "RequestState", "SamplingParams", "Schedule", "Sequence",
    "ServingEngine", "StepResult", "VirtualClock", "faults",
    "prefix_chain_key", "sample", "sample_grouped", "throughput_report",
]
