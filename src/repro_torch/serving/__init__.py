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
* :class:`~repro_torch.serving.engine.ServingEngine` over
  :class:`~repro_torch.serving.runner.BucketRunner` — the length-bucket
  baseline over the ring cache (``--engine bucket``, the CLI default),
  the engine that serves the hybrid RG-LRU stack;
* the host-side KV pool (``kv_pool``), scheduler (``scheduler``),
  sampler, request records and fault switchboard (``faults``).

Not ported yet: the async engine, HTTP front end, router and worker
fleet, tensor-parallel serving and speculative decoding.  Quantized serving (``quant=``) is ported.
"""

from . import faults
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
    "BucketRunner", "Clock", "Completion", "ContinuousScheduler",
    "ContinuousServingEngine", "EngineCore", "KVCachePool", "KVPoolConfig",
    "ModelRunner", "MonotonicClock", "PRIORITIES", "PrefixCache",
    "PrefixMatch", "Request", "SamplingParams", "Schedule", "Sequence",
    "ServingEngine", "StepResult", "VirtualClock", "faults",
    "prefix_chain_key", "sample", "sample_grouped", "throughput_report",
]
