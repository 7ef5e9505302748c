"""Serving-wide observability (the registry, tracer and checks copied
from ``repro.obs``, stdlib only; spans added, over ``torch.profiler``).

* :mod:`repro_torch.obs.metrics` — :class:`MetricsRegistry`: counters,
  gauges and fixed-bucket histograms with labels, JSON snapshot and
  Prometheus text export; :class:`NullRegistry` is the no-op twin.
* :mod:`repro_torch.obs.trace` — :class:`RequestTracer`: per-request
  lifecycle events stamped from the engine's injected clock, exported
  as JSONL.
* :mod:`repro_torch.obs.spans` — :class:`Span`: a named interval at a
  layer boundary of the serving step; it writes its host wall into a
  registry instrument, and opens a profiler range ``repro_torch.<name>``
  only while a profiler records (:func:`traced`: a decorator that opens
  the range alone, for functions any thread runs on the hot path).
* :mod:`repro_torch.obs.validate` — schema checks for both exports;
  also a CLI: ``python -m repro_torch.obs.validate --metrics M.json
  --trace T.jsonl``.
"""

from .metrics import (DEFAULT_BUCKETS_MS, Counter, Gauge, Histogram,
                      MetricsRegistry, NullRegistry)
from .spans import PREFIX, Span, traced
from .trace import (NullTracer, RequestTracer, TraceEvent, load_jsonl,
                    reconstruct_spans, validate_events)
from .validate import (validate_snapshot, validate_snapshot_file,
                       validate_trace_file)

__all__ = [
    "Counter", "DEFAULT_BUCKETS_MS", "Gauge", "Histogram",
    "MetricsRegistry", "NullRegistry", "NullTracer", "PREFIX",
    "RequestTracer", "Span", "TraceEvent", "load_jsonl",
    "reconstruct_spans", "traced", "validate_events",
    "validate_snapshot", "validate_snapshot_file", "validate_trace_file",
]
