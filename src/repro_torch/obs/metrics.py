"""Dependency-free metrics registry for the serving stack.

ArcLight's serving claims are all *measurements* — cross-NUMA page
traffic, scheduling stalls, phase splits — so the stack needs one
substrate every layer reports through instead of ad-hoc counters per
module.  Three instrument kinds, modelled on the Prometheus data
model but with zero dependencies:

* :class:`Counter` — monotonically increasing float (``inc``);
* :class:`Gauge` — last-write-wins float (``set``/``inc``);
* :class:`Histogram` — fixed-bucket distribution (``observe``) with
  cumulative bucket counts, sum/count, and quantile *estimates* by
  linear interpolation inside the winning bucket.

Every instrument supports **labels** (``labels(node=0, shard=1)``
returns a child bound to that label set), so one metric family covers
per-(node, shard) pool gauges, per-shard dispatch times, etc.

Two export surfaces:

* :meth:`MetricsRegistry.snapshot` — a plain-dict JSON document
  (schema checked by ``repro_torch.obs.validate``),
  what ``--metrics-json`` writes and benches assert on;
* :meth:`MetricsRegistry.to_prometheus` — the Prometheus text
  exposition format (``name{label="v"} value`` plus
  ``_bucket``/``_sum``/``_count`` series for histograms; dots in
  metric names become underscores), ready for a future HTTP
  ``/metrics`` endpoint.

:class:`NullRegistry` is the no-op twin: same API, every operation a
``pass``.  The ``serving_obs.*`` bench serves the same workload under
both and gates the instrumentation overhead (<= 3% decode tok/s —
``docs/observability.md`` "Overhead budget").  Hot-path discipline:
engines resolve instruments **once at construction** (attribute
lookups, not registry dict lookups, inside ``step()``).

Thread-safety: instrument writes are single-``dict``-op (atomic under
the GIL) and the async stepper is the only writer of engine metrics;
``snapshot``/``to_prometheus`` take a consistent point-in-time copy
under the registry lock.
"""

from __future__ import annotations

import bisect
import json
import threading
from typing import Dict, Iterable, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

SNAPSHOT_VERSION = 1

#: default histogram buckets (milliseconds): sub-ms dispatches up to
#: multi-second stalls, roughly log-spaced
DEFAULT_BUCKETS_MS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0)


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Instrument:
    """One metric family: name + help + per-label-set series."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help

    def labels(self, **labels: object) -> "_Instrument":
        raise NotImplementedError


class Counter(_Instrument):
    kind = "counter"

    def __init__(self, name: str, help: str = "") -> None:
        super().__init__(name, help)
        self._series: Dict[LabelKey, float] = {}

    def inc(self, v: float = 1.0, **labels: object) -> None:
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0.0) + v

    def value(self, **labels: object) -> float:
        return self._series.get(_label_key(labels), 0.0)

    def labels(self, **labels: object) -> "_BoundCounter":
        return _BoundCounter(self, _label_key(labels))

    def reset(self) -> None:
        self._series.clear()


class _BoundCounter:
    """Counter child bound to one label set (hot-path handle)."""

    __slots__ = ("_c", "_key")

    def __init__(self, c: Counter, key: LabelKey) -> None:
        self._c, self._key = c, key

    def inc(self, v: float = 1.0) -> None:
        s = self._c._series
        s[self._key] = s.get(self._key, 0.0) + v


class Gauge(_Instrument):
    kind = "gauge"

    def __init__(self, name: str, help: str = "") -> None:
        super().__init__(name, help)
        self._series: Dict[LabelKey, float] = {}

    def set(self, v: float, **labels: object) -> None:
        self._series[_label_key(labels)] = float(v)

    def inc(self, v: float = 1.0, **labels: object) -> None:
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0.0) + v

    def value(self, **labels: object) -> float:
        return self._series.get(_label_key(labels), 0.0)

    def labels(self, **labels: object) -> "_BoundGauge":
        return _BoundGauge(self, _label_key(labels))

    def reset(self) -> None:
        self._series.clear()


class _BoundGauge:
    __slots__ = ("_g", "_key")

    def __init__(self, g: Gauge, key: LabelKey) -> None:
        self._g, self._key = g, key

    def set(self, v: float) -> None:
        self._g._series[self._key] = float(v)


class _HistSeries:
    """One label set's distribution: cumulative-style bucket counts
    kept as per-bucket tallies (cumulated on export)."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int) -> None:
        self.counts = [0] * (n_buckets + 1)     # +1 = +Inf overflow
        self.sum = 0.0
        self.count = 0


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = DEFAULT_BUCKETS_MS) -> None:
        super().__init__(name, help)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"histogram {name}: need >= 1 bucket bound")
        self.buckets: Tuple[float, ...] = tuple(bs)
        self._series: Dict[LabelKey, _HistSeries] = {}

    def _get(self, key: LabelKey) -> _HistSeries:
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries(len(self.buckets))
        return s

    def observe(self, v: float, **labels: object) -> None:
        s = self._get(_label_key(labels))
        s.counts[bisect.bisect_left(self.buckets, v)] += 1
        s.sum += v
        s.count += 1

    def labels(self, **labels: object) -> "_BoundHistogram":
        return _BoundHistogram(self, _label_key(labels))

    def value(self, **labels: object) -> Tuple[float, int]:
        """(sum, count) for one label set."""
        s = self._series.get(_label_key(labels))
        return (s.sum, s.count) if s is not None else (0.0, 0)

    def quantile(self, q: float, **labels: object) -> float:
        """Quantile *estimate* from the bucket counts: linear
        interpolation inside the bucket the rank lands in (the overflow
        bucket clamps to the top bound).  0.0 when empty."""
        s = self._series.get(_label_key(labels))
        if s is None or s.count == 0:
            return 0.0
        rank = q * s.count
        seen = 0.0
        lo = 0.0
        for i, n in enumerate(s.counts):
            if n == 0:
                continue
            hi = (self.buckets[i] if i < len(self.buckets)
                  else self.buckets[-1])
            if seen + n >= rank:
                frac = min(max((rank - seen) / n, 0.0), 1.0)
                return lo + frac * (hi - lo)
            seen += n
            lo = hi
        return self.buckets[-1]

    def reset(self) -> None:
        self._series.clear()


class _BoundHistogram:
    __slots__ = ("_h", "_key")

    def __init__(self, h: Histogram, key: LabelKey) -> None:
        self._h, self._key = h, key

    def observe(self, v: float) -> None:
        s = self._h._get(self._key)
        s.counts[bisect.bisect_left(self._h.buckets, v)] += 1
        s.sum += v
        s.count += 1


class MetricsRegistry:
    """Name -> instrument map with JSON + Prometheus export.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent,
    so layers can resolve the same family independently); a name
    re-registered as a different kind raises.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Instrument] = {}

    # -- registration ---------------------------------------------------
    def _get_or_create(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}")
                return m
            m = cls(name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS_MS,
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Instrument]:
        return self._metrics.get(name)

    def reset(self) -> None:
        """Zero every series (run-scoped accounting: the engines call
        this from ``reset_run_stats`` so per-run reports start clean)."""
        with self._lock:
            for m in self._metrics.values():
                m.reset()

    # -- export ----------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Point-in-time JSON document (see ``repro_torch.obs.validate``
        for the schema): one entry per (metric, label set)."""
        with self._lock:
            counters, gauges, hists = [], [], []
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if isinstance(m, (Counter, Gauge)):
                    dest = counters if isinstance(m, Counter) else gauges
                    for key, v in sorted(m._series.items()):
                        dest.append({"name": name, "labels": dict(key),
                                     "value": v})
                elif isinstance(m, Histogram):
                    for key, s in sorted(m._series.items()):
                        hists.append({
                            "name": name, "labels": dict(key),
                            "buckets": list(m.buckets),
                            "counts": list(s.counts),
                            "sum": s.sum, "count": s.count,
                            "p50": m.quantile(0.5, **dict(key)),
                            "p99": m.quantile(0.99, **dict(key)),
                        })
        return {"version": SNAPSHOT_VERSION, "counters": counters,
                "gauges": gauges, "histograms": hists}

    def snapshot_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4).  Dots in metric
        names become underscores (``serving.decode.itl_ms`` ->
        ``serving_decode_itl_ms``)."""
        out: List[str] = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                pname = name.replace(".", "_")
                if m.help:
                    out.append(f"# HELP {pname} {m.help}")
                out.append(f"# TYPE {pname} {m.kind}")
                if isinstance(m, (Counter, Gauge)):
                    for key, v in sorted(m._series.items()):
                        out.append(f"{pname}{_fmt_labels(key)} {v:g}")
                elif isinstance(m, Histogram):
                    for key, s in sorted(m._series.items()):
                        cum = 0
                        for b, n in zip(m.buckets, s.counts):
                            cum += n
                            out.append(
                                f"{pname}_bucket"
                                f"{_fmt_labels(key, le=f'{b:g}')} {cum}")
                        out.append(
                            f"{pname}_bucket"
                            f"{_fmt_labels(key, le='+Inf')} {s.count}")
                        out.append(
                            f"{pname}_sum{_fmt_labels(key)} {s.sum:g}")
                        out.append(
                            f"{pname}_count{_fmt_labels(key)} {s.count}")
        return "\n".join(out) + "\n"

    def stats_line(self, names: Iterable[str]) -> str:
        """One compact ``k=v`` line for the launcher's periodic stats
        print; unknown names render as ``-`` so callers can list
        metrics that only exist in some configurations."""
        parts = []
        for name in names:
            m = self._metrics.get(name)
            if isinstance(m, (Counter, Gauge)):
                parts.append(f"{name}={sum(m._series.values()):g}")
            elif isinstance(m, Histogram):
                tot = sum(s.count for s in m._series.values())
                parts.append(f"{name}.n={tot}")
            else:
                parts.append(f"{name}=-")
        return " ".join(parts)


def _fmt_labels(key: LabelKey, **extra: str) -> str:
    items = list(key) + sorted(extra.items())
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


# ----------------------------------------------------------------------
# no-op twin: the overhead-comparison baseline and the "observability
# disabled" mode.  One shared instance of each no-op instrument.
# ----------------------------------------------------------------------
class _NullBound:
    __slots__ = ()

    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL_BOUND = _NullBound()


class _NullInstrument:
    __slots__ = ("name", "help", "kind", "buckets")

    def __init__(self, name: str = "", kind: str = "untyped") -> None:
        self.name, self.help, self.kind = name, "", kind
        self.buckets: Tuple[float, ...] = ()

    def inc(self, v: float = 1.0, **labels: object) -> None:
        pass

    def set(self, v: float, **labels: object) -> None:
        pass

    def observe(self, v: float, **labels: object) -> None:
        pass

    def value(self, **labels: object) -> float:
        return 0.0

    def quantile(self, q: float, **labels: object) -> float:
        return 0.0

    def labels(self, **labels: object) -> _NullBound:
        return _NULL_BOUND

    def reset(self) -> None:
        pass


class NullRegistry(MetricsRegistry):
    """Same API as :class:`MetricsRegistry`, every operation a no-op —
    the baseline the ``serving_obs.overhead_pct`` bench compares the
    real registry against."""

    def __init__(self) -> None:
        super().__init__()

    def counter(self, name: str, help: str = "") -> _NullInstrument:
        return _NullInstrument(name, "counter")

    def gauge(self, name: str, help: str = "") -> _NullInstrument:
        return _NullInstrument(name, "gauge")

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS_MS,
                  ) -> _NullInstrument:
        return _NullInstrument(name, "histogram")

    def snapshot(self) -> Dict[str, object]:
        return {"version": SNAPSHOT_VERSION, "counters": [],
                "gauges": [], "histograms": []}

    def to_prometheus(self) -> str:
        return "\n"
