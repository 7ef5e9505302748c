"""Schema validation for observability exports (no jsonschema dep).

A stdlib copy of ``repro.obs.validate``: the port writes the same two
documents, so it checks them by the same rules.

Two documents leave the serving stack (the reference's
``docs/observability.md``):

* the **metrics snapshot** (``--metrics-json``, JSON) — checked by
  :func:`validate_snapshot` against the shape
  ``MetricsRegistry.snapshot`` produces: ``version`` plus
  ``counters`` / ``gauges`` / ``histograms`` lists whose entries carry
  ``name``/``labels``/``value`` (histograms: aligned
  ``buckets``/``counts``, consistent ``count``);
* the **request trace** (``--trace``, JSONL) — checked by
  :func:`validate_trace_file` via ``trace.validate_events`` (per-uid
  monotone stamps, QUEUED-first, terminal lifecycle).

The module doubles as the smoke gate's CLI::

    python -m repro_torch.obs.validate --metrics M.json --trace T.jsonl \
        [--require-gauge kv_pool.pages_free:node,shard] \
        [--require-counter router.requests:replica]

``--require-gauge`` / ``--require-counter`` (``NAME[:label,label]``)
additionally assert the snapshot contains that series with the given
label keys (the reference's smoke gate pins per-(node, shard) pool
gauges and per-replica ``router.*`` series this way).  Exit 0 = all
documents valid.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from .metrics import SNAPSHOT_VERSION
from .trace import load_jsonl, validate_events


def validate_snapshot(doc: object) -> List[str]:
    """Problems with a ``MetricsRegistry.snapshot()`` document (empty
    list = valid)."""
    out: List[str] = []
    if not isinstance(doc, dict):
        return [f"snapshot is {type(doc).__name__}, not an object"]
    if doc.get("version") != SNAPSHOT_VERSION:
        out.append(f"version {doc.get('version')!r} != "
                   f"{SNAPSHOT_VERSION}")
    for kind in ("counters", "gauges", "histograms"):
        entries = doc.get(kind)
        if not isinstance(entries, list):
            out.append(f"{kind}: missing or not a list")
            continue
        for i, e in enumerate(entries):
            where = f"{kind}[{i}]"
            if not isinstance(e, dict):
                out.append(f"{where}: not an object")
                continue
            if not isinstance(e.get("name"), str) or not e.get("name"):
                out.append(f"{where}: missing name")
            if not isinstance(e.get("labels"), dict):
                out.append(f"{where}: missing labels object")
            if kind == "histograms":
                out.extend(_check_histogram(where, e))
            elif not isinstance(e.get("value"), (int, float)):
                out.append(f"{where}: missing numeric value")
    return out


def _check_histogram(where: str, e: Dict[str, object]) -> List[str]:
    out: List[str] = []
    buckets, counts = e.get("buckets"), e.get("counts")
    if not isinstance(buckets, list) or not buckets:
        out.append(f"{where}: missing buckets")
    if not isinstance(counts, list):
        out.append(f"{where}: missing counts")
    if (isinstance(buckets, list) and isinstance(counts, list)
            and len(counts) != len(buckets) + 1):
        out.append(f"{where}: {len(counts)} counts for "
                   f"{len(buckets)} buckets (want buckets+1)")
    n = e.get("count")
    if not isinstance(n, int):
        out.append(f"{where}: missing integer count")
    elif isinstance(counts, list) and sum(counts) != n:
        out.append(f"{where}: counts sum {sum(counts)} != count {n}")
    if not isinstance(e.get("sum"), (int, float)):
        out.append(f"{where}: missing numeric sum")
    return out


def validate_snapshot_file(path: str) -> List[str]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable ({e})"]
    return validate_snapshot(doc)


def validate_trace_file(path: str,
                        require_terminal: bool = True) -> List[str]:
    try:
        events = load_jsonl(path)
    except (OSError, json.JSONDecodeError, KeyError, ValueError) as e:
        return [f"{path}: unreadable ({e})"]
    if not events:
        return [f"{path}: no trace events"]
    return validate_events(events, require_terminal=require_terminal)


def _require_series(doc: Dict[str, object], kind: str, name: str,
                    label_keys: List[str]) -> List[str]:
    hits = [g for g in doc.get(kind, [])
            if g.get("name") == name
            and all(k in g.get("labels", {}) for k in label_keys)]
    if not hits:
        want = name + (":" + ",".join(label_keys) if label_keys else "")
        return [f"snapshot has no {kind[:-1]} {want}"]
    return []


def require_gauge(doc: Dict[str, object], name: str,
                  label_keys: List[str]) -> List[str]:
    """Assert the snapshot has >= 1 ``name`` gauge series carrying
    every label key in ``label_keys``."""
    return _require_series(doc, "gauges", name, label_keys)


def require_counter(doc: Dict[str, object], name: str,
                    label_keys: List[str]) -> List[str]:
    """Counter twin of :func:`require_gauge`."""
    return _require_series(doc, "counters", name, label_keys)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--metrics", help="metrics snapshot JSON to check")
    ap.add_argument("--trace", help="trace JSONL to check")
    ap.add_argument("--require-gauge", action="append", default=[],
                    metavar="NAME[:label,label]",
                    help="snapshot must contain this gauge (with these "
                         "label keys)")
    ap.add_argument("--require-counter", action="append", default=[],
                    metavar="NAME[:label,label]",
                    help="snapshot must contain this counter (with "
                         "these label keys)")
    args = ap.parse_args(argv)
    if not args.metrics and not args.trace:
        ap.error("nothing to validate: pass --metrics and/or --trace")

    problems: List[str] = []
    if args.metrics:
        problems += validate_snapshot_file(args.metrics)
        if not problems and (args.require_gauge or args.require_counter):
            with open(args.metrics) as f:
                doc = json.load(f)
            for spec in args.require_gauge:
                name, _, keys = spec.partition(":")
                problems += require_gauge(
                    doc, name, [k for k in keys.split(",") if k])
            for spec in args.require_counter:
                name, _, keys = spec.partition(":")
                problems += require_counter(
                    doc, name, [k for k in keys.split(",") if k])
    if args.trace:
        problems += validate_trace_file(args.trace)

    for p in problems:
        print(f"obs-validate: {p}", file=sys.stderr)
    print("obs-validate: " + ("FAILED" if problems else "OK"))
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
