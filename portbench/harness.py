"""One run of one cell: set-up, ramp, the measured window, the metrics and
the output check, as data from ``BENCHMARK.json``, the cell's
configuration file and its mix's data file.

:func:`run_cell` takes the device as an argument so the tests can drive
a whole run on the CPU at a tiny size; ``portbench/run.py`` gives it the
card and refuses to run without one.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import check, loadgen, mixes, serve, tracing
from .loadgen import Record

ROOT = Path(__file__).resolve().parent.parent
#: seconds between two readings of the KV pool's gauges in the window
POOL_EVERY_S = 0.1
#: seconds of the window the profiler traces in a traced run, at its end
#: (stopping the profiler stalls the stepper: after the window, not in it)
SLICE_S = 3.0


@dataclasses.dataclass
class Run:
    """What the metric readers (``portbench/metrics``) read."""

    cfg: Dict
    t_w0: float
    t_w1: float
    records: List[Record]
    before: Dict[str, float]
    after: Dict[str, float]
    setup_s: float
    trace: Optional[tracing.Reduced] = None
    calls: List[tracing.Call] = dataclasses.field(default_factory=list)


def load_benchmark(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones with
    ``--trace 0``, the per-layer ones with ``--trace 1``; a metric with a
    ``workloads`` list only in the cells it names."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metric(name: str, run: Run) -> Optional[float]:
    mod = importlib.import_module(f"portbench.metrics.{name}")
    return mod.read(run)


def card_facts(device) -> Dict[str, object]:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    facts = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
             "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        facts["nvidia_smi"] = out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        facts["nvidia_smi"] = f"not read ({e})"
    return facts


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _sleep_until(t: float, tick=None, every_s: float = 0.5) -> None:
    """Sleep until perf_counter ``t``, calling ``tick`` every ``every_s``."""
    while True:
        if tick is not None:
            tick()
        dt = t - time.perf_counter()
        if dt <= 0:
            return
        time.sleep(min(dt, every_s))


def breakdown(red: tracing.Reduced, k: int = 10) -> Dict[str, list]:
    """The slice's device operations that took most time (summed by
    name), and its device-idle time summed by what the stepper thread was
    doing when each gap began: inside a benchmark range (decode or
    prefill), in an outermost host operation (by name), or in Python
    between operations."""
    import bisect

    by_op: Dict[str, float] = {}
    for op, _ in red.ops:
        by_op[op.name] = by_op.get(op.name, 0.0) + (op.end - op.start) * 1e-9
    ranges = sorted((s, e, n.split("#")[0]) for n, s, e in red.ranges.values())
    r_starts = [r[0] for r in ranges]
    h_starts = [h.start for h in red.host]
    idle: Dict[str, float] = {}
    cursor = red.window_ns[0]
    for s, e in sorted((op.start, op.end) for op, _ in red.ops) + [
            (red.window_ns[1], red.window_ns[1])]:
        if s > cursor:
            name = "python between host ops"
            j = bisect.bisect_right(r_starts, cursor) - 1
            h = bisect.bisect_right(h_starts, cursor) - 1
            if j >= 0 and cursor < ranges[j][1]:
                name = ranges[j][2].replace(tracing.RANGE, "") + " range"
            elif h >= 0 and cursor < red.host[h].end:
                name = red.host[h].name
            idle[name] = idle.get(name, 0.0) + (s - cursor) * 1e-9
        cursor = max(cursor, e)

    def top(d):
        return [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]

    return {"device_ops": top(by_op), "idle_gaps": top(idle)}


def make_request(req: mixes.Req):
    """The engine's request for ``req``: greedy, no EOS, so it runs to the
    length the mix drew."""
    from repro_torch.serving import Request, SamplingParams
    return Request(uid=0, prompt=req.prompt, sampling=SamplingParams(
        temperature=0.0, max_new_tokens=req.out_len, eos_id=None))


def warm(engine, traffic: mixes.Traffic, cfg: Dict, vocab: int,
         seed: int) -> List[int]:
    """Warm the shapes the traffic's prompts reach (random prompts, from
    the seed), then send the traffic's own set-up requests (documents to
    cache); returns the shape prompts' lengths."""
    import numpy as np

    lo = min(len(r.prompt) for r in traffic.requests)
    hi = max(len(r.prompt) for r in traffic.requests)
    rng = np.random.default_rng([seed, 2])
    lens = serve.warm_lengths(lo, hi, int(cfg["engine"]["prefill_chunk"]))
    serve.warm_up(engine, [rng.integers(0, vocab, n).tolist() for n in lens])
    if traffic.warm:
        serve.warm_up(engine, [r.prompt for r in traffic.warm], out_len=1)
    return lens


def settle(engine, records: List[Record]) -> None:
    """Once the window has closed: each record's failure and the time the
    scheduler gave it a slot (the program's ``Completion.t_sched``, or the
    same stamp of a request still running)."""
    from repro_torch.serving import RequestState

    for r in records:
        h = r.handle
        r.failed = h.state is RequestState.FAILED
        if h.completion is not None:
            r.t_sched = h.completion.t_sched
        elif h._seq is not None and h._seq.t_first_sched >= 0:
            r.t_sched = engine._clock0 + h._seq.t_first_sched


def run_cell(bench: Dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t_proc0: float, startup_s: float = 0.0,
             config_dir: Path = serve.CONFIG_DIR,
             traffic_dir: Path = mixes.TRAFFIC_DIR,
             control: bool = False, log=print) -> Dict:
    """One run; returns the result line's object (plus ``control`` where
    asked).  ``t_proc0`` is the perf_counter reading taken when the
    process began its own work, ``startup_s`` the seconds before it."""
    cell = find(bench["workloads"], cell_name, "workload")
    cfg = serve.load_config(cell["config"], config_dir)
    mix = mixes.load_mix(cell["traffic"], traffic_dir)
    card = card_facts(device)
    log(f"[cell] {cell_name}: config {cfg['name']}, traffic {cell['traffic']}"
        f", seed {seed}, {seconds} s window, trace {int(trace)}; card {card}")
    engine, params, mc, facts = serve.build_engine(cfg, seed, device)
    log(f"[setup] {json.dumps(facts)}")
    traffic = mixes.build(mix, mc.vocab_size, seed, seconds)
    for line in traffic.described.values():
        log(f"[traffic] {line}")
    t_warm = time.perf_counter()
    shapes = warm(engine, traffic, cfg, mc.vocab_size, seed)
    _sync(device)
    log(f"[setup] warm-up: {len(shapes)} shape prompts {shapes}, "
        f"{len(traffic.warm)} set-up requests, "
        f"{time.perf_counter() - t_warm:.2f} s")
    ranges = tracing.install_ranges(engine) if trace else None

    gen = loadgen.LoadGen(engine, traffic, make_request)
    t0 = time.perf_counter()
    t_w0 = t0 + traffic.ramp_s
    t_w1 = t_w0 + seconds
    gen.start(t0, t_stop=t_w1)
    _sleep_until(t_w0)
    before = loadgen.counters(engine.registry)
    setup_s = startup_s + (t_w0 - t_proc0)
    if trace:
        ranges.profile_between(t_w1 - min(SLICE_S, seconds / 3), t_w1)
    pool = loadgen.PoolSampler(engine.registry)
    _sleep_until(t_w1, tick=pool.sample, every_s=POOL_EVERY_S)
    after = loadgen.counters(engine.registry)
    gen.join(timeout=60)
    red = ranges.reduced(timeout=60) if trace else None
    lat = gen.lateness_s()
    if lat:
        from .metrics import percentile
        log(f"[loadgen] open loop lateness over {len(lat)} submissions: "
            f"p50 {percentile(lat, 50) * 1e3:.3f} ms, p99 "
            f"{percentile(lat, 99) * 1e3:.3f} ms, max {max(lat) * 1e3:.3f} ms")
    settle(engine, gen.records)
    engine.shutdown()
    if engine._error is not None:
        raise RuntimeError("the engine's stepper died") from engine._error
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if card["platform"] == "gpu" else 0)
    run = Run(cfg=cfg, t_w0=t_w0, t_w1=t_w1, records=gen.records,
              before=before, after=after, setup_s=setup_s, trace=red,
              calls=ranges.calls if ranges else [])
    metrics = {}
    for m in cell_metrics(bench, cell_name, trace):
        v = read_metric(m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    started = [r for r in gen.records if t_w0 <= r.t_start < t_w1]
    from .metrics import percentile
    ttft = [r.stamps[0] - r.t_start for r in started
            if r.stamps and r.stamps[0] < t_w1]
    gaps = [b - a for r in gen.records for a, b in zip(r.stamps, r.stamps[1:])
            if t_w0 <= a and b < t_w1]
    for name, vals in (("ttft", ttft), ("itl", gaps)):
        if vals:
            log(f"[window] {name} over {len(vals)}: p50/p90/p95/p99 ms "
                + "/".join(f"{percentile(vals, q) * 1e3:.2f}"
                           for q in (50, 90, 95, 99)))
    kv_pages = pool.report()
    log(f"[window] KV pool pages in use, peak of {kv_pages['samples']} "
        f"readings: {json.dumps(kv_pages)}")
    n_failed = sum(1 for r in gen.records if r.failed)
    log(f"[window] {len(started)} requests started in the window, "
        f"{sum(1 for r in started if r.finished)} of them finished; "
        f"{len(gen.records)} sent in all, {n_failed} failed; counters "
        f"before {before} after {after}")
    # the output check, once the program's state is freed: every
    # reference to the engine dropped (the load generator's too)
    gen.engine = None
    del engine
    gc.collect()
    if card["platform"] == "gpu":
        torch.cuda.empty_cache()
    recs = check.sample(gen.records, traffic.check_requests, seed, t_w0, t_w1)
    got = check.logit_gap(cfg, params, recs, device)
    # the configuration names the statistic it compares: the widest gap,
    # or the mean over the served tokens (PERF.md says why and where)
    stat = cfg["check"].get("statistic", "logit_gap")
    limit = float(cfg["check"]["limit"])
    log(f"[check] reference ({cfg['reference']}, float32) over "
        f"{len(recs)} requests, {got['tokens']} served tokens, "
        f"{got['seconds']:.2f} s: widest gap {got['logit_gap']}, mean "
        f"{got['logit_gap_mean']}")
    checks = {
        stat: {"value": got[stat], "max": limit},
        "failed": {"value": n_failed, "max": 0},
        "checked_requests": {"value": len(recs),
                             "min": traffic.check_requests},
    }
    correct = (got[stat] <= limit and n_failed == 0
               and len(recs) >= traffic.check_requests)
    dev = {"platform": card["platform"], "kind": card["kind"],
           "count": card["count"], "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(started),
              "failed": sum(1 for r in started if r.failed),
              "metrics": metrics, "device": dev}
    if red is not None:
        busy = tracing.union_ns([(op.start, op.end) for op, _ in red.ops],
                                *red.window_ns)
        dev["busy_s"] = busy * 1e-9
        dev["window_s"] = red.window_s
        result["breakdown"] = breakdown(red)
        log(f"[trace] {len(red.ops)} device ops, {red.attributed} launched "
            f"inside a benchmark range; {len(red.ranges)} ranges")
    if control:
        result["gaps"] = {k: got[k] for k in ("logit_gap", "logit_gap_mean")}
        result["control"] = check.control_gap(cfg, params, recs, device)
        result["witness"] = check.control_gap(cfg, params, recs, device,
                                              precision="bf16")
        if "num_local_experts" in cfg:
            result["look"] = check.routing_look(cfg, params, recs, device)
    for name in [n for n, m in metrics.items()
                 if not math.isfinite(m["value"])]:
        log(f"[window] {name} is not finite (a failed request): left out")
        del metrics[name]
        result["correct"] = False
    result["kv_pages"] = kv_pages
    result["checks"] = checks
    for name, c in checks.items():
        bound = ", ".join(f"{k} {v}" for k, v in c.items() if k != "value")
        print(f"[check] {name} {c['value']} ({bound})", file=sys.stderr)
    return result
