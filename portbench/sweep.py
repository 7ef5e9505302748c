"""Sweep an open-loop cell's arrival rate to find its knee: the highest
rate of its arrival path at which the engine holds no growing backlog
through the window.

    python3 portbench/sweep.py --workload qwen3-1.7b.chat --seed 7 \\
        --seconds 30 --rates 3,4,5,6,7

One process: the engine is built and warmed once, then each rate runs its
own ramp and window of the cell's mix (``rate_per_s`` replaced).  For
each rate it prints the requests due and finished in the window, the
queue of requests due but not yet given a slot at the window's start,
middle and end, and the end-to-end metrics.
Requests still in flight when a rate's window closes are cancelled.  A
cell's mix takes 0.8 x the knee as its ``rate_per_s``.
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def queued(records, t: float) -> int:
    """Requests due by ``t`` that had no slot yet at ``t``."""
    return sum(1 for r in records if r.t_start <= t
               and (r.t_sched is None or r.t_sched > t))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", required=True,
                    help="comma-separated requests per second")
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from portbench import harness, loadgen, mixes, serve
    from portbench.metrics import percentile

    if not torch.cuda.is_available():
        print("error: the sweep needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    bench = harness.load_benchmark(ROOT)
    cell = harness.find(bench["workloads"], args.workload, "workload")
    cfg = serve.load_config(cell["config"])
    mix = mixes.load_mix(cell["traffic"])
    if mix["loop"] != "open":
        print("error: only an open-loop cell has a rate", file=sys.stderr)
        return 2
    print(f"[sweep] {args.workload}: {harness.card_facts('cuda:0')}")
    engine, params, mc, facts = serve.build_engine(cfg, args.seed, "cuda:0")
    rates = [float(x) for x in args.rates.split(",")]
    harness.warm(engine, mixes.build(dict(mix, rate_per_s=max(rates)),
                                     mc.vocab_size, args.seed, args.seconds),
                 cfg, mc.vocab_size, args.seed)

    for rate in rates:
        # the set-up's seed: the documents warmed are the ones asked for
        traffic = mixes.build(dict(mix, rate_per_s=rate), mc.vocab_size,
                              args.seed, args.seconds)
        gen = loadgen.LoadGen(engine, traffic, harness.make_request)
        t0 = time.perf_counter()
        t_w0, t_w1 = t0 + traffic.ramp_s, t0 + traffic.ramp_s + args.seconds
        gen.start(t0, t_stop=t_w1)
        harness._sleep_until(t_w0)
        before = loadgen.counters(engine.registry)
        harness._sleep_until(t_w1)
        after = loadgen.counters(engine.registry)
        gen.join(timeout=60)
        harness.settle(engine, gen.records)
        run = harness.Run(cfg=cfg, t_w0=t_w0, t_w1=t_w1,
                          records=gen.records, before=before, after=after,
                          setup_s=0.0)
        vals = {m: harness.read_metric(m, run) for m in (
            "output_tok_s", "ttft_p90_ms_chat", "itl_p95_ms",
            "queue_wait_p90_ms", "batch_occupancy_mean",
            "decode_step_wall_ms")}
        due = [r for r in gen.records if t_w0 <= r.t_start < t_w1]
        ttft = [r.stamps[0] - r.t_start for r in due
                if r.stamps and r.stamps[0] < t_w1]
        print(f"[sweep] rate {rate} req/s: {len(due)} due in the window, "
              f"{sum(1 for r in due if r.finished)} finished; queued at "
              f"start/middle/end {queued(gen.records, t_w0)}/"
              f"{queued(gen.records, (t_w0 + t_w1) / 2)}/"
              f"{queued(gen.records, t_w1)}; ttft p50 "
              f"{percentile(ttft, 50) * 1e3 if ttft else float('nan'):.1f} ms;"
              f" {' '.join(f'{k} {v:.2f}' for k, v in vals.items() if v is not None)}",
              flush=True)
        # end this rate: cancel what is still in flight
        for r in gen.records:
            engine.cancel(r.handle)
        while engine.core.has_work():
            time.sleep(0.05)
    engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
