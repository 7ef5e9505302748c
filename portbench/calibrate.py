"""Readings that a cell's ``logit_gap`` limit is set from: for each seed,
one whole run of the cell (its own load and window) and, on the same
sampled requests, the control: the reference computed in fp8 put in the
program's place (``portbench.check.control_gap``).

    python3 portbench/calibrate.py --workload qwen3-1.7b.chat \\
        --seconds 30 --seeds 11,12,13

All seeds run in one process, each with its own weights, engine and
traffic.  Prints one line a seed: the program's gap, the control's gap,
and the limit the configuration states; then the largest program gap and
the smallest control gap.  Benchmark runs never compute the control.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("error: calibration needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    bench = harness.load_benchmark(ROOT)
    prog, ctrl = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run_cell(bench, args.workload, seed, args.seconds,
                               False, "cuda:0", time.perf_counter(),
                               control=True, log=lambda *a: None)
        gc.collect()                # this seed's weights, before the next
        torch.cuda.empty_cache()
        (stat, gap), = [(k, v) for k, v in res["checks"].items()
                        if k.startswith("logit_gap")]
        prog.append(res["gaps"])
        ctrl.append(res["control"])
        print(f"[calibrate] {args.workload} seed {seed}: program "
              f"{json.dumps(res['gaps'])}, control "
              f"{json.dumps(res['control'])}, bf16 witness "
              f"{json.dumps(res['witness'])}; compared {stat} against "
              f"{gap['max']}: correct {res['correct']}; look "
              f"{json.dumps(res.get('look'))}; "
              f"{json.dumps(res['metrics'])}", flush=True)
    for stat in ("logit_gap", "logit_gap_mean"):
        print(f"[calibrate] {args.workload} {stat}: program max "
              f"{max(p[stat] for p in prog):.6f} over {len(prog)} seeds, "
              f"control min {min(c[stat] for c in ctrl):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
