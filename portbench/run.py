"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout: the cells, configurations, mixes and
metrics are named in ``BENCHMARK.json`` there, the port is imported from
``src/repro_torch``, and its kernels build into ``build/kernels`` there.
Needs one CUDA device; prints earlier lines of its own, then the checks
on standard error, then the result as one JSON object, the last line of
standard output.  Exits non-zero, and prints no result, without a card,
or if anything of JAX or of the JAX package is loaded once the window has
closed.
"""

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names a run must never load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def startup_s() -> float:
    """Seconds from the process's creation to now, from /proc."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # seconds before this module's first line ran
    t_startup = startup_s() - (time.perf_counter() - T_PROC0)
    # every cache the run writes stays inside the checkout, at fixed paths
    build = ROOT / "build" / "portbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from portbench import harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.find(bench["workloads"], args.workload, "workload")
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < int(cell["chips"]):
        print(f"error: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {seen}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T_PROC0,
                              startup_s=t_startup)
    bad = forbidden_loaded()
    if bad:
        print(f"error: the run loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
