"""Dry run of the production meshes against H100 peaks
(``repro.launch.dryrun``).

For every (architecture x input shape x mesh): build the case on meta
tensors (``launch.specs.build_case``), count its step
(``launch.step_cost``) and print its per-device argument bytes against
one H100's 80 GB and its roofline (``launch.roofline``).

This is the one entry point of the port that does not default to the
card: it runs on **meta** tensors only, allocates nothing and touches no
device, because a production mesh (256 or 512 GPUs) is not there to run
on.  The reference forces 512 host devices and compiles with GSPMD; the
port has no partitioner, so its FLOPs are the global count split evenly
(a lower bound) and its collectives come from the plan's rules.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out F]

``--all`` ends with the reports as a markdown table.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Optional

from ..configs import SHAPES, list_archs
from .mesh import HBM_PER_CHIP, make_production_mesh
from .roofline import RooflineReport, analyse, format_table
from .shardings import Policy
from .specs import build_case


def run_case(arch: str, shape: str, *, multi_pod: bool = False,
             policy: Optional[Policy] = None) -> RooflineReport:
    t0 = time.time()
    case = build_case(arch, shape, make_production_mesh(multi_pod=multi_pod),
                      policy=policy)
    report = analyse(case)
    print(f"== {arch} x {shape} x {report.mesh} "
          f"(count {time.time() - t0:.1f}s, note={case.note or '-'})")
    print(f"   memory: arguments {report.bytes_per_device / 2**30:.2f} GiB "
          f"+ outputs "
          f"{(report.mem_bytes - report.bytes_per_device) / 2**30:.2f} GiB "
          f"per device, of {HBM_PER_CHIP / 1e9:.0f} GB (activations not "
          f"counted)")
    print(f"   roofline: compute={report.t_compute:.3e}s "
          f"memory={report.t_memory:.3e}s "
          f"collective={report.t_collective:.3e}s "
          f"dominant={report.dominant} "
          f"useful={report.useful_flops_ratio:.2f}")
    print(f"   collectives: "
          f"{ {k: int(v) for k, v in report.coll_breakdown.items()} }")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) pair")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 multi-pod mesh")
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--expert-parallel", action="store_true")
    ap.add_argument("--no-seq-shard", action="store_true")
    args = ap.parse_args(argv)

    policy = Policy(fsdp=not args.no_fsdp,
                    expert_parallel=args.expert_parallel,
                    seq_shard_cache=not args.no_seq_shard)
    if args.all:
        pairs = [(a, s) for a in list_archs() for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape required unless --all")
        pairs = [(args.arch, args.shape)]

    reports, failures = [], []
    for arch, shape in pairs:
        try:
            reports.append(run_case(arch, shape, multi_pod=args.multi_pod,
                                    policy=policy))
        except Exception as e:  # noqa: BLE001 — report, keep sweeping
            traceback.print_exc()
            failures.append({"arch": arch, "shape": shape,
                             "error": f"{type(e).__name__}: {e}"})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": [r.to_dict() for r in reports],
                       "failures": failures}, f, indent=1)
        print(f"wrote {args.out}")
    if args.all:
        print(format_table(reports))
    print(f"\n{len(reports)} ok, {len(failures)} failed")
    for f_ in failures:
        print("  FAIL", f_["arch"], f_["shape"], f_["error"][:200])
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
