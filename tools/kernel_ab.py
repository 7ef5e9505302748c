#!/usr/bin/env python3
"""Time the contiguous decode-attention kernel and the Q4_0 GEMM of one tree
on a GPU, at the shapes of their main paths.

    python tools/kernel_ab.py TREE [--only da|q4] [--clean] [MOD.NAME=VAL ...]

TREE is the root of a checkout (``.`` for this one, or an unpacked older
commit), so that two versions can be timed in turns in one process run
each on the same card.  ``--clean`` deletes TREE's built kernels first (so
nvcc's register report is printed); ``da.NAME=VALUE`` / ``qg.NAME=VALUE``
override a plan constant of ``kernels/decode_attention.py`` /
``kernels/q4_gemm.py`` (for example ``qg.Q4_MAX_SPLIT=16``).

For each shape it prints ``[ab]`` with the mean device time per call from
``chip_smoke.cuda_ms`` (inputs rotated past the L2) and the wrapper's plan,
and ``[prof]`` with the device time per call by kernel name from
``torch.profiler`` (one input, so L2-warm); the last line is the ``[ab]``
results as JSON.  Needs a CUDA device; imports nothing of JAX.
"""

import argparse
import json
import math
import shutil
import sys
from pathlib import Path


def prof(torch, fn, label, n=30):
    """Print the device microseconds per call of ``fn`` by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as pr:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {e.key[:60]: round(e.device_time_total / n, 2)
           for e in pr.key_averages()
           if e.device_type == DeviceType.CUDA and e.device_time_total > 0}
    print(f"[prof] {label}: {out}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree")
    ap.add_argument("--only", choices=("da", "q4"))
    ap.add_argument("--clean", action="store_true")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args()
    root = Path(args.tree).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import q4_gemm as qg
    from repro_torch.quant import q4_0
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    if args.clean:
        shutil.rmtree(root / "build" / "kernels", ignore_errors=True)
    mods = {"da": da, "qg": qg}
    for kv in args.overrides:
        name, val = kv.split("=")
        mod, attr = name.split(".")
        setattr(mods[mod], attr, type(getattr(mods[mod], attr))(val))
    print(f"[ab] tree {root}, overrides {args.overrides}", flush=True)
    names = {"da": (da.CONTIGUOUS_KERNEL,), "q4": (qg.KERNEL,),
             None: (da.CONTIGUOUS_KERNEL, qg.KERNEL)}[args.only]
    for name in names:
        build.load(name)
        for line in str(build.build_record(name)["ptxas"]).splitlines():
            if "registers" in line or "spill" in line:
                print("[ptxas]", name, line.strip())

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    res = {}
    H, G, D = 1, 10, 256
    da_shapes = ((4, 560, 544), (4, 560, 288), (8, 560, 544),
                 (4, 2064, 2048), (8, 2064, 2048))
    for B, S, kv_len in da_shapes if args.only != "q4" else ():
        n = max(2, math.ceil(cs.ROTATE_BYTES / (2 * B * S * H * D * 2)))
        q = torch.randn(B, H, G, D, generator=gen,
                        device="cuda").to(torch.bfloat16)
        ks, vs = ([torch.randn(B, S, H, D, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(n)] for _ in range(2))
        pos = cs.ring_positions(torch, kv_len, S)
        kw = dict(kv_positions=pos, q_pos=kv_len - 1, window=2048)
        t = cs.cuda_ms(torch, lambda i: da.decode_attention(
            q, ks[i % n], vs[i % n], **kw), 300)
        res[f"da B={B} S={S} kv={kv_len}"] = (
            round(t * 1e3, 2), getattr(da.decode_attention, "plan", None))
        prof(torch, lambda: da.decode_attention(q, ks[0], vs[0], **kw),
             f"da B={B} kv={kv_len}")
        del ks, vs
    for K, N in sorted(set(cs.Q4_PROJ.values())) if args.only != "da" else ():
        w = torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K)
        packed, scales = q4_0.quantize(w)
        nq = max(2, math.ceil(cs.ROTATE_BYTES
                              / (packed.numel() + scales.numel() * 4)))
        qw = [(packed.clone(), scales.clone()) for _ in range(nq)]
        for M in (8, 128):
            x = torch.randn(M, K, generator=gen,
                            device="cuda").to(torch.bfloat16)
            t = cs.cuda_ms(torch, lambda i: qg.q4_gemm(x, *qw[i % nq]),
                           200 if M == 8 else 50)
            res[f"q4 M={M} K={K} N={N}"] = (round(t * 1e3, 2),
                                            getattr(qg.q4_gemm, "plan", None))
            prof(torch, lambda: qg.q4_gemm(x, *qw[0]), f"q4 M={M} K={K} N={N}")
        del qw
    if args.only != "da":
        res["q4 M=8 mean of 7"] = round(sum(
            res[f"q4 M=8 K={K} N={N}"][0]
            for K, N in cs.Q4_PROJ.values()) / 7, 2)
    for k, v in res.items():
        print(f"[ab] {k}: {v}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
