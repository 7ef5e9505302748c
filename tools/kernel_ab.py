#!/usr/bin/env python3
"""Time the contiguous decode-attention kernel, the Q4_0 GEMM and the RG-LRU
scan of one tree on a GPU, at the shapes of their main paths.

    python tools/kernel_ab.py TREE [--only da|q4|rs|pf] [--clean] [MOD.NAME=VAL ...]

TREE is the root of a checkout (``.`` for this one, or an unpacked older
commit), so that two versions can be timed in turns in one process run
each on the same card.  ``--clean`` deletes TREE's built kernels first (so
nvcc's register report is printed); ``da.NAME=VALUE`` / ``qg.NAME=VALUE`` /
``rs.NAME=VALUE`` override a plan constant of
``kernels/decode_attention.py`` / ``kernels/q4_gemm.py`` /
``kernels/rglru_scan.py`` (for example ``qg.Q4_MAX_SPLIT=16`` or
``rs.SCAN_STEPS=(8,)``; values are Python literals).  The scan is timed
at (B, T, W) = (4, 512, 2560), (4, 256, 2560), (1, 512, 2560) and
(1, 2048, 2560) with a zero h0, as a prefill runs it.  ``--only pf``
instead profiles one full-width RecurrentGemma-2B prefill of the
512-token bucket (B=4, random seeded weights) with TREE's package: device
time by kernel, the scan's share of it, and the host wall time per call.

For each shape it prints ``[ab]`` with the mean device time per call from
``chip_smoke.cuda_ms`` (inputs rotated past the L2) and the wrapper's plan,
and ``[prof]`` with the device time per call by kernel name from
``torch.profiler`` (one input, so L2-warm); the last line is the ``[ab]``
results as JSON.  Needs a CUDA device; imports nothing of JAX.
"""

import argparse
import ast
import json
import math
import shutil
import sys
import time
from pathlib import Path


def prof(torch, fn, label, n=30):
    """Print the device microseconds per call of ``fn`` by kernel name, and
    return them."""
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
    out = {e.key: round(e.device_time_total / n, 2)
           for e in pr.key_averages()
           if e.device_type == DeviceType.CUDA and e.device_time_total > 0}
    print(f"[prof] {label}: { {k[:60]: v for k, v in out.items()} }",
          flush=True)
    return out


def prefill(torch, gen):
    """Device microseconds of one full-width RecurrentGemma-2B prefill of
    four 512-token prompts, the scan's among them, and the median host
    milliseconds per synchronised call."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("recurrentgemma-2b")
    model = build_model(cfg)
    params = model.init(gen)
    toks = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen,
                         device="cuda")
    cache = model.init_cache(4, 560, device="cuda")

    def call():
        model.prefill(params, {"tokens": toks}, cache)

    by_kernel = prof(torch, call, "prefill B=4 T=512", n=2)
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    busy = sum(by_kernel.values())
    scan = sum(us for k, us in by_kernel.items() if "rglru_scan" in k)
    return (round(busy, 1), round(scan, 1),
            round(sorted(walls)[len(walls) // 2], 2))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree")
    ap.add_argument("--only", choices=("da", "q4", "rs", "pf"))
    ap.add_argument("--clean", action="store_true")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_intermixed_args()
    root = Path(args.tree).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import q4_gemm as qg
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.quant import q4_0
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    if args.clean:
        shutil.rmtree(root / "build" / "kernels", ignore_errors=True)
    mods = {"da": da, "qg": qg, "rs": rs}
    for kv in args.overrides:
        name, val = kv.split("=")
        mod, attr = name.split(".")
        setattr(mods[mod], attr, ast.literal_eval(val))
    print(f"[ab] tree {root}, overrides {args.overrides}", flush=True)
    names = {"da": (da.CONTIGUOUS_KERNEL,), "q4": (qg.KERNEL,),
             "rs": (rs.KERNEL,), "pf": (rs.KERNEL,),
             None: (da.CONTIGUOUS_KERNEL, qg.KERNEL, rs.KERNEL)}[args.only]
    run = {k: args.only in (None, k) for k in ("da", "q4", "rs")}
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
    for B, S, kv_len in da_shapes if run["da"] else ():
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
    for K, N in sorted(set(cs.Q4_PROJ.values())) if run["q4"] else ():
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
    for B, T, W in ((4, 512, 2560), (4, 256, 2560), (1, 512, 2560),
                    (1, 2048, 2560)) if run["rs"] else ():
        n = max(2, math.ceil(cs.ROTATE_BYTES / (2 * B * T * W * 4)))
        As = [0.5 + 0.5 * torch.rand(B, T, W, generator=gen, device="cuda")
              for _ in range(n)]
        Us = [torch.randn(B, T, W, generator=gen, device="cuda")
              for _ in range(n)]
        h0 = torch.zeros(B, W, device="cuda")
        t = cs.cuda_ms(torch, lambda i: rs.rglru_scan(As[i % n], Us[i % n],
                                                      h0), 100)
        res[f"rs B={B} T={T} W={W}"] = (round(t * 1e3, 2),
                                        getattr(rs.rglru_scan, "plan", None))
        prof(torch, lambda: rs.rglru_scan(As[0], Us[0], h0),
             f"rs B={B} T={T} W={W}")
        del As, Us
    if args.only == "pf":
        res["pf device us, scan us, wall ms"] = prefill(torch, gen)
    if run["q4"]:
        res["q4 M=8 mean of 7"] = round(sum(
            res[f"q4 M=8 K={K} N={N}"][0]
            for K, N in cs.Q4_PROJ.values()) / 7, 2)
    for k, v in res.items():
        print(f"[ab] {k}: {v}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
