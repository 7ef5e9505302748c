"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

The port's counterpart of ``repro.launch.serve --engine bucket|continuous``:
brings up a serving engine on a REDUCED variant of the architecture
(float32, as the reference serves reduced configs), with random weights
drawn from a fixed seed, serves a batch of byte-level prompts and
prints the completions and the throughput report.

``--engine bucket`` (the default, as in the reference) is the
length-bucket baseline over the ring cache; it serves every ported
arch, the hybrid RG-LRU stack of ``recurrentgemma-2b`` included (the
contiguous decode and RG-LRU scan kernels on the card).
``--engine continuous`` is the paged continuous-batching engine, for
uniform self-attention stacks.

It runs on the GPU (``--device cuda``, the default) and raises when no
GPU is present; ``--device cpu`` runs it on the CPU.  ``--arch tiny`` is
the benchmark suite's bench-tiny model.  Warm-up training is not ported
yet, so ``--warmup-steps`` must stay 0.

``--quant q4`` serves Q4_0 attention/MLP projections (the hand-written
Q4_0 GEMM on the card) and ``--kv-dtype int8`` int8 KV pages with
per-row scales (the int8 variant of the paged decode kernel); both go
through the continuous engine.

Examples:
    python -m repro_torch.launch.serve --arch recurrentgemma-2b
    python -m repro_torch.launch.serve --arch qwen3-1.7b --engine continuous
    python -m repro_torch.launch.serve --arch qwen3-1.7b --engine continuous \\
        --quant q4 --kv-dtype int8
    python -m repro_torch.launch.serve --arch gemma3-1b --engine continuous \\
        --max-running 4 --page-size 16 --prefill-chunk 8 --device cpu
"""

import argparse
import dataclasses
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--prompt", action="append", default=None)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="bucket engine: requests per length bucket")
    ap.add_argument("--engine", choices=("bucket", "continuous"),
                    default="bucket",
                    help="serving engine: the length-bucket baseline over "
                         "the ring cache, or the paged continuous-batching "
                         "engine")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; no GPU "
                         "raises instead of falling back to the CPU)")
    ap.add_argument("--max-running", type=int, default=4,
                    help="continuous engine: running-batch slots")
    ap.add_argument("--page-size", type=int, default=16,
                    help="continuous engine: KV page token slots")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="continuous engine: KV pool pages (default: "
                         "no-preemption sizing)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="continuous engine: prefill at most this many "
                         "prompt tokens per step (default: one-shot)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="continuous engine: disable prompt-prefix "
                         "page sharing")
    ap.add_argument("--quant", choices=("none", "q4"), default="none",
                    help="continuous engine: weight format — 'q4' packs "
                         "attention/MLP projections to Q4_0 at load")
    ap.add_argument("--kv-dtype", choices=("fp32", "int8"),
                    default="fp32",
                    help="continuous engine: KV page format — 'int8' "
                         "stores quantized pages with per-row scales "
                         "('fp32' keeps the model's dtype)")
    ap.add_argument("--warmup-steps", type=int, default=0,
                    help="LM warm-up training steps (not ported yet: "
                         "only 0 is accepted)")
    args = ap.parse_args(argv)
    if args.engine == "bucket" and (args.quant != "none"
                                    or args.kv_dtype != "fp32"):
        ap.error("--quant/--kv-dtype serve through the paged engine; "
                 "use --engine continuous")
    if args.warmup_steps:
        ap.error("--warmup-steps: training is not ported yet; use 0")

    import torch

    from ..configs import BENCH_TINY, get_config, list_archs
    from ..data.tokenizer import ByteTokenizer
    from ..models import build_model, reduced_config
    from ..quant import QuantPolicy
    from ..serving import (ContinuousServingEngine, Request, ServingEngine,
                           throughput_report)
    from ..serving.runner import resolve_device
    from ..serving.sampler import SamplingParams

    device = resolve_device(args.device)
    if args.arch == "tiny":
        cfg = BENCH_TINY
    elif args.arch not in list_archs():
        ap.error(f"unknown arch; choose 'tiny' or one of {list_archs()}")
    else:
        cfg = reduced_config(get_config(args.arch))
        cfg = dataclasses.replace(cfg, dtype=torch.float32,
                                  vocab_size=max(cfg.vocab_size, 259))
    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = model.init(gen)
    tok = ByteTokenizer()
    print(f"arch={cfg.name} (reduced, {cfg.param_count() / 1e6:.1f}M) "
          f"on {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))

    prompts = args.prompt or ["the scheduler binds", "a numa node",
                              "the kv cache streams", "one thread gathers"]
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        max_new_tokens=args.max_new)
    reqs = [Request(uid=i, prompt=tok.encode(p), sampling=sp)
            for i, p in enumerate(prompts)]
    max_len = max(len(r.prompt) for r in reqs) + args.max_new + 8
    quant = None
    if args.quant != "none" or args.kv_dtype != "fp32":
        quant = QuantPolicy(weights=args.quant, kv_dtype=args.kv_dtype)
        print(f"quant: weights={quant.weights} kv_dtype={quant.kv_dtype}")
    if args.engine == "continuous":
        eng = ContinuousServingEngine(
            model, params, max_len=max_len, max_running=args.max_running,
            page_size=args.page_size, n_pages=args.n_pages,
            prefill_chunk=args.prefill_chunk,
            prefix_cache=not args.no_prefix_cache, quant=quant,
            device=device)
        comps = eng.generate(reqs)
        st = eng.pool.stats
        print(f"kv pool: {st['fresh_pages']} pages allocated, "
              f"{st['shared_pages']} shared, {st['cow_copies']} CoW, "
              f"{st['cached_tokens']} prompt tokens served from cache")
    else:
        eng = ServingEngine(model, params, max_len=max_len, device=device)
        comps = eng.generate(reqs, max_batch=args.max_batch)
    for c, p in zip(comps, prompts):
        print(f"[{c.uid}] {p!r} -> {tok.decode(c.tokens)!r}")
    rep = throughput_report(comps, **eng.last_phase_s)
    print("throughput:", {k: round(v, 2) if isinstance(v, float) else v
                          for k, v in rep.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
