#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # from the root of a checkout

Drives the port's main path (``src/repro_torch``) on the card and exits
non-zero if any phase fails, or if no CUDA device is present:

1. card: torch / CUDA versions and the card's name and power limit;
2. build: compile the paged decode-attention kernel from
   ``src/repro_torch/csrc`` with nvcc for sm_90a;
3. kernel vs plain version on the card, at the serving path's shapes
   (B=8, 16 query / 8 kv heads, D=128, 16-token bf16 pages, kv_len from
   0 to 2048, windows 0 and 7, softcap 0 and 30) and at the bench-tiny
   shapes (4 / 2 heads, D=32, f32 pages);
4. kernel timing with CUDA events at B=8, kv_len 1024 and 4096, beside
   the plain version, the byte bound and, as a yardstick the port never
   calls, ``scaled_dot_product_attention`` over pre-gathered K/V;
5. serve full-width Qwen3-1.7B (28 layers, bf16, weights drawn from a
   seeded ``torch.Generator``) through ``ContinuousServingEngine``: 8
   requests, prompts of 128-512 random tokens, two sharing a 256-token
   prefix, prefill in 128-token chunks, 32 greedy tokens each; checks
   the completions and that the kernel ran 28 times per decode step;
6. decode parity: from one cache state after the prefills, one decode
   step with the kernel and one with the plain version on a clone of
   the cache; logits must agree; then the kernel is timed on that
   state, cycling the 28 layers' pages as a decode step does.

It prints one JSON line ``{"kernels": [...]}`` before the last line, and
as the last line ``{"ok": true, "device": {...}}``.  Nothing here
imports JAX or the reference package.
"""

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: kernel vs plain version: both read the same page values (bf16 -> f32
#: is exact) and compute in f32; only the summation order and the online
#: softmax rescaling differ, each worth ~1e-6 at these lengths
KERNEL_TOL = 1e-5
#: a bf16 query gets a bf16 result: the kernel rounds its f32 value to
#: nearest, which moves it by at most half a bf16 ulp (2**-8 of its size)
#: beyond KERNEL_TOL
BF16_HALF_ULP = 2.0 ** -8
#: decode logits, kernel vs plain version, full width in bf16: the two
#: attention outputs differ by ~1e-6 in f32 but are rounded to bf16, so
#: an element may land one bf16 ulp (2**-8 relative) apart; 28 layers of
#: bf16 residual arithmetic carry such flips into logits of size ~1
LOGIT_TOL = 0.125


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn(i)`` over ``iters`` calls."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(lens_sum: int, B: int, Hkv: int, G: int, D: int, max_pages: int,
          itemsize: int, dtype_name: str):
    """Least time (ms) the card could take for one paged decode-attention
    call: each valid K/V row read once, q read, out written (all of
    ``itemsize`` bytes), block table and lengths read — or the flops at
    the input type's peak."""
    nbytes = (lens_sum * Hkv * D * 2 * itemsize
              + 2 * B * Hkv * G * D * itemsize + B * max_pages * 4 + B * 4)
    flops = 4 * lens_sum * Hkv * G * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def check(torch, got, want, live, what: str) -> float:
    """Max |kernel - plain| over live lanes; fails if any lane is not
    finite or a value is off by more than KERNEL_TOL (plus half a bf16
    ulp of the plain value when the result is bf16)."""
    if not bool(torch.isfinite(got).all()):
        fail(f"{what}: non-finite output")
    want = want.float()
    err = (got.float() - want)[live].abs()
    tol = KERNEL_TOL + (BF16_HALF_ULP * want[live].abs()
                        if got.dtype == torch.bfloat16 else 0.0)
    if not bool((err <= tol).all()):
        fail(f"{what}: kernel disagrees with the plain version "
             f"(max {err.max().item():.3e})")
    return err.max().item()


def plain(ref, q, *args, **kw):
    """The kernel's plain version, its result in q's type like the
    kernel's."""
    return ref.paged_decode_attention_ref(q, *args, **kw).to(q.dtype)


def make_case(torch, gen, *, B, Hkv, G, D, ps, max_pages, lens, dtype,
              copies=1):
    """q, page pools and ``copies`` block tables over disjoint shuffled
    pages (copies > 1 lets a timing loop rotate past the 50 MB L2)."""
    dev = "cuda"
    n_pages = 1 + copies * B * max_pages
    q = torch.randn(B, Hkv, G, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(n_pages, ps, Hkv, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(n_pages, ps, Hkv, D, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bts = perm.reshape(copies, B, max_pages).to(torch.int32)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, k, v, list(bts), kv_lens


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch under {ROOT}: run chip_smoke.py from the "
             "root of a checkout of the repository")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "an NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 1. card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi gave nothing"
    kind = torch.cuda.get_device_name(0)
    print(f"[card] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    print(f"[card] {card}", flush=True)

    from repro_torch.kernels import build, ref
    from repro_torch.kernels import decode_attention as da
    kernel = da.paged_decode_attention

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    build.load(da.KERNEL)
    rec = build.build_record(da.KERNEL)
    print(f"[build] {da.KERNEL}: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {rec['seconds']:.2f} s, cached={rec['cached']})")
    for line in str(rec["ptxas"]).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    max_err = 0.0

    # -- 3. kernel vs plain version --------------------------------------
    main_lens = [0, 1, 16, 17, 300, 1023, 1500, 2048]
    cases = [
        ("serve", dict(B=8, Hkv=8, G=2, D=128, ps=16, max_pages=128,
                       lens=main_lens, dtype=torch.bfloat16)),
        ("bench-tiny", dict(B=8, Hkv=2, G=2, D=32, ps=16, max_pages=16,
                            lens=[0, 1, 16, 17, 40, 100, 255, 256],
                            dtype=torch.float32)),
    ]
    # q in f32 (f32 result: KERNEL_TOL alone) and, where the pages are
    # bf16, also in bf16 as the serving path passes it (bf16 result)
    for name, shape in cases:
        q, k, v, (bt,), lens = make_case(torch, gen, **shape)
        live = lens > 0
        for q_dtype in dict.fromkeys((torch.float32, shape["dtype"])):
            qq = q.to(q_dtype)
            for window in (0, 7):
                for softcap in (0.0, 30.0):
                    got = kernel(qq, k, v, bt, lens, window,
                                 softcap=softcap)
                    torch.cuda.synchronize()
                    want = ref.paged_decode_attention_ref(
                        qq, k, v, bt, lens, window, softcap=softcap)
                    what = (f"{name} q {q_dtype} pages {shape['dtype']} "
                            f"window={window} softcap={softcap}")
                    err = check(torch, got, want, live, what)
                    max_err = max(max_err, err)
                    print(f"[kernel] {what}: max|kernel-plain| {err:.3e}")

    # -- 4. kernel timing ------------------------------------------------
    import torch.nn.functional as F
    timings = {}
    for L in (1024, 4096):
        B, Hkv, G, D, ps = 8, 8, 2, 128, 16
        mp = L // ps
        q, k, v, bts, lens = make_case(
            torch, gen, B=B, Hkv=Hkv, G=G, D=D, ps=ps, max_pages=mp,
            lens=[L] * B, dtype=torch.bfloat16, copies=4)
        n = len(bts)
        t_k = cuda_ms(torch, lambda i: kernel(q, k, v, bts[i % n], lens),
                      200)
        t_p = cuda_ms(torch, lambda i: plain(ref, q, k, v, bts[i % n], lens),
                      20)
        # yardstick only: the library call over K/V gathered contiguous
        # beforehand (the gather is not timed)
        qs = q.reshape(B, Hkv * G, 1, D)
        kc = [k[bt.long()].reshape(B, L, Hkv, D).transpose(1, 2).contiguous()
              for bt in bts]
        vc = [v[bt.long()].reshape(B, L, Hkv, D).transpose(1, 2).contiguous()
              for bt in bts]
        t_l = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
            qs, kc[i % n], vc[i % n], enable_gqa=True), 200)
        b_ms, b_by = bound(B * L, B, Hkv, G, D, mp, 2, "bfloat16")
        timings[L] = (t_k, t_p, t_l, b_ms)
        print(f"[timing] B={B} kv_len={L} bf16 D={D}: kernel "
              f"{t_k * 1e3:.1f} us, plain {t_p * 1e3:.1f} us, sdpa "
              f"(pre-gathered, gather excluded) {t_l * 1e3:.1f} us, bound "
              f"{b_ms * 1e3:.1f} us ({b_by}) — {card}")
        del q, k, v, kc, vc

    # -- 5. serve full-width Qwen3-1.7B ---------------------------------
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import (ContinuousServingEngine, Request,
                                     SamplingParams, throughput_report)
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("qwen3-1.7b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    wgen = torch.Generator(device="cuda")
    wgen.manual_seed(0)
    params = model.init(wgen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {n_params / 1e9:.3f} B params in {cfg.dtype} "
          f"({time.perf_counter() - t0:.1f} s to draw)")
    rng = np.random.default_rng(0)
    V = cfg.vocab_size
    prefix = rng.integers(0, V, 256).tolist()
    lens_p = [128, 200, 256 + 64, 256 + 160, 384, 448, 500, 512]
    prompts = [rng.integers(0, V, n).tolist() for n in lens_p]
    prompts[2] = prefix + prompts[2][256:]
    prompts[3] = prefix + prompts[3][256:]
    sp = SamplingParams(max_new_tokens=32)
    eng = ContinuousServingEngine(model, params, max_len=1024, max_running=8,
                                  page_size=16, prefill_chunk=128, seed=0,
                                  device="cuda")
    # warm-up: one request over the shared prefix; its prompt pages stay
    # in the pool's retention LRU, so the two prefix-sharing requests of
    # the measured run hit the prefix cache
    eng.generate([Request(uid=100, prompt=prefix + [1, 2, 3],
                          sampling=SamplingParams(max_new_tokens=2))])
    occ = eng.registry.get("serving.batch.occupancy")
    steps0 = occ.value()[1]
    st0 = dict(eng.pool.stats)
    reqs = [Request(uid=i, prompt=p, sampling=sp)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    kernel.launches = 0                     # count the main path only
    comps = eng.generate(reqs)
    torch.cuda.synchronize()
    launches = kernel.launches
    decode_steps = int(occ.value()[1] - steps0)
    peak = torch.cuda.max_memory_allocated()
    st = {k_: eng.pool.stats[k_] - st0.get(k_, 0) for k_ in eng.pool.stats}
    if len(comps) != len(reqs):
        fail(f"{len(comps)} of {len(reqs)} requests completed")
    for c in comps:
        if len(c.tokens) != 32 or not all(0 <= t < V for t in c.tokens):
            fail(f"request {c.uid}: {len(c.tokens)} tokens, in vocab: "
                 f"{all(0 <= t < V for t in c.tokens)}")
    if decode_steps <= 0 or launches != cfg.n_layers * decode_steps:
        fail(f"kernel launches {launches} != {cfg.n_layers} x "
             f"{decode_steps} decode steps")
    if st["cached_tokens"] < 2 * 256 or st["shared_pages"] < 32:
        fail(f"prefix cache not exercised: {st}")
    rep = throughput_report(comps, **eng.last_phase_s)
    ttft = sorted(c.t_first - c.t0 for c in comps)
    print(f"[serve] {len(comps)} requests x 32 tokens; {decode_steps} "
          f"decode steps, kernel launches {launches} = {cfg.n_layers} x "
          f"{decode_steps}; prefix cache: {st['cached_tokens']} tokens, "
          f"{st['shared_pages']} shared pages")
    print(f"[serve] decode {rep['decode_tok_per_s']:.1f} tok/s, prefill "
          f"{rep['prefill_tok_per_s']:.1f} tok/s, wall {rep['wall_s']:.3f} s, "
          f"TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms max "
          f"{ttft[-1] * 1e3:.1f} ms, peak memory {peak / 2**30:.2f} GiB — "
          f"{card}", flush=True)

    # -- 6. decode parity on the card ------------------------------------
    runner = eng.runner
    ps, B = 16, 8
    cache = model.init_cache(B, 1024, page_size=ps, device="cuda")
    mp = cache["block_tables"].shape[1]
    perm = torch.randperm(B * mp, generator=gen, device="cuda") + 1
    cache["block_tables"].copy_(perm.reshape(B, mp).to(torch.int32))
    fed = np.zeros((B, 1), np.int64)
    for b, p in enumerate(prompts):
        Sp = 1 << max(3, (len(p) - 1).bit_length())
        toks = torch.zeros((1, Sp), dtype=torch.long, device="cuda")
        toks[0, :len(p)] = torch.tensor(p, device="cuda")
        logits, _ = model.prefill_paged(runner.params, {"tokens": toks},
                                        cache, b, len(p), page_size=ps)
        fed[b, 0] = int(logits[0, -1].float().argmax())
    pos = torch.tensor([len(p) for p in prompts], device="cuda")
    clone = {"block_tables": cache["block_tables"].clone(),
             "layers": [{"self": {n_: t.clone() for n_, t in
                                  layer["self"].items()}}
                        for layer in cache["layers"]]}
    fed_t = torch.from_numpy(fed).cuda()
    got, _ = model.decode_step(runner.params, cache, fed_t, pos,
                               page_size=ps)
    want, _ = model.decode_step(runner.params, clone, fed_t, pos,
                                page_size=ps, impl="ref")
    got, want = got[:, 0].float(), want[:, 0].float()
    dlog = (got - want).abs().max().item()
    top2 = want.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    clear = margin > LOGIT_TOL
    same = bool((got.argmax(-1) == want.argmax(-1))[clear].all())
    print(f"[parity] full-width decode logits, kernel vs plain: max|d| "
          f"{dlog:.4f} (tol {LOGIT_TOL}); argmax equal on "
          f"{int(clear.sum())}/{B} lanes with top-2 margin > tol: {same}")
    if not (math.isfinite(dlog) and dlog <= LOGIT_TOL and same):
        fail("decode parity failed")

    # the kernel at the serving path's own inputs: this state's block
    # table and lengths, cycling the 28 layers' pools as one decode step
    # does (so K/V come from HBM, not L2)
    lens = (pos + 1).to(torch.int32)
    bt = cache["block_tables"]
    pools = [(layer["self"]["k"].view(-1, ps, cfg.n_kv_heads, 128),
              layer["self"]["v"].view(-1, ps, cfg.n_kv_heads, 128))
             for layer in cache["layers"]]
    qd = torch.randn(B, cfg.n_kv_heads, 2, 128, generator=gen,
                     device="cuda").to(torch.bfloat16)
    nl = len(pools)
    out_k = kernel(qd, *pools[0], bt, lens)
    out_p = ref.paged_decode_attention_ref(qd, *pools[0], bt, lens)
    torch.cuda.synchronize()
    err6 = check(torch, out_k, out_p, lens > 0, "serving state")
    max_err = max(max_err, err6)
    print(f"[kernel] serving state, q and pages bf16: max|kernel-plain| "
          f"{err6:.3e}")
    t_k = cuda_ms(torch, lambda i: kernel(qd, *pools[i % nl], bt, lens),
                  10 * nl)
    t_p = cuda_ms(torch, lambda i: plain(ref, qd, *pools[i % nl], bt, lens),
                  nl)
    L = mp * ps
    mask = (torch.arange(L, device="cuda")[None, :] < lens[:, None].long()
            ).reshape(B, 1, 1, L)
    gathered = [tuple(t[bt.long()].reshape(B, L, cfg.n_kv_heads, 128)
                      .transpose(1, 2).contiguous() for t in kv)
                for kv in pools]
    qs = qd.reshape(B, cfg.n_heads, 1, 128)
    t_l = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
        qs, *gathered[i % nl], attn_mask=mask, enable_gqa=True), 10 * nl)
    del gathered
    b_ms, b_by = bound(int(lens.sum()), B, cfg.n_kv_heads, 2, 128, mp, 2,
                       "bfloat16")
    print(f"[timing] serving state (B=8, kv_len {lens.tolist()}): kernel "
          f"{t_k * 1e3:.1f} us, plain {t_p * 1e3:.1f} us, sdpa "
          f"(pre-gathered, gather excluded) {t_l * 1e3:.1f} us, bound "
          f"{b_ms * 1e3:.2f} us ({b_by}) — {card}")

    # where a full-width decode step's time goes: host wall per step
    # (synchronised, no profiler), then device time by kernel name from
    # torch.profiler over the same number of further steps
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n_steps = 4

    def steps(first):
        for s in range(n_steps):
            model.decode_step(runner.params, cache, fed_t, first + s,
                              page_size=ps)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(pos + 1)
    wall_ms = (time.perf_counter() - t0) / n_steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(pos + 1 + n_steps)
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:    # host ops: not device time
            continue
        if e.device_time_total > 0:                 # microseconds
            by_kernel[e.key] = e.device_time_total / n_steps / 1e3
    busy_ms = sum(by_kernel.values())
    print(f"[profile] full-width decode step (B=8): wall {wall_ms:.2f} ms, "
          f"device busy {busy_ms:.2f} ms "
          f"({busy_ms / wall_ms:.1%} of wall) — {card}")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[profile]   {ms * 1e3:8.1f} us/step  {name[:90]}")

    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:160",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t_k,
        "plain_ms": t_p,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": t_l,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except Exception:                          # any phase's failure
        traceback.print_exc()
        print("FAIL: a phase raised", flush=True)
        sys.exit(1)
