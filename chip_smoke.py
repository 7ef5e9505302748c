#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # from the root of a checkout

Drives the port's main paths (``src/repro_torch``) on the card and exits
non-zero if any phase fails, or if no CUDA device is present:

1. card: torch / CUDA versions and the card's name and power limit;
2. build: compile both kernels from ``src/repro_torch/csrc`` with nvcc
   for sm_90a, one nvcc per source, started together;
3. kernels vs plain versions on the card:
   a. paged decode attention at the serving path's shapes (B=8, 16 query
      / 8 kv heads, D=128, 16-token bf16 pages, kv_len 0-2048, windows 0
      and 7, softcap 0 and 30) and at the bench-tiny shapes (4 / 2 heads,
      D=32, f32 pages);
   b. its int8-page variant at the serving shapes (int8 pages with
      per-row scales, an idle lane on the scratch page), q in f32 and
      bf16;
   c. the Q4_0 GEMM at the four full-width projection shapes, M 1, 8 and
      128, and at a bench-tiny shape, x in f32 and bf16;
4. kernel timing with CUDA events, inputs rotated past the 50 MB L2,
   beside the plain version and the bound: paged attention (bf16 and
   int8 pages) at B=8, kv_len 1024 and 4096, with
   ``scaled_dot_product_attention`` over pre-gathered K/V as the
   yardstick the port never calls; the Q4_0 GEMM per projection shape at
   M=8 and M=128, with a dense bf16 ``torch.matmul`` of the same shape
   as context (no PyTorch call computes Q4_0);
5. serve full-width Qwen3-1.7B (28 layers, bf16, weights drawn from a
   seeded ``torch.Generator``) through ``ContinuousServingEngine``: 8
   requests, prompts of 128-512 random tokens, two sharing a 256-token
   prefix, prefill in 128-token chunks, 32 greedy tokens each; checks
   the completions and that the paged kernel ran 28 times per decode
   step;
6. bf16 decode parity: from one cache state after the prefills, one
   decode step with the kernel and one with the plain version on a clone
   of the cache; logits must agree; the kernel is timed on that state,
   and a decode step is profiled;
7. serve the same model and traffic under ``QuantPolicy(weights="q4",
   kv_dtype="int8")`` after freeing the bf16 engine; checks the
   completions, the prefix cache, Q4_0 launches = 7 x 28 per forward
   call (prefill chunks and decode steps alike), int8 paged launches =
   28 x decode steps and ``runner.quant.q4_dispatch`` in both phases;
8. quantized decode parity: one decode step with both kernels against
   the plain versions (plain ``qmm`` and plain attention) on a clone of
   the int8 cache; the int8 kernel is timed on that state beside the
   bf16 kernel on the same state dequantized, and a decode step is
   profiled.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: paged kernel vs plain version: both read the same page values (bf16 ->
#: f32 and int8 code x scale are exact) and compute in f32; only the
#: summation order and the online softmax rescaling differ, each worth
#: ~1e-6 at these lengths
KERNEL_TOL = 1e-5
#: Q4_0 GEMM vs plain version: the same exactly dequantized weights summed
#: in f32 in another order; the Pallas test's tolerance
#: (tests/test_kernels.py): |d| <= Q4_ATOL + Q4_RTOL * |plain|
Q4_RTOL, Q4_ATOL = 1e-5, 1e-4
#: a bf16 input gets a bf16 result: the kernel rounds its f32 value to
#: nearest, which moves it by at most half a bf16 ulp (2**-8 of its size)
#: beyond the tolerances above
BF16_HALF_ULP = 2.0 ** -8
#: decode logits, kernel vs plain version, full width in bf16: the two
#: attention outputs differ by ~1e-6 in f32 but are rounded to bf16, so
#: an element may land one bf16 ulp (2**-8 relative) apart; 28 layers of
#: bf16 residual arithmetic carry such flips into logits of size ~1
LOGIT_TOL = 0.125
#: the same under q4 weights and int8 pages: besides attention, each of
#: the 196 projections of a step may round one bf16 ulp apart, and the fed
#: token's K/V may then quantize one int8 code apart; logits here lie at
#: |x| 8-16, where one bf16 ulp is 0.0625, so four ulps
LOGIT_TOL_Q4 = 0.25
#: the 7 projections of one full-width Qwen3-1.7B layer: (K, N)
Q4_PROJ = {"w_q": (2048, 2048), "w_k": (2048, 1024), "w_v": (2048, 1024),
           "w_o": (2048, 2048), "w_gate": (2048, 6144),
           "w_up": (2048, 6144), "w_down": (6144, 2048)}
#: rotate timing inputs over at least this many bytes (L2 is 50 MB)
ROTATE_BYTES = 120e6
#: cycles the device spins before a timed loop (~0.1 s at 1.98 GHz), so
#: the host has queued every call before the first one runs
SPIN_CYCLES = 200_000_000


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn(i)`` over ``iters`` calls.

    The device first spins (``torch.cuda._sleep``) while the host queues
    all the calls, and the start event fires when the spin ends: so the
    events time the device's work, not the host's launch rate, which on
    this card's host is slower than a short kernel (tens of µs per
    Python-level call)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def least(nbytes: float, flops: float, dtype_name: str):
    """Least time (ms) for moving ``nbytes`` and doing ``flops`` at the
    input type's peak, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def bound(lens_sum: int, B: int, Hkv: int, G: int, D: int, max_pages: int,
          itemsize: int, dtype_name: str, row_bytes: int = 0):
    """Least time (ms) for one paged decode-attention call: each valid K/V
    row read once (``row_bytes`` per row and kv head: D * itemsize, or
    D + 4 for int8 pages with their scale), q read and out written (of
    ``itemsize`` bytes), block table and lengths read — or the flops at
    the query type's peak."""
    row_bytes = row_bytes or D * itemsize
    nbytes = (lens_sum * Hkv * row_bytes * 2
              + 2 * B * Hkv * G * D * itemsize + B * max_pages * 4 + B * 4)
    return least(nbytes, 4 * lens_sum * Hkv * G * D, dtype_name)


def q4_bound(M: int, K: int, N: int, itemsize: int, dtype_name: str):
    """Least time (ms) for one Q4_0 GEMM: packed codes and scales read
    once, x read and out written, 2 M K N flops at x's type's peak."""
    nbytes = K * N // 2 + (K // 32) * N * 4 + (M * K + M * N) * itemsize
    return least(nbytes, 2 * M * K * N, dtype_name)


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


def check_q4(torch, got, want, what: str) -> float:
    """Max |kernel - plain| of a Q4_0 GEMM; fails beyond Q4_ATOL + Q4_RTOL
    |plain| (plus half a bf16 ulp of the plain value for a bf16 result)."""
    if not bool(torch.isfinite(got).all()):
        fail(f"{what}: non-finite output")
    err = (got.float() - want).abs()
    tol = Q4_ATOL + Q4_RTOL * want.abs()
    if got.dtype == torch.bfloat16:
        tol = tol + BF16_HALF_ULP * want.abs()
    if not bool((err <= tol).all()):
        fail(f"{what}: kernel disagrees with the plain version "
             f"(max {err.max().item():.3e})")
    return err.max().item()


def plain(ref, q, *args, **kw):
    """The paged kernel's plain version, its result in q's type like the
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


def serve(torch, eng, prompts, cfg, kernels, label, card):
    """Drive the engine's main path once: a warm-up request over the
    shared prefix (its pages stay in the retention LRU, so the two
    prefix-sharing requests hit the prefix cache), then the 8 measured
    requests with every kernel's launch count set to 0 just before and
    read just after.  Checks completions and the prefix cache; returns
    (launches by kernel name, decode steps, forward calls by phase from
    ``runner.quant.q4_dispatch`` or None without q4)."""
    from repro_torch.serving import Request, SamplingParams, \
        throughput_report
    V = cfg.vocab_size
    eng.generate([Request(uid=100, prompt=prompts[2][:256] + [1, 2, 3],
                          sampling=SamplingParams(max_new_tokens=2))])
    occ = eng.registry.get("serving.batch.occupancy")
    steps0 = occ.value()[1]
    st0 = dict(eng.pool.stats)
    disp = eng.registry.get("runner.quant.q4_dispatch")
    phases = ("prefill", "decode")
    d0 = [disp.value(phase=p_) for p_ in phases] if disp else None
    reqs = [Request(uid=i, prompt=p,
                    sampling=SamplingParams(max_new_tokens=32))
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0                     # count the main path only
    comps = eng.generate(reqs)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    decode_steps = int(occ.value()[1] - steps0)
    fwd = ({p_: int(disp.value(phase=p_) - d) for p_, d in zip(phases, d0)}
           if disp else None)
    peak = torch.cuda.max_memory_allocated()
    st = {k_: eng.pool.stats[k_] - st0.get(k_, 0) for k_ in eng.pool.stats}
    if len(comps) != len(reqs):
        fail(f"{label}: {len(comps)} of {len(reqs)} requests completed")
    for c in comps:
        if len(c.tokens) != 32 or not all(0 <= t < V for t in c.tokens):
            fail(f"{label}: request {c.uid}: {len(c.tokens)} tokens, in "
                 f"vocab: {all(0 <= t < V for t in c.tokens)}")
    if st["cached_tokens"] < 2 * 256 or st["shared_pages"] < 32:
        fail(f"{label}: prefix cache not exercised: {st}")
    rep = throughput_report(comps, **eng.last_phase_s)
    ttft = sorted(c.t_first - c.t0 for c in comps)
    print(f"[{label}] {len(comps)} requests x 32 tokens; {decode_steps} "
          f"decode steps; launches {launches}; prefix cache: "
          f"{st['cached_tokens']} tokens, {st['shared_pages']} shared pages")
    print(f"[{label}] decode {rep['decode_tok_per_s']:.1f} tok/s, prefill "
          f"{rep['prefill_tok_per_s']:.1f} tok/s, wall {rep['wall_s']:.3f} s,"
          f" TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms max "
          f"{ttft[-1] * 1e3:.1f} ms, peak memory {peak / 2**30:.2f} GiB — "
          f"{card}", flush=True)
    return launches, decode_steps, fwd


def parity_state(torch, np, gen, model, params, prompts, kv_dtype):
    """A fresh paged cache (shuffled block tables) holding the 8 prompts,
    one-shot prefilled; returns (cache, its clone, fed tokens, positions,
    page size)."""
    ps, B = 16, len(prompts)
    cache = model.init_cache(B, 1024, page_size=ps, kv_dtype=kv_dtype,
                             device="cuda")
    mp = cache["block_tables"].shape[1]
    perm = torch.randperm(B * mp, generator=gen, device="cuda") + 1
    cache["block_tables"].copy_(perm.reshape(B, mp).to(torch.int32))
    fed = np.zeros((B, 1), np.int64)
    for b, p in enumerate(prompts):
        Sp = 1 << max(3, (len(p) - 1).bit_length())
        toks = torch.zeros((1, Sp), dtype=torch.long, device="cuda")
        toks[0, :len(p)] = torch.tensor(p, device="cuda")
        logits, _ = model.prefill_paged(params, {"tokens": toks}, cache, b,
                                        len(p), page_size=ps)
        fed[b, 0] = int(logits[0, -1].float().argmax())
    pos = torch.tensor([len(p) for p in prompts], device="cuda")
    clone = {"block_tables": cache["block_tables"].clone(),
             "layers": [{"self": {n_: t.clone() for n_, t in
                                  layer["self"].items()}}
                        for layer in cache["layers"]]}
    return cache, clone, torch.from_numpy(fed).to("cuda"), pos, ps


def logit_parity(torch, got, want, tol, what):
    """Max |d| of two decode steps' logits within ``tol``, and the argmax
    equal on every lane whose top-2 margin exceeds ``tol``."""
    got, want = got[:, 0].float(), want[:, 0].float()
    dlog = (got - want).abs().max().item()
    top2 = want.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    same = bool((got.argmax(-1) == want.argmax(-1))[clear].all())
    print(f"[parity] {what}: max|d| {dlog:.4f} (tol {tol}); argmax equal "
          f"on {int(clear.sum())}/{len(clear)} lanes with top-2 margin > "
          f"tol: {same}")
    if not (math.isfinite(dlog) and dlog <= tol and same):
        fail(f"{what}: decode parity failed")


def profile_step(torch, model, params, cache, fed_t, first, ps, label,
                 card):
    """Host wall per full-width decode step (synchronised, no profiler),
    then device time by kernel name from torch.profiler over the same
    number of further steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n_steps = 4

    def steps(start):
        for s in range(n_steps):
            model.decode_step(params, cache, fed_t, start + s, page_size=ps)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(first)
    wall_ms = (time.perf_counter() - t0) / n_steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(first + n_steps)
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:    # host ops: not device time
            continue
        if e.device_time_total > 0:                 # microseconds
            by_kernel[e.key] = e.device_time_total / n_steps / 1e3
    busy_ms = sum(by_kernel.values())
    print(f"[profile] {label} decode step (B=8): wall {wall_ms:.2f} ms, "
          f"device busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.1%} of wall) "
          f"— {card}")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"[profile]   {ms * 1e3:8.1f} us/step  {name[:90]}")


def time_serving_state(torch, F, ref, kernel, cache, pos, cfg, gen, label,
                       card):
    """The paged kernel at the serving path's own inputs: this state's
    block table and lengths, cycling the 28 layers' pools as one decode
    step does (so K/V come from HBM, not L2).  Returns (max error, kernel
    ms, plain ms, SDPA ms, bound ms, bound_by, and for int8 pages the bf16
    kernel's ms on the same state dequantized)."""
    from repro_torch.quant import dequantize_rows
    ps, B, D = 16, len(pos), cfg.resolved_head_dim
    Hkv = cfg.n_kv_heads
    lens = (pos + 1).to(torch.int32)
    bt = cache["block_tables"]
    mp = bt.shape[1]
    int8 = "k_scale" in cache["layers"][0]["self"]
    pools, scales = [], []
    for layer in cache["layers"]:
        lc = layer["self"]
        pools.append((lc["k"].view(-1, ps, Hkv, D),
                      lc["v"].view(-1, ps, Hkv, D)))
        scales.append({"k_scales": lc["k_scale"].view(-1, ps, Hkv),
                       "v_scales": lc["v_scale"].view(-1, ps, Hkv)}
                      if int8 else {})
    qd = torch.randn(B, Hkv, cfg.n_heads // Hkv, D, generator=gen,
                     device="cuda").to(torch.bfloat16)
    nl = len(pools)
    out_k = kernel(qd, *pools[0], bt, lens, **scales[0])
    out_p = ref.paged_decode_attention_ref(qd, *pools[0], bt, lens,
                                           **scales[0])
    torch.cuda.synchronize()
    err = check(torch, out_k, out_p, lens > 0, f"{label} serving state")
    print(f"[kernel] {label} serving state, q bf16: max|kernel-plain| "
          f"{err:.3e}")
    t_k = cuda_ms(torch, lambda i: kernel(qd, *pools[i % nl], bt, lens,
                                          **scales[i % nl]), 10 * nl)
    t_p = cuda_ms(torch, lambda i: plain(ref, qd, *pools[i % nl], bt, lens,
                                         **scales[i % nl]), nl)
    L = mp * ps
    mask = (torch.arange(L, device="cuda")[None, :] < lens[:, None].long()
            ).reshape(B, 1, 1, L)

    def dense(t, s):     # (P, ps, Hkv, D) pages -> bf16, dequantized
        return (dequantize_rows(t, s, torch.bfloat16) if int8
                else t)

    bf16_pools = [(dense(k, sc.get("k_scales")), dense(v, sc.get("v_scales")))
                  for (k, v), sc in zip(pools, scales)]
    gathered = [tuple(t[bt.long()].reshape(B, L, Hkv, D)
                      .transpose(1, 2).contiguous() for t in kv)
                for kv in bf16_pools]
    qs = qd.reshape(B, cfg.n_heads, 1, D)
    t_l = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
        qs, *gathered[i % nl], attn_mask=mask, enable_gqa=True), 10 * nl)
    del gathered
    t_bf16 = None
    if int8:
        t_bf16 = cuda_ms(torch, lambda i: kernel(
            qd, *bf16_pools[i % nl], bt, lens), 10 * nl)
    del bf16_pools
    b_ms, b_by = bound(int(lens.sum()), B, Hkv, cfg.n_heads // Hkv, D, mp,
                       2, "bfloat16", row_bytes=D + 4 if int8 else 0)
    print(f"[timing] {label} serving state (B=8, kv_len {lens.tolist()}): "
          f"kernel {t_k * 1e3:.1f} us, plain {t_p * 1e3:.1f} us, sdpa "
          f"(pre-gathered{', dequantized' if int8 else ''}, excluded from "
          f"the time) {t_l * 1e3:.1f} us"
          + (f", bf16 kernel on the same state {t_bf16 * 1e3:.1f} us"
             if int8 else "")
          + f", bound {b_ms * 1e3:.2f} us ({b_by}) — {card}")
    return err, t_k, t_p, t_l, b_ms, b_by, t_bf16


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
    from repro_torch.kernels import q4_gemm as qg
    from repro_torch.quant import (QuantPolicy, count_q4_leaves, make_qmm,
                                   param_bytes, q4_0, quantize_rows)
    kernel = da.paged_decode_attention
    q4k = qg.q4_gemm
    kernels = {"paged_decode_attention": kernel, "q4_gemm": q4k}

    # -- 2. build: one nvcc per source, both at once ----------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        list(ex.map(build.load, (da.KERNEL, qg.KERNEL)))
    print(f"[build] {da.KERNEL} + {qg.KERNEL}: "
          f"{time.perf_counter() - t0:.2f} s wall")
    for name in (da.KERNEL, qg.KERNEL):
        rec = build.build_record(name)
        print(f"[build] {name}: nvcc {rec['seconds']:.2f} s, "
              f"cached={rec['cached']}")
        for line in str(rec["ptxas"]).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    max_err = 0.0

    # -- 3a. paged kernel vs plain version -------------------------------
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

    # -- 3b. int8-page variant vs plain version --------------------------
    # pages quantized as the model writes them; page 0 is the zeroed
    # scratch page (scale 0), and the idle lane's table points at it
    err_i8 = 0.0
    q, k, v, (bt,), lens = make_case(torch, gen, **cases[0][1])
    k[0], v[0] = 0.0, 0.0
    bt[0] = 0
    (kc, ks), (vc, vs) = quantize_rows(k), quantize_rows(v)
    if bool(ks[0].any()):
        fail("scratch page scales are not 0")
    for q_dtype in (torch.float32, torch.bfloat16):
        qq = q.to(q_dtype)
        for window in (0, 7):
            for softcap in (0.0, 30.0):
                got = kernel(qq, kc, vc, bt, lens, window, softcap=softcap,
                             k_scales=ks, v_scales=vs)
                torch.cuda.synchronize()
                want = ref.paged_decode_attention_ref(
                    qq, kc, vc, bt, lens, window, softcap=softcap,
                    k_scales=ks, v_scales=vs)
                what = (f"serve q {q_dtype} int8 pages window={window} "
                        f"softcap={softcap}")
                err = check(torch, got, want, lens > 0, what)
                err_i8 = max(err_i8, err)
                print(f"[kernel] {what}: max|kernel-plain| {err:.3e}")
    del q, k, v, kc, vc, ks, vs

    # -- 3c. Q4_0 GEMM vs plain version ----------------------------------
    err_q4 = 0.0
    for K, N in sorted(set(Q4_PROJ.values())) + [(128, 256)]:
        w = torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K)
        packed, scales = q4_0.quantize(w)
        for M in (1, 8, 128):
            for x_dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(M, K, generator=gen, device="cuda").to(
                    x_dtype)
                got = q4k(x, packed, scales)
                torch.cuda.synchronize()
                want = ref.q4_gemm_ref(x, packed, scales)
                what = f"q4_gemm M={M} K={K} N={N} x {x_dtype}"
                err = check_q4(torch, got, want, what)
                err_q4 = max(err_q4, err)
                print(f"[kernel] {what}: max|kernel-plain| {err:.3e}")

    # -- 4. kernel timing ------------------------------------------------
    import torch.nn.functional as F
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
        del kc, vc
        b_ms, b_by = bound(B * L, B, Hkv, G, D, mp, 2, "bfloat16")
        print(f"[timing] B={B} kv_len={L} bf16 D={D}: kernel "
              f"{t_k * 1e3:.1f} us, plain {t_p * 1e3:.1f} us, sdpa "
              f"(pre-gathered, gather excluded) {t_l * 1e3:.1f} us, bound "
              f"{b_ms * 1e3:.1f} us ({b_by}) — {card}")
        (kq, ksc), (vq, vsc) = quantize_rows(k), quantize_rows(v)
        del k, v
        i8 = {"k_scales": ksc, "v_scales": vsc}
        t_k8 = cuda_ms(torch, lambda i: kernel(q, kq, vq, bts[i % n], lens,
                                               **i8), 200)
        t_p8 = cuda_ms(torch, lambda i: plain(ref, q, kq, vq, bts[i % n],
                                              lens, **i8), 20)
        b8, b8_by = bound(B * L, B, Hkv, G, D, mp, 2, "bfloat16",
                          row_bytes=D + 4)
        print(f"[timing] B={B} kv_len={L} int8 pages D={D}: kernel "
              f"{t_k8 * 1e3:.1f} us, plain {t_p8 * 1e3:.1f} us, bound "
              f"{b8 * 1e3:.1f} us ({b8_by}) — {card}")
        del q, kq, vq, ksc, vsc, i8

    # the Q4_0 GEMM per projection shape: packed weights rotated over
    # >= ROTATE_BYTES of copies, as a decode step reads each layer's
    # weights from HBM once; the dense bf16 matmul likewise
    q4_times = {}
    for K, N in sorted(set(Q4_PROJ.values())):
        w = torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K)
        packed, scales = q4_0.quantize(w)
        dense_w = q4_0.dequantize(packed, scales, torch.bfloat16)
        del w
        qbytes = packed.numel() + scales.numel() * 4
        nq = max(2, math.ceil(ROTATE_BYTES / qbytes))
        nd = max(2, math.ceil(ROTATE_BYTES / (K * N * 2)))
        qw = [(packed.clone(), scales.clone()) for _ in range(nq)]
        dw = [dense_w.clone() for _ in range(nd)]
        for M in (8, 128):
            x = torch.randn(M, K, generator=gen, device="cuda").to(
                torch.bfloat16)
            t_k = cuda_ms(torch, lambda i: q4k(x, *qw[i % nq]),
                          200 if M == 8 else 50)
            t_p = cuda_ms(torch, lambda i: ref.q4_gemm_ref(
                x, *qw[i % nq]).to(x.dtype), 10)
            t_d = cuda_ms(torch, lambda i: x @ dw[i % nd], 200)
            b_ms, b_by = q4_bound(M, K, N, 2, "bfloat16")
            q4_times[(K, N, M)] = (t_k, t_p, t_d, b_ms, b_by)
            names = "/".join(n_ for n_, s in Q4_PROJ.items() if s == (K, N))
            print(f"[timing] q4_gemm {names} M={M} K={K} N={N} x bf16: "
                  f"kernel {t_k * 1e3:.1f} us, plain {t_p * 1e3:.1f} us, "
                  f"dense bf16 matmul (context) {t_d * 1e3:.1f} us, bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}) — {card}")
        del qw, dw, packed, scales, dense_w
    torch.cuda.empty_cache()

    # -- 5. serve full-width Qwen3-1.7B in bf16 --------------------------
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.weights import tree_leaves_with_path
    from repro_torch.serving import ContinuousServingEngine
    cfg = get_config("qwen3-1.7b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    wgen = torch.Generator(device="cuda")
    wgen.manual_seed(0)
    params = model.init(wgen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves_with_path(params))
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
    eng = ContinuousServingEngine(model, params, max_len=1024, max_running=8,
                                  page_size=16, prefill_chunk=128, seed=0,
                                  device="cuda")
    counts, decode_steps, _ = serve(torch, eng, prompts, cfg, kernels,
                                    "serve", card)
    launches = counts["paged_decode_attention"]
    if decode_steps <= 0 or launches != cfg.n_layers * decode_steps:
        fail(f"kernel launches {launches} != {cfg.n_layers} x "
             f"{decode_steps} decode steps")
    if counts["q4_gemm"]:
        fail(f"bf16 serving launched the Q4_0 GEMM {counts['q4_gemm']} times")

    # -- 6. decode parity on the card (bf16) -----------------------------
    cache, clone, fed_t, pos, ps = parity_state(
        torch, np, gen, model, eng.runner.params, prompts, "fp32")
    got, _ = model.decode_step(eng.runner.params, cache, fed_t, pos,
                               page_size=ps)
    want, _ = model.decode_step(eng.runner.params, clone, fed_t, pos,
                                page_size=ps, impl="ref")
    logit_parity(torch, got, want, LOGIT_TOL,
                 "full-width decode logits, kernel vs plain")
    err6, t_k, t_p, t_l, b_ms, b_by, _ = time_serving_state(
        torch, F, ref, kernel, cache, pos, cfg, gen, "bf16", card)
    max_err = max(max_err, err6)
    profile_step(torch, model, eng.runner.params, cache, fed_t, pos + 1, ps,
                 "full-width bf16", card)

    # -- 7. serve under q4 weights + int8 pages ---------------------------
    del eng, cache, clone, got, want
    torch.cuda.empty_cache()
    qp = QuantPolicy(weights="q4", kv_dtype="int8")
    t0 = time.perf_counter()
    eng = ContinuousServingEngine(model, params, max_len=1024, max_running=8,
                                  page_size=16, prefill_chunk=128, seed=0,
                                  quant=qp, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    del params                    # the runner holds the quantized tree
    torch.cuda.empty_cache()
    qparams = eng.runner.params
    if count_q4_leaves(qparams) != 7:
        fail(f"{count_q4_leaves(qparams)} q4 leaves, expected 7")
    print(f"[q4] quantized {cfg.n_layers} x 7 projections on the card in "
          f"{t_load:.2f} s; params {param_bytes(qparams) / 2**30:.3f} GiB, "
          f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"(weights + int8 page pool)")
    counts_q, steps_q, fwd_q = serve(torch, eng, prompts, cfg, kernels,
                                     "q4", card)
    fwd_prefill, fwd_decode = fwd_q["prefill"], fwd_q["decode"]
    fwd = fwd_prefill + fwd_decode
    launches_q4 = counts_q["q4_gemm"]
    launches_i8 = counts_q["paged_decode_attention"]
    if fwd_prefill <= 0 or fwd_decode <= 0:
        fail(f"runner.quant.q4_dispatch prefill {fwd_prefill} decode "
             f"{fwd_decode}: both phases must dispatch")
    if launches_q4 != 7 * cfg.n_layers * fwd:
        fail(f"q4_gemm launches {launches_q4} != 7 x {cfg.n_layers} x {fwd} "
             "forward calls")
    if steps_q <= 0 or launches_i8 != cfg.n_layers * steps_q:
        fail(f"int8 paged launches {launches_i8} != {cfg.n_layers} x "
             f"{steps_q} decode steps")
    print(f"[q4] launches: q4_gemm {launches_q4} = 7 x {cfg.n_layers} x "
          f"{fwd} forward calls ({fwd_prefill} prefill chunks + "
          f"{fwd_decode} decode steps); int8 paged attention "
          f"{launches_i8} = {cfg.n_layers} x {steps_q} decode steps")

    # -- 8. quantized decode parity on the card --------------------------
    cache, clone, fed_t, pos, ps = parity_state(
        torch, np, gen, model, qparams, prompts, "int8")
    got, _ = model.decode_step(qparams, cache, fed_t, pos, page_size=ps)
    model.qmm = make_qmm("ref")
    want, _ = model.decode_step(qparams, clone, fed_t, pos, page_size=ps,
                                impl="ref")
    model.qmm = make_qmm(qp.impl)
    logit_parity(torch, got, want, LOGIT_TOL_Q4,
                 "q4 + int8 decode logits, kernels vs plain")
    err8, t_k8, t_p8, t_l8, b8_ms, b8_by, t_bf16 = time_serving_state(
        torch, F, ref, kernel, cache, pos, cfg, gen, "int8", card)
    err_i8 = max(err_i8, err8)
    profile_step(torch, model, qparams, cache, fed_t, pos + 1, ps,
                 "full-width q4 + int8", card)

    # one decode-step layer's 7 projections at M=8: mean per call
    def q4_mean(j):
        return sum(q4_times[s + (8,)][j] for s in Q4_PROJ.values()) / 7

    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    paged_src = "src/repro_torch/csrc/paged_decode_attention.cu"
    print(json.dumps({"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": paged_src,
        "replaces": "src/repro/kernels/decode_attention.py:160",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t_k,
        "plain_ms": t_p,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": t_l,
    }, {
        "name": "paged_decode_attention_int8",
        "route": "cuda",
        "source": paged_src,
        "replaces": "src/repro/kernels/decode_attention.py:160",
        "launches": launches_i8,
        "max_abs_err": err_i8,
        "ms": t_k8,
        "plain_ms": t_p8,
        "bound_ms": b8_ms,
        "bound_by": b8_by,
        "library_ms": t_l8,
        "bf16_pages_same_state_ms": t_bf16,
    }, {
        "name": "q4_gemm",
        "route": "cuda",
        "source": "src/repro_torch/csrc/q4_gemm.cu",
        "replaces": "src/repro/kernels/q4_gemm.py:62",
        "launches": launches_q4,
        "max_abs_err": err_q4,
        "ms": q4_mean(0),
        "plain_ms": q4_mean(1),
        "bound_ms": q4_mean(3),
        "bound_by": "bytes" if all(
            q4_times[s + (8,)][4] == "bytes" for s in Q4_PROJ.values())
        else "operations",
        "library_ms": None,
        "dense_bf16_matmul_ms": q4_mean(2),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except Exception:                          # any phase's failure
        traceback.print_exc()
        print("FAIL: a phase raised", flush=True)
        sys.exit(1)
