#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py            # from the root of a checkout

Drives the port's main paths (``src/repro_torch``) on the card and exits
non-zero if any phase fails, or if no CUDA device is present:

1. card: torch / CUDA versions and the card's name and power limit;
2. build: compile the four kernel sources of ``src/repro_torch/csrc``
   with nvcc for sm_90a, one nvcc per source, all started together;
3. kernels vs plain versions on the card:
   a. paged decode attention at the serving path's shapes (B=8, 16 query
      / 8 kv heads, D=128, 16-token bf16 pages, kv_len 0-2048, windows 0
      and 7, softcap 0 and 30) and at the bench-tiny shapes (4 / 2 heads,
      D=32, f32 pages);
   b. its int8-page variant at the serving shapes (int8 pages with
      per-row scales, an idle lane on the scratch page), q in f32 and
      bf16;
   c. its split-K for f32, bf16 and int8 pages: kv_len at every split
      edge and one either side, kv_len = max_pages * ps, idle lanes on the
      zeroed scratch page, windows that begin inside a split with whole
      splits before them, page sizes 4 and 16, long tables (max_pages 256,
      kv_len 4096), G 1-16 at D 16-256, q in f32 and bf16;
   d. one paged call captured in a CUDA graph and replayed, against
      eager calls, before and after kv_lens and the block table change in
      place (bf16 and int8 pages);
   e. the Q4_0 GEMM at the four full-width projection shapes, M 1, 8 and
      128, and at a bench-tiny shape, x in f32 and bf16;
   f. every kernel called twice on the same input at the main paths'
      shapes (paged bf16 and int8 pages, the Q4_0 GEMM at M=8 and 128 in
      bf16 and at M=8 in f32, the contiguous kernel over a ring, the
      RG-LRU scan): the two results must be bit-equal;
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
   and a decode step is profiled (the paged kernel's split and merge
   launches must each run once per layer);
7. serve the same model and traffic under ``QuantPolicy(weights="q4",
   kv_dtype="int8")`` after freeing the bf16 engine; checks the
   completions, the prefix cache, Q4_0 launches = 7 x 28 per forward
   call (prefill chunks and decode steps alike), int8 paged launches =
   28 x decode steps and ``runner.quant.q4_dispatch`` in both phases;
8. quantized decode parity: one decode step with both kernels against
   the plain versions (plain ``qmm`` and plain attention) on a clone of
   the int8 cache; the int8 kernel is timed on that state beside the
   bf16 kernel on the same state dequantized, and a decode step is
   profiled, as in 6 (the Q4_0 kernel must run 196 times in it); then one
   full-width 128-token prefill chunk is profiled by kernel (the Q4_0
   kernel again 196 times, at M=128);
9. speculative verify parity, bf16 and then q4 + int8 (on phase 5's
   weights, drawn again): from one prefilled state, 3 sequential decode
   steps give each lane its greedy continuation; one verify step fed
   those tokens as 2 drafts (S = 3) on a copy of the state must give
   column j's logits within the tolerance of decode step j's (so every
   draft with a clear top-2 margin is accepted), and so must its plain
   version (plain paged attention, plain ``qmm``) against the kernels;
   one verify step is profiled beside one decode step on that state
   (the paged kernel's split and merge launches 3 x 28 times in it, the
   Q4_0 kernel 196 times at M = 24);
10. serve full-width Qwen3-1.7B through ``AsyncEngine`` with
    ``spec_decode=2`` and then 0, bf16 and then q4 + int8: 4 requests of
    128-512 tokens, each a random segment repeated (so prompt lookup
    drafts), two sharing a 256-token prefix, 32 greedy tokens each, all
    submitted at once, one streamed; checks the completions,
    ``spec.drafted > 0``, paged launches = 28 x (decode steps + 3 x
    verify steps), Q4_0 launches = 7 x 28 x forward calls (verify
    included), the free pages back at their start, and the k=2 tokens
    against k=0's under the margin rule (where they first differ, k=0's
    top-2 margin there must be under the tolerance); prints the spec
    counters, tokens per verify step, decode tok/s, TTFT and peak memory
    of both;
11. ``python -m repro_torch.launch.serve --engine async --spec-decode 2
    --metrics-json M --trace T`` (reduced config, on the card) must exit
    0, and ``python -m repro_torch.obs.validate`` must pass both files;
12. the contiguous decode-attention kernel vs its plain version: at
    RecurrentGemma's decode shape (B 4 and 8, one kv head, G=10, D=256,
    bf16 cache of 560 slots) in the TPU kernel's form (kv_len 0, 1, 300,
    560) and in the ring form (filling, full and wrapped rings, windows 7
    and 2048, softcap 0 and 30), and at the Qwen3 (8 / 16 heads, D=128,
    bf16) and bench-tiny (2 / 4 heads, D=32, f32) shapes;
13. the RG-LRU scan kernel vs its plain version, with and without h0, bit
    for bit: (4, 512, 2560), (8, 256, 2560), (1, 2048, 2560), T around a
    multiple of the plan's stage (511, 513) and one step short of and past
    a stage, T = 1, and W = 64, 6 and 36 (a ragged last strip; 6 and 36
    off the 16-byte unit of the tensor copies);
14. timing of both, inputs rotated past the L2: the decode kernel at B=4
    and 8, kv_len 544 and 2048 over a ring, beside its plain version, its
    byte bound and ``scaled_dot_product_attention`` with a boolean mask
    (the yardstick the port never calls); the decode kernel in its
    ``kv_len`` form at the two cross-attention reads of phases 20-21
    (B=4, kv_len 6404, 8 kv heads of G=4, D=128; B=4, kv_len 1500, 16
    heads, G=1, D=64; bf16 K/V), each first held against its plain
    version, beside it, its byte bound and an unmasked
    ``scaled_dot_product_attention``; the scan at (4, 512, 2560),
    (4, 256, 2560), (1, 512, 2560) and (1, 2048, 2560) beside its plain
    version, its byte bound and its plan (no PyTorch call computes this
    recurrence);
15. serve full-width RecurrentGemma-2B (26 layers, bf16, weights drawn
    from a seeded ``torch.Generator``) through ``ServingEngine`` /
    ``BucketRunner``: 8 requests, four prompts of 256 random tokens and
    four of 512, ``max_batch=4`` (two buckets), 32 greedy tokens each;
    checks the completions and the launch counts (decode kernel = 8 x
    decode steps, scan kernel = 18 x prefill calls);
16. parity on the card: prefill logits with the scan kernel against the
    plain scan, and one decode step with the kernels against the plain
    versions on a clone of the ring cache; then a prefill call of the
    512-token bucket (B=4) is profiled by kernel (the scan must run once
    per RG-LRU layer; its share of the call is printed) and a decode step
    (the contiguous kernel must run once per attention layer);
17. the HTTP front end, the router and the worker fleet:
    a. full-width Qwen3-1.7B in bf16 (phase 5's weights, drawn again)
       through ``AsyncEngine``, first in process and then behind the
       port's ``HttpFrontend``: phase 5's 8 prompts from 8 concurrent
       streaming HTTP clients, 32 greedy tokens each; the tokens must
       equal the in-process run's under the margin rule, the ``done``
       frames count 32, ``http.requests`` is 8 and ``http.inflight`` 0
       afterwards, every page is free again, and the paged kernel ran
       28 times per decode step;
    b. a second engine with its own copy of the weights behind its own
       frontend, a ``Router`` over two ``HttpWorkerClient``s and a front
       ``HttpFrontend(router)``: the same 8 clients; the two requests
       that share a prefix land on one replica (``router.affinity.hits``
       >= 1), the tokens equal the in-process run's under the margin
       rule, and the paged kernel ran 28 times per decode step of the
       two engines; TTFT p50 and decode tok/s over HTTP are printed
       beside the in-process run's, with the process's peak memory;
    c. ``python -m repro_torch.launch.serve --arch qwen3-1.7b --engine
       async --http --replicas 2 --max-respawns 1 --quant q4 --kv-dtype
       int8`` (two reduced workers on the card, their log in
       ``build/chip_smoke_fleet/``): 4 streams, each worker's
       ``/metrics.json`` showing decode steps on int8 pages and Q4_0
       forward calls, a SIGKILL of one worker healed by a respawn and
       the router's readmission, 2 more streams, then SIGTERM: the front
       door exits 0 and no worker outlives it;
18. full-width Phi-3.5-MoE (d_model 4096, 32 / 8 heads x 128, d_ff
    6400, 16 experts top-2, vocab 32,064, untied embeddings, bf16) at 16
    of its 32 layers (the full depth does not fit one 80 GB card), at the
    serve CLI's capacity factor 4.0, weights drawn on the card from a
    seeded ``torch.Generator`` one expert stack at a time, after every
    earlier phase's engines and weights are freed:
    a. ``ContinuousServingEngine`` on phase 5's traffic (8 requests of
       128-512 tokens, two sharing a 256-token prefix, 128-token chunks,
       32 greedy tokens each); checks the completions and the prefix
       cache, paged kernel launches = 16 x decode steps; one decode step
       with the kernel against the plain attention on a clone of the
       cache, the plain run routed as the kernel run was (every token
       whose experts differ between the two runs must sit within
       ``ROUTE_TOL`` of a tie), logits within 0.125; ``moe_scatter``
       against ``moe_dense`` at one layer for 128 bf16 rows where nothing
       drops; prints peak memory, decode tok/s, TTFT, and a profiled
       decode step's device time, busy share and the expert products'
       share (``aten::bmm``);
    b. the same model through ``ServingEngine`` / ``BucketRunner``: four
       prompts of 256 tokens, ``max_batch=4``, 16 tokens each;
       contiguous kernel launches = 16 x decode steps, and one ring
       decode step with the kernel against the plain version on a clone
       of the ring, routed as in (a);
    c. the Q4_0 GEMM against its plain version at the model's attention
       projections, (K, N) = (4096, 4096) and (4096, 1024), M = 8 and
       128, x in bf16;
19. full-width, full-depth Mamba-2-370m (48 SSD layers, d_model 1024, 32
    heads x 64, state 128, chunk 64, vocab 50,280, bf16, weights drawn
    on the card) through ``ServingEngine``: 8 requests, four prompts of
    256 tokens and four of 512, 32 greedy tokens each; checks the
    completions and that none of the port's kernels ran (the SSD path
    has none: the reference's chunk scan is plain jnp); ``ssd_chunked``
    against ``ssd_reference`` at one layer's shapes, T = 200 across
    chunk edges, with and without an initial state (f32, ``SSD_TOL``);
    the logits of a decode step after a prefill of 511 tokens against
    the last logits of a prefill of 512 (0.125); prints the device time
    of a decode step and of a 512-token prefill call, and peak memory;
20. full-width, full-depth Llama-3.2-Vision-11B (40 layers, every fifth a
    tanh-gated cross-attention layer over 6404 image tokens, d_model
    4096, 32 / 8 heads x 128, d_ff 14,336, vocab 128,256, untied, bf16;
    9.775 B parameters drawn on the card, every gate drawn nonzero)
    through ``ServingEngine``: four prompts of 256 random tokens, each
    with its own image stub (the port's numpy ``stub_image_embeds``, fed
    in bf16), ``max_batch=4``, 16 greedy tokens each; checks the
    completions and that the contiguous kernel ran 40 times a decode
    step (32 ring reads, 8 cross-attention reads in the ``kv_len``
    form); one ring decode step with the kernels against the plain
    versions on a clone of the cache (``LOGIT_TOL``); the kernel against
    its plain version at the first cross-attention layer's K/V; the same
    decode step over another lane's image moving the logits by more than
    0.1; a decode step after a prefill of 255 tokens against the last
    logits of a prefill of 256 (0.125); prints a profiled decode step's
    device time and busy share, a prefill call's device time, peak
    memory, decode tok/s and TTFT p50;
21. full-width, full-depth Whisper-medium (24 encoder and 24 decoder
    layers, d_model 1024, 16 heads x 64, d_ff 4096, GELU, LayerNorm,
    tied, bf16; 0.758 B parameters) the same way: four prompts of 64
    tokens and four of 128, each with its own 1500 x 1024 frame stub
    (``stub_frames``, in bf16), ``max_batch=4`` (two buckets: the
    encoder runs twice), 32 tokens each; the contiguous kernel 48 times
    a decode step (24 ring + 24 cross-attention reads); the same checks
    and numbers, and the encoder's device time over the prefill's
    frames;
22. training at full width (``repro_torch.training``), after every
    earlier phase's engines and weights are freed:
    a. full-width, full-depth Qwen3-1.7B (28 layers, bf16, 1.72 B
       parameters drawn on the card from seed 0), ``make_train_step``
       with AdamW (lr ``TRAIN_LR``, ``TRAIN_WARMUP`` warm-up steps) on
       ``PackedLMDataset`` batches of 4 x 512 tokens: 1 warm-up and 4
       timed steps; every loss and gradient norm
       finite, the last loss below the first, the parameters moved, and
       no port kernel launched (the path has none); prints each step's
       wall time, the mean, tokens/s, the model FLOPs' share of the bf16
       peak, peak memory, a profiled step's device time and top kernels,
       and the AdamW update alone timed with CUDA events beside its byte
       bound;
    b. full-width, full-depth RecurrentGemma-2B (26 layers) the same way
       at 2 x 512 tokens; with the counts set to 0 around one train step,
       the scan kernel's forward mode and its reverse mode (the gradient)
       must each have launched 18 times (one a RG-LRU layer) and nothing
       else;
    c. the reverse mode against its plain version, bit for bit
       (``SCAN_TOL``): (2, 512, 2560), (4, 512, 2560), (1, 2048, 2560), one
       step short of and past a stage, W = 36 and a ragged strip (W = 64);
    d. its time at the first three, inputs rotated past the L2, beside its
       plain version and its byte bound, and the scan's whole backward
       (kernel + the elementwise dL/da pass);
    e. the gradients of one full-width RG-LRU block in float32 (B = 2 x
       512) with the scan kernels against the plain scans, within
       ``BLOCK_GRAD_RTOL`` of each leaf's largest |g|.
    Phase 11's CLI run takes the serve CLI's default ``--warmup-steps
    40``: it warm-trains on the card before it serves.

The build phase prints nvcc's register and spill report for every
kernel, and the scan's plan and shared memory at its timed shapes.  It
prints one JSON line ``{"kernels": [...]}`` before the last line (the
contiguous kernel's entry carries all four timed shapes with their SDPA
times and bounds, the Q4_0 entry its M=8 and M=128 times and bounds by
shape and its device time in a decode step and a prefill chunk, the scan
entry its four timed shapes with their plans and its device time in the
profiled prefill call; the paged entries and the Q4_0 entry also their
launches in phase 10's k=2 run and their device time in a verify step,
the bf16 paged entry its launches in phases 17a, 17b and 18a and its
device time a call in 18a's decode step, the contiguous entry its
launches in 18b, 20 and 21 and its two cross-attention shapes' times,
the Q4_0 entry its error at 18c's shapes; the scan entry its launches
in a train step, and an entry for its reverse mode with its launches in
a train step, its error, its times by shape and the block gradients'
error; then the two train runs' numbers under ``training``),
and as the last line ``{"ok": true, "device":
{...}}``.  Nothing
here imports JAX or the reference package.
"""

import gc
import json
import math
import os
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
#: RG-LRU scan kernel vs plain version: the same sequential recurrence
#: with the same two f32 roundings per step (the kernel's __fmul_rn /
#: __fadd_rn are never fused into an FMA), so bit for bit: tolerance 0
SCAN_TOL = 0.0
#: full-width RecurrentGemma-2B logits, kernels vs plain versions, in
#: bf16: decode attention differs by ~1e-6 in f32 before its bf16
#: rounding, as the paged kernel's does, and 26 layers of bf16 residual
#: arithmetic carry a one-ulp flip into logits of size ~1; the scan is bit
#: for bit, so prefill logits should agree exactly.  The Qwen3 tolerance
LOGIT_TOL_RG = 0.125
#: the 7 projections of one full-width Qwen3-1.7B layer: (K, N)
Q4_PROJ = {"w_q": (2048, 2048), "w_k": (2048, 1024), "w_v": (2048, 1024),
           "w_o": (2048, 2048), "w_gate": (2048, 6144),
           "w_up": (2048, 6144), "w_down": (6144, 2048)}
#: rotate timing inputs over at least this many bytes (L2 is 50 MB)
ROTATE_BYTES = 120e6
#: cycles the device spins before a timed loop (~0.1 s at 1.98 GHz), so
#: the host has queued every call before the first one runs
SPIN_CYCLES = 200_000_000


def stamp(t_start: float, what: str) -> None:
    """Print the seconds since ``t_start`` at the start of a phase."""
    print(f"[time] {time.perf_counter() - t_start:.1f} s: {what}",
          flush=True)


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
              copies=1, dev="cuda"):
    """q, page pools and ``copies`` block tables over disjoint shuffled
    pages (copies > 1 lets a timing loop rotate past the 50 MB L2)."""
    n_pages = 1 + copies * B * max_pages
    q = torch.randn(B, Hkv, G, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(n_pages, ps, Hkv, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(n_pages, ps, Hkv, D, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bts = perm.reshape(copies, B, max_pages).to(torch.int32)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, k, v, list(bts), kv_lens


def paged_pages(torch, quantize_rows, kind, k, v):
    """(k, v, scale kwargs) of float pages in the page format ``kind``."""
    if kind == "int8":
        (kc, ks), (vc, vs) = quantize_rows(k), quantize_rows(v)
        return kc, vc, {"k_scales": ks, "v_scales": vs}
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    return k.to(dtype), v.to(dtype), {}


def check_paged_splits(torch, ref, da, quantize_rows, gen):
    """Phase 3c: the paged kernel's split-K against its plain version:
    kv_len at every split edge and one either side, kv_len = max_pages *
    ps and an idle lane on the zeroed scratch page, windows that begin
    inside a split with whole splits before them, page sizes 4 and 16,
    long tables (max_pages 256, kv_len 4096), G 1-16 at D 16-256, q in
    f32 and bf16, for f32, bf16 and int8 pages.  Returns the largest
    |kernel - plain| for float pages and for int8 pages."""
    kernel = da.paged_decode_attention
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs = {"float": 0.0, "int8": 0.0}

    def run(name, kind, shape, windows, q_dtypes, softcaps=(0.0, 30.0),
            scratch=True):
        q, k, v, (bt,), lens = make_case(torch, gen, dtype=torch.float32,
                                         **shape)
        if scratch:                # the idle lane's table on the scratch page
            k[0], v[0] = 0.0, 0.0
            bt[int(torch.argmin(lens))] = 0
        k, v, scales = paged_pages(torch, quantize_rows, kind, k, v)
        live = lens > 0
        n = 0
        err = 0.0
        for q_dtype in q_dtypes:
            qq = q.to(q_dtype)
            for window in windows:
                for softcap in softcaps:
                    got = kernel(qq, k, v, bt, lens, window, softcap=softcap,
                                 **scales)
                    torch.cuda.synchronize()
                    want = ref.paged_decode_attention_ref(
                        qq, k, v, bt, lens, window, softcap=softcap,
                        **scales)
                    what = (f"{name} {kind} pages q {q_dtype} "
                            f"window={window} softcap={softcap}")
                    if bool((got[~live] != 0).any()):
                        fail(f"{what}: an idle lane is not zero")
                    err = max(err, check(torch, got, want, live, what))
                    n += 1
        key = "int8" if kind == "int8" else "float"
        errs[key] = max(errs[key], err)
        print(f"[kernel] paged splits, {name}, {kind} pages: {n} cases, "
              f"max|kernel-plain| {err:.3e}")

    for kind in ("f32", "bf16", "int8"):
        for ps, mp in ((16, 64), (4, 48)):
            B, Hkv, G = 2, 2, 2
            ng = da.paged_heads_per_block(G, kind == "int8")
            n_split, chunk = da.paged_split_plan(mp, ps, B * Hkv * -(-G // ng),
                                                 sms)
            edge = chunk * ps
            lens = sorted({min(max(z * edge + d, 0), mp * ps)
                           for z in range(1, n_split) for d in (-1, 0, 1)}
                          | {0, 1, mp * ps})
            inside = 2 * edge + edge // 2
            run(f"ps={ps} max_pages={mp} ({n_split} splits of {chunk} "
                f"pages), kv_len at split edges", kind,
                dict(B=len(lens), Hkv=Hkv, G=G, D=128, ps=ps, max_pages=mp,
                     lens=lens), (0, 7, inside), (torch.float32,
                                                  torch.bfloat16))
        if kind != "f32":
            run("long tables (max_pages 256, kv_len to 4096)", kind,
                dict(B=8, Hkv=8, G=2, D=128, ps=16, max_pages=256,
                     lens=[0, 4096, 4095, 4081, 3000, 2049, 1024, 17]),
                (0, 1000), (torch.bfloat16,), (0.0,))
        for G, D in ((1, 256), (3, 64), (5, 16), (8, 128), (10, 256),
                     (16, 128), (16, 48)):
            run(f"G={G} D={D}", kind,
                dict(B=5, Hkv=2, G=G, D=D, ps=16, max_pages=24,
                     lens=[0, 1, 100, 257, 384]), (0, 33), (torch.bfloat16,))
    return errs["float"], errs["int8"]


def check_paged_graph(torch, ref, kernel, quantize_rows, gen):
    """Phase 3d: one paged call captured in a CUDA graph and replayed
    equals an eager call, also after kv_lens and the block table change in
    place (read on the device at each replay, never on the host)."""
    for kind in ("bf16", "int8"):
        q, k, v, (bt,), lens = make_case(
            torch, gen, B=8, Hkv=8, G=2, D=128, ps=16, max_pages=64,
            lens=[0, 129, 201, 321, 417, 385, 449, 513], dtype=torch.float32)
        q = q.to(torch.bfloat16)
        k, v, scales = paged_pages(torch, quantize_rows, kind, k, v)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kernel(q, k, v, bt, lens, **scales)
        torch.cuda.current_stream().wait_stream(side)
        before = kernel.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = kernel(q, k, v, bt, lens, **scales)
        if kernel.launches != before + 1:
            fail(f"graph capture counted {kernel.launches - before} launches")
        for step in range(2):
            if step:                       # new lengths and tables in place
                lens.copy_(torch.tensor([600, 1, 0, 1024, 17, 16, 300, 999],
                                        dtype=torch.int32))
                bt.copy_(bt.flip(0))
            graph.replay()
            eager = kernel(q, k, v, bt, lens, **scales)
            torch.cuda.synchronize()
            if not torch.equal(captured, eager):
                fail(f"{kind} pages: graph replay {step} differs from an "
                     "eager call")
            check(torch, captured, ref.paged_decode_attention_ref(
                q, k, v, bt, lens, **scales), lens > 0,
                f"{kind} pages graph replay {step}")
        print(f"[kernel] paged {kind} pages in a CUDA graph: 2 replays "
              f"(kv_lens and block table changed in place between them) "
              f"equal eager calls bit for bit")
        del graph, captured


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


def serve_prompts(np, V):
    """Phase 5's traffic (seed 0): 8 prompts of 128-512 random tokens,
    the third and the fourth sharing a 256-token prefix."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, V, 256).tolist()
    lens_p = [128, 200, 256 + 64, 256 + 160, 384, 448, 500, 512]
    prompts = [rng.integers(0, V, n).tolist() for n in lens_p]
    prompts[2] = prefix + prompts[2][256:]
    prompts[3] = prefix + prompts[3][256:]
    return prompts


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


def profiled(torch, run, n):
    """``key_averages()`` of torch.profiler over ``n`` calls of ``run()``,
    each synchronised.  One call before them is the profiler's warm-up,
    its events dropped: a trace that opens on a busy device can miss its
    first launches (once, every kernel's count came out ~1 % short)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n,
                                   repeat=1)) as prof:
        for _ in range(n + 1):
            run()
            torch.cuda.synchronize()
            prof.step()
    return prof.key_averages()


def port_kernels():
    """The port's kernel wrappers by name; each adds one to its
    ``.launches`` where it launches its kernel."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import q4_gemm as qg
    from repro_torch.kernels import rglru_scan as rs
    return {"paged_decode_attention": da.paged_decode_attention,
            "q4_gemm": qg.q4_gemm, "decode_attention": da.decode_attention,
            "rglru_scan": rs.rglru_scan,
            "rglru_scan_reverse": rs.rglru_scan_reverse}


def kernel_times(torch, run, n):
    """Device milliseconds and launches per run by kernel name, from
    :func:`profiled` over ``n`` calls of ``run()``.  Every call launches
    the same kernels, so the wrappers' own counts over the traced calls
    must be whole per call: if one is not, a launch really went missing
    and the script fails.  If they are and the trace's count of some
    kernel is not, the trace lost events (once, one of 112 paged launches
    went missing in a q4 + int8 decode step, after the warm-up): it is
    taken again, up to three traces, each retrace counted on
    ``kernel_times.retraces`` (in the kernels line), and the last one is
    returned; the callers' exact launch checks apply to it unchanged."""
    from torch.autograd import DeviceType
    wrappers = port_kernels()
    tries = 3
    for attempt in range(1, tries + 1):
        before = {name: fn.launches for name, fn in wrappers.items()}
        events = profiled(torch, run, n)
        for name, fn in wrappers.items():          # n + 1: the warm-up too
            if (fn.launches - before[name]) % (n + 1):
                fail(f"{name}: {fn.launches - before[name]} launches over "
                     f"{n + 1} calls that each launch the same kernels")
        by_kernel, lost = {}, []
        for e in events:
            if e.device_type != DeviceType.CUDA:  # host ops: no device time
                continue
            if e.key.startswith("ProfilerStep"):  # the schedule's step marks
                continue
            if e.device_time_total > 0:               # microseconds
                by_kernel[e.key] = (e.device_time_total / n / 1e3,
                                    e.count / n)
                if e.count % n:
                    lost.append(e.key)
        if not lost or attempt == tries:
            break
        kernel_times.retraces += 1
        print(f"[profile] trace {attempt} of {tries}: {len(lost)} kernel(s) "
              f"with launches not whole per call while the wrappers' counts "
              f"are (events lost), e.g. {lost[0][:60]}; tracing again")
    return by_kernel


kernel_times.retraces = 0


def print_top(by_kernel, k=8):
    for name, (ms, n) in sorted(by_kernel.items(),
                                key=lambda kv: -kv[1][0])[:k]:
        print(f"[profile]   {ms * 1e3:8.1f} us/step {n:5.0f} launches/step  "
              f"{name[:80]}")


def kernel_share(by_kernel, parts):
    """(device ms, launches) per step of the kernels whose names hold any
    of ``parts``."""
    hits = [v for name, v in by_kernel.items()
            if any(part in name for part in parts)]
    return sum(ms for ms, _ in hits), sum(n for _, n in hits)


def profile_step(torch, step, first, label, card, batch=8, stats=None,
                 n_steps=4):
    """Host wall per full-width decode step (``step(pos)`` runs one,
    synchronised, no profiler) over ``n_steps`` steps, then device time
    by kernel name from torch.profiler over as many further steps.  Returns the
    device milliseconds per step by kernel name (and puts the wall and
    device-busy milliseconds per step into ``stats``, if given)."""

    def steps(start):
        for s in range(n_steps):
            step(start + s)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(first)
    wall_ms = (time.perf_counter() - t0) / n_steps * 1e3
    done = []                       # the profiled steps follow the timed

    def next_step():
        step(first + n_steps + len(done))
        done.append(1)

    by_kernel = kernel_times(torch, next_step, n_steps)
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    print(f"[profile] {label} step (B={batch}): wall {wall_ms:.2f} "
          f"ms, device busy {busy_ms:.2f} ms ({busy_ms / wall_ms:.1%} of "
          f"wall) — {card}")
    print_top(by_kernel)
    if stats is not None:
        stats.update(wall_ms=wall_ms, busy_ms=busy_ms)
    return by_kernel


def q4_profile(by_kernel, n_calls, label, card):
    """The Q4_0 kernel in a profiled forward call: device ms per call of
    the forward and its launches, which must be ``n_calls``."""
    ms, n = kernel_share(by_kernel, ("q4_mma_kernel", "q4_decode_kernel",
                                     "q4_gemm_kernel"))
    if round(n) != n_calls:
        fail(f"{label}: {n:.0f} Q4_0 launches, not {n_calls}")
    print(f"[profile] Q4_0 GEMM in the {label}: {ms * 1e3:.1f} us over "
          f"{n:.0f} launches ({ms / n * 1e3:.2f} us a call) — {card}")
    return ms


def paged_profile(by_kernel, n_calls, label, card):
    """The paged kernel's two launches in a profiled step: device ms per
    step of the split and the merge launches, each of which must run
    ``n_calls`` times (once per layer in a decode step, S times per layer
    in a verify step).  Returns the device ms per call, both included."""
    found = {}
    for part in ("paged_split_kernel", "paged_merge_kernel"):
        found[part] = kernel_share(by_kernel, (part,))
        if found[part][1] != n_calls:
            fail(f"{label} step: {found[part][1]} {part} launches a step, "
                 f"not {n_calls}")
    (ms_s, n_s), (ms_m, n_m) = found.values()
    print(f"[profile] paged decode attention in the {label} step: "
          f"split {ms_s * 1e3:.1f} us/step over {n_s:.0f} launches, merge "
          f"{ms_m * 1e3:.1f} us/step over {n_m:.0f} launches, "
          f"{(ms_s + ms_m) / n_calls * 1e3:.1f} us a call — {card}")
    return (ms_s + ms_m) / n_calls


def time_serving_state(torch, F, ref, kernel, cache, pos, cfg, gen, label,
                       card):
    """The paged kernel at the serving path's own inputs: this state's
    block table and lengths, cycling the layers' pools as one decode
    step does (so K/V come from HBM, not L2).  Returns (max error, kernel
    ms, plain ms, SDPA ms, bound ms, bound_by, for int8 pages the bf16
    kernel's ms on the same state dequantized, and the kernel's n_split
    there)."""
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
    n_split, chunk = kernel.plan            # what this call launched
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
    print(f"[timing] {label} serving state (B=8, kv_len {lens.tolist()}, "
          f"max_pages {mp}: {n_split} splits of {chunk} pages): "
          f"kernel {t_k * 1e3:.1f} us, plain {t_p * 1e3:.1f} us, sdpa "
          f"(pre-gathered{', dequantized' if int8 else ''}, excluded from "
          f"the time) {t_l * 1e3:.1f} us"
          + (f", bf16 kernel on the same state {t_bf16 * 1e3:.1f} us"
             if int8 else "")
          + f", bound {b_ms * 1e3:.2f} us ({b_by}) — {card}")
    return err, t_k, t_p, t_l, b_ms, b_by, t_bf16, n_split


def ring_positions(torch, n_written, slots, dev="cuda"):
    """The position array of a ring of ``slots`` after positions
    0 .. n_written - 1 were written at ``p % slots`` (-1 = empty)."""
    pos = torch.full((slots,), -1, dtype=torch.int32)
    p = torch.arange(max(n_written - slots, 0), n_written, dtype=torch.int32)
    pos[p.long() % slots] = p
    return pos.to(dev)


def check_decode_kernel(torch, ref, kern, gen, dev="cuda"):
    """Phase 12: the contiguous decode kernel against its plain version,
    in the TPU form (kv_len, nothing valid at 0: the mean of V in both)
    and in the ring form (filling, full and wrapped rings).  Returns the
    largest |kernel - plain|."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("recurrentgemma B=4", 4, 560, 1, 10, 256, bf16),
             ("recurrentgemma B=8", 8, 560, 1, 10, 256, bf16),
             ("qwen3", 8, 1024, 8, 2, 128, bf16),
             ("bench-tiny", 8, 256, 2, 2, 32, f32)]
    max_err = 0.0
    for name, B, S, H, G, D, dtype in cases:
        q = torch.randn(B, H, G, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
        runs = []
        for kv_len in (0, 1, 300, S):
            for window, softcap in ((0, 0.0), (0, 30.0), (7, 0.0)):
                runs.append((f"kv_len={kv_len} window={window} "
                             f"softcap={softcap}",
                             dict(kv_len=kv_len, window=window,
                                  softcap=softcap)))
        for n_written in (300, S, 3 * S - 100):
            pos = ring_positions(torch, n_written, S, dev)
            for window in (7, 2048):
                for softcap in (0.0, 30.0):
                    runs.append((f"ring of {S} after {n_written} "
                                 f"positions window={window} "
                                 f"softcap={softcap}",
                                 dict(kv_positions=pos, q_pos=n_written - 1,
                                      window=window, softcap=softcap)))
        case_err = 0.0
        for what, kw in runs:
            got = kern(q, k, v, **kw)
            torch.cuda.synchronize()
            want = ref.decode_attention_ref(q, k, v, **kw)
            err = check(torch, got, want, ..., f"{name} {what}")
            case_err = max(case_err, err)
        max_err = max(max_err, case_err)
        print(f"[kernel] decode_attention {name} (B={B}, S={S}, {H}/{H * G}"
              f" heads, D={D}, {dtype}): {len(runs)} cases, max|kernel-"
              f"plain| {case_err:.3e}")
    return max_err


def scan_stage_edge(plan, B, W, edge, sms):
    """The first T whose scan plan's stage is T - edge steps long: edge -1
    is one step short of a stage, +1 one step past it."""
    return next(T for T in range(2, 4096) if plan(B, T, W, sms)[1] == T - edge)


def check_scan_kernel(torch, ref, kern, plan, sms, gen, dev="cuda"):
    """Phase 13: the RG-LRU scan kernel against its plain version, bit
    for bit: the prefill buckets' shapes, one prompt at the window length,
    T around a multiple of the stage and one step short of and past the
    stage of ``plan`` on ``sms`` SMs, T = 1, and widths off the 16-byte
    unit of the tensor copies (6, 36: the 4-byte path) or of 32 (36, 64:
    a ragged last strip).  Returns the largest |kernel - plain|."""
    max_err = 0.0
    shapes = [(4, 512, 2560), (8, 256, 2560), (1, 2048, 2560),
              (4, 511, 2560), (4, 513, 2560), (2, 37, 64), (4, 1, 2560),
              (2, 37, 6), (2, 100, 36)]
    shapes += [(4, scan_stage_edge(plan, 4, 2560, e, sms), 2560)
               for e in (-1, 1)]
    for B, T, W in shapes:
        a = 0.5 + 0.5 * torch.rand(B, T, W, generator=gen, device=dev)
        u = torch.randn(B, T, W, generator=gen, device=dev)
        h0 = torch.randn(B, W, generator=gen, device=dev)
        for h in (None, h0):
            got = kern(a, u, h)
            torch.cuda.synchronize()
            want = ref.rglru_scan_ref(a, u, h)
            err = (got - want).abs().max().item()
            if not (bool(torch.isfinite(got).all()) and err <= SCAN_TOL):
                fail(f"rglru_scan ({B}, {T}, {W}) h0={h is not None}: "
                     f"kernel disagrees with the plain version ({err:.3e})")
            max_err = max(max_err, err)
            print(f"[kernel] rglru_scan ({B}, {T}, {W}) h0="
                  f"{h is not None}: max|kernel-plain| {err:.3e}, plan "
                  f"{getattr(kern, 'plan', None)}")
    return max_err


def time_decode_kernel(torch, F, ref, kern, gen, card, dev="cuda"):
    """Phase 14a: the decode kernel over a ring at RecurrentGemma's shape,
    K/V rotated past the L2.  Returns {(B, kv_len): (kernel ms, plain ms,
    SDPA ms, bound ms, bound_by)}."""
    H, G, D, out = 1, 10, 256, {}
    for B in (4, 8):
        for kv_len in (544, 2048):
            S = kv_len + 16
            n = max(2, math.ceil(ROTATE_BYTES / (2 * B * S * H * D * 2)))
            q = torch.randn(B, H, G, D, generator=gen,
                            device=dev).to(torch.bfloat16)
            ks = [torch.randn(B, S, H, D, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(n)]
            vs = [torch.randn(B, S, H, D, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(n)]
            pos = ring_positions(torch, kv_len, S, dev)
            kw = dict(kv_positions=pos, q_pos=kv_len - 1, window=2048)
            t_k = cuda_ms(torch, lambda i: kern(q, ks[i % n], vs[i % n],
                                                **kw), 200)
            t_p = cuda_ms(torch, lambda i: ref.decode_attention_ref(
                q, ks[i % n], vs[i % n], **kw).to(q.dtype), 20)
            # yardstick only: SDPA over the same cache, one kv head
            # expanded to the 10 query heads (enable_gqa), boolean mask
            kt = [t.transpose(1, 2).contiguous() for t in ks]
            vt = [t.transpose(1, 2).contiguous() for t in vs]
            qs = q.reshape(B, H * G, 1, D)
            valid = (pos >= 0) & (pos <= kv_len - 1) & (pos > kv_len - 1 -
                                                         2048)
            mask = valid.reshape(1, 1, 1, S)
            t_l = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
                qs, kt[i % n], vt[i % n], attn_mask=mask, enable_gqa=True),
                200)
            nbytes = (2 * B * kv_len * H * D * 2 + 2 * B * H * G * D * 2
                      + S * 4)
            b_ms, b_by = least(nbytes, 4 * B * kv_len * H * G * D,
                               "bfloat16")
            out[(B, kv_len)] = (t_k, t_p, t_l, b_ms, b_by)
            print(f"[timing] decode_attention B={B} kv_len={kv_len} (ring "
                  f"of {S}, MQA 10 heads, D=256, bf16): kernel "
                  f"{t_k * 1e3:.1f} us, plain {t_p * 1e3:.1f} us, sdpa "
                  f"(masked, enable_gqa) {t_l * 1e3:.1f} us, bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}) — {card}")
            del ks, vs, kt, vt
    return out


#: the cross-attention reads of a decode step (B, kv_len, kv heads, G, D):
#: Llama-3.2-Vision's 6404 image tokens and Whisper-medium's 1500 frames
CROSS_SHAPES = ((4, 6404, 8, 4, 128), (4, 1500, 16, 1, 64))


def time_cross_kernel(torch, F, ref, kern, gen, card):
    """Phase 14c: the decode kernel in the TPU kernel's ``kv_len`` form,
    every slot valid, at CROSS_SHAPES with bf16 K/V rotated past the L2:
    each held against its plain version first, then timed beside it, its
    byte bound and ``scaled_dot_product_attention`` over the same K/V (no
    mask: every slot is valid; the yardstick the port never calls).
    Returns {shape: (kernel ms, plain ms, SDPA ms, bound ms, bound_by,
    max |kernel - plain|)}."""
    out = {}
    for B, M, H, G, D in CROSS_SHAPES:
        n = max(2, math.ceil(ROTATE_BYTES / (2 * B * M * H * D * 2)))
        q = torch.randn(B, H, G, D, generator=gen,
                        device="cuda").to(torch.bfloat16)
        ks = [torch.randn(B, M, H, D, generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(n)]
        vs = [torch.randn(B, M, H, D, generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(n)]
        got = kern(q, ks[0], vs[0], M)
        torch.cuda.synchronize()
        err = check(torch, got, ref.decode_attention_ref(q, ks[0], vs[0], M),
                    ..., f"decode_attention kv_len={M} (B={B}, {H}/{H * G} "
                    f"heads, D={D})")
        t_k = cuda_ms(torch, lambda i: kern(q, ks[i % n], vs[i % n], M), 200)
        t_p = cuda_ms(torch, lambda i: ref.decode_attention_ref(
            q, ks[i % n], vs[i % n], M).to(q.dtype), 20)
        kt = [t.transpose(1, 2).contiguous() for t in ks]
        vt = [t.transpose(1, 2).contiguous() for t in vs]
        qs = q.reshape(B, H * G, 1, D)
        t_l = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
            qs, kt[i % n], vt[i % n], enable_gqa=True), 200)
        b_ms, b_by = least(2 * B * M * H * D * 2 + 2 * B * H * G * D * 2,
                           4 * B * M * H * G * D, "bfloat16")
        out[(B, M, H, G, D)] = (t_k, t_p, t_l, b_ms, b_by, err)
        print(f"[timing] decode_attention kv_len={M} (cross-attention read, "
              f"B={B}, {H}/{H * G} heads, D={D}, bf16 K/V, plan "
              f"{kern.plan}): kernel {t_k * 1e3:.1f} us, plain "
              f"{t_p * 1e3:.1f} us, sdpa (enable_gqa, no mask) "
              f"{t_l * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us ({b_by}); "
              f"max|kernel-plain| {err:.3e} — {card}")
        del ks, vs, kt, vt
    return out


#: the scan's timed shapes (B, T, W): the 512- and 256-token prefill
#: buckets of four prompts, one 512-token prompt, one prompt at the
#: window length; the first is the main path's
SCAN_SHAPES = ((4, 512, 2560), (4, 256, 2560), (1, 512, 2560),
               (1, 2048, 2560))


def time_scan_kernel(torch, ref, kern, gen, card, dev="cuda"):
    """Phase 14b: the scan at SCAN_SHAPES with a zero h0, as a prefill
    runs it; a and u rotated past the L2.  Returns {(B, T, W): (kernel
    ms, plain ms, bound ms, bound_by, plan)}."""
    out = {}
    for B, T, W in SCAN_SHAPES:
        n = max(2, math.ceil(ROTATE_BYTES / (2 * B * T * W * 4)))
        As = [0.5 + 0.5 * torch.rand(B, T, W, generator=gen, device=dev)
              for _ in range(n)]
        Us = [torch.randn(B, T, W, generator=gen, device=dev)
              for _ in range(n)]
        h0 = torch.zeros(B, W, device=dev)
        t_k = cuda_ms(torch, lambda i: kern(As[i % n], Us[i % n], h0), 100)
        t_p = cuda_ms(torch, lambda i: ref.rglru_scan_ref(
            As[i % n], Us[i % n], h0), 3)
        b_ms, b_by = least(12 * B * T * W + 4 * B * W, 2 * B * T * W,
                           "float32")
        plan = getattr(kern, "plan", None)
        out[(B, T, W)] = (t_k, t_p, b_ms, b_by, plan)
        print(f"[timing] rglru_scan ({B}, {T}, {W}) f32: kernel "
              f"{t_k * 1e3:.2f} us (roofline share {b_ms / t_k:.0%}), plain "
              f"{t_p * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us ({b_by}); "
              f"plan (warps a block, steps a stage, stages) {plan}; no "
              f"single PyTorch call computes this recurrence — {card}")
        del As, Us
    return out


def check_repeatable(torch, gen, kernels, quantize_rows, q4_0, dev="cuda"):
    """Phase 3f: each kernel called twice on the same inputs gives the
    same bits (no float atomics anywhere), at the main paths' shapes:
    the paged kernel (bf16 and int8 pages), the Q4_0 GEMM (bf16 x at M=8
    and 128, f32 x), the contiguous decode kernel over a ring and the
    RG-LRU scan."""
    paged, q4k, contig, scan = (kernels[n] for n in (
        "paged_decode_attention", "q4_gemm", "decode_attention",
        "rglru_scan"))
    q, k, v, (bt,), lens = make_case(
        torch, gen, B=8, Hkv=8, G=2, D=128, ps=16, max_pages=64,
        lens=[0, 1, 129, 300, 513, 700, 900, 1024], dtype=torch.bfloat16,
        dev=dev)
    (kc, ks), (vc, vs) = quantize_rows(k), quantize_rows(v)
    w = torch.randn(2048, 6144, generator=gen, device=dev) / 45.0
    packed, scales = q4_0.quantize(w)
    xs = [torch.randn(M, 2048, generator=gen, device=dev).to(dt)
          for M, dt in ((8, torch.bfloat16), (128, torch.bfloat16),
                        (8, torch.float32))]
    qr = torch.randn(4, 1, 10, 256, generator=gen, device=dev).to(
        torch.bfloat16)
    kr, vr = (torch.randn(4, 560, 1, 256, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    pos = ring_positions(torch, 1500, 560, dev)
    a = 0.5 + 0.5 * torch.rand(4, 512, 2560, generator=gen, device=dev)
    u = torch.randn(4, 512, 2560, generator=gen, device=dev)
    calls = [("paged bf16 pages", lambda: paged(q, k, v, bt, lens)),
             ("paged int8 pages", lambda: paged(q, kc, vc, bt, lens,
                                                k_scales=ks, v_scales=vs)),
             ("decode_attention ring", lambda: contig(
                 qr, kr, vr, kv_positions=pos, q_pos=1499, window=2048)),
             ("rglru_scan", lambda: scan(a, u, None))]
    calls += [(f"q4_gemm M={x.shape[0]} x {x.dtype}",
               lambda x=x: q4k(x, packed, scales)) for x in xs]
    for what, fn in calls:
        first, second = fn(), fn()
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            fail(f"{what}: two calls on the same input differ")
    print(f"[kernel] repeatable: {len(calls)} kernel calls, each twice on "
          f"the same input, bit-equal")


def counted(calls, name, fn):
    """``fn`` that adds one to ``calls[name]`` per call."""
    def call(*args, **kw):
        calls[name] += 1
        return fn(*args, **kw)
    return call


def serve_recurrentgemma(torch, np, kernels, card, dev="cuda", cfg=None,
                         lens=(256, 512), max_len=560):
    """Phase 15: full-width RecurrentGemma-2B through the bucket engine:
    a warm-up request, then 8 measured requests (four prompts of each
    length in ``lens``, 32 greedy tokens each, ``max_batch=4``) with
    every kernel's launch count set to 0 just before and read just
    after.  Returns (model, engine, prompts, launches by kernel name,
    runner calls by phase)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.quant import param_bytes
    from repro_torch.serving import (Request, SamplingParams, ServingEngine,
                                     throughput_report)
    cfg = cfg or get_config("recurrentgemma-2b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    wgen = torch.Generator(device=dev)
    wgen.manual_seed(0)
    params = model.init(wgen)
    torch.cuda.synchronize()
    print(f"[rg] {cfg.name}: {cfg.n_layers} layers ({model.n_full_blocks} "
          f"(R, R, A) blocks + {model.n_tail} tail), d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.resolved_head_dim}, "
          f"lru_width {cfg.lru_width}, window {cfg.sliding_window}; "
          f"{param_bytes(params) / 2**30:.3f} GiB of {cfg.dtype} weights "
          f"on the card ({time.perf_counter() - t0:.1f} s to draw)")
    eng = ServingEngine(model, params, max_len=max_len, seed=0, device=dev)
    del params
    calls = {"prefill": 0, "decode": 0}
    eng.runner.prefill = counted(calls, "prefill", eng.runner.prefill)
    eng.runner.decode = counted(calls, "decode", eng.runner.decode)
    rng = np.random.default_rng(1)
    V = cfg.vocab_size
    prompts = [rng.integers(0, V, n).tolist() for n in lens for _ in range(4)]
    eng.generate([Request(uid=100, prompt=prompts[0][:16],
                          sampling=SamplingParams(max_new_tokens=2))])
    reqs = [Request(uid=i, prompt=p,
                    sampling=SamplingParams(max_new_tokens=32))
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0                     # count the main path only
    calls.update(prefill=0, decode=0)
    comps = eng.generate(reqs, max_batch=4)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    if len(comps) != len(reqs):
        fail(f"rg: {len(comps)} of {len(reqs)} requests completed")
    for c in comps:
        if len(c.tokens) != 32 or not all(0 <= t < V for t in c.tokens):
            fail(f"rg: request {c.uid}: {len(c.tokens)} tokens, in vocab: "
                 f"{all(0 <= t < V for t in c.tokens)}")
    rep = throughput_report(comps, **eng.last_phase_s)
    ttft = sorted(c.t_first - c.t0 for c in comps)
    print(f"[rg] {len(comps)} requests x 32 tokens in "
          f"{len(eng._buckets(reqs, 4))} buckets; {calls['prefill']} "
          f"prefill calls, {calls['decode']} decode steps; launches "
          f"{launches}")
    print(f"[rg] decode {rep['decode_tok_per_s']:.1f} tok/s, prefill "
          f"{rep['prefill_tok_per_s']:.1f} tok/s, wall {rep['wall_s']:.3f} "
          f"s, TTFT p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms max "
          f"{ttft[-1] * 1e3:.1f} ms, peak memory {peak / 2**30:.2f} GiB — "
          f"{card}", flush=True)
    return model, eng, prompts, launches, calls


def prefill_profile(torch, model, params, toks, max_len, card, dev="cuda"):
    """One full-width prefill call of the bucket ``toks`` profiled by
    kernel: the scan must run once per RG-LRU layer.  Returns (device ms
    of the call, the scan's device ms in it)."""
    cache = model.init_cache(toks.shape[0], max_len, device=dev)

    def run():
        model.prefill(params, {"tokens": toks}, cache)

    run()
    torch.cuda.synchronize()
    by_kernel = kernel_times(torch, run, 2)
    busy = sum(ms for ms, _ in by_kernel.values())
    scan_ms, scan_n = kernel_share(by_kernel, ("rglru_scan",))
    n_rglru = model.kinds.count("rglru")
    if round(scan_n) != n_rglru:
        fail(f"RecurrentGemma prefill: {scan_n:.0f} rglru_scan launches a "
             f"call, not {n_rglru}")
    print(f"[profile] full-width RecurrentGemma prefill (B={toks.shape[0]}, "
          f"{toks.shape[1]} tokens): device busy {busy:.2f} ms; rglru_scan "
          f"{scan_ms * 1e3:.1f} us over {scan_n:.0f} launches "
          f"({scan_ms / scan_n * 1e3:.2f} us a call), {scan_ms / busy:.1%} "
          f"of the call — {card}")
    print_top(by_kernel)
    return busy, scan_ms


def rg_parity(torch, model, params, prompts, card, dev="cuda"):
    """Phase 16: from the 512-token bucket's prompts, prefill with the
    scan kernel and with the plain scan (fresh ring caches), then one
    decode step with the kernels and with the plain versions on a clone
    of the cache; logits must agree.  Then a prefill call of that bucket
    and a decode step are profiled.  Returns the device ms per step by
    kernel name, and the prefill's device ms and the scan's in it."""
    from repro_torch.models.weights import tree_map
    B, S = 4, len(prompts[-1])
    toks = torch.tensor(prompts[-B:], dtype=torch.long, device=dev)
    max_len = S + 48
    cache = model.init_cache(B, max_len, device=dev)
    got, _ = model.prefill(params, {"tokens": toks}, cache)
    plain_cache = model.init_cache(B, max_len, device=dev)
    want, _ = model.prefill(params, {"tokens": toks}, plain_cache,
                            impl="ref")
    logit_parity(torch, got, want, LOGIT_TOL_RG,
                 "RecurrentGemma prefill logits, scan kernel vs plain")
    del plain_cache
    prefill = prefill_profile(torch, model, params, toks, max_len, card, dev)
    fed = got[:, 0].float().argmax(-1, keepdim=True)
    clone = tree_map(lambda t: t.clone(), cache)
    got, _ = model.decode_step(params, cache, fed, S)
    want, _ = model.decode_step(params, clone, fed, S, impl="ref")
    logit_parity(torch, got, want, LOGIT_TOL_RG,
                 "RecurrentGemma decode logits, kernels vs plain")
    del clone
    return profile_step(torch, lambda p_: model.decode_step(
        params, cache, fed, p_), S + 1, "full-width RecurrentGemma decode",
        card,
        batch=B), prefill


#: speculative decoding's lookahead on the card: k = 2 drafts, so a
#: verify step feeds S = 3 columns and calls the paged kernel 3 x a layer
SPEC_K = 2


def clone_paged(cache):
    """A copy of a paged cache (block tables and every layer's buffers)."""
    return {"block_tables": cache["block_tables"].clone(),
            "layers": [{"self": {n_: t.clone() for n_, t in
                                 layer["self"].items()}}
                       for layer in cache["layers"]]}


def verify_phase(torch, np, gen, model, params, prompts, kv_dtype, tol,
                 label, card, ref_qmm=None, dev="cuda"):
    """Phase 9: from one prefilled state, SPEC_K + 1 sequential
    decode steps give each lane its greedy continuation; one verify step
    fed those tokens as drafts, on a copy of the state, must give column
    j's logits within ``tol`` of decode step j's (and accept every draft
    whose top-2 margin there exceeds ``tol``), and so must the verify
    step's plain version (plain paged attention; ``ref_qmm`` for the
    projections) against the kernels.  Then one decode step and one
    verify step are profiled on the same state.  Returns [decode,
    verify]: each a pair (device ms per step by kernel name, {"wall_ms",
    "busy_ms"} per step)."""
    S = SPEC_K + 1
    cache, clone, fed, pos, ps = parity_state(torch, np, gen, model, params,
                                              prompts, kv_dtype)
    plain_clone = clone_paged(clone)
    toks, dec = [fed], []
    for j in range(S):
        logits, _ = model.decode_step(params, cache, toks[-1], pos + j,
                                      page_size=ps)
        dec.append(logits)
        toks.append(logits[:, 0].float().argmax(-1, keepdim=True))
    feed = torch.cat(toks[:S], dim=1)          # fed token + SPEC_K drafts
    n_fed = torch.full_like(pos, S)
    ver, _ = model.verify_step(params, clone, feed, pos, n_fed, page_size=ps)
    for j in range(S):
        logit_parity(torch, ver[:, j:j + 1], dec[j], tol,
                     f"{label} verify column {j} vs decode step {j}")
    accepted = 0
    for j in range(1, S):     # draft j is checked by column j - 1
        acc = ver[:, j - 1].float().argmax(-1) == toks[j][:, 0]
        accepted += int(acc.sum())
    print(f"[verify] {label}: {accepted} of {SPEC_K * len(prompts)} greedy "
          f"drafts accepted by one verify step (S={S})")
    kernel_qmm = model.qmm
    if ref_qmm is not None:
        model.qmm = ref_qmm
    want, _ = model.verify_step(params, plain_clone, feed, pos, n_fed,
                                page_size=ps, impl="ref")
    model.qmm = kernel_qmm
    for j in range(S):
        logit_parity(torch, ver[:, j:j + 1], want[:, j:j + 1], tol,
                     f"{label} verify column {j}, kernels vs plain")
    del clone, plain_clone, ver, want, dec
    start = pos + S

    def decode(p_):
        model.decode_step(params, cache, fed, p_, page_size=ps)

    def verify(p_):
        model.verify_step(params, cache, feed, p_, n_fed, page_size=ps)

    out = []
    for what, step, first in (("decode", decode, start),
                              (f"verify (S={S})", verify, start + 8)):
        stats = {}
        out.append((profile_step(torch, step, first, f"{label} {what}", card,
                                 stats=stats, n_steps=2), stats))
    return out


def greedy_margin(torch, model, params, prompt, toks, i, kv_dtype,
                  dev="cuda"):
    """The top-2 logit margin of token ``i`` of the greedy continuation
    ``toks`` of ``prompt``, recomputed on one lane: one-shot prefill,
    then ``i`` decode steps fed ``toks``."""
    ps, P = 16, len(prompt)
    cache = model.init_cache(1, P + i + 1, page_size=ps, kv_dtype=kv_dtype,
                             device=dev)
    mp = cache["block_tables"].shape[1]
    cache["block_tables"].copy_(torch.arange(1, mp + 1, dtype=torch.int32,
                                             device=dev)[None])
    t = torch.zeros((1, 1 << max(3, (P - 1).bit_length())), dtype=torch.long,
                    device=dev)
    t[0, :P] = torch.tensor(prompt, device=dev)
    logits, _ = model.prefill_paged(params, {"tokens": t}, cache, 0, P,
                                    page_size=ps)
    for j in range(i):
        logits, _ = model.decode_step(
            params, cache, torch.tensor([[toks[j]]], device=dev),
            torch.tensor([P + j], device=dev), page_size=ps)
    top2 = logits[0, -1].float().topk(2).values
    return float(top2[0] - top2[1])


def spec_prompts(np, V, seed=2):
    """4 prompts of 128-512 tokens, each a random segment repeated (so
    prompt lookup drafts), the middle two sharing a 256-token prefix."""
    rng = np.random.default_rng(seed)

    def repeated(n):
        seg = rng.integers(0, V, int(rng.integers(8, 48))).tolist()
        return (seg * (n // len(seg) + 1))[:n]

    prompts = [repeated(n) for n in (128, 256 + 64, 256 + 160, 512)]
    prefix = repeated(256)
    prompts[1] = prefix + prompts[1][256:]
    prompts[2] = prefix + prompts[2][256:]
    return prompts


def serve_async(torch, eng, prompts, kernels, V):
    """One run of ``prompts`` through ``AsyncEngine`` ``eng``: a warm-up
    request over the shared prefix, then every kernel's launch count set
    to 0, all requests submitted at once, the first streamed and the
    rest waited for.  Returns (completions, streamed tokens, launches,
    runner calls by kind, q4 forward calls by phase or None, spec
    counters, (tokens emitted, lanes) of each verify step, peak memory,
    TTFTs, report, free pages before and after)."""
    from repro_torch.serving import Request, SamplingParams, \
        throughput_report
    core, reg = eng.core, eng.registry
    h = eng.submit(Request(uid=0, prompt=prompts[1][:256] + [1, 2, 3],
                           sampling=SamplingParams(max_new_tokens=2)))
    eng.result(h, timeout=600)
    while core.has_work():
        time.sleep(0.01)
    hist = {kind: reg.get(f"runner.{kind}.dispatch_ms")
            for kind in ("prefill", "decode", "verify")}
    disp = reg.get("runner.quant.q4_dispatch")
    phases = ("prefill", "decode", "verify")

    def snap():
        calls = {k_: hist[k_].value(shards="1")[1] for k_ in hist}
        fwd = ({p_: disp.value(phase=p_) for p_ in phases} if disp
               else None)
        spec = {n_: (reg.get(n_).value() if reg.get(n_) else 0.0)
                for n_ in ("spec.drafted", "spec.accepted",
                           "spec.rollbacks", "spec.pages_returned",
                           "spec.auto_disabled")}
        phase_s = {p_: reg.get(f"serving.phase.{p_}_s").value()
                   for p_ in ("prefill", "decode")}
        return calls, fwd, spec, phase_s

    before = snap()
    free0 = core.pool.n_free()
    emitted = []
    verify_step = core._decode_verify

    def counted_verify(plan, *args):
        n = verify_step(plan, *args)
        emitted.append((n, len(plan.decodes)))
        return n

    core._decode_verify = counted_verify
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0                     # count the main path only
    reqs = [Request(uid=i, prompt=p,
                    sampling=SamplingParams(max_new_tokens=32))
            for i, p in enumerate(prompts)]
    handles = [eng.submit(r) for r in reqs]
    streamed = list(eng.stream(handles[0], timeout=600))
    comps = [eng.result(h_, timeout=600) for h_ in handles]
    while core.has_work():
        time.sleep(0.01)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    core._decode_verify = verify_step
    after = snap()
    calls = {k_: int(after[0][k_] - before[0][k_]) for k_ in hist}
    fwd = ({p_: int(after[1][p_] - before[1][p_]) for p_ in phases}
           if disp else None)
    spec = {n_: int(after[2][n_] - before[2][n_]) for n_ in after[2]}
    phase_s = {p_: after[3][p_] - before[3][p_] for p_ in after[3]}
    for c in comps:
        if len(c.tokens) != 32 or not all(0 <= t < V for t in c.tokens):
            raise RuntimeError(f"request {c.uid}: {len(c.tokens)} tokens, "
                               f"in vocab: {all(0 <= t < V for t in c.tokens)}")
    if streamed != comps[0].tokens:
        raise RuntimeError("the streamed tokens differ from the result's")
    rep = throughput_report(comps, prefill_s=phase_s["prefill"],
                            decode_s=phase_s["decode"])
    ttft = sorted(c.t_first - c.t0 for c in comps)
    return dict(comps=comps, launches=launches, calls=calls, fwd=fwd,
                spec=spec, emitted=emitted, peak=peak, ttft=ttft, rep=rep,
                free=(free0, core.pool.n_free()))


def async_spec_phase(torch, model, draw_params, cfg, kernels, prompts,
                     quant, tol, label, card, dev="cuda"):
    """Phase 10: full-width Qwen3-1.7B through ``AsyncEngine``
    with ``spec_decode=SPEC_K`` and then 0 on the same prompts
    (``max_running=8``, 16-token pages, 128-token prefill chunks, 32
    greedy tokens each; :func:`spec_prompts`), each engine built from
    the weights ``draw_params()`` returns.  Checks every completion, ``spec.drafted > 0``,
    the paged launches (n_layers x (plain decode steps + S x verify
    steps)) and under q4 the Q4_0 launches (7 x n_layers x forward calls,
    verify included), the free pages back at their start, and the k=2
    tokens against k=0's under the margin rule: where they first differ,
    k=0's top-2 logit margin there must be under ``tol``.  Returns the
    k=2 run's launches by kernel name and both runs' numbers."""
    from repro_torch.serving import AsyncEngine
    S, L, V = SPEC_K + 1, cfg.n_layers, cfg.vocab_size
    runs = {}
    for k in (SPEC_K, 0):
        eng = AsyncEngine(model, draw_params(), max_len=1024,
                          max_running=8, page_size=16, prefill_chunk=128,
                          spec_decode=k, quant=quant, seed=0, device=dev)
        try:
            run = serve_async(torch, eng, prompts, kernels, V)
        finally:
            eng.shutdown()
        if k == 0:                  # for the margins of the k=0 tokens
            run["params"] = eng.core.runner.params
        runs[k] = run
        del eng
        gc.collect()                # the stepper thread's cycle holds it
        torch.cuda.empty_cache()
        calls, launches = run["calls"], run["launches"]
        paged = launches["paged_decode_attention"]
        want = L * (calls["decode"] + S * calls["verify"])
        if paged != want or calls["decode"] + calls["verify"] <= 0:
            fail(f"{label} k={k}: paged launches {paged} != {L} x "
                 f"({calls['decode']} decode steps + {S} x "
                 f"{calls['verify']} verify steps)")
        if run["fwd"] is not None:
            fwd = sum(run["fwd"].values())
            if launches["q4_gemm"] != 7 * L * fwd:
                fail(f"{label} k={k}: q4_gemm launches "
                     f"{launches['q4_gemm']} != 7 x {L} x {fwd} forward "
                     f"calls {run['fwd']}")
            if run["fwd"]["verify"] != calls["verify"]:
                fail(f"{label} k={k}: q4_dispatch verify "
                     f"{run['fwd']['verify']} != {calls['verify']} verify "
                     f"steps")
        elif launches["q4_gemm"]:
            fail(f"{label}: bf16 serving launched q4_gemm")
        if run["free"][0] != run["free"][1]:
            fail(f"{label} k={k}: {run['free'][0]} free pages before the "
                 f"run, {run['free'][1]} after")
        if launches["decode_attention"] or launches["rglru_scan"]:
            fail(f"{label}: paged serving launched a bucket-path kernel")
        rep = run["rep"]
        ttft_p50 = run["ttft"][len(prompts) // 2]
        print(f"[async] {label} k={k}: {len(prompts)} requests x 32 "
              f"tokens, one streamed; {calls['prefill']} prefill chunks, "
              f"{calls['decode']} decode steps, {calls['verify']} verify "
              f"steps; launches {launches}"
              + (f"; q4 forward calls {run['fwd']}" if run["fwd"] else ""))
        print(f"[async] {label} k={k}: decode {rep['decode_tok_per_s']:.1f} "
              f"tok/s, prefill {rep['prefill_tok_per_s']:.1f} tok/s, wall "
              f"{rep['wall_s']:.3f} s, TTFT p50 {ttft_p50 * 1e3:.1f} ms max "
              f"{run['ttft'][-1] * 1e3:.1f}"
              f" ms, peak memory {run['peak'] / 2**30:.2f} GiB; spec "
              f"{run['spec']}; free pages {run['free'][0]} -> "
              f"{run['free'][1]} — {card}", flush=True)
    if runs[SPEC_K]["spec"]["spec.drafted"] <= 0:
        fail(f"{label}: prompt lookup drafted nothing")
    agree, total = margin_rule(
        torch, model, runs[0]["params"], prompts,
        [c.tokens for c in runs[SPEC_K]["comps"]],
        [c.tokens for c in runs[0]["comps"]],
        quant.kv_dtype if quant else "fp32", tol,
        f"[async] {label}", f"k={SPEC_K}", "k=0", dev)
    print(f"[async] {label}: k={SPEC_K} tokens agree with k=0 on "
          f"{agree}/{total} (up to each request's first difference)")
    del runs[0]["params"]
    return runs


def margin_rule(torch, model, params, prompts, got, want, kv_dtype, tol,
                tag, got_name, want_name, dev="cuda"):
    """Greedy tokens ``got`` against ``want`` (lists of token lists, one
    per prompt) under the margin rule: where a request's two first
    differ, ``want``'s top-2 logit margin there (recomputed on one lane
    with ``params``) must be under ``tol``.  Returns (tokens that agree
    up to each request's first difference, tokens in all)."""
    agree = total = 0
    for j, (g, w, prompt) in enumerate(zip(got, want, prompts)):
        total += len(w)
        if len(g) != len(w):
            fail(f"{tag}: request {j}: {got_name} gave {len(g)} tokens, "
                 f"{want_name} {len(w)}")
        diff = [i for i, (a, b) in enumerate(zip(g, w)) if a != b]
        if not diff:
            agree += len(w)
            continue
        i = diff[0]
        agree += i
        margin = greedy_margin(torch, model, params, prompt, w, i, kv_dtype,
                               dev)
        print(f"{tag}: request {j} {got_name} and {want_name} first differ "
              f"at token {i}; {want_name} top-2 margin there {margin:.4f} "
              f"(tol {tol})")
        if not margin < tol:
            fail(f"{tag}: request {j}: {got_name} and {want_name} differ at "
                 f"token {i} with a clear margin {margin:.4f}")
    return agree, total


def cli_phase(card):
    """Phase 11: ``python -m repro_torch.launch.serve --engine async
    --spec-decode 2 --metrics-json M --trace T`` (reduced qwen3-1.7b, on
    the card) must exit 0, and both files must pass
    ``python -m repro_torch.obs.validate``."""
    out_dir = ROOT / "build" / "chip_smoke_cli"
    out_dir.mkdir(parents=True, exist_ok=True)
    m, t = out_dir / "metrics.json", out_dir / "trace.jsonl"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-1.7b", "--engine", "async", "--spec-decode", str(SPEC_K),
         "--max-new", "8", "--metrics-json", str(m), "--trace", str(t)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        fail(f"serve CLI exited {run.returncode}: {run.stderr[-2000:]}")
    lines = [ln for ln in run.stdout.splitlines()
             if ln.startswith(("arch=", "warm-up", "[", "throughput",
                               "ttft"))]
    for ln in lines:
        print(f"[cli]   {ln}")
    if "warm-up training (40 steps) ..." not in run.stdout:
        fail("the serve CLI did not warm-train at its default "
             "--warmup-steps 40")
    check_run = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.validate", "--metrics",
         str(m), "--trace", str(t), "--require-counter", "spec.drafted"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    if check_run.returncode != 0:
        fail(f"obs.validate: {check_run.stdout[-1000:]} "
             f"{check_run.stderr[-1000:]}")
    print(f"[cli] --engine async --spec-decode {SPEC_K} on the card, after "
          f"the default 40 warm-up train steps: exit 0 in {wall:.1f} s; "
          f"metrics and trace validate — {card}")


#: greedy tokens each request of phases 17a and 17b asks for
HTTP_TOKENS = 32
#: the vocabulary of the CLI's reduced configs (``reduced_config``'s 512)
REDUCED_VOCAB = 512


def http_stream(host, port, prompt, max_tokens, timeout=600.0):
    """One streamed ``POST /v1/completions`` on its own connection.
    Returns (token ids, the ``done`` frame, seconds from sending the
    request to the first token frame, seconds to ``[DONE]``); raises on
    another status than 200, an ``error`` frame or a stream cut short."""
    import http.client
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": prompt, "max_tokens": max_tokens,
                                 "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {resp.read()[:300]!r}")
        toks, done, t_first = [], None, None
        while True:
            line = resp.readline()
            if not line:
                raise RuntimeError("the stream closed before [DONE]")
            line = line.strip()
            if not line.startswith(b"data:"):
                continue
            payload = line[5:].strip()
            if payload == b"[DONE]":
                break
            ev = json.loads(payload)
            if "error" in ev:
                raise RuntimeError(f"error frame: {ev['error']}")
            if "token" in ev:
                if t_first is None:
                    t_first = time.perf_counter()
                toks.append(int(ev["token"]))
            elif "done" in ev:
                done = ev["done"]
        t1 = time.perf_counter()
    finally:
        conn.close()
    return toks, done, (t_first or t1) - t0, t1 - t0


def http_clients(host, port, prompts, max_tokens):
    """``prompts`` sent at once by concurrent streaming clients, one
    thread each; their :func:`http_stream` results in prompt order."""
    with ThreadPoolExecutor(len(prompts)) as ex:
        futs = [ex.submit(http_stream, host, port, p, max_tokens)
                for p in prompts]
        return [f.result() for f in futs]


def http_clients_apart(host, port, prompts, max_tokens):
    """:func:`http_clients` in a process of its own (stdlib only), so that
    the clients' threads do not take the serving process's interpreter
    lock from its engine steppers, as a remote client would not."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as ex:
        return ex.submit(http_clients, host, port, prompts,
                         max_tokens).result()


def http_json(host, port, path):
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=30)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def snap_value(doc, kind, name, **labels):
    """Sum over the series of ``name`` in a ``/metrics.json`` document
    whose labels include ``labels`` (a histogram's count)."""
    return sum(e["count"] if kind == "histograms" else e["value"]
               for e in doc[kind] if e["name"] == name
               and all(str(e["labels"].get(k)) == str(v)
                       for k, v in labels.items()))


def check_streams(res, n_tokens, V, what):
    """Every stream gave ``n_tokens`` ids in ``[0, V)`` and a ``done``
    frame that counts them."""
    for j, (toks, done, _, _) in enumerate(res):
        if len(toks) != n_tokens or not all(0 <= t < V for t in toks):
            fail(f"{what}: request {j}: {len(toks)} tokens, in vocab: "
                 f"{all(0 <= t < V for t in toks)}")
        if done is None or done["completion_tokens"] != n_tokens:
            fail(f"{what}: request {j}: done frame {done}")


def engine_counts(eng):
    """(runner calls by kind, engine phase seconds) from the registry."""
    reg = eng.registry
    calls = {k: reg.get(f"runner.{k}.dispatch_ms").value(shards="1")[1]
             for k in ("prefill", "decode", "verify")}
    return calls, {p: reg.get(f"serving.phase.{p}_s").value()
                   for p in ("prefill", "decode")}


def idle(torch, *engines):
    for eng in engines:
        while eng.core.has_work():
            time.sleep(0.005)
    torch.cuda.synchronize()


def warm_up(torch, eng, V):
    """One short request of its own (no prefix shared with the measured
    prompts) through a fresh engine, so that no measured run pays for
    the stepper thread's first calls."""
    from repro_torch.serving import Request, SamplingParams
    eng.result(eng.submit(Request(
        uid=0, prompt=list(range(V - 40, V)),
        sampling=SamplingParams(max_new_tokens=2))), timeout=600)
    idle(torch, eng)


def http_phase(torch, np, kernels, card, dev="cuda", cfg=None):
    """Phases 17a and 17b: full-width Qwen3-1.7B in bf16 (phase 5's
    weights, drawn again from seed 0) through ``AsyncEngine`` behind the
    port's HTTP front end, on phase 5's 8 prompts, 32 greedy tokens each.

    The in-process run first: a fresh engine, every request submitted at
    once.  (a) a fresh engine behind one ``HttpFrontend``
    (``tokenizer=None``), 8 concurrent streaming clients; (b) a second
    fresh engine with its own copy of the weights behind its own
    frontend, a ``Router`` over two ``HttpWorkerClient``s pointed at the
    two frontends and a front ``HttpFrontend(router)``, the same 8
    clients.  Each run's kernel counts are set to 0 just before it and
    read just after; the paged kernel must run n_layers times per decode
    step, the wire's tokens must equal the in-process run's under the
    margin rule, the ``done`` frames must count 32, ``http.requests`` 8
    and ``http.inflight`` 0, every page must be free again, and in (b)
    the two requests that share a prefix must land on one replica
    (``router.affinity.hits`` >= 1).  Returns the runs' numbers."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.weights import tree_map
    from repro_torch.serving import (AsyncEngine, HttpFrontend,
                                     HttpWorkerClient, Request, Router,
                                     SamplingParams, throughput_report)
    cfg = cfg or get_config("qwen3-1.7b")
    L, V = cfg.n_layers, cfg.vocab_size
    model = build_model(cfg)
    wgen = torch.Generator(device=dev)
    wgen.manual_seed(0)
    params = model.init(wgen)               # phase 5's and 10's weights
    prompts = serve_prompts(np, V)
    n = len(prompts)
    kw = dict(max_len=1024, max_running=8, page_size=16, prefill_chunk=128,
              seed=0, device=dev)
    out = {}

    def p50(xs):
        return sorted(xs)[len(xs) // 2]

    # -- the in-process run --------------------------------------------
    eng = AsyncEngine(model, params, **kw)
    try:
        warm_up(torch, eng, V)
        _, ph0 = engine_counts(eng)
        torch.cuda.reset_peak_memory_stats()
        handles = [eng.submit(Request(
            uid=i, prompt=p, sampling=SamplingParams(
                max_new_tokens=HTTP_TOKENS))) for i, p in enumerate(prompts)]
        comps = [eng.result(h, timeout=600) for h in handles]
        idle(torch, eng)
        _, ph1 = engine_counts(eng)
    finally:
        eng.shutdown()
    want = [c.tokens for c in comps]
    rep = throughput_report(comps, prefill_s=ph1["prefill"] - ph0["prefill"],
                            decode_s=ph1["decode"] - ph0["decode"])
    out["in_process"] = {
        "ttft_p50_ms": p50([c.t_first - c.t0 for c in comps]) * 1e3,
        "decode_tok_per_s": rep["decode_tok_per_s"],
        "wall_s": max(c.t1 for c in comps) - min(c.t0 for c in comps),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del eng, comps, handles
    gc.collect()                    # the stepper thread's cycle holds it
    torch.cuda.empty_cache()

    def run_http(host, port, engines, label):
        before = [engine_counts(e) for e in engines]
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launches = 0                 # count this path only
        res = http_clients_apart(host, port, prompts, HTTP_TOKENS)
        wall = max(r[3] for r in res)       # the clients start together
        idle(torch, *engines)
        launches = {name: fn.launches for name, fn in kernels.items()}
        after = [engine_counts(e) for e in engines]
        check_streams(res, HTTP_TOKENS, V, label)
        steps = {k: sum(int(a[0][k] - b[0][k]) for a, b in zip(after, before))
                 for k in ("prefill", "decode", "verify")}
        decode_s = [a[1]["decode"] - b[1]["decode"]
                    for a, b in zip(after, before)]
        paged = launches["paged_decode_attention"]
        if steps["decode"] <= 0 or paged != L * steps["decode"]:
            fail(f"{label}: paged launches {paged} != {L} x "
                 f"{steps['decode']} decode steps")
        for name in ("q4_gemm", "decode_attention", "rglru_scan"):
            if launches[name]:
                fail(f"{label}: bf16 serving launched {name}")
        if steps["verify"]:
            fail(f"{label}: {steps['verify']} verify steps at spec_decode 0")
        agree, total = margin_rule(
            torch, model, params, prompts, [r[0] for r in res], want, "fp32",
            LOGIT_TOL, f"[http] {label}", "HTTP", "in-process", dev)
        run = {"ttft_p50_ms": p50([r[2] for r in res]) * 1e3,
               "ttft_max_ms": max(r[2] for r in res) * 1e3,
               # the front frontend's own clock, from its submit to the
               # first token: the wire's share is the difference
               "server_ttft_p50_ms": p50([r[1]["ttft_ms"] for r in res]),
               "wall_s": wall, "launches": launches, "decode_s": decode_s,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(f"[http] {label}: {n} streaming clients x {HTTP_TOKENS} "
              f"tokens; {steps['prefill']} prefill chunks, "
              f"{steps['decode']} decode steps; paged launches {paged} = "
              f"{L} x {steps['decode']}; tokens agree with the in-process "
              f"run on {agree}/{total} (up to each request's first "
              f"difference)")
        return run

    def check_pages(e, free, label):
        pool = e.core.pool
        if pool.n_live() or pool.n_free() != free:
            fail(f"{label}: {pool.n_live()} pages still held, "
                 f"{pool.n_free()} free after the run, {free} before")

    def check_frontend(fe, label, n_req):
        reg = fe.registry
        if reg.get("http.requests").value() != n_req:
            fail(f"{label}: http.requests {reg.get('http.requests').value()}"
                 f" != {n_req}")
        if reg.get("http.inflight").value() != 0:
            fail(f"{label}: http.inflight {reg.get('http.inflight').value()}"
                 " after the run")
        for name in ("http.failed", "http.shed", "http.client_disconnects"):
            if reg.get(name).value():
                fail(f"{label}: {name} {reg.get(name).value()}")

    eng1 = AsyncEngine(model, params, **kw)
    eng2 = fe1 = fe2 = router = front = None
    try:
        warm_up(torch, eng1, V)
        free1 = eng1.core.pool.n_free()
        fe1 = HttpFrontend(eng1).start()
        # -- 17a. one frontend over the engine ---------------------------
        a = run_http(fe1.host, fe1.port, [eng1], "17a one frontend")
        check_frontend(fe1, "17a", n)
        check_pages(eng1, free1, "17a")
        a["decode_tok_per_s"] = n * HTTP_TOKENS / a["decode_s"][0]
        out["a"] = a
        # -- 17b. two replicas behind the router -------------------------
        eng2 = AsyncEngine(model, tree_map(torch.clone, params), **kw)
        warm_up(torch, eng2, V)
        free2 = eng2.core.pool.n_free()
        fe2 = HttpFrontend(eng2).start()
        router = Router({0: HttpWorkerClient(fe1.host, fe1.port),
                         1: HttpWorkerClient(fe2.host, fe2.port)},
                        page_size=16)
        front = HttpFrontend(router).start()
        b = run_http(front.host, front.port, [eng1, eng2],
                     "17b router over two replicas")
        check_frontend(front, "17b front", n)
        rreg = router.registry
        per = [int(rreg.get("router.requests").value(replica=r))
               for r in (0, 1)]
        hits = rreg.get("router.affinity.hits").value()
        keyed = rreg.get("router.affinity.keyed").value()
        if hits < 1 or keyed != n:
            fail(f"17b: router.affinity.hits {hits}, keyed {keyed}: the two "
                 "requests sharing a prefix did not land on one replica")
        for e, free in ((eng1, free1), (eng2, free2)):
            check_pages(e, free, "17b")
        check_frontend(fe2, "17b replica 1", per[1])
        check_frontend(fe1, "17b replica 0", n + per[0])
        b["requests_per_replica"] = per
        b["affinity_hits"] = hits
        b["decode_tok_per_s_per_replica"] = [
            r_ * HTTP_TOKENS / s_ if s_ > 0 else 0.0
            for r_, s_ in zip(per, b["decode_s"])]
        b["tok_per_s_over_wall"] = n * HTTP_TOKENS / b["wall_s"]
        out["b"] = b
    finally:
        for fe_ in (front, fe1, fe2):
            if fe_ is not None:
                fe_.close()
        if router is not None:
            router.shutdown()
        for e in (eng1, eng2):
            if e is not None:
                e.shutdown()
    del eng1, eng2, params, model
    gc.collect()
    torch.cuda.empty_cache()
    ip, a, b = out["in_process"], out["a"], out["b"]
    print(f"[http] in-process: TTFT p50 {ip['ttft_p50_ms']:.1f} ms, decode "
          f"{ip['decode_tok_per_s']:.1f} tok/s, wall {ip['wall_s']:.3f} s, "
          f"peak memory {ip['peak_gib']:.2f} GiB — {card}")
    print(f"[http] 17a over HTTP: TTFT p50 {a['ttft_p50_ms']:.1f} ms (max "
          f"{a['ttft_max_ms']:.1f}; {a['server_ttft_p50_ms']:.1f} ms on the "
          f"frontend's clock), decode {a['decode_tok_per_s']:.1f} "
          f"tok/s, wall {a['wall_s']:.3f} s, peak memory "
          f"{a['peak_gib']:.2f} GiB — {card}")
    print(f"[http] 17b router, two replicas: requests {b['requests_per_replica']}"
          f", affinity hits {b['affinity_hits']}; TTFT p50 "
          f"{b['ttft_p50_ms']:.1f} ms (max {b['ttft_max_ms']:.1f}; "
          f"{b['server_ttft_p50_ms']:.1f} ms on the front frontend's "
          f"clock), decode "
          f"{[round(x, 1) for x in b['decode_tok_per_s_per_replica']]} "
          f"tok/s per replica, {b['tok_per_s_over_wall']:.1f} tok/s over the "
          f"wall {b['wall_s']:.3f} s, peak memory {b['peak_gib']:.2f} GiB "
          f"(one process, both replicas) — {card}", flush=True)
    return out


def children(pid):
    """Pids whose parent is ``pid`` (``/proc``)."""
    kids = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            stat = (d / "stat").read_text()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            kids.append(int(d.name))
    return kids


def wait_for(cond, seconds, what, log=None):
    deadline = time.perf_counter() + seconds
    while not cond():
        if time.perf_counter() > deadline:
            fail(f"{what} within {seconds} s"
                 + (f"; log tail: {log.read_text()[-3000:]}" if log else ""))
        time.sleep(0.1)


def fleet_cli_phase(card, extra=()):
    """Phase 17c: ``python -m repro_torch.launch.serve --arch qwen3-1.7b
    --engine async --http --replicas 2 --max-respawns 1 --quant q4
    --kv-dtype int8 --port 0 --port-file F``: a front door over two
    reduced workers on the card.  Streams 4 requests, reads each
    worker's own ``/metrics.json`` (decode steps, Q4_0 forward calls,
    int8 pages), SIGKILLs one worker, waits for the respawn and the
    router's readmission, streams 2 more, then SIGTERMs the front door:
    it must exit 0 and leave no worker behind."""
    import signal
    out_dir = ROOT / "build" / "chip_smoke_fleet"
    out_dir.mkdir(parents=True, exist_ok=True)
    log, port_file = out_dir / "serve.log", out_dir / "port"
    port_file.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    with open(log, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "qwen3-1.7b", "--engine", "async", "--http", "--replicas", "2",
             "--max-respawns", "1", "--quant", "q4", "--kv-dtype", "int8",
             "--port", "0", "--port-file", str(port_file), *extra],
            cwd=ROOT, env=env, stdout=logf, stderr=subprocess.STDOUT)
    seen = set()
    try:
        wait_for(lambda: proc.poll() is not None or (
            port_file.exists() and port_file.read_text()), 300,
            "the front door did not bind", log)
        if proc.poll() is not None:
            fail(f"the front door exited {proc.returncode}: "
                 f"{log.read_text()[-3000:]}")
        t_up = time.perf_counter() - t0
        port = int(port_file.read_text())
        workers = {}
        for ln in log.read_text().splitlines():
            if ln.strip().startswith("worker "):
                rid, rest = ln.strip()[7:].split(":", 1)
                addr, pid = rest.strip().split(" pid ")
                workers[int(rid)] = (int(addr.rsplit(":", 1)[1]), int(pid))
        seen.update(pid for _, pid in workers.values())
        if sorted(workers) != [0, 1]:
            fail(f"17c: workers {workers}: {log.read_text()[-2000:]}")
        prompts = ["the scheduler binds each request to a page of the pool",
                   "the scheduler binds each request to a slot, then decodes",
                   "a numa node holds the kv cache", "one thread gathers"]
        res = http_clients("127.0.0.1", port, prompts, 16)
        check_streams(res, 16, REDUCED_VOCAB, "17c")
        served = {}
        for rid, (wport, pid) in sorted(workers.items()):
            doc = http_json("127.0.0.1", wport, "/metrics.json")
            served[rid] = {
                "requests": snap_value(doc, "counters", "http.requests"),
                "decode_steps": snap_value(doc, "histograms",
                                           "runner.decode.dispatch_ms"),
                "q4_forward_calls": snap_value(
                    doc, "counters", "runner.quant.q4_dispatch"),
                "int8_page_bytes": snap_value(
                    doc, "gauges", "kv_pool.page_bytes", kv_dtype="int8")}
        for rid, st in served.items():
            if st["requests"] and not (st["decode_steps"] > 0
                                       and st["q4_forward_calls"] > 0
                                       and st["int8_page_bytes"] > 0):
                fail(f"17c: worker {rid} served {st} (no decode on int8 "
                     "pages or no Q4_0 forward call)")
        if sum(st["requests"] for st in served.values()) != len(prompts):
            fail(f"17c: the workers count {served} requests, not "
                 f"{len(prompts)}")
        # SIGKILL one worker; the supervisor respawns it and the router
        # readmits it
        victim_pid = workers[0][1]
        os.kill(victim_pid, signal.SIGKILL)
        t_kill = time.perf_counter()

        def healed():
            doc = http_json("127.0.0.1", port, "/metrics.json")
            return (snap_value(doc, "counters", "router.readmissions") == 1
                    and http_json("127.0.0.1", port, "/healthz")["live"] == 2)
        wait_for(healed, 300, "17c: the fleet did not heal", log)
        t_heal = time.perf_counter() - t_kill
        kids = children(proc.pid)
        seen.update(kids)
        if victim_pid in kids or len(kids) != 2:
            fail(f"17c: workers after the respawn {kids} (killed "
                 f"{victim_pid})")
        res2 = http_clients("127.0.0.1", port, prompts[:2], 16)
        check_streams(res2, 16, REDUCED_VOCAB, "17c after the respawn")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for pid in seen:                    # stop every process we started
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    left = [p for p in seen if Path(f"/proc/{p}").exists()]
    if rc != 0 or "http serving stopped" not in log.read_text():
        fail(f"17c: the front door exited {rc}: {log.read_text()[-3000:]}")
    if left:
        fail(f"17c: workers {left} outlived the front door")
    ttft = sorted(r[2] for r in res)
    print(f"[fleet] --http --replicas 2 --quant q4 --kv-dtype int8 on the "
          f"card: front door up in {t_up:.1f} s; 4 streams x 16 tokens, TTFT "
          f"p50 {ttft[len(ttft) // 2] * 1e3:.1f} ms; workers {served}; "
          f"SIGKILL of pid {victim_pid} healed in {t_heal:.1f} s, 2 more "
          f"streams served; SIGTERM: exit 0, no worker left — {card}",
          flush=True)


#: Phi-3.5-MoE on the card: full width, 16 of its 32 layers (at full
#: depth its 41.87 B bf16 parameters, 78.0 GiB, do not fit one 80 GB card,
#: and Q4_0 leaves the expert stacks dense, as in the reference), at the
#: capacity factor the serve CLI sets
MOE_LAYERS = 16
MOE_CF = 4.0
#: a routing decision of one decode step that differs between the kernel
#: run and the plain run must be within rounding of a tie: the plain run's
#: probabilities of the experts it chose and of those the kernel run chose
#: differ by less than this (one bf16 ulp of an attention output moves a
#: full-width router probability by ~1e-3 after 16 layers); the plain run
#: then takes the kernel run's experts, so its logits are held to LOGIT_TOL
ROUTE_TOL = 0.02
#: moe_scatter vs moe_dense at one full-width layer in bf16, nothing
#: dropped: the same expert products, but at M = capacity against M = T
#: (other cuBLAS tiles, so another f32 summation order before each bf16
#: rounding: an expert output may round one ulp apart), and the two gated
#: outputs combined by a bf16 product and scatter-add in one (three
#: roundings) and by an einsum over all 16 experts in the other (one):
#: |scatter - dense| <= MOE_DISPATCH_RTOL * (|dense| + rms(dense)), eight
#: bf16 ulps (a CPU rehearsal at d_model 128 reached 0.0072)
MOE_DISPATCH_RTOL = 2.0 ** -5
#: Mamba-2's chunked SSD vs its sequential oracle in f32 (TF32 off): the
#: same sums of up to 200 x 128 terms in another association, ~1.3e-6 of
#: the largest output on the CPU at these shapes;
#: |chunked - oracle| <= SSD_TOL * max|oracle|
SSD_TOL = 2e-5
#: phases 20 and 21: (phase, arch, prompt lengths (four prompts each),
#: greedy tokens a request)
XATTN_PHASES = ((20, "llama-3.2-vision-11b", (256,), 16),
                (21, "whisper-medium", (64, 128), 32))
#: Mamba-2-370m logits, a decode step after a prefill of n tokens against
#: the last logits of a prefill of n + 1: the decode step is a chunk padded
#: with zeros, so the two sum the same terms in another order and round
#: each of 48 layers' outputs to bf16; LOGIT_TOL's rule (0.125, the argmax
#: equal on every lane whose top-2 margin exceeds it)
LOGIT_TOL_SSD = 0.125


class RoutePin:
    """Wraps ``repro_torch.models.moe._router`` for one pair of runs of a
    step: while recording, it keeps each call's expert ids; after
    :meth:`replay`, each call computes its own probabilities and top-k,
    counts the tokens whose experts differ from the recorded run's with
    the probability gap they fell within, and returns the recorded
    experts with its own renormalised probabilities.  So the kernel run
    and the plain run of one step route every token to the same experts,
    and every routing flip is reported with its margin."""

    def __init__(self, moe_mod):
        self.mod, self.orig = moe_mod, moe_mod._router
        self.calls, self.replaying, self.i = [], False, 0
        self.flips, self.max_gap = 0, 0.0

    def __call__(self, params, x2d, k):
        logits, probs, topv, topi = self.orig(params, x2d, k)
        if not self.replaying:
            self.calls.append(topi.clone())
            return logits, probs, topv, topi
        want = self.calls[self.i]
        self.i += 1
        diff = (topi != want).any(dim=-1)
        if bool(diff.any()):
            p = probs[diff]
            gap = (p.gather(1, topi[diff]) - p.gather(1, want[diff])).abs()
            self.flips += int(diff.sum())
            self.max_gap = max(self.max_gap, gap.max().item())
        topv = probs.gather(1, want)
        return logits, probs, topv / topv.sum(dim=-1, keepdim=True), want

    def __enter__(self):
        self.mod._router = self
        return self

    def __exit__(self, *exc):
        self.mod._router = self.orig

    def replay(self):
        self.replaying, self.i = True, 0


def pinned_parity(torch, run_kernel, run_plain, tol, what):
    """One step with the kernels, then with the plain versions on a clone
    of its state, the plain run routed as the kernel run was
    (:class:`RoutePin`): routing flips within ROUTE_TOL, logits within
    ``tol`` (``logit_parity``).  Returns the number of flips."""
    from repro_torch.models import moe as moe_mod
    with RoutePin(moe_mod) as pin:
        got = run_kernel()
        pin.replay()
        want = run_plain()
    print(f"[parity] {what}: {len(pin.calls)} router calls, {pin.flips} "
          f"token routings differ between the two runs (largest gap "
          f"{pin.max_gap:.4f}, tol {ROUTE_TOL}); the plain run takes the "
          f"kernel run's experts")
    if pin.flips and not pin.max_gap < ROUTE_TOL:
        fail(f"{what}: a routing decision differs with a clear margin "
             f"{pin.max_gap:.4f}")
    logit_parity(torch, got, want, tol, what)
    return pin.flips


def op_device_ms(torch, run, n, names):
    """Device ms per call of ``run()`` spent in the kernels of the named
    aten ops, from :func:`profiled` over ``n`` calls."""
    from torch.autograd import DeviceType
    return {e.key: e.device_time_total / n / 1e3
            for e in profiled(torch, run, n)
            if e.device_type == DeviceType.CPU and e.key in names}


def check_moe_dispatch(torch, params, cfg, gen):
    """``moe_scatter`` against ``moe_dense`` at layer 0's weights on 128
    bf16 rows, at the capacity factor E / k, where each expert can take
    every row and nothing drops.  Returns the max |d|."""
    from repro_torch.models import moe as moe_mod
    lp = {k_: v[0] for k_, v in params["layers"]["moe"].items()}
    T, E, k = 128, cfg.n_experts, cfg.experts_per_token
    cf = E / k
    x = torch.randn(T, cfg.d_model, generator=gen, device="cuda").to(
        cfg.dtype)
    _, _, _, topi = moe_mod._router(lp, x, k)
    cap, _, keep = moe_mod.moe_routing(topi, E, cf)
    if cap < T or not bool(keep.all()):
        fail(f"moe dispatch check: capacity {cap} drops tokens")
    got, aux_s = moe_mod.moe_scatter(lp, x, k=k, act=cfg.act,
                                     capacity_factor=cf)
    want, aux_d = moe_mod.moe_dense(lp, x, k=k, act=cfg.act)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        fail("moe_scatter: non-finite output")
    want = want.float()
    err = (got.float() - want).abs()
    rms = want.square().mean().sqrt()
    if not bool((err <= MOE_DISPATCH_RTOL * (want.abs() + rms)).all()):
        fail(f"moe_scatter disagrees with moe_dense (max "
             f"{err.max().item():.3e})")
    if not math.isclose(aux_s.item(), aux_d.item(), rel_tol=1e-6):
        fail(f"moe aux loss: scatter {aux_s.item()} dense {aux_d.item()}")
    print(f"[moe] moe_scatter vs moe_dense, layer 0 of {cfg.name}, {T} "
          f"{cfg.dtype} rows, capacity {cap} (none dropped): max|d| "
          f"{err.max().item():.3e} (output rms {rms.item():.3e}; tol "
          f"{MOE_DISPATCH_RTOL} x (|dense| + rms)); aux loss "
          f"{aux_s.item():.4f} both")
    return err.max().item()


def moe_phase(torch, np, kernels, card):
    """Phases 18a-c: full-width Phi-3.5-MoE (16 of 32 layers, bf16,
    weights drawn on the card from seed 0, one expert stack at a time,
    ``capacity_factor`` 4.0).  (a) the continuous engine on phase 5's
    traffic (``serve``: counts set to 0 just before, read just after; the
    paged kernel n_layers x decode steps), one decode step with the
    kernel against the plain attention on a clone of the cache under
    :func:`pinned_parity`, the paged kernel against its plain version on
    that state's block table and lengths (:func:`time_serving_state`),
    ``moe_scatter`` against ``moe_dense`` at one layer, a profiled decode
    step with the expert products' share, and the cost of the router aux
    loss the serving steps skip; (b) the bucket engine on four prompts of
    256 tokens, 16 tokens each (counts set to 0 just before, read just
    after; the contiguous kernel n_layers x decode steps), one ring decode
    step with the kernel against the plain version on a clone of the
    ring, and the contiguous kernel against its plain version on each
    layer's ring; (c) the Q4_0 GEMM
    against its plain version at the attention projections' shapes, M =
    8 and 128, x in bf16.  Returns the phase's numbers."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import q4_gemm as qg
    from repro_torch.kernels import ref
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.weights import tree_leaves_with_path, tree_map
    from repro_torch.quant import param_bytes, q4_0
    from repro_torch.serving import (ContinuousServingEngine, Request,
                                     SamplingParams, ServingEngine,
                                     throughput_report)
    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"),
                              n_layers=MOE_LAYERS, capacity_factor=MOE_CF)
    L, V = cfg.n_layers, cfg.vocab_size
    out = {}
    print(f"[moe] allocated before the phase: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wgen = torch.Generator(device="cuda")
    wgen.manual_seed(0)
    params = model.init(wgen)
    torch.cuda.synchronize()
    out["draw_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["weights_gib"] = param_bytes(params) / 2**30
    n_params = sum(t.numel() for _, t in tree_leaves_with_path(params))
    print(f"[moe] {cfg.name}: {L} of 32 layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff}, {cfg.n_experts} experts top-"
          f"{cfg.experts_per_token}, vocab {V}, capacity factor "
          f"{cfg.capacity_factor}; {n_params / 1e9:.3f} B params, "
          f"{out['weights_gib']:.2f} GiB of {cfg.dtype} weights on the card "
          f"({time.perf_counter() - t0:.1f} s to draw, peak "
          f"{out['draw_peak_gib']:.2f} GiB while drawing)", flush=True)

    # -- 18a. the continuous engine ------------------------------------
    prompts = serve_prompts(np, V)
    eng = ContinuousServingEngine(model, params, max_len=1024, max_running=8,
                                  page_size=16, prefill_chunk=128, seed=0,
                                  device="cuda")
    counts, steps, _ = serve(torch, eng, prompts, cfg, kernels, "moe", card)
    out["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if steps <= 0 or counts["paged_decode_attention"] != L * steps:
        fail(f"18a: paged launches {counts['paged_decode_attention']} != "
             f"{L} x {steps} decode steps")
    for name in ("q4_gemm", "decode_attention", "rglru_scan"):
        if counts[name]:
            fail(f"18a: MoE paged serving launched {name} {counts[name]} "
                 "times")
    out["launches_paged"] = counts["paged_decode_attention"]
    out["decode_steps"] = steps
    print(f"[moe] 18a launches: paged decode attention "
          f"{counts['paged_decode_attention']} = {L} x {steps} decode steps")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    cache, clone, fed_t, pos, ps = parity_state(torch, np, gen, model, params,
                                                prompts, "fp32")
    out["flips_paged"] = pinned_parity(
        torch,
        lambda: model.decode_step(params, cache, fed_t, pos, page_size=ps)[0],
        lambda: model.decode_step(params, clone, fed_t, pos, page_size=ps,
                                  impl="ref")[0],
        LOGIT_TOL, "18a Phi-3.5-MoE paged decode logits, kernel vs plain")
    del clone
    (out["paged_err"], out["paged_ms"], out["paged_plain_ms"],
     out["paged_sdpa_ms"], out["paged_bound_ms"], *_) = time_serving_state(
        torch, F, ref, kernels["paged_decode_attention"], cache, pos, cfg,
        gen, "18a Phi-3.5-MoE", card)
    out["dispatch_err"] = check_moe_dispatch(torch, params, cfg, gen)
    stats = {}
    by_kernel = profile_step(torch, lambda p_: model.decode_step(
        params, cache, fed_t, p_, page_size=ps), pos + 1,
        "full-width Phi-3.5-MoE decode", card, stats=stats)
    out["paged_ms_per_call"] = paged_profile(by_kernel, L, "MoE decode",
                                             card)
    nxt = [pos + 10]                # past the profiled steps' positions

    def one_step():
        model.decode_step(params, cache, fed_t, nxt[0], page_size=ps)
        nxt[0] = nxt[0] + 1

    ops = op_device_ms(torch, one_step, 2, ("aten::bmm",))
    out["step_busy_ms"] = stats["busy_ms"]
    out["step_wall_ms"] = stats["wall_ms"]
    out["expert_bmm_ms"] = ops.get("aten::bmm", 0.0)
    expert_bytes = 3 * L * cfg.n_experts * cfg.d_model * cfg.d_ff * 2
    out["expert_bound_ms"] = expert_bytes / HBM_BYTES_PER_S * 1e3
    if out["expert_bmm_ms"] <= 0:
        fail("18a: no device time in the expert products (aten::bmm)")
    print(f"[profile] 18a MoE decode step (B=8): device busy "
          f"{out['step_busy_ms']:.2f} ms of {out['step_wall_ms']:.2f} ms "
          f"wall ({out['step_busy_ms'] / out['step_wall_ms']:.1%}); expert "
          f"products (aten::bmm) {out['expert_bmm_ms']:.2f} ms a step "
          f"({out['expert_bmm_ms'] / out['step_busy_ms']:.1%} of the busy "
          f"time; their {expert_bytes / 1e9:.1f} GB of weights take "
          f"{out['expert_bound_ms']:.2f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s) — {card}", flush=True)
    # the router aux loss, which the serving steps skip, at a decode
    # step's shape: its cost a layer, and a step's worth
    lp0 = {k_: v[0] for k_, v in params["layers"]["moe"].items()}
    xs = torch.randn(8, cfg.d_model, generator=gen, device="cuda").to(
        cfg.dtype)
    _, probs, _, topi = moe_mod._router(lp0, xs, cfg.experts_per_token)
    E = cfg.n_experts
    aux_dev = cuda_ms(torch, lambda i: moe_mod._aux_loss(probs, topi, E), 50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        moe_mod._aux_loss(probs, topi, E)
    torch.cuda.synchronize()
    aux_wall = (time.perf_counter() - t0) / 200 * 1e3
    out["aux_step_device_ms"], out["aux_step_wall_ms"] = (L * aux_dev,
                                                          L * aux_wall)
    print(f"[moe] router aux loss at a decode step's shape (8 rows, {E} "
          f"experts), skipped by the serving steps: {aux_dev * 1e3:.1f} us "
          f"of device time and {aux_wall * 1e3:.1f} us of wall a layer; "
          f"x {L} layers {L * aux_dev:.3f} ms device "
          f"({L * aux_dev / out['step_busy_ms']:.1%} of the step's busy "
          f"time), {L * aux_wall:.3f} ms wall "
          f"({L * aux_wall / out['step_wall_ms']:.1%} of its wall) — {card}")
    del cache
    gc.collect()
    torch.cuda.empty_cache()

    # -- 18b. the bucket engine ----------------------------------------
    rng = np.random.default_rng(3)
    bprompts = [rng.integers(0, V, 256).tolist() for _ in range(4)]
    beng = ServingEngine(model, params, max_len=288, seed=0, device="cuda")
    calls = {"prefill": 0, "decode": 0}
    beng.runner.prefill = counted(calls, "prefill", beng.runner.prefill)
    beng.runner.decode = counted(calls, "decode", beng.runner.decode)
    beng.generate([Request(uid=100, prompt=bprompts[0][:16],
                           sampling=SamplingParams(max_new_tokens=2))])
    reqs = [Request(uid=i, prompt=p,
                    sampling=SamplingParams(max_new_tokens=16))
            for i, p in enumerate(bprompts)]
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0                     # count this path only
    calls.update(prefill=0, decode=0)
    comps = beng.generate(reqs, max_batch=4)
    torch.cuda.synchronize()
    bcounts = {name: fn.launches for name, fn in kernels.items()}
    for c in comps:
        if len(c.tokens) != 16 or not all(0 <= t < V for t in c.tokens):
            fail(f"18b: request {c.uid}: {len(c.tokens)} tokens")
    if calls["decode"] <= 0 or \
            bcounts["decode_attention"] != L * calls["decode"]:
        fail(f"18b: contiguous launches {bcounts['decode_attention']} != "
             f"{L} x {calls['decode']} decode steps")
    for name in ("paged_decode_attention", "q4_gemm", "rglru_scan"):
        if bcounts[name]:
            fail(f"18b: MoE bucket serving launched {name} {bcounts[name]} "
                 "times")
    rep = throughput_report(comps, **beng.last_phase_s)
    out["launches_contiguous"] = bcounts["decode_attention"]
    out["bucket_decode_steps"] = calls["decode"]
    out["bucket_decode_tok_per_s"] = rep["decode_tok_per_s"]
    print(f"[moe] 18b bucket engine: 4 requests x 16 tokens, "
          f"{calls['prefill']} prefill call, {calls['decode']} decode steps; "
          f"contiguous decode attention {bcounts['decode_attention']} = {L} "
          f"x {calls['decode']}; decode {rep['decode_tok_per_s']:.1f} tok/s "
          f"— {card}")
    del beng
    toks = torch.tensor(bprompts, dtype=torch.long, device="cuda")
    ring = model.init_cache(4, 288, device="cuda")
    logits, _ = model.prefill(params, {"tokens": toks}, ring)
    fed = logits[:, 0].float().argmax(-1, keepdim=True)
    ring_clone = tree_map(lambda t: t.clone(), ring)
    out["flips_ring"] = pinned_parity(
        torch, lambda: model.decode_step(params, ring, fed, 256)[0],
        lambda: model.decode_step(params, ring_clone, fed, 256,
                                  impl="ref")[0],
        LOGIT_TOL, "18b Phi-3.5-MoE ring decode logits, kernel vs plain")
    sc, windows = ring["layers"]["self"], cfg.layer_windows(0)
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    q = torch.randn(4, Hkv, cfg.n_heads // Hkv, hd, generator=gen,
                    device="cuda").to(cfg.dtype)
    out["ring_err"] = 0.0
    for i in range(L):
        kw = dict(kv_positions=sc["pos"][i], q_pos=256, window=windows[i],
                  softcap=cfg.attn_logit_softcap)
        got = kernels["decode_attention"](q, sc["k"][i], sc["v"][i], **kw)
        torch.cuda.synchronize()
        want = ref.decode_attention_ref(q, sc["k"][i], sc["v"][i], **kw)
        out["ring_err"] = max(out["ring_err"], check(
            torch, got, want, ..., f"18b decode_attention ring layer {i}"))
    print(f"[kernel] 18b decode_attention on each of the {L} layers' rings "
          f"(B=4, 288 slots, positions 0-256, {Hkv}/{cfg.n_heads} heads, "
          f"D={hd}, {cfg.dtype}): max|kernel-plain| {out['ring_err']:.3e}")
    del ring, ring_clone, params, model
    gc.collect()
    torch.cuda.empty_cache()

    # -- 18c. the Q4_0 GEMM at the attention projections' shapes ---------
    err = 0.0
    hd = cfg.resolved_head_dim
    for K, N in ((cfg.d_model, cfg.n_heads * hd),
                 (cfg.d_model, cfg.n_kv_heads * hd)):
        w = torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K)
        packed, scales = q4_0.quantize(w)
        for M in (8, 128):
            x = torch.randn(M, K, generator=gen, device="cuda").to(
                torch.bfloat16)
            got = qg.q4_gemm(x, packed, scales)
            torch.cuda.synchronize()
            want = ref.q4_gemm_ref(x, packed, scales)
            what = f"18c q4_gemm Phi-3.5-MoE M={M} K={K} N={N} x bf16"
            e_ = check_q4(torch, got, want, what)
            err = max(err, e_)
            print(f"[kernel] {what}: max|kernel-plain| {e_:.3e}")
    out["q4_err"] = err
    return out


def mamba_phase(torch, np, kernels, card):
    """Phase 19: full-width, full-depth Mamba-2-370m (bf16, weights drawn
    on the card from seed 0) through the bucket engine: 8 requests (four
    prompts of 256 tokens and four of 512), 32 greedy tokens each,
    ``max_batch=4``, counts set to 0 just before and read just after (no
    kernel of the port runs on this path); ``ssd_chunked`` against
    ``ssd_reference`` at one layer's shapes, T = 200 across chunk edges;
    the logits of a decode step after a prefill of n - 1 tokens against
    the last logits of a prefill of n; device time of a decode step and
    of a prefill call.  Returns the phase's numbers."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, ssm
    from repro_torch.quant import param_bytes
    from repro_torch.serving import (Request, SamplingParams, ServingEngine,
                                     throughput_report)
    cfg, lens = get_config("mamba2-370m"), (256, 512)
    V = cfg.vocab_size
    out = {}
    model = build_model(cfg)
    t0 = time.perf_counter()
    wgen = torch.Generator(device="cuda")
    wgen.manual_seed(0)
    params = model.init(wgen)
    torch.cuda.synchronize()
    print(f"[ssd] {cfg.name}: {cfg.n_layers} SSD layers, d_model "
          f"{cfg.d_model}, {cfg.ssm_heads} heads x {cfg.ssm_head_dim}, state "
          f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab {V}; "
          f"{param_bytes(params) / 2**30:.3f} GiB of {cfg.dtype} weights "
          f"({time.perf_counter() - t0:.1f} s to draw)", flush=True)

    # the chunked scan against the sequential oracle at one layer's shapes
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    lp = {k_: v[0] for k_, v in params["layers"]["ssd"].items()}
    H, P, N, T = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, 200
    x = torch.randn(2, T, H, P, generator=gen, device="cuda")
    dt = F.softplus(torch.randn(2, T, H, generator=gen, device="cuda")
                    + lp["dt_bias"])
    A = -torch.exp(lp["A_log"])
    Bm = torch.randn(2, T, cfg.ssm_groups, N, generator=gen, device="cuda")
    Cm = torch.randn(2, T, cfg.ssm_groups, N, generator=gen, device="cuda")
    s0 = torch.randn(2, H, P, N, generator=gen, device="cuda")
    err = 0.0
    for init in (None, s0):
        y, st = ssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=cfg.ssm_chunk,
                                initial_state=init)
        yr, sr = ssm.ssd_reference(x, dt, A, Bm, Cm, initial_state=init)
        torch.cuda.synchronize()
        for got, want, what in ((y, yr, "y"), (st, sr, "final state")):
            e_ = (got - want).abs().max().item()
            scale = want.abs().max().item()
            if not (math.isfinite(e_) and e_ <= SSD_TOL * scale):
                fail(f"19: ssd_chunked {what} disagrees with ssd_reference "
                     f"(max {e_:.3e}, max|oracle| {scale:.3e})")
            err = max(err, e_ / scale)
            print(f"[ssd] ssd_chunked vs ssd_reference, (2, {T}, {H}, {P}) "
                  f"state {N}, chunk {cfg.ssm_chunk}, "
                  f"{'with' if init is not None else 'without'} an initial "
                  f"state, f32: {what} max|d| {e_:.3e} of max|oracle| "
                  f"{scale:.3e} (tol {SSD_TOL} x max|oracle|)")
    out["chunked_rel_err"] = err
    del x, dt, Bm, Cm, s0, y, yr, st, sr

    eng = ServingEngine(model, params, max_len=max(lens) + 48, seed=0,
                        device="cuda")
    calls = {"prefill": 0, "decode": 0}
    eng.runner.prefill = counted(calls, "prefill", eng.runner.prefill)
    eng.runner.decode = counted(calls, "decode", eng.runner.decode)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, V, n).tolist() for n in lens for _ in range(4)]
    eng.generate([Request(uid=100, prompt=prompts[0][:16],
                          sampling=SamplingParams(max_new_tokens=2))])
    reqs = [Request(uid=i, prompt=p,
                    sampling=SamplingParams(max_new_tokens=32))
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0                     # count this path only
    calls.update(prefill=0, decode=0)
    comps = eng.generate(reqs, max_batch=4)
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in kernels.items()}
    out["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    for c in comps:
        if len(c.tokens) != 32 or not all(0 <= t < V for t in c.tokens):
            fail(f"19: request {c.uid}: {len(c.tokens)} tokens")
    if calls["prefill"] != 2 or calls["decode"] <= 0:
        fail(f"19: runner calls {calls}: expected 2 prefills and decode "
             "steps")
    if any(counts.values()):
        fail(f"19: the SSD path launched the port's kernels: {counts}")
    rep = throughput_report(comps, **eng.last_phase_s)
    ttft = sorted(c.t_first - c.t0 for c in comps)
    out.update(decode_tok_per_s=rep["decode_tok_per_s"],
               ttft_p50_ms=ttft[len(ttft) // 2] * 1e3, calls=dict(calls))
    print(f"[ssd] 19: {len(comps)} requests x 32 tokens in "
          f"{len(eng._buckets(reqs, 4))} buckets; {calls['prefill']} prefill "
          f"calls, {calls['decode']} decode steps; decode "
          f"{rep['decode_tok_per_s']:.1f} tok/s, prefill "
          f"{rep['prefill_tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{out['ttft_p50_ms']:.1f} ms, peak memory "
          f"{out['serve_peak_gib']:.2f} GiB — {card}", flush=True)
    del eng

    # a decode step after a prefill of n - 1 tokens against the last
    # logits of a prefill of n
    n = max(lens)
    toks = torch.tensor(prompts[-4:], dtype=torch.long, device="cuda")
    cache = model.init_cache(4, n + 48, device="cuda")
    model.prefill(params, {"tokens": toks[:, :n - 1]}, cache)
    got, _ = model.decode_step(params, cache, toks[:, n - 1:n], n - 1)
    whole = model.init_cache(4, n + 48, device="cuda")
    want, _ = model.prefill(params, {"tokens": toks}, whole)
    logit_parity(torch, got, want, LOGIT_TOL_SSD,
                 f"19 Mamba-2 decode after a prefill of {n - 1} tokens vs "
                 f"the last logits of a prefill of {n}")
    del whole
    stats = {}
    profile_step(torch, lambda p_: model.decode_step(
        params, cache, toks[:, :1], p_), n, "full-width Mamba-2-370m decode",
        card, batch=4, stats=stats)
    out["step_busy_ms"] = stats["busy_ms"]
    out["step_wall_ms"] = stats["wall_ms"]
    pcache = model.init_cache(4, n + 48, device="cuda")

    def run():
        model.prefill(params, {"tokens": toks}, pcache)

    run()
    torch.cuda.synchronize()
    by_prefill = kernel_times(torch, run, 2)
    out["prefill_busy_ms"] = sum(ms for ms, _ in by_prefill.values())
    print(f"[profile] full-width Mamba-2-370m prefill (B=4, {n} tokens): "
          f"device busy {out['prefill_busy_ms']:.2f} ms — {card}")
    print_top(by_prefill)
    del cache, pcache, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def live_gates(torch, params, gen):
    """Every cross-attention ``gate`` of ``params`` drawn uniform in
    [0.5, 1.5) from ``gen``, in place: the init's zero gates would switch
    every cross-attention off (tanh(0) = 0), and the phase would pass
    with it broken.  Returns the number of gates."""
    from repro_torch.models.weights import tree_leaves_with_path
    n = 0
    for path, leaf in tree_leaves_with_path(params):
        if path[-1] == "gate":
            leaf.copy_(torch.rand(leaf.shape, generator=gen,
                                  device=leaf.device) + 0.5)
            n += leaf.numel()
    return n


def xattn_phase(torch, np, kernels, card, phase, arch, lens, n_new):
    """Phases 20 and 21: full-width ``arch`` (Llama-3.2-Vision-11B or
    Whisper-medium) through the bucket engine, weights drawn on the card
    from seed 0 with every gate drawn nonzero.  Four prompts of
    each length in ``lens``, each with its own image or audio stub (the
    port's ``data.pipeline`` stub, the reference's numpy draw, fed in
    ``cfg.dtype``, as a caller may), ``max_batch=4``, ``n_new`` greedy
    tokens each; counts set to 0 just before and read just after.
    Checks: the completions; contiguous-kernel launches = (self-attention
    layers + cross-attention reads) x decode steps; from the largest
    bucket's prefill, one decode step with the kernels against the plain
    versions on a clone of the ring (``LOGIT_TOL``), the same step with
    every gate at 0 and over another lane's memory each moving the logits
    by more than 0.1 (both printed beside ``LOGIT_TOL``), the kernel
    against its plain version at the first cross-attention layer's K/V
    (``kv_len`` = M); a decode step after a prefill of n - 1 tokens against
    the last logits of a prefill of n.  Profiles a decode step (its
    contiguous-kernel launches counted), a prefill call and, for Whisper,
    the encoder alone over the same frames.  Returns the phase's
    numbers."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import stub_frames, stub_image_embeds
    from repro_torch.kernels import ref
    from repro_torch.models import build_model, transformer
    from repro_torch.models.weights import tree_leaves_with_path, tree_map
    from repro_torch.quant import param_bytes
    from repro_torch.serving import (Request, SamplingParams, ServingEngine,
                                     throughput_report)
    cfg = get_config(arch)
    V, d = cfg.vocab_size, cfg.d_model
    model = build_model(cfg)
    # the model names the input its cross-attention reads
    key = model.memory_input
    stub, M = {"frames": (stub_frames, cfg.n_audio_frames),
               "image_embeds": (stub_image_embeds, cfg.n_image_tokens)}[key]
    t0 = time.perf_counter()
    wgen = torch.Generator(device="cuda")
    wgen.manual_seed(0)
    params = model.init(wgen)
    n_gates = live_gates(torch, params, wgen)
    torch.cuda.synchronize()
    n_self = model.kinds.count("attn")
    n_cross = n_self if model.decoder_cross else model.kinds.count("xattn")
    per_step = n_self + n_cross
    enc = (f"{cfg.n_encoder_layers} encoder layers over {M} frames, "
           if cfg.is_encoder_decoder else f"{M} image tokens, ")
    print(f"[xattn] {phase}: {cfg.name}: {cfg.n_layers} decoder layers "
          f"({n_self} self-attention, {n_cross} with cross-attention), "
          f"{enc}d_model {d}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {V}; "
          f"{cfg.param_count() / 1e9:.3f} B parameters, "
          f"{param_bytes(params) / 2**30:.2f} GiB of {cfg.dtype} weights, "
          f"{n_gates} gates drawn in [0.5, 1.5) "
          f"({time.perf_counter() - t0:.1f} s to draw); the {key} stubs "
          f"are the port's numpy draws, fed in {cfg.dtype}", flush=True)

    def memory(seed):
        return torch.from_numpy(stub(1, M, d, seed=seed)[0]).to(
            "cuda", cfg.dtype)

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, V, n).tolist() for n in lens for _ in range(4)]
    mems = [memory(i) for i in range(len(prompts))]
    eng = ServingEngine(model, params, max_len=max(lens) + n_new + 16,
                        seed=0, device="cuda")
    calls = {"prefill": 0, "decode": 0}
    eng.runner.prefill = counted(calls, "prefill", eng.runner.prefill)
    eng.runner.decode = counted(calls, "decode", eng.runner.decode)
    eng.generate([Request(uid=100, prompt=prompts[0][:16],
                          sampling=SamplingParams(max_new_tokens=2),
                          extra={key: mems[0]})])
    reqs = [Request(uid=i, prompt=p,
                    sampling=SamplingParams(max_new_tokens=n_new),
                    extra={key: mems[i]}) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0                     # count this path only
    calls.update(prefill=0, decode=0)
    comps = eng.generate(reqs, max_batch=4)
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in kernels.items()}
    out = {"serve_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": counts["decode_attention"], "per_step": per_step}
    for c in comps:
        if len(c.tokens) != n_new or not all(0 <= t < V for t in c.tokens):
            fail(f"{phase}: request {c.uid}: {len(c.tokens)} tokens")
    if calls["prefill"] != len(lens) or calls["decode"] <= 0:
        fail(f"{phase}: runner calls {calls}: expected {len(lens)} "
             "prefills and decode steps")
    if counts["decode_attention"] != per_step * calls["decode"]:
        fail(f"{phase}: contiguous launches {counts['decode_attention']} != "
             f"{per_step} x {calls['decode']} decode steps")
    for name in ("paged_decode_attention", "q4_gemm", "rglru_scan"):
        if counts[name]:
            fail(f"{phase}: launched {name} {counts[name]} times")
    rep = throughput_report(comps, **eng.last_phase_s)
    ttft = sorted(c.t_first - c.t0 for c in comps)
    out.update(decode_steps=calls["decode"],
               decode_tok_per_s=rep["decode_tok_per_s"],
               ttft_p50_ms=ttft[len(ttft) // 2] * 1e3)
    print(f"[xattn] {phase}: {len(comps)} requests x {n_new} tokens in "
          f"{len(eng._buckets(reqs, 4))} bucket(s); {calls['prefill']} "
          f"prefill calls, {calls['decode']} decode steps; contiguous decode "
          f"attention {counts['decode_attention']} = {per_step} x "
          f"{calls['decode']} ({n_self} ring + {n_cross} kv_len reads a "
          f"step); decode {rep['decode_tok_per_s']:.1f} tok/s, prefill "
          f"{rep['prefill_tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{out['ttft_p50_ms']:.1f} ms, peak memory "
          f"{out['serve_peak_gib']:.2f} GiB — {card}", flush=True)
    del eng, comps

    # parity from the largest bucket's prefill
    n, B = max(lens), 4
    toks = torch.tensor(prompts[-B:], dtype=torch.long, device="cuda")
    batch = {"tokens": toks, key: torch.stack(mems[-B:])}
    cache = model.init_cache(B, n + 48, device="cuda")
    logits, _ = model.prefill(params, batch, cache)
    fed = logits[:, 0].float().argmax(-1, keepdim=True)
    clone = tree_map(lambda t: t.clone(), cache)
    off = tree_map(lambda t: t.clone(), cache)
    moved = dict(tree_map(lambda t: t.clone(), cache),
                 memory=cache["memory"].roll(1, 0))
    got, _ = model.decode_step(params, cache, fed, n)
    want, _ = model.decode_step(params, clone, fed, n, impl="ref")
    logit_parity(torch, got, want, LOGIT_TOL,
                 f"{phase} {cfg.name} ring decode logits, kernels vs plain")
    other, _ = model.decode_step(params, moved, fed, n)
    # the cross-attention switched off: every gate at 0, then restored
    gates = [leaf for path, leaf in tree_leaves_with_path(params)
             if path[-1] == "gate"]
    drawn = [g.clone() for g in gates]
    for g in gates:
        g.zero_()
    dead, _ = model.decode_step(params, off, fed, n)
    for g, w in zip(gates, drawn):
        g.copy_(w)

    def max_d(a):
        return (a.float() - got.float()).abs().max().item()

    out.update(live_gates_off_max_d=max_d(dead), live_max_d=max_d(other),
               parity_max_d=max_d(want))
    print(f"[parity] {phase}: the same decode step with every gate at 0 "
          f"moves the logits by max|d| {out['live_gates_off_max_d']:.3f}, "
          f"over the next lane's {key} by {out['live_max_d']:.3f} (each "
          "must exceed 0.1: the cross-attention is live); that is "
          f"{out['live_gates_off_max_d'] / LOGIT_TOL:.2f}x / "
          f"{out['live_max_d'] / LOGIT_TOL:.2f}x LOGIT_TOL, where the "
          f"kernels against the plain versions moved them by "
          f"{out['parity_max_d']:.4f}")
    if not (out["live_gates_off_max_d"] > 0.1 and out["live_max_d"] > 0.1):
        fail(f"{phase}: the cross-attention does not reach the logits")
    del clone, off, moved, other, dead, drawn
    # the kernel at the first cross-attention layer's K/V, kv_len = M
    lp = next(lp for _, lp, _c in model._layer_views(params["layers"],
                                                       cache["layers"])
              if "xattn" in lp)
    mem = cache["memory"]
    _, k, v = transformer._project_qkv(cfg, lp["xattn"], mem[:, :1], mem)
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    q = torch.randn(B, Hkv, cfg.n_heads // Hkv, hd, generator=gen,
                    device="cuda").to(cfg.dtype)
    got_k = kernels["decode_attention"](q, k, v, M)
    torch.cuda.synchronize()
    out["cross_err"] = check(torch, got_k, ref.decode_attention_ref(
        q, k, v, M), ..., f"{phase} decode_attention at the first "
        "cross-attention layer's K/V")
    print(f"[kernel] {phase} decode_attention at the first cross-attention "
          f"layer's K/V (B={B}, kv_len {M}, {Hkv}/{cfg.n_heads} heads, "
          f"D={hd}, {k.dtype}): max|kernel-plain| {out['cross_err']:.3e}")
    del k, v, q, got_k
    # a decode step after a prefill of n - 1 tokens against the last
    # logits of a prefill of n
    short = model.init_cache(B, n + 48, device="cuda")
    model.prefill(params, dict(batch, tokens=toks[:, :n - 1]), short)
    got, _ = model.decode_step(params, short, toks[:, n - 1:n], n - 1)
    whole = model.init_cache(B, n + 48, device="cuda")
    want, _ = model.prefill(params, batch, whole)
    logit_parity(torch, got, want, LOGIT_TOL,
                 f"{phase} {cfg.name} decode after a prefill of {n - 1} "
                 f"tokens vs the last logits of a prefill of {n}")
    del short, whole
    stats = {}
    by_step = profile_step(torch, lambda p_: model.decode_step(
        params, cache, fed, p_), n + 1, f"full-width {cfg.name} decode",
        card, batch=B, stats=stats)
    da_ms, da_n = kernel_share(by_step, ("decode_attn_kernel",))
    if round(da_n) != per_step:
        fail(f"{phase}: {da_n:.0f} decode_attn_kernel launches in a profiled "
             f"decode step, not {per_step}")
    out.update(step_busy_ms=stats["busy_ms"], step_wall_ms=stats["wall_ms"],
               step_decode_attention_ms=da_ms)
    print(f"[profile] {phase} decode_attention in the decode step: "
          f"{da_ms * 1e3:.1f} us over {da_n:.0f} launches — {card}")
    pcache = model.init_cache(B, n + 48, device="cuda")

    def run():
        model.prefill(params, batch, pcache)

    run()
    torch.cuda.synchronize()
    by_prefill = kernel_times(torch, run, 2)
    out["prefill_busy_ms"] = sum(ms for ms, _ in by_prefill.values())
    line = (f"[profile] full-width {cfg.name} prefill (B={B}, {n} tokens): "
            f"device busy {out['prefill_busy_ms']:.2f} ms")
    if cfg.is_encoder_decoder:
        by_encoder = kernel_times(
            torch, lambda: model._encode(params, batch[key]), 2)
        out["encoder_busy_ms"] = sum(ms for ms, _ in by_encoder.values())
        line += (f", of which the encoder alone over the same frames "
                 f"{out['encoder_busy_ms']:.2f} ms")
    print(f"{line} — {card}", flush=True)
    print_top(by_encoder if cfg.is_encoder_decoder else by_prefill)
    del cache, pcache, batch, mems, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# 22. training at full width
# ----------------------------------------------------------------------

#: AdamW in phase 22: the peak learning rate and its linear warm-up over
#: the 5 checked steps.  Higher, the first steps from a random init
#: overshot: Qwen3's loss went 12.3, 7.7, 17.5, 9.1, 7.1 at 1e-3 without a
#: warm-up, and 12.3, 8.1, 6.2, 8.8, 9.5 at 3e-4 with this one (AdamW's
#: first updates are ~lr on every weight, whatever its gradient, and a
#: bf16 weight of ~0.02 moves by whole ulps of 1.2e-4)
TRAIN_LR = 1e-4
TRAIN_WARMUP = 5
#: gradients of one full-width RG-LRU block in float32, scan kernels
#: against the plain scans: both scans are bit for bit and every other
#: operation is the same call on the same inputs, so they should agree
#: exactly; 1e-5 of a leaf's largest |g| leaves room only for a library
#: matmul that reorders a float32 sum between two calls
BLOCK_GRAD_RTOL = 1e-5
#: kernel names of the library GEMMs in a profile (cuBLAS on Hopper)
GEMM_NAMES = ("nvjet", "gemm", "cutlass", "sm90_xmma")
#: the reverse scan's timed and checked shapes: the main path's (a train
#: step of RecurrentGemma-2B at B=2 x 512, and the issue's B=4 x 512),
#: one prompt at the window length
REVERSE_SHAPES = ((2, 512, 2560), (4, 512, 2560), (1, 2048, 2560))


def train_flops(cfg, n_params, B, S):
    """Model FLOPs of one train step: 6 x parameters x tokens, plus the
    attention products (QK^T and PV, 4*B*S^2*H*D a layer forward, the
    whole square: the port's blockwise attention masks, it does not skip)
    times 3 for forward and backward; the remat's recomputed forward is
    not counted."""
    n_attn = cfg.layer_kinds.count("attn")
    attn = 3 * 4 * B * S * S * cfg.n_heads * cfg.resolved_head_dim * n_attn
    return 6 * n_params * B * S + attn


def train_steps(torch, step, params, opt_state, batches, n, label, card,
                kernels=None, count_at=None):
    """``n`` train steps, each synchronised and timed on the host clock;
    with ``count_at``, every kernel's launch count set to 0 just before
    that step and read just after.  Returns (params, opt_state, losses,
    grad norms, step seconds, launches of the counted step)."""
    losses, norms, secs, counted_launches = [], [], [], None
    for i in range(n):
        batch = next(batches)
        torch.cuda.synchronize()
        if count_at == i:
            for fn in kernels.values():
                fn.launches = 0
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if count_at == i:
            counted_launches = {k: fn.launches for k, fn in kernels.items()}
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        print(f"[train] {label} step {i}: loss {losses[-1]:.4f} lr "
              f"{float(m['lr']):.2e} gnorm {norms[-1]:.3f} "
              f"{secs[-1] * 1e3:.1f} ms wall — {card}", flush=True)
    return params, opt_state, losses, norms, secs, counted_launches


def check_training(losses, norms, moved, label):
    if not all(math.isfinite(x) for x in losses + norms):
        fail(f"{label}: a loss or gradient norm is not finite: {losses} "
             f"{norms}")
    if not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall: {losses}")
    if not moved:
        fail(f"{label}: the train steps did not move the parameters")


def train_model(torch, arch, B, S, card, kernels):
    """A full-width ``arch`` (bf16, weights drawn on the card from seed 0)
    and its train step (AdamW at TRAIN_LR after TRAIN_WARMUP steps)
    over ``PackedLMDataset`` batches of B x S tokens: 1 warm-up step and 4
    timed steps (the kernels' counts set to 0 around the first timed one),
    then one step profiled by kernel and the AdamW update timed alone
    with CUDA events.  Returns the phase's numbers."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PackedLMDataset
    from repro_torch.models import build_model
    from repro_torch.models.weights import tree_leaves_with_path
    from repro_torch.training import loop, optimizer
    cfg = get_config(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    wgen = torch.Generator(device="cuda")
    wgen.manual_seed(0)
    params = model.init(wgen)
    torch.cuda.synchronize()
    leaves = [t for _, t in tree_leaves_with_path(params)]
    n_params = sum(t.numel() for t in leaves)
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B "
          f"params in {cfg.dtype} ({time.perf_counter() - t0:.1f} s to "
          f"draw); batches of {B} x {S} tokens", flush=True)
    probe = leaves[len(leaves) // 2]
    before = probe.flatten()[:4096].clone()
    opt_cfg = optimizer.AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                                    total_steps=100)
    step = loop.make_train_step(model, opt_cfg)
    batches = PackedLMDataset(seq_len=S, n_docs=2000,
                              vocab_size=cfg.vocab_size).batches(B)
    opt_state = optimizer.adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, losses, norms, secs, launches = train_steps(
        torch, step, params, opt_state, batches, 5, cfg.name, card,
        kernels=kernels, count_at=1)
    peak = torch.cuda.max_memory_allocated()
    moved = not torch.equal(before, probe.flatten()[:4096])
    check_training(losses, norms, moved, f"{cfg.name} training")
    wall_ms = 1e3 * sum(secs[1:]) / len(secs[1:])
    flops = train_flops(cfg, n_params, B, S)
    batch = next(batches)

    def run():
        nonlocal params, opt_state
        params, opt_state, _ = step(params, opt_state, batch)

    by_kernel = kernel_times(torch, run, 1)
    busy = sum(ms for ms, _ in by_kernel.values())
    gemm_ms, gemm_n = kernel_share(by_kernel, GEMM_NAMES)
    n_all = sum(n for _, n in by_kernel.values())
    # the AdamW update alone, on one set of gradients
    for p in leaves:
        p.requires_grad_(True)
    bt = loop.batch_to(batch, "cuda")
    loss, _ = model.loss(params, bt)
    grads = list(torch.autograd.grad(loss, leaves))
    for p in leaves:
        p.requires_grad_(False)
    del loss
    gtree = loop._unflatten_like(params, grads)
    del grads
    adamw_ms = cuda_ms(torch, lambda i: optimizer.adamw_update(
        opt_cfg, gtree, opt_state, params), 3, warmup=1)
    del gtree
    adamw_bytes = sum(t.numel() * (2 * t.element_size() + 2 * 2 * 4
                                   + t.element_size()) for t in leaves)
    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
        "B": B, "S": S, "losses": losses, "grad_norms": norms,
        "step_wall_ms": wall_ms, "step_device_ms": busy,
        "tokens_per_s": B * S / (wall_ms / 1e3),
        "model_tflop": flops / 1e12,
        "bf16_peak_share": flops / PEAK_FLOPS["bfloat16"] / (wall_ms / 1e3),
        "peak_gib": peak / 2**30, "adamw_ms": adamw_ms,
        "adamw_bound_ms": adamw_bytes / HBM_BYTES_PER_S * 1e3,
        "gemm_ms": gemm_ms, "gemm_launches": gemm_n,
        "device_launches": n_all,
        "launches": launches, "n_rglru": model.kinds.count("rglru")}
    print(f"[train] {cfg.name}: step {wall_ms:.1f} ms wall (mean of 4), "
          f"{busy:.1f} ms device busy in a profiled step ({busy / wall_ms:.0%}"
          f" of the wall); {out['tokens_per_s']:.0f} tokens/s; "
          f"{out['model_tflop']:.2f} TFLOP of model work a step, "
          f"{out['bf16_peak_share']:.1%} of the bf16 peak; the AdamW update "
          f"alone {adamw_ms:.1f} ms (its byte bound "
          f"{out['adamw_bound_ms']:.1f} ms); peak memory {peak / 2**30:.2f} "
          f"GiB; launches in one step {launches} — {card}", flush=True)
    print(f"[profile] {cfg.name} train step: GEMMs (cuBLAS) {gemm_ms:.1f} ms "
          f"over {gemm_n:.0f} launches, the other {n_all - gemm_n:.0f} "
          f"launches {busy - gemm_ms:.1f} ms — {card}")
    print_top(by_kernel, 10)
    del params, opt_state, leaves, probe, step, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_reverse_kernel(torch, ref, kern, plan, sms, gen):
    """Phase 22c: the scan kernel's reverse mode against its plain version,
    bit for bit: REVERSE_SHAPES, one step short of and past a stage of the
    plan at B=4 (their T from :func:`scan_stage_edge`), W = 36 (the
    4-byte path) and a ragged last strip (W = 64, T = 37).  Returns the
    largest |kernel - plain|."""
    shapes = list(REVERSE_SHAPES) + [
        (4, scan_stage_edge(plan, 4, 2560, e, sms), 2560) for e in (-1, 1)]
    shapes += [(2, 100, 36), (2, 37, 64)]
    max_err = 0.0
    for B, T, W in shapes:
        a = 0.5 + 0.5 * torch.rand(B, T, W, generator=gen, device="cuda")
        g = torch.randn(B, T, W, generator=gen, device="cuda")
        got = kern(a, g)
        torch.cuda.synchronize()
        want = ref.rglru_scan_reverse_ref(a, g)
        err = (got - want).abs().max().item()
        if not (bool(torch.isfinite(got).all()) and err <= SCAN_TOL):
            fail(f"rglru_scan_reverse ({B}, {T}, {W}): kernel disagrees with "
                 f"the plain version ({err:.3e})")
        max_err = max(max_err, err)
        print(f"[kernel] rglru_scan_reverse ({B}, {T}, {W}): max|kernel-"
              f"plain| {err:.3e}, plan {kern.plan}")
    return max_err


def time_reverse_kernel(torch, ref, ops, kern, gen, card):
    """Phase 22d: the reverse mode at REVERSE_SHAPES, a and g rotated past
    the L2, beside its plain version and its byte bound (12 B T W: a and g
    read once, c written once); and the scan Function's whole backward
    (the reverse kernel, then the elementwise dL/da pass) as context.
    Returns {(B, T, W): (kernel ms, plain ms, bound ms, bound_by, plan,
    backward ms)}."""
    out = {}
    for B, T, W in REVERSE_SHAPES:
        n = max(2, math.ceil(ROTATE_BYTES / (2 * B * T * W * 4)))
        As = [0.5 + 0.5 * torch.rand(B, T, W, generator=gen, device="cuda")
              for _ in range(n)]
        Gs = [torch.randn(B, T, W, generator=gen, device="cuda")
              for _ in range(n)]
        t_k = cuda_ms(torch, lambda i: kern(As[i % n], Gs[i % n]), 100)
        t_p = cuda_ms(torch, lambda i: ref.rglru_scan_reverse_ref(
            As[i % n], Gs[i % n]), 3)
        b_ms, b_by = least(12 * B * T * W, 2 * B * T * W, "float32")
        plan = kern.plan
        us = [torch.randn(B, T, W, generator=gen, device="cuda")
              .requires_grad_() for _ in range(n)]
        a_req = [a.requires_grad_() for a in As]
        hs = [ops.rglru_linear_scan(a_req[i], us[i]) for i in range(n)]
        t_b = cuda_ms(torch, lambda i: torch.autograd.grad(
            hs[i % n], (a_req[i % n], us[i % n]), Gs[i % n],
            retain_graph=True), 50)
        out[(B, T, W)] = (t_k, t_p, b_ms, b_by, plan, t_b)
        print(f"[timing] rglru_scan_reverse ({B}, {T}, {W}) f32: kernel "
              f"{t_k * 1e3:.2f} us (roofline share {b_ms / t_k:.0%}), plain "
              f"{t_p * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us ({b_by}); plan "
              f"{plan}; the whole scan backward (kernel + dL/da pass) "
              f"{t_b * 1e3:.2f} us; no single PyTorch call computes this "
              f"recurrence — {card}")
        del As, Gs, us, a_req, hs
    return out


def rglru_block_grads(torch, ref_impl, lp, x, dy):
    """Gradients of one ``rglru_block`` (its parameters and its input)
    under ``impl``; float32."""
    from repro_torch.models.recurrent import rglru_block
    lp = {k: v.detach().float().requires_grad_() for k, v in lp.items()}
    x = x.detach().clone().requires_grad_()
    y, _ = rglru_block(lp, x, impl=ref_impl)
    names = sorted(lp)
    grads = torch.autograd.grad(y, [lp[k] for k in names] + [x], dy)
    return dict(zip(names + ["x"], grads))


def train_phase(torch, kernels, card, gen):
    """Phase 22: training at full width on the card.

    a. full-width, full-depth Qwen3-1.7B (28 layers, bf16): 1 warm-up and
       4 timed train steps of 4 x 512 tokens, one profiled;
    b. full-width, full-depth RecurrentGemma-2B (26 layers, bf16) at 2 x
       512 the same way; a train step must launch the scan's forward and
       reverse modes once per RG-LRU layer (18 + 18);
    c. the reverse mode against its plain version, bit for bit;
    d. its time beside its bound and its plain version;
    e. the gradients of one full-width RG-LRU block (layer 0's weights, in
       float32, B=2 x 512) with the scan kernels against the plain scans.
    Returns the phase's numbers."""
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.models.weights import tree_map
    out = {"qwen": train_model(torch, "qwen3-1.7b", 4, 512, card, kernels)}
    q = out["qwen"]["launches"]
    if any(q.values()):
        fail(f"Qwen3 train step launched port kernels: {q}")
    rg = train_model(torch, "recurrentgemma-2b", 2, 512, card, kernels)
    out["rg"] = rg
    out["qwen"].pop("n_rglru")
    n_rglru = rg.pop("n_rglru")          # 18 in the full config
    la = rg["launches"]
    if (la["rglru_scan"] != n_rglru or la["rglru_scan_reverse"] != n_rglru
            or la["decode_attention"] or la["paged_decode_attention"]
            or la["q4_gemm"]):
        fail(f"RecurrentGemma train step launches {la}: want {n_rglru} "
             f"rglru_scan and {n_rglru} rglru_scan_reverse, nothing else")
    print(f"[train] RecurrentGemma-2B train step: rglru_scan {la['rglru_scan']}"
          f" + rglru_scan_reverse {la['rglru_scan_reverse']} launches = "
          f"{n_rglru} + {n_rglru} RG-LRU layers")
    out["reverse_err"] = check_reverse_kernel(
        torch, ref, rs.rglru_scan_reverse, rs.scan_plan, build.sm_count(0),
        gen)
    out["reverse_times"] = time_reverse_kernel(
        torch, ref, ops, rs.rglru_scan_reverse, gen, card)
    # e. one full-width block's gradients, kernels vs plain scans
    from repro_torch.configs import get_config
    from repro_torch.models.recurrent import init_rglru_block
    cfg = get_config("recurrentgemma-2b")
    bgen = torch.Generator(device="cuda")
    bgen.manual_seed(1)
    lp = init_rglru_block(bgen, cfg.d_model, cfg.lru_width, cfg.ssm_conv,
                          torch.float32)
    lp = tree_map(lambda t: t if bool(t.any()) else 0.1 * torch.randn(
        t.shape, generator=bgen, device="cuda"), lp)
    x = torch.randn(2, 512, cfg.d_model, generator=bgen, device="cuda")
    dy = torch.randn(2, 512, cfg.d_model, generator=bgen, device="cuda")
    got = rglru_block_grads(torch, "auto", lp, x, dy)
    want = rglru_block_grads(torch, "ref", lp, x, dy)
    worst = 0.0
    for k, g in got.items():
        w = want[k]
        rel = ((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
        worst = max(worst, rel)
        if not (bool(torch.isfinite(g).all()) and rel <= BLOCK_GRAD_RTOL):
            fail(f"rglru_block gradient of {k}: kernels vs plain "
                 f"{rel:.3e} of its largest |g| (tol {BLOCK_GRAD_RTOL})")
    out["block_grad_rel"] = worst
    print(f"[train] full-width rglru_block gradients (B=2 x 512, f32), "
          f"scan kernels vs plain scans: worst leaf {worst:.3e} of its "
          f"largest |g| (tol {BLOCK_GRAD_RTOL}) over {len(got)} leaves")
    return out


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
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.quant import (QuantPolicy, count_q4_leaves, make_qmm,
                                   param_bytes, q4_0, quantize_rows)
    kernels = port_kernels()
    kernel = kernels["paged_decode_attention"]
    q4k = kernels["q4_gemm"]

    # -- 2. build: one nvcc per source, all at once -----------------------
    sources = (da.KERNEL, qg.KERNEL, da.CONTIGUOUS_KERNEL, rs.KERNEL)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as ex:
        list(ex.map(build.load, sources))
    print(f"[build] {' + '.join(sources)}: "
          f"{time.perf_counter() - t0:.2f} s wall")
    for name in sources:
        rec = build.build_record(name)
        print(f"[build] {name}: nvcc {rec['seconds']:.2f} s, "
              f"cached={rec['cached']}")
        for line in str(rec["ptxas"]).splitlines():
            # the scan's instantiations (STEPS, path) are named, so that
            # its registers can be read by kernel
            if "registers" in line or "spill" in line or (
                    name == rs.KERNEL and "entry function" in line):
                print(f"[build]   {line.strip()}")
    for B_, T_, W_ in SCAN_SHAPES:
        plan = rs.scan_plan(B_, T_, W_, build.sm_count(0))
        print(f"[build] rglru_scan plan at ({B_}, {T_}, {W_}): {plan[0]} "
              f"warp(s) a block, {plan[1]} steps a stage, {plan[2]} stages; "
              f"{rs.scan_smem(*plan)} bytes of dynamic shared memory a "
              f"block")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    max_err = 0.0

    # -- 3a. paged kernel vs plain version -------------------------------
    stamp(t_start, "phase 3, kernels vs plain versions")
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

    # -- 3c./3d. the paged kernel's split-K, and a CUDA graph ------------
    err_f, err_8 = check_paged_splits(torch, ref, da, quantize_rows, gen)
    max_err, err_i8 = max(max_err, err_f), max(err_i8, err_8)
    check_paged_graph(torch, ref, kernel, quantize_rows, gen)
    torch.cuda.empty_cache()

    # -- 3e. Q4_0 GEMM vs plain version ----------------------------------
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

    # -- 3f. two calls on the same input give the same bits -------------
    check_repeatable(torch, gen, kernels, quantize_rows, q4_0)

    # -- 4. kernel timing ------------------------------------------------
    stamp(t_start, "phase 4, kernel timing")
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
    stamp(t_start, "phase 5, continuous serving in bf16")
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
    V = cfg.vocab_size
    prompts = serve_prompts(np, V)
    eng = ContinuousServingEngine(model, params, max_len=1024, max_running=8,
                                  page_size=16, prefill_chunk=128, seed=0,
                                  device="cuda")
    counts, decode_steps, _ = serve(torch, eng, prompts, cfg, kernels,
                                    "serve", card)
    launches = counts["paged_decode_attention"]
    if decode_steps <= 0 or launches != cfg.n_layers * decode_steps:
        fail(f"kernel launches {launches} != {cfg.n_layers} x "
             f"{decode_steps} decode steps")
    for name in ("q4_gemm", "decode_attention", "rglru_scan"):
        if counts[name]:
            fail(f"bf16 paged serving launched {name} {counts[name]} times")

    # -- 6. decode parity on the card (bf16) -----------------------------
    cache, clone, fed_t, pos, ps = parity_state(
        torch, np, gen, model, eng.runner.params, prompts, "fp32")
    got, _ = model.decode_step(eng.runner.params, cache, fed_t, pos,
                               page_size=ps)
    want, _ = model.decode_step(eng.runner.params, clone, fed_t, pos,
                                page_size=ps, impl="ref")
    logit_parity(torch, got, want, LOGIT_TOL,
                 "full-width decode logits, kernel vs plain")
    err6, t_k, t_p, t_l, b_ms, b_by, _, n_split = time_serving_state(
        torch, F, ref, kernel, cache, pos, cfg, gen, "bf16", card)
    max_err = max(max_err, err6)
    run_params = eng.runner.params
    paged_dev = paged_profile(profile_step(torch, lambda p_: model.decode_step(
        run_params, cache, fed_t, p_, page_size=ps), pos + 1,
        "full-width bf16 decode", card), cfg.n_layers, "bf16 decode", card)

    # -- 7. serve under q4 weights + int8 pages ---------------------------
    stamp(t_start, "phase 7, continuous serving under q4 + int8")
    del eng, cache, clone, got, want, run_params
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
    err8, t_k8, t_p8, t_l8, b8_ms, b8_by, t_bf16, n_split8 = (
        time_serving_state(torch, F, ref, kernel, cache, pos, cfg, gen,
                           "int8", card))
    err_i8 = max(err_i8, err8)
    by_kernel8 = profile_step(
        torch, lambda p_: model.decode_step(qparams, cache, fed_t, p_,
                                            page_size=ps), pos + 1,
        "full-width q4 + int8 decode", card)
    paged_dev8 = paged_profile(by_kernel8, cfg.n_layers, "q4 + int8 decode",
                               card)
    q4_step_ms = q4_profile(by_kernel8, 7 * cfg.n_layers,
                            "q4 + int8 decode step (M=8)", card)
    # one full-width 128-token prefill chunk under q4 + int8: device time
    # by kernel (the 196 projections run at M=128)
    chunk = torch.tensor([prompts[-1][:128]], device="cuda")
    run_chunk = (lambda: model.prefill_paged(qparams, {"tokens": chunk},
                                             cache, 0, 128, page_size=ps))
    run_chunk()
    torch.cuda.synchronize()
    by_chunk = kernel_times(torch, run_chunk, 2)
    print(f"[profile] full-width q4 + int8 prefill chunk (1 x 128 tokens): "
          f"device busy {sum(ms for ms, _ in by_chunk.values()):.2f} ms — "
          f"{card}")
    print_top(by_chunk)
    q4_chunk_ms = q4_profile(by_chunk, 7 * cfg.n_layers,
                             "q4 + int8 prefill chunk (M=128)", card)

    # -- 9.-11. speculative verify, async serving, the CLI --------------
    stamp(t_start, "phase 9, verify parity")
    del eng, cache, clone, got, want, qparams, model
    torch.cuda.empty_cache()
    from repro_torch.quant import quantize_serving_params
    L, S = cfg.n_layers, SPEC_K + 1
    model = build_model(cfg)                  # no qmm hook: bf16 serving
    wgen.manual_seed(0)
    params = model.init(wgen)                 # phase 5's weights again
    model_q = build_model(cfg)
    model_q.qmm = make_qmm(qp.impl)
    qparams = quantize_serving_params(params, min_size=qp.min_size)
    spec = {}
    for label, m_, p_, kv, tol, ref_qmm in (
            ("bf16", model, params, "fp32", LOGIT_TOL, None),
            ("q4 + int8", model_q, qparams, "int8", LOGIT_TOL_Q4,
             make_qmm("ref"))):
        (dec, dec_st), (ver, ver_st) = verify_phase(
            torch, np, gen, m_, p_, prompts, kv, tol, label, card,
            ref_qmm=ref_qmm)
        spec[label] = {
            "decode": dec_st, "verify": ver_st,
            "paged_decode": paged_profile(dec, L, f"{label} decode", card),
            "paged_verify": paged_profile(ver, S * L,
                                          f"{label} verify (S={S})", card)}
        if ref_qmm is not None:
            spec[label]["q4_verify"] = q4_profile(
                ver, 7 * L, f"{label} verify step (M={8 * S})", card)
        print(f"[spec] {label}: one verify step (S={S}) takes "
              f"{ver_st['busy_ms']:.2f} ms of device time and "
              f"{ver_st['wall_ms']:.2f} ms of host wall, one decode step "
              f"{dec_st['busy_ms']:.2f} / {dec_st['wall_ms']:.2f} ms on the "
              f"same state — {card}")
    del qparams, p_                 # the loop variable holds the q4 tree
    gc.collect()
    torch.cuda.empty_cache()
    sprompts = spec_prompts(np, V)
    stamp(t_start, "phase 10, async serving with spec_decode")

    def draw_again():               # phase 5's weights, for a q4 engine
        wgen.manual_seed(0)
        return model_q.init(wgen)

    for label, m_, draw, quant, tol in (
            ("bf16", model, lambda: params, None, LOGIT_TOL),
            ("q4 + int8", model_q, draw_again, qp, LOGIT_TOL_Q4)):
        if quant is not None:
            # each q4 engine quantizes a fresh draw and keeps only its
            # Q4_0 tree, so its peak memory is the quantized path's
            del params
            gc.collect()
            torch.cuda.empty_cache()
        runs = async_spec_phase(torch, m_, draw, cfg, kernels, sprompts,
                                quant, tol, label, card)
        spec[label]["async"] = runs
        r2, r0 = runs[SPEC_K], runs[0]
        n_tok = sum(n for n, _ in r2["emitted"])
        n_lanes = sum(b for _, b in r2["emitted"])
        steps = len(r2["emitted"])
        print(f"[spec] {label}: k={SPEC_K} decode "
              f"{r2['rep']['decode_tok_per_s']:.1f} tok/s against k=0 "
              f"{r0['rep']['decode_tok_per_s']:.1f}; {n_tok / steps:.2f} "
              f"tokens per verify step ({n_tok / n_lanes:.2f} a lane) over "
              f"{steps} verify steps; accepted "
              f"{r2['spec']['spec.accepted']} of "
              f"{r2['spec']['spec.drafted']} drafts — {card}")
    stamp(t_start, "phase 11, the async CLI")
    cli_phase(card)
    del model, model_q
    torch.cuda.empty_cache()

    # -- 12.-14. the bucket path's kernels vs plain versions, timed ------
    stamp(t_start, "phase 12, the bucket path's kernels")
    err_da = check_decode_kernel(torch, ref, da.decode_attention, gen)
    err_rs = check_scan_kernel(torch, ref, rs.rglru_scan, rs.scan_plan,
                               build.sm_count(0), gen)
    da_times = time_decode_kernel(torch, F, ref, da.decode_attention, gen,
                                  card)
    cross_times = time_cross_kernel(torch, F, ref, da.decode_attention, gen,
                                    card)
    err_da = max([err_da] + [t[5] for t in cross_times.values()])
    rs_times = time_scan_kernel(torch, ref, rs.rglru_scan, gen, card)
    t_rs, t_rs_p, b_rs, b_rs_by, rs_plan = rs_times[SCAN_SHAPES[0]]
    torch.cuda.empty_cache()

    # -- 15. serve full-width RecurrentGemma-2B (bucket engine) ----------
    stamp(t_start, "phase 15, RecurrentGemma-2B bucket serving")
    model, eng, prompts, counts_rg, calls = serve_recurrentgemma(
        torch, np, kernels, card)
    n_attn = model.kinds.count("attn")
    n_rglru = model.kinds.count("rglru")
    launches_da = counts_rg["decode_attention"]
    launches_rs = counts_rg["rglru_scan"]
    if calls["decode"] <= 0 or launches_da != n_attn * calls["decode"]:
        fail(f"decode_attention launches {launches_da} != {n_attn} x "
             f"{calls['decode']} decode steps")
    if calls["prefill"] <= 0 or launches_rs != n_rglru * calls["prefill"]:
        fail(f"rglru_scan launches {launches_rs} != {n_rglru} x "
             f"{calls['prefill']} prefill calls")
    for name in ("paged_decode_attention", "q4_gemm"):
        if counts_rg[name]:
            fail(f"bucket serving launched {name} {counts_rg[name]} times")
    print(f"[rg] launches: decode_attention {launches_da} = {n_attn} x "
          f"{calls['decode']} decode steps; rglru_scan {launches_rs} = "
          f"{n_rglru} x {calls['prefill']} prefill calls")

    # -- 16. parity on the card, profile ---------------------------------
    by_kernel, (prefill_ms, prefill_scan_ms) = rg_parity(
        torch, model, eng.runner.params, prompts, card)
    # the contiguous kernel is one launch (its splits merge in a cluster)
    # per attention layer
    da_dev, da_n = kernel_share(by_kernel, ("decode_attn_kernel",))
    if da_dev <= 0 or round(da_n) != n_attn:
        fail(f"RecurrentGemma decode step: {da_n:.0f} decode_attn_kernel "
             f"launches a step, not {n_attn}")
    print(f"[profile] decode_attention in the RecurrentGemma decode step: "
          f"{da_dev * 1e3:.1f} us/step over {n_attn} calls "
          f"({da_dev / n_attn * 1e3:.1f} us a call) — {card}")

    # one decode-step layer's 7 projections at M=8: mean per call
    def q4_mean(j, M=8, names=tuple(Q4_PROJ)):
        return sum(q4_times[Q4_PROJ[n_] + (M,)][j] for n_ in names) / len(
            names)

    mlp = ("w_gate", "w_up", "w_down")

    t_da, t_da_p, t_da_l, b_da, b_da_by = da_times[(4, 544)]

    # -- 17. the HTTP front end, the router and the worker fleet ---------
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()
    stamp(t_start, "phase 17a/b, HTTP serving at full width")
    http_runs = http_phase(torch, np, kernels, card)
    stamp(t_start, "phase 17c, the fleet CLI on the card")
    fleet_cli_phase(card)

    # -- 18. Phi-3.5-MoE at full width (16 layers), both engines ---------
    gc.collect()
    torch.cuda.empty_cache()
    stamp(t_start, "phase 18, Phi-3.5-MoE at full width")
    moe = moe_phase(torch, np, kernels, card)
    err_q4 = max(err_q4, moe["q4_err"])
    max_err = max(max_err, moe["paged_err"])
    err_da = max(err_da, moe["ring_err"])

    # -- 19. Mamba-2-370m through the bucket engine ------------------------
    stamp(t_start, "phase 19, Mamba-2-370m bucket serving")
    mamba_phase(torch, np, kernels, card)

    # -- 20.-21. cross-attention and encoder-decoder stacks ----------------
    xattn = {}
    for phase, arch, lens, n_new in XATTN_PHASES:
        stamp(t_start, f"phase {phase}, {arch} bucket serving")
        xattn[arch] = xattn_phase(torch, np, kernels, card, phase, arch,
                                  lens, n_new)
        err_da = max(err_da, xattn[arch]["cross_err"])

    # -- 22. training at full width --------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    stamp(t_start, "phase 22, training at full width")
    tr = train_phase(torch, kernels, card, gen)
    rev = tr["reverse_times"]
    t_rv, t_rv_p, b_rv, b_rv_by, rv_plan, _ = rev[REVERSE_SHAPES[0]]
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
        "splits": n_split,
        "decode_step_device_ms_per_call": paged_dev,
        "launches_async_spec": spec["bf16"]["async"][SPEC_K]["launches"][
            "paged_decode_attention"],
        "verify_step_device_ms_per_call": spec["bf16"]["paged_verify"],
        "launches_http_one_frontend": http_runs["a"]["launches"][
            "paged_decode_attention"],
        "launches_http_router_two_replicas": http_runs["b"]["launches"][
            "paged_decode_attention"],
        "launches_moe_continuous": moe["launches_paged"],
        "moe_decode_step_device_ms_per_call": moe["paged_ms_per_call"],
        "moe_serving_state": {"ms": moe["paged_ms"],
                              "plain_ms": moe["paged_plain_ms"],
                              "library_ms": moe["paged_sdpa_ms"],
                              "bound_ms": moe["paged_bound_ms"],
                              "max_abs_err": moe["paged_err"]},
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
        "splits": n_split8,
        "decode_step_device_ms_per_call": paged_dev8,
        "launches_async_spec": spec["q4 + int8"]["async"][SPEC_K][
            "launches"]["paged_decode_attention"],
        "verify_step_device_ms_per_call": spec["q4 + int8"]["paged_verify"],
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
        "decode_step_device_ms": q4_step_ms,
        "m128_mlp": {"ms": q4_mean(0, 128, mlp),
                     "plain_ms": q4_mean(1, 128, mlp),
                     "bound_ms": q4_mean(3, 128, mlp),
                     "dense_bf16_matmul_ms": q4_mean(2, 128, mlp)},
        "by_shape": [{"K": K, "N": N, "M": M, "ms": t[0], "plain_ms": t[1],
                      "dense_bf16_matmul_ms": t[2], "bound_ms": t[3],
                      "bound_by": t[4]}
                     for (K, N, M), t in sorted(q4_times.items())],
        "prefill_chunk_device_ms": q4_chunk_ms,
        "launches_async_spec": spec["q4 + int8"]["async"][SPEC_K][
            "launches"]["q4_gemm"],
        "verify_step_device_ms": spec["q4 + int8"]["q4_verify"],
        "moe_attention_shapes_max_abs_err": moe["q4_err"],
    }, {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:71",
        "launches": launches_da,
        "max_abs_err": err_da,
        "ms": t_da,
        "plain_ms": t_da_p,
        "bound_ms": b_da,
        "bound_by": b_da_by,
        "library_ms": t_da_l,
        "decode_step_device_ms_per_call": da_dev / n_attn,
        "splits": da.decode_attention.plan[0],
        "launches_moe_bucket": moe["launches_contiguous"],
        "moe_ring_max_abs_err": moe["ring_err"],
        "launches_llama_vision_bucket": xattn["llama-3.2-vision-11b"][
            "launches"],
        "launches_whisper_bucket": xattn["whisper-medium"]["launches"],
        "cross_by_shape": [{"B": B_, "kv_len": M_, "kv_heads": H_, "G": G_,
                            "D": D_, "ms": t[0], "plain_ms": t[1],
                            "library_ms": t[2], "bound_ms": t[3],
                            "bound_by": t[4], "max_abs_err": t[5]}
                           for (B_, M_, H_, G_, D_), t in
                           cross_times.items()],
        "by_shape": [{"B": B_, "kv_len": L_, "ms": t[0], "plain_ms": t[1],
                      "library_ms": t[2], "bound_ms": t[3],
                      "bound_by": t[4]}
                     for (B_, L_), t in sorted(da_times.items())],
    }, {
        "name": "rglru_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:46",
        "launches": launches_rs,
        "max_abs_err": err_rs,
        "ms": t_rs,
        "plain_ms": t_rs_p,
        "bound_ms": b_rs,
        "bound_by": b_rs_by,
        "library_ms": None,
        "plan": rs_plan,
        "by_shape": [{"B": B_, "T": T_, "W": W_, "ms": t[0],
                      "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3],
                      "plan": t[4]}
                     for (B_, T_, W_), t in rs_times.items()],
        "prefill_device_ms": prefill_ms,
        "prefill_scan_device_ms": prefill_scan_ms,
        "launches_train_step": tr["rg"]["launches"]["rglru_scan"],
    }, {
        "name": "rglru_scan_reverse",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:46",
        "mode": "reverse in T (the gradient's recurrence); the JAX package "
                "differentiates jax.lax.associative_scan",
        "launches": tr["rg"]["launches"]["rglru_scan_reverse"],
        "max_abs_err": tr["reverse_err"],
        "ms": t_rv,
        "plain_ms": t_rv_p,
        "bound_ms": b_rv,
        "bound_by": b_rv_by,
        "library_ms": None,
        "plan": rv_plan,
        "by_shape": [{"B": B_, "T": T_, "W": W_, "ms": t[0],
                      "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3],
                      "plan": t[4], "scan_backward_ms": t[5]}
                     for (B_, T_, W_), t in rev.items()],
        "block_grad_rel_err": tr["block_grad_rel"],
    }], "training": {k: {n: v for n, v in tr[k].items() if n != "launches"}
                     for k in ("qwen", "rg")},
        "profile_retraces": kernel_times.retraces}))
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
