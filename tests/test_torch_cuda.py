"""The port's CUDA kernels against their plain versions, on the GPU.

These tests carry the ``cuda`` marker and skip where no GPU is present
(the check runs inside each test, not at import).  This file imports
neither JAX nor the reference package, so it also runs on the GPU
machine, which has no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance, paged decode attention (bf16, f32 and int8 pages): the
kernel and the plain version read the same page values (bf16 -> f32 and
int8 code x scale are exact) and both compute in f32; they differ only
in summation order and online-softmax rescaling, ~1e-6 at these
lengths, so 1e-5 absolute.  With a bf16 query the kernel rounds its f32
result to bf16 (round to nearest), which moves each value by at most
half a bf16 ulp, 2**-8 of its size: that is added to the bound.

Tolerance, Q4_0 GEMM: both sides multiply x by the same exactly
dequantized weights and sum in f32 in other orders (the bf16 kernel on
the tensor cores, whose bf16 products of x and (code - 8) are exact), so
the Pallas test's rtol 1e-5 / atol 1e-4 (``tests/test_kernels.py``),
plus half a bf16 ulp of the plain value for a bf16 result.  TF32 is off
for the plain version's matmul.  Every kernel sums in a fixed order (no
float atomics), so two calls on one input are held bit-equal.

Tolerance, contiguous decode attention: as for the paged kernel (1e-5,
plus half a bf16 ulp for a bf16 result): the same values, float32
arithmetic, another summation order.

Tolerance, RG-LRU scan: none.  Kernel and plain version run the same
sequential recurrence with the same two float32 roundings per step (the
kernel's ``__fmul_rn`` / ``__fadd_rn`` cannot be fused into an FMA), so
they must agree bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as krs
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention)
from repro_torch.kernels.q4_gemm import q4_gemm
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.quant import q4_0, quantize_rows

TOL = 1e-5
BF16_HALF_ULP = 2.0 ** -8


def _max_excess(got, want, live):
    """Largest |got - want| beyond the stated bound over live lanes (<= 0
    when within it), and the largest |got - want| itself."""
    want = want.float()
    err = (got.float() - want)[live].abs()
    bound = TOL + (BF16_HALF_ULP * want[live].abs()
                   if got.dtype == torch.bfloat16 else 0.0)
    return (err - bound).max().item(), err.max().item()


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel is CUDA C++ for "
                    "sm_90a and has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, *, B, H, G, D, ps, max_pages, lens, dtype, dev,
          q_dtype=None):
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * max_pages
    q = torch.from_numpy(rng.normal(size=(B, H, G, D))).to(dev, dtype)
    q = q.to(q_dtype or dtype)
    k = torch.from_numpy(rng.normal(size=(n_pages, ps, H, D))).to(dev, dtype)
    v = torch.from_numpy(rng.normal(size=(n_pages, ps, H, D))).to(dev, dtype)
    bt = (rng.permutation(n_pages - 1) + 1).reshape(B, max_pages)
    return (q, k, v, torch.from_numpy(bt.astype(np.int32)).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,G,ps", [(16, 1, 4), (32, 2, 16), (128, 2, 16),
                                    (256, 4, 8)])
def test_kernel_matches_plain_version(dtype, D, G, ps):
    """Pages and q of one type; out comes back in q's type."""
    dev = _device()
    q, k, v, bt, lens = _case(D + G, B=5, H=2, G=G, D=D, ps=ps,
                              max_pages=9, lens=[0, 1, ps, ps + 1, 9 * ps],
                              dtype=dtype, dev=dev)
    live = lens > 0
    for window in (0, 7):
        for softcap in (0.0, 30.0):
            got = paged_decode_attention(q, k, v, bt, lens, window,
                                         softcap=softcap)
            torch.cuda.synchronize()
            want = tref.paged_decode_attention_ref(q, k, v, bt, lens,
                                                   window, softcap=softcap)
            assert got.dtype == q.dtype
            assert torch.isfinite(got).all(), "kv_len = 0 lane not finite"
            excess, err = _max_excess(got, want, live)
            assert excess <= 0, (window, softcap, err)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_kernel_takes_q_and_pages_of_different_types(q_dtype, kv_dtype):
    dev = _device()
    q, k, v, bt, lens = _case(7, B=5, H=2, G=2, D=128, ps=16, max_pages=9,
                              lens=[0, 1, 16, 17, 144], dtype=kv_dtype,
                              dev=dev, q_dtype=q_dtype)
    got = paged_decode_attention(q, k, v, bt, lens, 7, softcap=30.0)
    want = tref.paged_decode_attention_ref(q, k, v, bt, lens, 7,
                                           softcap=30.0)
    assert got.dtype == q_dtype
    excess, err = _max_excess(got, want, lens > 0)
    assert excess <= 0, err


@pytest.mark.cuda
def test_ops_wrapper_launches_the_kernel_on_cuda_tensors():
    dev = _device()
    q, k, v, bt, lens = _case(1, B=3, H=2, G=2, D=32, ps=4, max_pages=4,
                              lens=[0, 5, 16], dtype=torch.float32, dev=dev)
    B, H, G, D = q.shape
    before = paged_decode_attention.launches
    out = ops.paged_gqa_decode_attention(
        q.reshape(B, 1, H * G, D), k.reshape(-1, H, D), v.reshape(-1, H, D),
        bt, lens, page_size=4)
    assert paged_decode_attention.launches == before + 1
    ref = ops.paged_gqa_decode_attention(
        q.reshape(B, 1, H * G, D), k.reshape(-1, H, D), v.reshape(-1, H, D),
        bt, lens, page_size=4, impl="ref")
    assert paged_decode_attention.launches == before + 1
    assert (out - ref)[1:].abs().max().item() < TOL


def _int8_pages(k, v):
    """Quantize float pages (P, ps, H, D) as the model writes them."""
    (kc, ks), (vc, vs) = quantize_rows(k), quantize_rows(v)
    return kc, vc, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,G,ps", [(16, 1, 4), (32, 2, 16), (128, 2, 16),
                                    (256, 4, 8)])
def test_int8_kernel_matches_plain_version(q_dtype, D, G, ps):
    """Int8 pages with per-(row, head) scales; a scratch row of scale 0
    sits in every table (physical page 0), and kv_len 0 stays finite."""
    dev = _device()
    q, k, v, bt, lens = _case(D * 3 + G, B=5, H=2, G=G, D=D, ps=ps,
                              max_pages=9, lens=[0, 1, ps, ps + 1, 9 * ps],
                              dtype=torch.float32, dev=dev, q_dtype=q_dtype)
    k[0], v[0] = 0.0, 0.0
    bt[1, 0] = 0
    kc, vc, ks, vs = _int8_pages(k, v)
    assert (ks[0] == 0).all()
    live = lens > 0
    for window in (0, 7):
        for softcap in (0.0, 30.0):
            got = paged_decode_attention(q, kc, vc, bt, lens, window,
                                         softcap=softcap, k_scales=ks,
                                         v_scales=vs)
            torch.cuda.synchronize()
            want = tref.paged_decode_attention_ref(
                q, kc, vc, bt, lens, window, softcap=softcap, k_scales=ks,
                v_scales=vs)
            assert got.dtype == q.dtype
            assert torch.isfinite(got).all()
            excess, err = _max_excess(got, want, live)
            assert excess <= 0, (window, softcap, err)


@pytest.mark.cuda
def test_ops_wrapper_refuses_int8_pages_on_cuda_tensors():
    """The int8 page path of ops.paged_gqa_decode_attention launches the
    int8 kernel on the card (impl="ref" still runs the plain version),
    and the kernel refuses int8 pages without float32 scales."""
    dev = _device()
    q, k, v, bt, lens = _case(3, B=3, H=2, G=2, D=32, ps=4, max_pages=4,
                              lens=[0, 5, 16], dtype=torch.float32, dev=dev)
    B, H, G, D = q.shape
    kc, vc, ks, vs = _int8_pages(k, v)
    args = (q.reshape(B, 1, H * G, D), kc.reshape(-1, H, D),
            vc.reshape(-1, H, D), bt, lens, 3)
    kw = dict(page_size=4, k_scale=ks.reshape(-1, H),
              v_scale=vs.reshape(-1, H))
    before = paged_decode_attention.launches
    out = ops.paged_gqa_decode_attention(*args, **kw)
    assert paged_decode_attention.launches == before + 1
    ref = ops.paged_gqa_decode_attention(*args, impl="ref", **kw)
    assert paged_decode_attention.launches == before + 1
    assert (out - ref)[1:].abs().max().item() < TOL
    with pytest.raises(ValueError, match="k_scales and v_scales"):
        paged_decode_attention(q, kc, vc, bt, lens)
    with pytest.raises(ValueError, match="k_scales"):
        paged_decode_attention(q, kc, vc, bt, lens, k_scales=ks.double(),
                               v_scales=vs)
    assert paged_decode_attention.launches == before + 1


def _q4_case(seed, M, K, N, x_dtype, dev):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(size=(K, N)) / np.sqrt(K)).float()
    packed, scales = q4_0.quantize(w.to(dev))
    x = torch.from_numpy(rng.normal(size=(M, K))).to(dev, x_dtype)
    return x, packed, scales


def _q4_excess(got, want):
    """Largest |got - want| beyond rtol 1e-5 / atol 1e-4 (+ half a bf16
    ulp for a bf16 result); <= 0 when within the bound."""
    err = (got.float() - want).abs()
    bound = 1e-4 + 1e-5 * want.abs()
    if got.dtype == torch.bfloat16:
        bound = bound + BF16_HALF_ULP * want.abs()
    return (err - bound).max().item(), err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 3, 8, 9, 16, 64, 127, 128, 129, 200])
@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 1024), (2048, 6144),
                                 (6144, 2048), (128, 64), (320, 36)])
def test_q4_kernel_matches_plain_version(x_dtype, M, K, N):
    """The four full-width projection shapes, bench-tiny widths and a
    ragged K / N (320 = 10 blocks, 36 = not a multiple of 32 columns)."""
    dev = _device()
    x, packed, scales = _q4_case(M + K + N, M, K, N, x_dtype, dev)
    got = q4_gemm(x, packed, scales)
    torch.cuda.synchronize()
    want = tref.q4_gemm_ref(x, packed, scales)
    assert got.dtype == x_dtype and got.shape == (M, N)
    excess, err = _q4_excess(got, want)
    assert excess <= 0, err


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(8, 2048, 1024), (8, 6144, 2048),
                                   (128, 2048, 6144), (129, 320, 36),
                                   (3, 2048, 2048)])
def test_q4_kernel_is_repeatable(x_dtype, M, K, N):
    """Two calls on the same input give the same bits: the K slices are
    summed in a fixed order (no float atomics)."""
    dev = _device()
    x, packed, scales = _q4_case(M * 3 + K + N, M, K, N, x_dtype, dev)
    first = q4_gemm(x, packed, scales)
    second = q4_gemm(x, packed, scales)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_q4_matmul_launches_the_kernel_and_refuses_what_it_cannot_take():
    dev = _device()
    x, packed, scales = _q4_case(4, 8, 256, 64, torch.bfloat16, dev)
    before = q4_gemm.launches
    out = ops.q4_matmul(x, packed, scales)
    assert q4_gemm.launches == before + 1
    ref = ops.q4_matmul(x, packed, scales, impl="ref")
    assert q4_gemm.launches == before + 1 and ref.dtype == torch.bfloat16
    ops.q4_matmul(x, packed, scales, impl="kernel")
    assert q4_gemm.launches == before + 2
    excess, err = _q4_excess(out, tref.q4_gemm_ref(x, packed, scales))
    assert excess <= 0, err
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        q4_gemm(x.half(), packed, scales)
    with pytest.raises(ValueError, match="does not fit"):
        q4_gemm(x[:, :128], packed, scales)
    with pytest.raises(ValueError, match=r"\(8, 256, 62\)"):
        q4_gemm(x, packed[:, :62].contiguous(), scales[:, :62].contiguous())
    with pytest.raises(ValueError, match="on cpu"):
        q4_gemm(x, packed.cpu(), scales)
    assert q4_gemm.launches == before + 2
    # x at an address the kernel's 16-byte loads cannot take is copied
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    assert torch.equal(q4_gemm(shifted, packed, scales),
                       q4_gemm(x, packed, scales))


# ----------------------------------------------------------------------
# the paged kernel's split-K: split edges, windows, long tables, head
# groups and CUDA-graph capture
# ----------------------------------------------------------------------

def _pages(kind, k, v):
    """(k, v, scale kwargs) in the page format ``kind``."""
    if kind == "int8":
        kc, vc, ks, vs = _int8_pages(k, v)
        return kc, vc, dict(k_scales=ks, v_scales=vs)
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    return k.to(dtype), v.to(dtype), {}


def _plan(B, H, G, ps, max_pages, kind):
    ng = kda.paged_heads_per_block(G, kind == "int8")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return kda.paged_split_plan(max_pages, ps, B * H * -(-G // ng), sms)


def _check_paged(q, k, v, bt, lens, windows, softcaps=(0.0,), **scales):
    live = lens > 0
    for window in windows:
        for softcap in softcaps:
            got = paged_decode_attention(q, k, v, bt, lens, window,
                                         softcap=softcap, **scales)
            torch.cuda.synchronize()
            want = tref.paged_decode_attention_ref(q, k, v, bt, lens, window,
                                                   softcap=softcap, **scales)
            assert got.dtype == q.dtype
            assert torch.isfinite(got).all(), "a lane is not finite"
            assert (got[~live] == 0).all(), "an idle lane is not zero"
            excess, err = _max_excess(got, want, live)
            assert excess <= 0, (window, softcap, err)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("ps,max_pages", [(16, 64), (4, 48)])
def test_paged_kernel_at_split_edges_and_windows(q_dtype, kind, ps,
                                                 max_pages):
    """kv_len at every split edge and one either side of it, kv_len =
    max_pages * ps, an idle lane; windows 0, 7, one that begins inside a
    split with whole splits before it, and one wider than the table."""
    dev = _device()
    B, H, G, D = 2, 2, 2, 128
    n_split, chunk = _plan(B, H, G, ps, max_pages, kind)
    edge = chunk * ps
    assert n_split >= 3
    lens = sorted({min(max(z * edge + d, 0), max_pages * ps)
                   for z in range(1, n_split) for d in (-1, 0, 1)}
                  | {0, 1, max_pages * ps})
    q, k, v, bt, lens_t = _case(ps * 5 + len(kind), B=len(lens), H=H, G=G,
                                D=D, ps=ps, max_pages=max_pages, lens=lens,
                                dtype=torch.float32, dev=dev,
                                q_dtype=q_dtype)
    k[0], v[0] = 0.0, 0.0            # the zeroed scratch page, in a table
    bt[0, 0] = 0
    k, v, scales = _pages(kind, k, v)
    inside = 2 * edge + edge // 2     # starts in split 2 of a full table
    _check_paged(q, k, v, bt, lens_t, (0, 7, inside, 10 * max_pages * ps),
                 (0.0, 30.0), **scales)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_paged_kernel_over_long_tables(kind):
    """max_pages 256, kv_len 4096 (B = 8 as chip_smoke times it) and
    ragged lengths up to it."""
    dev = _device()
    lens = [4096, 4095, 4081, 3000, 2049, 1024, 17, 0]
    q, k, v, bt, lens_t = _case(11, B=8, H=8, G=2, D=128, ps=16,
                                max_pages=256, lens=lens,
                                dtype=torch.float32, dev=dev,
                                q_dtype=torch.bfloat16)
    k, v, scales = _pages(kind, k, v)
    _check_paged(q, k, v, bt, lens_t, (0, 1000), **scales)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("G,D", [(1, 256), (3, 64), (4, 128), (5, 16),
                                 (8, 128), (10, 256), (16, 128), (16, 48)])
def test_paged_kernel_head_groups(kind, G, D):
    """G 1-16 at D 16-256: groups above a block's heads (8, or 4 for int8
    pages) take several blocks; G not a power of two pads the last one;
    G = 4 at D = 128 is Phi-3.5-MoE's group."""
    dev = _device()
    lens = [0, 1, 100, 257, 16 * 24]
    q, k, v, bt, lens_t = _case(G * D, B=len(lens), H=2, G=G, D=D, ps=16,
                                max_pages=24, lens=lens, dtype=torch.float32,
                                dev=dev, q_dtype=torch.bfloat16)
    k, v, scales = _pages(kind, k, v)
    _check_paged(q, k, v, bt, lens_t, (0, 33), (0.0, 30.0), **scales)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_paged_kernel_replays_in_a_cuda_graph(kind):
    """A call captured in a CUDA graph and replayed equals an eager call,
    also after kv_lens and block_tables change in place: the wrapper reads
    nothing of them on the host, and the kernel reads them on the device
    at every replay."""
    dev = _device()
    q, k, v, bt, lens = _case(21, B=8, H=8, G=2, D=128, ps=16, max_pages=64,
                              lens=[0, 129, 201, 321, 417, 385, 449, 513],
                              dtype=torch.float32, dev=dev,
                              q_dtype=torch.bfloat16)
    k, v, scales = _pages(kind, k, v)
    eager = paged_decode_attention(q, k, v, bt, lens, **scales)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):             # warm-up off the capture
        paged_decode_attention(q, k, v, bt, lens, **scales)
    torch.cuda.current_stream().wait_stream(side)
    before = paged_decode_attention.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = paged_decode_attention(q, k, v, bt, lens, **scales)
    assert paged_decode_attention.launches == before + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    lens.copy_(torch.tensor([600, 1, 0, 1024, 17, 16, 300, 999],
                            dtype=torch.int32))
    bt.copy_(bt.flip(0))
    graph.replay()
    eager = paged_decode_attention(q, k, v, bt, lens, **scales)
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    excess, err = _max_excess(captured, tref.paged_decode_attention_ref(
        q, k, v, bt, lens, **scales), lens > 0)
    assert excess <= 0, err


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    dev = _device()
    q, k, v, bt, lens = _case(2, B=2, H=2, G=2, D=32, ps=4, max_pages=2,
                              lens=[1, 8], dtype=torch.float16, dev=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        paged_decode_attention(q, k, v, bt, lens)
    with pytest.raises(TypeError, match="int32"):
        paged_decode_attention(q.float(), k.float(), v.float(), bt.long(),
                               lens)


# ----------------------------------------------------------------------
# contiguous decode attention (the bucket engine's ring cache)
# ----------------------------------------------------------------------

def _cache_case(seed, *, B, S, H, G, D, dtype, dev):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=shape)).to(dev, dtype)
               for shape in ((B, H, G, D), (B, S, H, D), (B, S, H, D)))
    return q, k, v


def ring_positions(n_written, slots, dev):
    """Positions held by a ring of ``slots`` after writing positions
    0 .. n_written - 1 at ``p % slots`` (-1 = never written)."""
    pos = np.full(slots, -1, np.int32)
    for p in range(max(n_written - slots, 0), n_written):
        pos[p % slots] = p
    return torch.from_numpy(pos).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,G,D", [(2, 256, 2, 4, 64), (1, 512, 4, 1, 128),
                                       (3, 128, 2, 8, 32),
                                       (1, 1024, 1, 4, 256)])
def test_contiguous_kernel_matches_plain_version(dtype, B, S, H, G, D):
    """The TPU kernel's form (kv_len), at the Pallas test's shapes, with
    kv_len 0 (nothing valid: the mean of V), 1, mid and S, windows and a
    softcap."""
    dev = _device()
    q, k, v = _cache_case(S + G, B=B, S=S, H=H, G=G, D=D, dtype=dtype,
                          dev=dev)
    live = torch.ones(B, H, G, D, dtype=torch.bool, device=dev)
    for kv_len in (0, 1, S // 3 + 1, S):
        for window, softcap in ((0, 0.0), (7, 0.0), (0, 30.0)):
            got = decode_attention(q, k, v, kv_len, window=window,
                                   softcap=softcap)
            torch.cuda.synchronize()
            want = tref.decode_attention_ref(q, k, v, kv_len, window=window,
                                             softcap=softcap)
            assert got.dtype == q.dtype and torch.isfinite(got).all()
            excess, err = _max_excess(got, want, live)
            assert excess <= 0, (kv_len, window, softcap, err)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4, 8])
def test_ring_kernel_matches_plain_version(B):
    """RecurrentGemma's decode shape (MQA, G = 10, D = 256, bf16 cache of
    560 slots): a ring that is filling, one that is full and a wrapped
    one (written past its length), windows 7 and 2048, softcap 0 and 30;
    plus an f32 query on the bf16 cache."""
    dev = _device()
    S = 560
    q, k, v = _cache_case(B, B=B, S=S, H=1, G=10, D=256,
                          dtype=torch.bfloat16, dev=dev)
    live = torch.ones(B, 1, 10, 256, dtype=torch.bool, device=dev)
    for n_written in (1, 300, S, 1500):
        pos = ring_positions(n_written, S, dev)
        q_pos = n_written - 1
        for window in (7, 2048):
            for softcap in (0.0, 30.0):
                for qq in (q, q.float()):
                    got = decode_attention(qq, k, v, kv_positions=pos,
                                           q_pos=q_pos, window=window,
                                           softcap=softcap)
                    torch.cuda.synchronize()
                    want = tref.decode_attention_ref(
                        qq, k, v, kv_positions=pos, q_pos=q_pos,
                        window=window, softcap=softcap)
                    excess, err = _max_excess(got, want, live)
                    assert excess <= 0, (n_written, window, softcap, err)


@pytest.mark.cuda
@pytest.mark.parametrize("n_written", [1, 257, 288, 700])
def test_ring_kernel_at_phi35_moe_decode_shape(n_written):
    """Phi-3.5-MoE's bucket-engine decode shape (B = 4, 8 kv heads of
    G = 4, D = 128, a bf16 ring of 288 slots): a ring that is filling,
    one that is full and a wrapped one, global and windowed."""
    dev = _device()
    B, S, H, G, D = 4, 288, 8, 4, 128
    q, k, v = _cache_case(n_written, B=B, S=S, H=H, G=G, D=D,
                          dtype=torch.bfloat16, dev=dev)
    live = torch.ones(B, H, G, D, dtype=torch.bool, device=dev)
    pos = ring_positions(n_written, S, dev)
    for window in (0, 7):
        kw = dict(kv_positions=pos, q_pos=n_written - 1, window=window)
        got = decode_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = tref.decode_attention_ref(q, k, v, **kw)
        assert got.dtype == q.dtype and torch.isfinite(got).all()
        excess, err = _max_excess(got, want, live)
        assert excess <= 0, (window, err)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,H,G,D", [(6404, 8, 4, 128), (1500, 16, 1, 64)])
def test_contiguous_kernel_at_the_cross_attention_reads(kv_dtype, M, H, G,
                                                        D):
    """A decode step's cross-attention read, through the wrapper the model
    calls (``ops.gqa_decode_attention(..., kv_len=M)``, the TPU kernel's
    form): Llama-3.2-Vision's (B = 4, 6404 image tokens, 8 kv heads of
    G = 4, D = 128) and Whisper's (B = 4, 1500 frames, 16 heads, G = 1,
    D = 64), a bf16 query over bf16 K/V and over float32 K/V (a bf16 model
    fed float32 stubs); kv_len M (every slot valid), 1, one past a split
    chunk's edge and M - 1; and a memory of a single slot."""
    dev = _device()
    B = 4
    q, k, v = _cache_case(M + G, B=B, S=M, H=H, G=G, D=D, dtype=kv_dtype,
                          dev=dev)
    q = q.to(torch.bfloat16).reshape(B, 1, H * G, D)
    blocks = B * H * -(-G // kda.contiguous_heads_per_block(G))
    n_split, chunk = kda.contiguous_split_plan(
        M, G, D, k.element_size(), blocks, build.sm_count(dev.index or 0))
    assert n_split > 1, (n_split, chunk)
    cases = [(k, v, L) for L in (M, 1, chunk + 1, M - 1)]
    cases.append((k[:, :1].contiguous(), v[:, :1].contiguous(), 1))
    for kk, vv, kv_len in cases:
        before = decode_attention.launches
        got = ops.gqa_decode_attention(q, kk, vv, kv_len=kv_len)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        want = tref.decode_attention_ref(q.reshape(B, H, G, D), kk, vv,
                                         kv_len)
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
        excess, err = _max_excess(got.reshape(want.shape), want,
                                  torch.ones_like(want, dtype=torch.bool))
        assert excess <= 0, (kv_len, kk.shape[1], err)


#: head groups G at head dims D, both cache types: every G * D the
#: wrapper takes (G * D <= 4096)
_GROUPS = [(G, D) for G in (1, 2, 4, 8, 10, 16, 32) for D in (32, 128, 256)
           if G * D <= 4096]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,D", _GROUPS)
def test_contiguous_kernel_head_groups(dtype, G, D):
    """Head groups cut into head chunks of at most 8 (G = 10 as two of 5),
    over a wrapped ring and in the TPU form."""
    dev = _device()
    B, S, H = 2, 300, 2
    q, k, v = _cache_case(G * 7 + D, B=B, S=S, H=H, G=G, D=D, dtype=dtype,
                          dev=dev)
    live = torch.ones(B, H, G, D, dtype=torch.bool, device=dev)
    pos = ring_positions(700, S, dev)
    for kw in (dict(kv_positions=pos, q_pos=699, window=256),
               dict(kv_len=S - 17)):
        got = decode_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = tref.decode_attention_ref(q, k, v, **kw)
        assert got.dtype == q.dtype and torch.isfinite(got).all()
        excess, err = _max_excess(got, want, live)
        assert excess <= 0, (kw.get("q_pos"), err)


def _split_edges(S, G, D, itemsize, B, H):
    """The slot edges of the contiguous kernel's splits for this shape."""
    ng = kda.contiguous_heads_per_block(G)
    n_split, chunk = kda.contiguous_split_plan(
        S, G, D, itemsize, B * H * -(-G // ng),
        torch.cuda.get_device_properties(0).multi_processor_count)
    return n_split, chunk


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_kernel_edges(dtype):
    """RecurrentGemma's group (G = 10, D = 256) over a 560-slot ring, a
    full cluster of splits: nothing valid (an empty ring, and a query
    before every written position), one valid slot, windows whose edge
    falls on a split edge and one either side, and rings that are
    filling, full and wrapped."""
    dev = _device()
    B, S, H, G, D = 4, 560, 1, 10, 256
    q, k, v = _cache_case(31, B=B, S=S, H=H, G=G, D=D, dtype=dtype, dev=dev)
    live = torch.ones(B, H, G, D, dtype=torch.bool, device=dev)
    n_split, chunk = _split_edges(S, G, D, k.element_size(), B, H)
    assert n_split > 1
    empty = torch.full((S,), -1, dtype=torch.int32, device=dev)
    cases = [(empty, 10, 0), (ring_positions(S, S, dev), -1, 0),
             (ring_positions(1, S, dev), 0, 0),        # one valid slot
             (ring_positions(S, S, dev), S - 1, 1)]    # window of one
    for n_written in (chunk, 3 * chunk + 1, S, 2 * S + chunk - 1):
        pos = ring_positions(n_written, S, dev)
        for window in (0, chunk - 1, chunk, chunk + 1, 2048):
            cases.append((pos, n_written - 1, window))
    for pos, q_pos, window in cases:
        for softcap in (0.0, 30.0):
            kw = dict(kv_positions=pos, q_pos=q_pos, window=window,
                      softcap=softcap)
            got = decode_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = tref.decode_attention_ref(q, k, v, **kw)
            assert torch.isfinite(got).all()
            excess, err = _max_excess(got, want, live)
            assert excess <= 0, (q_pos, window, softcap, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_contiguous_kernel_is_repeatable(dtype):
    """Two calls on the same input give the same bits, in both forms: the
    splits are merged in split order (no float atomics)."""
    dev = _device()
    q, k, v = _cache_case(5, B=4, S=560, H=1, G=10, D=256, dtype=dtype,
                          dev=dev)
    pos = ring_positions(1500, 560, dev)
    for kw in (dict(kv_positions=pos, q_pos=1499, window=2048),
               dict(kv_len=300)):
        first = decode_attention(q, k, v, **kw)
        second = decode_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


@pytest.mark.cuda
def test_gqa_decode_attention_launches_the_kernel_on_cuda_tensors():
    dev = _device()
    q, k, v = _cache_case(5, B=3, S=40, H=2, G=4, D=32,
                          dtype=torch.float32, dev=dev)
    q1 = q.reshape(3, 1, 8, 32)
    pos = ring_positions(50, 40, dev)
    before = decode_attention.launches
    out = ops.gqa_decode_attention(q1, k, v, kv_positions=pos, q_pos=49,
                                   window=16)
    assert decode_attention.launches == before + 1
    ref = ops.gqa_decode_attention(q1, k, v, kv_positions=pos, q_pos=49,
                                   window=16, impl="ref")
    assert decode_attention.launches == before + 1
    assert out.shape == (3, 1, 8, 32) and (out - ref).abs().max() < TOL
    with pytest.raises(ValueError, match="kv_len"):
        decode_attention(q, k, v)
    with pytest.raises(ValueError, match="ring form"):
        decode_attention(q, k, v, 4, kv_positions=pos, q_pos=3)
    with pytest.raises(ValueError, match="int32"):
        decode_attention(q, k, v, kv_positions=pos.long(), q_pos=3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        decode_attention(q.half(), k.half(), v.half(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q, k.transpose(0, 1).contiguous().transpose(0, 1),
                         v, 4)
    assert decode_attention.launches == before + 1


# ----------------------------------------------------------------------
# RG-LRU scan
# ----------------------------------------------------------------------

def _stage_edge(B, W, edge, sms):
    """The first T whose plan's stage is T - edge steps long: edge -1 is
    one step short of a stage (a single short tile), +1 one step past it
    (a full tile and a one-step tile)."""
    return next(T for T in range(2, 4096)
                if krs.scan_plan(B, T, W, sms)[1] == T - edge)


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,T,W", [
    (4, 512, 2560), (8, 256, 2560),       # the prefill buckets' shapes
    (1, 2048, 2560),                      # one prompt at the window length
    (4, 511, 2560), (4, 513, 2560),       # a short last tile, a one-step one
    (4, "stage-1", 2560), (4, "stage+1", 2560),
    (2, 37, 64), (3, 1, 5), (1, 33, 100),
    (2, 37, 6), (2, 100, 36)])
def test_rglru_kernel_matches_plain_version(with_h0, B, T, W):
    """The model's shapes; T one step short of and one past the plan's
    stage, and around a multiple of it; T = 1; W not a multiple of 4 (5,
    6: the 4-byte copies), of 32 (36, 100: a ragged last strip) or of
    the 16-byte copy unit (W = 6 rows are 24 bytes)."""
    dev = _device()
    edge = {"stage-1": -1, "stage+1": 1}.get(T)
    if edge:
        T = _stage_edge(B, W, edge, build.sm_count(dev.index or 0))
    rng = np.random.default_rng(B * T + W)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, T, W))).to(dev,
                                                              torch.float32)
    u = torch.from_numpy(rng.normal(size=(B, T, W))).to(dev, torch.float32)
    h0 = (torch.from_numpy(rng.normal(size=(B, W))).to(dev, torch.float32)
          if with_h0 else None)
    got = rglru_scan(a, u, h0)
    torch.cuda.synchronize()
    want = tref.rglru_scan_ref(a, u, h0)
    assert torch.equal(got, want), (got - want).abs().max().item()
    if edge:
        assert rglru_scan.plan[1] == T - edge, (T, rglru_scan.plan)


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["a", "u", "h0"])
def test_rglru_kernel_reads_inputs_off_16_byte_alignment(operand):
    """An operand that starts 4 bytes past an aligned address: a or u
    cannot be a tensor map's base, so the kernel takes its 4-byte path;
    h0 is read directly.  The same bits either way."""
    dev = _device()
    B, T, W = 2, 50, 64
    rng = np.random.default_rng(7)
    ops_ = {"a": rng.uniform(0.5, 1.0, (B, T, W)),
            "u": rng.normal(size=(B, T, W)), "h0": rng.normal(size=(B, W))}
    t = {k: torch.from_numpy(v).to(dev, torch.float32)
         for k, v in ops_.items()}
    flat = torch.empty(t[operand].numel() + 1, device=dev)
    shifted = flat[1:].view(t[operand].shape)
    shifted.copy_(t[operand])
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    t[operand] = shifted
    got = rglru_scan(t["a"], t["u"], t["h0"])
    torch.cuda.synchronize()
    assert torch.equal(got, tref.rglru_scan_ref(t["a"], t["u"], t["h0"]))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,W", [(4, 512, 2560), (1, 2048, 2560),
                                   (2, 37, 36)])
def test_rglru_kernel_is_repeatable_and_replays_in_a_cuda_graph(B, T, W):
    """Two calls on one input give the same bits, and so does a call
    captured in a CUDA graph and replayed, also after a, u and h0 change
    in place (the wrapper's tensor maps hold addresses, not values)."""
    dev = _device()
    rng = np.random.default_rng(T + W)

    def draw():
        return (torch.from_numpy(rng.uniform(0.5, 1.0, (B, T, W))).to(
                    dev, torch.float32),
                torch.from_numpy(rng.normal(size=(B, T, W))).to(
                    dev, torch.float32),
                torch.from_numpy(rng.normal(size=(B, W))).to(
                    dev, torch.float32))

    a, u, h0 = draw()
    eager = rglru_scan(a, u, h0)
    assert torch.equal(eager, rglru_scan(a, u, h0))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):             # warm-up off the capture
        rglru_scan(a, u, h0)
    torch.cuda.current_stream().wait_stream(side)
    before = rglru_scan.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = rglru_scan(a, u, h0)
    assert rglru_scan.launches == before + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    for t, new in zip((a, u, h0), draw()):
        t.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, tref.rglru_scan_ref(a, u, h0))


@pytest.mark.cuda
def test_rglru_linear_scan_launches_the_kernel_and_refuses_bad_input():
    dev = _device()
    a = torch.rand(2, 9, 16, device=dev)
    u = torch.randn(2, 9, 16, device=dev)
    before = rglru_scan.launches
    out = ops.rglru_linear_scan(a, u)
    assert rglru_scan.launches == before + 1
    ref = ops.rglru_linear_scan(a, u, impl="ref")
    assert rglru_scan.launches == before + 1 and torch.equal(out, ref)
    with pytest.raises(TypeError, match="float32"):
        rglru_scan(a.double(), u.double())
    with pytest.raises(ValueError, match="h0"):
        rglru_scan(a, u, torch.zeros(2, 15, device=dev))
    with pytest.raises(ValueError, match="on cpu"):
        rglru_scan(a, u.cpu())
    assert rglru_scan.launches == before + 1
