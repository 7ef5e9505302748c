"""The port's CUDA kernel against its plain version, on the GPU.

These tests carry the ``cuda`` marker and skip where no GPU is present
(the check runs inside each test, not at import).  This file imports
neither JAX nor the reference package, so it also runs on the GPU
machine, which has no JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: the kernel and the plain version read the same page values
(bf16 -> f32 is exact) and both compute in f32; they differ only in
summation order and online-softmax rescaling, ~1e-6 at these lengths,
so 1e-5 absolute.  With a bf16 query the kernel rounds its f32 result
to bf16 (round to nearest), which moves each value by at most half a
bf16 ulp, 2**-8 of its size: that is added to the bound.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import paged_decode_attention

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


@pytest.mark.cuda
def test_ops_wrapper_refuses_int8_pages_on_cuda_tensors():
    """No int8 kernel variant yet: the scale path raises on the card
    instead of running the plain version there."""
    dev = _device()
    q, k, v, bt, lens = _case(3, B=2, H=2, G=2, D=32, ps=4, max_pages=2,
                              lens=[1, 8], dtype=torch.float32, dev=dev)
    B, H, G, D = q.shape
    scale = torch.ones(k.shape[0] * 4, H, device=dev)
    before = paged_decode_attention.launches
    for impl in ("auto", "ref"):
        with pytest.raises(NotImplementedError, match="int8 pages"):
            ops.paged_gqa_decode_attention(
                q.reshape(B, 1, H * G, D), k.to(torch.int8).reshape(-1, H, D),
                v.to(torch.int8).reshape(-1, H, D), bt, lens, page_size=4,
                impl=impl, k_scale=scale, v_scale=scale)
    assert paged_decode_attention.launches == before


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
