"""The port's decode attention kernels vs the Pallas TPU kernels.

On the CPU the port's wrappers (``repro_torch.kernels.ops``) run each
kernel's plain version; it is held against the Pallas kernel itself
(``interpret=True``) and against the reference's jnp oracle, on the same
numpy inputs: the paged kernel, and the contiguous one in its TPU form
(``kv_len``) and in its ring form (``kv_positions``, held against the
reference's ``flash_attention`` over a wrapped ring, the contract of the
ring decode step).  Tolerance 1e-5: every path computes in float32 from
the same float32 inputs and differs only in summation order.  (The
RG-LRU scan's plain version is held against the reference in
``tests/test_torch_recurrent.py``.)

The CUDA kernels themselves run only on a GPU: ``tests/test_torch_cuda.py``
holds them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.decode_attention import \
    paged_decode_attention as pallas_paged
from repro.models.attention import flash_attention as j_flash_attention
from repro_torch.kernels import build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention)
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.models.attention import flash_attention

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed, *, B=3, H=2, G=2, D=16, ps=4, max_pages=5, lens=None):
    """Random q / page pool with SHUFFLED physical pages per sequence and
    a kv_len = 0 lane (lane 0)."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * max_pages
    q = rng.normal(size=(B, H, G, D)).astype(np.float32)
    k = rng.normal(size=(n_pages, ps, H, D)).astype(np.float32)
    v = rng.normal(size=(n_pages, ps, H, D)).astype(np.float32)
    bt = (rng.permutation(n_pages - 1) + 1).reshape(B, max_pages)
    bt = bt.astype(np.int32)
    if lens is None:
        lens = rng.integers(1, max_pages * ps + 1, size=B)
        lens[0] = 0
    return q, k, v, bt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("G", [1, 2])
def test_plain_version_matches_pallas_and_oracle(window, softcap, G):
    lens = [0, 1, 4, 5, 13, 20]         # idle lane, page edges, full table
    q, k, v, bt, lens = _case(window * 7 + G, G=G, B=len(lens), lens=lens)
    t = tref.paged_decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bt), torch.from_numpy(lens), window,
        softcap=softcap).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v, bt, lens)]
    pallas = np.asarray(pallas_paged(*jargs, window, softcap=softcap,
                                     interpret=True))
    oracle = np.asarray(jref.paged_decode_attention_ref(
        *jargs, window=window, softcap=softcap))
    live = lens > 0
    assert np.isfinite(t).all(), "kv_len = 0 lane must stay finite"
    np.testing.assert_allclose(t[live], pallas[live], **TOL)
    np.testing.assert_allclose(t, oracle, **TOL)


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_ops_wrapper_folds_gqa_like_the_reference(window, softcap):
    """ops.paged_gqa_decode_attention on CPU tensors: (B,1,Hq,D) query,
    ONE layer's flat pool, query head h reads kv head h // G, output in
    q.dtype — against the reference's ops wrapper."""
    q, k, v, bt, lens = _case(40 + window, B=4, H=2, G=2, D=16, ps=4)
    B, H, G, D = q.shape
    ps = k.shape[1]
    q1 = q.reshape(B, 1, H * G, D)
    kpool = k.reshape(-1, H, D)
    vpool = v.reshape(-1, H, D)
    from repro.kernels import ops as jops
    want = np.asarray(jops.paged_gqa_decode_attention(
        jnp.asarray(q1), jnp.asarray(kpool), jnp.asarray(vpool),
        jnp.asarray(bt), jnp.asarray(lens), window, page_size=ps,
        softcap=softcap, impl="ref"))
    got = ops.paged_gqa_decode_attention(
        torch.from_numpy(q1), torch.from_numpy(kpool),
        torch.from_numpy(vpool), torch.from_numpy(bt),
        torch.from_numpy(lens), window, page_size=ps, softcap=softcap)
    assert got.shape == (B, 1, H * G, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # and against the reference wrapper's Pallas route (any impl other
    # than "auto"/"ref" runs the kernel, here in interpret mode)
    pallas = np.asarray(jops.paged_gqa_decode_attention(
        jnp.asarray(q1), jnp.asarray(kpool), jnp.asarray(vpool),
        jnp.asarray(bt), jnp.asarray(lens), window, page_size=ps,
        softcap=softcap, impl="pallas"))
    live = lens > 0
    np.testing.assert_allclose(got.numpy()[live], pallas[live], **TOL)
    # an explicit impl="ref" is the same plain version
    again = ops.paged_gqa_decode_attention(
        torch.from_numpy(q1), torch.from_numpy(kpool),
        torch.from_numpy(vpool), torch.from_numpy(bt),
        torch.from_numpy(lens), window, page_size=ps, softcap=softcap,
        impl="ref")
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_int8_page_scales_match_the_oracle():
    q, k, v, bt, lens = _case(50)
    rng = np.random.default_rng(51)
    kc = rng.integers(-127, 128, size=k.shape).astype(np.int8)
    vc = rng.integers(-127, 128, size=v.shape).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, size=k.shape[:3]).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, size=v.shape[:3]).astype(np.float32)
    got = tref.paged_decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(bt), torch.from_numpy(lens), 0,
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    want = jref.paged_decode_attention_ref(
        *[jnp.asarray(a) for a in (q, kc, vc, bt, lens)],
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ops_wrapper_reads_int8_pages_like_the_reference():
    """On CPU tensors the scale path of ops.paged_gqa_decode_attention
    reads int8 pages through the plain version, as the reference's
    wrapper does (on CUDA tensors it launches the int8 kernel:
    tests/test_torch_cuda.py)."""
    q, k, v, bt, lens = _case(52, B=4, H=2, G=2, D=16, ps=4)
    rng = np.random.default_rng(53)
    B, H, G, D = q.shape
    ps = k.shape[1]
    kc = rng.integers(-127, 128, size=(k.shape[0] * ps, H, D)).astype(np.int8)
    vc = rng.integers(-127, 128, size=kc.shape).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, size=kc.shape[:2]).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, size=kc.shape[:2]).astype(np.float32)
    q1 = q.reshape(B, 1, H * G, D)
    from repro.kernels import ops as jops
    want = np.asarray(jops.paged_gqa_decode_attention(
        *[jnp.asarray(a) for a in (q1, kc, vc, bt, lens)], 3, page_size=ps,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    got = ops.paged_gqa_decode_attention(
        *[torch.from_numpy(a) for a in (q1, kc, vc, bt, lens)], 3,
        page_size=ps, k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_kernel_module_imports_and_refuses_cpu_tensors():
    """The kernel modules import without nvcc (nothing builds at import)
    and their wrappers take CUDA tensors only — no silent CPU fallback."""
    q, k, v, bt, lens = _case(60)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention(*(torch.from_numpy(a)
                                 for a in (q, k, v, bt, lens)))
    assert isinstance(paged_decode_attention.launches, int)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(torch.zeros(1, 1, 2, 16), torch.zeros(1, 4, 1, 16),
                         torch.zeros(1, 4, 1, 16), 3)
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan(torch.zeros(1, 3, 4), torch.zeros(1, 3, 4))
    assert isinstance(decode_attention.launches, int)
    assert isinstance(rglru_scan.launches, int)
    with pytest.raises(ValueError, match="impl"):
        ops.rglru_linear_scan(torch.zeros(1, 3, 4), torch.zeros(1, 3, 4),
                              impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        ops.paged_gqa_decode_attention(
            torch.zeros(1, 1, 2, 16), torch.zeros(8, 2, 16),
            torch.zeros(8, 2, 16), torch.zeros(1, 2, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), page_size=4, impl="pallas")


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    if build.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has a CUDA toolkit at the default path")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


# ----------------------------------------------------------------------
# contiguous decode attention
# ----------------------------------------------------------------------

def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("fill", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("B,S,H,G,D,bs", [
    (2, 256, 2, 4, 64, 64),
    (1, 512, 4, 1, 128, 128),
    (3, 128, 2, 8, 32, 32),
    (1, 1024, 1, 4, 256, 256),    # gemma3-like MQA
])
def test_contiguous_plain_version_matches_pallas_and_oracle(B, S, H, G, D,
                                                            bs, fill):
    """The reference's Pallas test shapes (``tests/test_kernels.py``),
    kv_len 0 included: nothing valid gives the mean of V in both (the
    finite NEG_INF), where the reference's -inf oracle gives NaN."""
    kv_len = int(S * fill) if fill else 0
    q, k, v = _rand((B, H, G, D), 0), _rand((B, S, H, D), 1), \
        _rand((B, S, H, D), 2)
    got = tref.decode_attention_ref(*(torch.from_numpy(a)
                                      for a in (q, k, v)), kv_len).numpy()
    assert np.isfinite(got).all()
    pallas = np.asarray(pallas_decode(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), kv_len, block_s=bs,
                                      interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    if kv_len == 0:
        np.testing.assert_allclose(got, np.broadcast_to(
            v.mean(axis=1)[:, :, None, :], got.shape), **TOL)
        return
    oracle = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len))
    np.testing.assert_allclose(got, oracle, **TOL)
    from repro.kernels import ops as jops
    q1 = q.reshape(B, 1, H * G, D)
    want = np.asarray(jops.gqa_decode_attention(
        jnp.asarray(q1), jnp.asarray(k), jnp.asarray(v), kv_len,
        impl="ref"))
    for impl in ("auto", "ref"):
        mine = ops.gqa_decode_attention(
            torch.from_numpy(q1), torch.from_numpy(k), torch.from_numpy(v),
            kv_len, impl=impl)
        assert mine.shape == (B, 1, H * G, D)
        np.testing.assert_allclose(mine.numpy(), want, **TOL)


def _ring(n_written, slots):
    """Positions a ring of ``slots`` holds after positions 0..n-1 were
    written at ``p % slots`` (-1 = never written)."""
    pos = np.full(slots, -1, np.int32)
    for p in range(max(n_written - slots, 0), n_written):
        pos[p % slots] = p
    return pos


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("window", [0, 5, 64])
@pytest.mark.parametrize("n_written", [3, 24, 61])
def test_ring_form_matches_flash_attention_over_the_ring(n_written, window,
                                                         softcap):
    """The ring decode step's contract (``transformer.py:362-365``): one
    query at ``q_pos`` over a 24-slot ring holding 3 (filling), 24
    (full) or the last 24 of 61 (wrapped) positions, through the
    reference ``flash_attention(..., q_offset, kv_positions, window,
    softcap)``; the port's own ``flash_attention`` gives the same."""
    B, S, Hkv, G, D = 2, 24, 2, 3, 16
    pos = _ring(n_written, S)
    q = _rand((B, 1, Hkv * G, D), 3)
    k, v = _rand((B, S, Hkv, D), 4), _rand((B, S, Hkv, D), 5)
    q_pos = n_written - 1
    want = np.asarray(j_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, q_offset=q_pos, kv_positions=jnp.asarray(pos),
        chunk=16, softcap=softcap))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    got = ops.gqa_decode_attention(tq, tk, tv, kv_positions=tpos,
                                   q_pos=q_pos, window=window,
                                   softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    flash = flash_attention(tq, tk, tv, causal=True, window=window,
                            q_offset=q_pos, kv_positions=tpos, chunk=16,
                            softcap=softcap)
    np.testing.assert_allclose(flash.numpy(), want, **TOL)


@pytest.mark.parametrize("kv_offset,kv_len", [(0, None), (8, None), (8, 30)])
def test_flash_attention_kv_offset_matches_the_reference(kv_offset, kv_len):
    """A key block that starts at ``kv_offset`` (a padded last chunk
    included), with and without a global ``kv_len``."""
    q, k, v = _rand((2, 5, 4, 16), 6), _rand((2, 27, 2, 16), 7), \
        _rand((2, 27, 2, 16), 8)
    kw = dict(causal=True, window=0, q_offset=30, kv_offset=kv_offset,
              kv_len=kv_len, chunk=8)
    want = np.asarray(j_flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                        **kw))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
