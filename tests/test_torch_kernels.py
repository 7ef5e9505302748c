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
``tests/test_torch_recurrent.py``; here its kernel's plan is checked
against the card's shared memory, and the kernel's tile schedule,
emulated in torch, against the plain version bit for bit.)

The CUDA kernels themselves run only on a GPU: ``tests/test_torch_cuda.py``
holds them against these plain versions there.
"""

import math

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
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as krs
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
# the paged kernel's split-K: the host's plan and the merge arithmetic
# ----------------------------------------------------------------------

def _split_tokens(z, chunk, ps, max_pages, kv_len, window):
    """Valid tokens [lo, hi) of split z, as the kernel's split launch
    clips its pages to [kv_len - window, kv_len) (empty when lo >= hi)."""
    j0 = max(kv_len - window, 0) if window > 0 else 0
    lo = max(z * chunk * ps, j0)
    hi = min(min(z * chunk + chunk, max_pages) * ps, kv_len)
    return lo, hi


@pytest.mark.parametrize("max_pages,ps,blocks,sms", [
    (64, 16, 64, 132),      # the Qwen3 serving state: max_len 1024, B*Hkv 64
    (256, 16, 64, 132),     # B=8 at kv_len 4096
    (5, 4, 6, 132),
    (40, 4, 2, 132),
    (300, 4, 1, 132),       # more splits wanted than MAX_SPLITS allows
    (1, 16, 8, 132),
    (7, 16, 1000, 132),     # more blocks than the card holds: one split
])
def test_paged_split_plan_covers_each_valid_page_once(max_pages, ps, blocks,
                                                      sms):
    n_split, chunk = kda.paged_split_plan(max_pages, ps, blocks, sms)
    assert 1 <= n_split <= kda.MAX_SPLITS
    # split z holds pages [z * chunk, (z + 1) * chunk), the last clipped
    splits = [range(z * chunk, min((z + 1) * chunk, max_pages))
              for z in range(n_split)]
    assert all(len(r) > 0 for r in splits), "no split runs past max_pages"
    for window in (0, 7):
        for kv_len in range(max_pages * ps + 1):
            j0 = max(kv_len - window, 0) if window > 0 else 0
            valid = {p for p in range(max_pages)
                     if p * ps < kv_len and (p + 1) * ps > j0}
            seen = [p for r in splits for p in r if p in valid]
            assert sorted(seen) == sorted(valid), (window, kv_len)
    assert sorted(p for r in splits for p in r) == list(range(max_pages))
    if (max_pages, ps) == (64, 16):       # splits of 4 pages, 16 per pair
        assert (n_split, chunk) == (16, 4)


@pytest.mark.parametrize("pairs", [1, 2, 8, 16, 64, 1000])
def test_contiguous_split_plan_covers_each_slot_once(pairs):
    """The contiguous kernel's plan for ``pairs`` (sequence, kv head, head
    chunk) triples: every slot in exactly one split, none past the end, at
    most a cluster's 16 splits, and no split shorter than its state's
    round trip costs in K/V bytes (the cost model of
    ``csrc/decode_attention.cu``)."""
    for G, D, itemsize in ((10, 256, 2), (2, 128, 2), (4, 32, 4),
                           (32, 128, 2)):
        min_slots = -(-2 * (G * D + 2 * G) * 4 // (2 * D * itemsize))
        for n_slots in range(0, 300, 7):
            n_split, chunk = kda.contiguous_split_plan(n_slots, G, D,
                                                       itemsize, pairs, 132)
            assert 1 <= n_split <= kda.CONTIGUOUS_MAX_SPLITS
            # no more splits than whole min_slots runs of slots
            assert n_split <= max(1, -(-n_slots // min_slots))
            slots = [s for z in range(n_split)
                     for s in range(z * chunk, min((z + 1) * chunk,
                                                   n_slots))]
            assert slots == list(range(n_slots)), n_slots
            assert n_slots == 0 or (n_split - 1) * chunk < n_slots
    # RecurrentGemma's ring at the serving state: B = 4, MQA, G = 10 in
    # two head chunks of 5, D = 256 bf16, 560 slots: a full cluster
    if pairs == 8:
        assert kda.contiguous_heads_per_block(10) == 5
        assert kda.contiguous_split_plan(560, 10, 256, 2, 8, 132) == (16, 35)


@pytest.mark.parametrize("G,ng", [(1, 1), (2, 2), (3, 4), (5, 5), (8, 8),
                                  (10, 5), (16, 8), (17, 8), (32, 8)])
def test_contiguous_heads_per_block_cover_the_group(G, ng):
    got = kda.contiguous_heads_per_block(G)
    assert got == ng and got <= kda.CONTIGUOUS_MAX_HEADS
    n_gc = -(-G // got)
    assert (n_gc - 1) * got < G <= n_gc * got


# ----------------------------------------------------------------------
# the RG-LRU scan's ring: the host's plan and the tile schedule
# ----------------------------------------------------------------------

@pytest.mark.parametrize("B,T,W", [
    (4, 512, 2560),         # the 512-token bucket of RecurrentGemma-2B
    (4, 256, 2560),         # the 256-token bucket
    (1, 512, 2560),         # one 512-token prompt
    (1, 2048, 2560),        # one prompt at the window length
    (8, 256, 2560),
    (64, 2048, 2560),       # more warps than one wave of rings holds
    (3, 1, 5),
    (2, 37, 64),
    (2, 37, 6),
])
def test_scan_plan_fits_the_card_and_covers_the_channels(B, T, W):
    """The scan kernel's plan: compiled stage lengths, a ring of at least
    two stages and no deeper than T needs, a grid whose warps cover every
    channel with no empty block, one block's rings within its shared
    memory and, unless the ring is already the smallest, the blocks an SM
    holds in one wave within the SM's; at RecurrentGemma's width the
    grid's rings keep more than the card's latency-bandwidth product
    (2.3 MB) in flight."""
    sms = 132
    wpb, steps, stages = krs.scan_plan(B, T, W, sms)
    assert 1 <= wpb <= krs.SCAN_MAX_WARPS and steps in krs.SCAN_STEPS
    assert 2 <= stages <= krs.SCAN_MAX_STAGES
    assert stages - 1 <= max(1, -(-T // steps))
    warps = B * -(-W // krs.LANES)
    blocks = -(-warps // wpb)
    assert blocks * wpb * krs.LANES >= B * W and (blocks - 1) * wpb < warps
    block_smem = krs.scan_smem(wpb, steps, stages)
    assert block_smem >= wpb * (stages + 1) * steps * krs.STEP_BYTES
    assert block_smem <= krs.SMEM_PER_BLOCK
    if (steps, stages) != (krs.SCAN_STEPS[0], 2):
        per_sm = -(-blocks // sms)
        assert per_sm * (block_smem + krs.SMEM_RESERVED_PER_BLOCK) \
            <= krs.SMEM_PER_SM
    if W == 2560 and B <= 8:
        assert warps * (stages - 1) * steps * krs.STEP_BYTES > 2.3e6


def _emulate_ring_scan(a, u, h0, steps, stages):
    """Plain-torch emulation of the scan kernel's schedule for every warp
    at once: tiles of ``steps`` steps (the last one short, zero-filled
    past T) enter slot ``k % stages`` of the ring, ``stages - 1`` ahead;
    the tile issued before tile k is consumed goes to the slot that tile
    k - 1 held; each step is a product and then a sum, each rounded to
    float32.  It checks the schedule's slot arithmetic and ragged edges,
    not the kernel: the CUDA kernel is held against the plain version on
    the card by ``test_rglru_kernel_matches_plain_version``."""
    B, T, W = a.shape
    tiles = -(-T // steps)
    ring = [None] * stages                  # (tile, a tile, u tile)
    consumed = set()

    def issue(k):
        if k >= tiles:
            return
        held = ring[k % stages]
        assert held is None or held[0] in consumed, "slot refilled early"
        t0, n = k * steps, min(steps, T - k * steps)
        ta, tu = torch.zeros(B, steps, W), torch.zeros(B, steps, W)
        ta[:, :n], tu[:, :n] = a[:, t0:t0 + n], u[:, t0:t0 + n]
        ring[k % stages] = (k, ta, tu)

    for k in range(stages - 1):
        issue(k)
    state = h0.clone() if h0 is not None else torch.zeros(B, W)
    h = torch.empty_like(a)
    for k in range(tiles):
        issue(k + stages - 1)
        tag, ta, tu = ring[k % stages]
        assert tag == k, "the tile consumed is not the one in its slot"
        for i in range(min(steps, T - k * steps)):
            state = torch.add(ta[:, i] * state, tu[:, i])
            h[:, k * steps + i] = state
        consumed.add(k)
    return h


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,T,W,plan", [
    (2, 37, 64, None), (3, 1, 5, None), (1, 33, 6, None),
    (2, 7, 36, None), (2, 9, 36, None),     # one short / past a stage of 8
    (1, 40, 8, (8, 2)), (1, 40, 8, (32, 16)), (2, 65, 4, (16, 5)),
    (1, 130, 8, (64, 3)),
])
def test_ring_scan_emulation_matches_the_plain_version(with_h0, B, T, W,
                                                       plan):
    """The tile schedule at the wrapper's plan (or a forced one) gives
    the plain version's bits: T one short and one past a stage, T = 1,
    a ragged last tile, a ring deeper than T and the shallowest ring."""
    steps, stages = plan or krs.scan_plan(B, T, W, 132)[1:]
    rng = np.random.default_rng(B * T + W)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, T, W)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(B, T, W)).astype(np.float32))
    h0 = (torch.from_numpy(rng.normal(size=(B, W)).astype(np.float32))
          if with_h0 else None)
    got = _emulate_ring_scan(a, u, h0, steps, stages)
    assert torch.equal(got, tref.rglru_scan_ref(a, u, h0))


def _emulate_split_merge(q, k, v, bt, lens, window, softcap, n_split,
                         chunk):
    """Plain-torch emulation of the kernel's two launches: each split's
    unnormalised (m, l, acc) over its valid tokens, an empty split marked
    l = 0 with a NaN acc (its scratch is never written), then the merge
    launch's formula.  It checks the formula, not the kernel: the CUDA
    kernel's own clipping and merge are held against the plain version on
    the card by ``test_paged_kernel_at_split_edges_and_windows``."""
    B, H, G, D = q.shape
    ps, max_pages = k.shape[1], bt.shape[1]
    neg = tref.NEG_INF
    m = torch.full((B, H, n_split, G), neg)
    l = torch.zeros((B, H, n_split, G))
    acc = torch.full((B, H, n_split, G, D), float("nan"))
    for b in range(B):
        for z in range(n_split):
            lo, hi = _split_tokens(z, chunk, ps, max_pages, int(lens[b]),
                                   window)
            if lo >= hi:
                continue
            j = torch.arange(lo, hi)
            rows = bt[b, j // ps].long() * ps + j % ps
            kz = k.reshape(-1, H, D)[rows]            # (n, H, D)
            vz = v.reshape(-1, H, D)[rows]
            s = torch.einsum("hgd,nhd->hgn", q[b], kz) / math.sqrt(D)
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            mz = s.max(-1).values
            p = torch.exp(s - mz[..., None])
            m[b, :, z], l[b, :, z] = mz, p.sum(-1)
            acc[b, :, z] = torch.einsum("hgn,nhd->hgd", p, vz)
    live = l > 0
    mx = torch.where(live, m, torch.full_like(m, neg)).max(2).values
    w = torch.where(live, torch.exp(m - mx[:, :, None]), torch.zeros_like(m))
    den = (w * l).sum(2)
    w = w / torch.where(den > 0, den, torch.ones_like(den))[:, :, None]
    out = torch.zeros((B, H, G, D))
    for z in range(n_split):
        wz = w[:, :, z]
        used = wz != 0
        out += torch.where(used[..., None],
                           wz[..., None] * torch.nan_to_num(acc[:, :, z]),
                           torch.zeros_like(out))
    return out


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("ps,max_pages,G,min_tokens", [
    (16, 20, 2, None),        # 5 splits of 4 pages
    (4, 40, 1, None),         # 3 splits of 16 pages
    (4, 12, 3, 4),            # splits of one page: most of them empty
])
def test_split_and_merge_emulation_matches_the_plain_version(
        monkeypatch, softcap, window, ps, max_pages, G, min_tokens):
    if min_tokens:
        monkeypatch.setattr(kda, "PAGED_MIN_SPLIT_TOKENS", min_tokens)
    B, H, D = 8, 2, 16
    n_split, chunk = kda.paged_split_plan(max_pages, ps, B * H, 132)
    assert n_split > 1
    edge = chunk * ps                   # tokens per split
    lens = [0, 1, edge - 1, edge, edge + 1, 2 * edge + 1,
            max_pages * ps - 1, max_pages * ps]
    q, k, v, bt, lens = (torch.from_numpy(a) for a in _case(
        ps * 13 + G, B=B, H=H, G=G, D=D, ps=ps, max_pages=max_pages,
        lens=lens))
    got = _emulate_split_merge(q, k, v, bt, lens, window, softcap, n_split,
                               chunk)
    want = tref.paged_decode_attention_ref(q, k, v, bt, lens, window,
                                           softcap=softcap)
    live = lens > 0
    assert torch.isfinite(got).all()
    assert (got[~live] == 0).all(), "kv_len = 0 lanes come out as zeros"
    np.testing.assert_allclose(got[live].numpy(), want[live].numpy(),
                               rtol=0, atol=1e-5)


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


def _emulate_contiguous(q, k, v, *, kv_len=None, kv_positions=None,
                        q_pos=None, window=0, softcap=0.0, sms=132):
    """Plain-torch emulation of ``csrc/decode_attention.cu``'s partition
    and merge, at the wrapper's plan (:func:`contiguous_split_plan`,
    :func:`contiguous_heads_per_block`): per (sequence, kv head, head
    chunk, split) the list of valid slots in slot order, dealt to the
    block's token streams as the kernel deals them (list index j to
    stream ``(j % T_tile) % NS``), each stream's (m, l, acc) in log2
    units, the streams combined, then the cluster merge's formula, with
    the mean of V where no slot is valid.  Empty splits leave NaN in
    their acc, which the merge must never read."""
    B, H, G, D = q.shape
    S, itemsize = k.shape[1], k.element_size()
    if kv_positions is None:
        lo = max(kv_len - window, 0) if window > 0 else 0
        hi, q_pos = max(min(kv_len, S), 0), kv_len - 1
        pos = torch.arange(S)
    else:
        lo, hi, pos = 0, S, kv_positions.long()
    ok = (pos >= 0) & (pos <= q_pos)
    if window > 0:
        ok &= pos > q_pos - window
    ng = kda.contiguous_heads_per_block(G)
    n_gc = -(-G // ng)
    n_split, chunk = kda.contiguous_split_plan(max(hi - lo, 0), G, D,
                                               itemsize, B * H * n_gc, sms)
    ch = 2 if itemsize == 4 else 1                 # 16-byte chunks a lane
    lanes = -(-(D * itemsize // 16) // ch)
    tg = 1
    while tg < lanes:
        tg *= 2
    ns = 4 * (32 // tg)                            # token streams a block
    t_tile = 4 * ns                                # kR = 4 slots a stream
    log2e = 1.0 / math.log(2.0)
    scale = 1.0 / math.sqrt(D)
    neg = tref.NEG_INF
    m = torch.full((B, H, n_split, G), neg)
    l = torch.zeros((B, H, n_split, G))
    acc = torch.full((B, H, n_split, G, D), float("nan"))
    for b in range(B):
        for h in range(H):
            for z in range(n_split):
                s0 = lo + z * chunk
                lst = [s for s in range(s0, min(hi, s0 + chunk)) if ok[s]]
                if not lst:
                    continue
                for gc in range(n_gc):
                    heads = list(range(gc * ng, min(G, gc * ng + ng)))
                    streams = []
                    for sid in range(ns):
                        js = [j for j in range(len(lst))
                              if (j % t_tile) % ns == sid]
                        if not js:
                            continue
                        slots = torch.tensor([lst[j] for j in js])
                        sc = q[b, h, heads].float() @ k[b, slots, h].float().T
                        if softcap:
                            sc = torch.tanh(sc * scale / softcap) * softcap
                        else:
                            sc = sc * scale
                        sc = sc * log2e
                        ms = sc.max(-1).values
                        pr = torch.exp2(sc - ms[:, None])
                        streams.append((ms, pr.sum(-1),
                                        pr @ v[b, slots, h].float()))
                    mx = torch.stack([st[0] for st in streams]).max(0).values
                    wts = [torch.exp2(st[0] - mx) for st in streams]
                    m[b, h, z, heads] = mx
                    l[b, h, z, heads] = sum(w * st[1]
                                            for w, st in zip(wts, streams))
                    acc[b, h, z, heads] = sum(w[:, None] * st[2]
                                              for w, st in zip(wts, streams))
    out = torch.zeros((B, H, G, D))
    for b in range(B):
        for h in range(H):
            live = l[b, h, :, 0] > 0
            if not bool(live.any()):              # nothing valid anywhere
                out[b, h] = v[b, :, h].float().mean(0)
                continue
            mx = m[b, h][live].max(0).values
            w = torch.exp2(m[b, h][live] - mx)
            den = (w * l[b, h][live]).sum(0)
            out[b, h] = ((w / den)[..., None] * acc[b, h][live]).sum(0)
    return out


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("G", [2, 10])
def test_contiguous_split_and_merge_emulation_matches_the_plain_version(
        G, window, softcap):
    """The redesigned contiguous kernel's partition (splits that pay for
    their merge, head chunks of at most 8, token streams) and merge, in
    plain torch, against the plain version and the JAX functions: the
    Pallas kernel (interpret mode) in the TPU form where it applies (no
    window, no softcap), ``flash_attention`` over the ring otherwise.
    Tolerance 1e-5: float32 throughout, another summation order."""
    B, S, H, D = 3, 96, 2, 64
    q, k, v = (torch.from_numpy(_rand(shape, seed)) for shape, seed in
               (((B, H, G, D), 11), ((B, S, H, D), 12), ((B, S, H, D), 13)))
    kw = dict(window=window, softcap=softcap)
    for kv_len in (0, 1, 20, 57, S):
        got = _emulate_contiguous(q, k, v, kv_len=kv_len, **kw)
        want = tref.decode_attention_ref(q, k, v, kv_len, **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
        if window == 0 and softcap == 0.0:
            pallas = np.asarray(pallas_decode(
                *(jnp.asarray(t.numpy()) for t in (q, k, v)), kv_len,
                block_s=32, interpret=True))
            np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    for n_written in (5, S, 250):                 # filling, full, wrapped
        pos = torch.from_numpy(_ring(n_written, S))
        got = _emulate_contiguous(q, k, v, kv_positions=pos,
                                  q_pos=n_written - 1, **kw)
        want = tref.decode_attention_ref(q, k, v, kv_positions=pos,
                                         q_pos=n_written - 1, **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
        jq = jnp.asarray(q.reshape(B, 1, H * G, D).numpy())
        jflash = np.asarray(j_flash_attention(
            jq, jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), causal=True,
            window=window, q_offset=n_written - 1,
            kv_positions=jnp.asarray(pos.numpy()), chunk=16,
            softcap=softcap))
        np.testing.assert_allclose(got.reshape(B, 1, H * G, D).numpy(),
                                   jflash, **TOL)


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
