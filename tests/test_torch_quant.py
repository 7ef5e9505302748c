"""The port's quantized serving path vs the JAX reference, on the CPU.

Inputs come from numpy with a seed and go through both packages:

* Q4_0 weights (``quant/q4_0.py``) and int8 KV rows (``quant/kv_int8.py``):
  packed codes and scales are compared **bit for bit**.  A differing Q4_0
  code is reported with its element, its pre-round value and both codes.
* ``q4_gemm_ref`` (the plain version of the port's Q4_0 kernel) against
  the Pallas kernel in interpret mode and the reference's jnp oracle, at
  the reference's ``TestQ4Gemm`` shapes: rtol 1e-5 / atol 1e-4, the
  Pallas test's own tolerance (f32 sums of the same exact weights in
  another order).
* ``quantize_serving_params``, the weight bridge of a quantized tree,
  ``make_qmm`` and ``init_cache(kv_dtype="int8")``.
* The fp32 tiny model under q4 + int8, teacher forced, and the engine's
  greedy tokens, against the reference (tolerances stated below).
* Inside the port: prefix sharing over int8 pages with a copy-on-write
  copy of codes and scales, and the serve CLI with ``--quant q4
  --kv-dtype int8``.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.kernels import ref as jref
from repro.kernels.q4_gemm import q4_gemm as pallas_q4_gemm
from repro.models import ModelConfig as JModelConfig
from repro.models import build_model as jbuild
from repro.quant import kv_int8 as jkv
from repro.quant import policy as jpolicy
from repro.quant import q4_0 as jq4
from repro_torch.kernels import ops
from repro_torch.kernels import q4_gemm as tqg
from repro_torch.kernels import ref as tref
from repro_torch.kernels.q4_gemm import q4_gemm as cuda_q4_gemm
from repro_torch.models import ModelConfig
from repro_torch.models import build_model as tbuild
from repro_torch.models.weights import params_from_numpy, params_to_numpy
from repro_torch.quant import kv_int8 as tkv
from repro_torch.quant import policy as tpolicy
from repro_torch.quant import q4_0 as tq4

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
#: the reference's own Pallas-vs-oracle tolerance (tests/test_kernels.py)
GEMM_TOL = dict(rtol=1e-5, atol=1e-4)


def _np(x):
    """A jax or torch array as numpy (bf16 as its uint16 bits)."""
    if isinstance(x, torch.Tensor):
        return params_to_numpy(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _tiny_jcfg(**kw):
    base = dict(name="bench-tiny", arch_type="dense", n_layers=4,
                d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                vocab_size=259, dtype=jnp.float32)
    base.update(kw)
    return JModelConfig(**base)


def _port_cfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JModelConfig)}
    fields["dtype"] = torch.float32
    return ModelConfig(**fields)


# ----------------------------------------------------------------------
# Q4_0 and int8 rows: bit-equal to the reference
# ----------------------------------------------------------------------

def _tie_weights():
    """Blocks whose w / scale lands on .5 ties, and blocks whose +absmax
    and -absmax tie (the first occurrence sets the sign)."""
    w = np.random.default_rng(5).normal(size=(128, 8)).astype(np.float32)
    # column 0, block 0: signed max -8 -> scale 1, every value x.5
    w[:32, 0] = np.resize([-8.0, 2.5, -3.5, 0.5, -0.5, 1.5, 6.5, -7.5], 32)
    # column 1, block 0: +4 before -4; block 1: -4 before +4
    w[:32, 1] = np.resize([4.0, -4.0, 1.0, -2.0, 3.0], 32)
    w[32:64, 1] = np.resize([-4.0, 4.0, 1.0, -2.0, 3.0], 32)
    # column 2: scale 0.25 ties (values k/8 + 1/16), an all-zero block
    w[:32, 2] = np.resize([2.0, 0.0625, -0.1875, 0.3125], 32)
    w[32:64, 2] = 0.0
    return w


def _assert_q4_equal(w, got, want):
    """Bit-equal packed codes and scales; report any differing code with
    its element, pre-round value and both codes."""
    (tp, ts), (jp, js) = got, want
    np.testing.assert_array_equal(_np(ts).view(np.uint32),
                                  _np(js).view(np.uint32))
    tc = tq4.unpack_codes(tp).numpy()
    jc = np.asarray(jq4.unpack_codes(jp))
    if not np.array_equal(tc, jc):
        k, n = np.argwhere(tc != jc)[0]
        s = np.asarray(js)[k // 32, n]
        wf = np.asarray(w, np.float32)
        pre = wf[k, n] / s if k < wf.shape[0] and s else 0.0
        pytest.fail(f"code differs at (k={k}, n={n}): w={wf[k, n]!r} "
                    f"w/scale~{pre!r}, port {tc[k, n]}, reference "
                    f"{jc[k, n]}")
    np.testing.assert_array_equal(_np(tp), _np(jp))


@pytest.mark.parametrize("case", ["normal", "ties", "bf16", "pad"])
def test_q4_quantize_is_bit_equal(case):
    rng = np.random.default_rng(1)
    if case == "ties":
        w = _tie_weights()
    elif case == "pad":
        w = rng.normal(size=(72, 40)).astype(np.float32) * 0.2  # K 72 -> 96
    else:
        w = rng.normal(size=(256, 96)).astype(np.float32) * 0.2
    tw = torch.from_numpy(w)
    jw = jnp.asarray(w)
    if case == "bf16":
        tw, jw = tw.bfloat16(), jw.astype(jnp.bfloat16)
        w = np.asarray(jw.astype(jnp.float32))
    pad = case == "pad"
    got = tq4.quantize(tw, pad=pad)
    want = jq4.quantize(jw, pad=pad)
    _assert_q4_equal(w, got, want)
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.float32
    np.testing.assert_array_equal(
        tq4.dequantize(*got).numpy(),
        np.asarray(jq4.dequantize(*want)))
    if not pad:
        with pytest.raises(ValueError, match="multiple of 32"):
            tq4.quantize(tw[:40])


def test_q4_quantize_stacked_and_sizes_are_bit_equal():
    w = np.random.default_rng(2).normal(size=(3, 64, 48)).astype(np.float32)
    tp, ts = tq4.quantize_stacked(torch.from_numpy(w))
    jp, js = jq4.quantize_stacked(jnp.asarray(w))
    assert tp.shape == (3, 32, 48) and ts.shape == (3, 2, 48)
    for i in range(3):
        _assert_q4_equal(w[i], (tp[i], ts[i]), (jp[i], js[i]))
    assert tq4.BYTES_PER_WEIGHT == jq4.BYTES_PER_WEIGHT
    assert tq4.padded_k(40) == jq4.padded_k(40) == 64
    assert tq4.quantized_bytes((2048, 6144)) == jq4.quantized_bytes(
        (2048, 6144))


def test_int8_rows_are_bit_equal():
    x = np.random.default_rng(3).normal(size=(6, 2, 32)).astype(np.float32)
    x[1] = 0.0                                   # all-zero rows: scale 0
    x[2, 0, :4] = [127.0, -63.5, 0.5, -1.5]      # x / scale on .5 ties
    x[2, 0, 4:] = 0.0
    tq, ts = tkv.quantize_rows(torch.from_numpy(x))
    jq, js = jkv.quantize_rows(jnp.asarray(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    assert (ts[1] == 0).all() and (tq[1] == 0).all()
    np.testing.assert_array_equal(tkv.dequantize_rows(tq, ts).numpy(),
                                  np.asarray(jkv.dequantize_rows(jq, js)))
    # bf16 rows, as the full-width model writes them
    xb = torch.from_numpy(x).bfloat16()
    tq, ts = tkv.quantize_rows(xb)
    jq, js = jkv.quantize_rows(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tkv.kv_bytes_per_row_head(128) == jkv.kv_bytes_per_row_head(128)


# ----------------------------------------------------------------------
# the Q4_0 GEMM's plain version vs the Pallas kernel and the oracle
# ----------------------------------------------------------------------

@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,bn,bk", [
    (1, 256, 512, 256, 256),      # the reference's TestQ4Gemm shapes
    (4, 512, 256, 128, 128),
    (8, 1024, 768, 256, 256),
    (3, 64, 128, 128, 64),
    (16, 128, 384, 128, 32),
    (2, 320, 128, 64, 160),
])
def test_q4_gemm_ref_matches_pallas_and_oracle(M, K, N, bn, bk, xdtype):
    rng = np.random.default_rng(K + N)
    w = (rng.normal(size=(K, N)) * 0.2).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    jp, js = jq4.quantize(jnp.asarray(w))
    jx = jnp.asarray(x, getattr(jnp, xdtype))
    tx = torch.from_numpy(x).to(getattr(torch, xdtype))
    tp, ts = torch.from_numpy(_np(jp)), torch.from_numpy(_np(js))
    got = tref.q4_gemm_ref(tx, tp, ts)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    pallas = np.asarray(pallas_q4_gemm(jx, jp, js, block_n=bn, block_k=bk,
                                       interpret=True))
    oracle = np.asarray(jref.q4_gemm_ref(jx, jp, js))
    np.testing.assert_allclose(got.numpy(), pallas, **GEMM_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **GEMM_TOL)
    # the ops wrapper on CPU tensors is the plain version, in x's type
    out = ops.q4_matmul(tx, tp, ts)
    assert out.dtype == tx.dtype
    np.testing.assert_array_equal(out.numpy() if xdtype == "float32"
                                  else _np(out), _np(got.to(tx.dtype)))


def _emulate_q4_mma(x, packed, scales, sms=132):
    """Plain-torch emulation of ``csrc/q4_gemm.cu``'s bf16 tensor-core
    path at the wrapper's plan (:func:`q4_plan`): K cut into slices of
    64-k stages; per 32-k Q4_0 block, the f32 sum of exact products of
    bf16 x and the integer (code - 8), then times that block's column
    scales and added to a running f32 total: the slice's (prefill
    kernel), or at M <= 8 (decode kernel) that of warp ``kg``, which takes
    the slice's stages kg, kg + 4, ..., the 4 warps' totals then summed in
    warp order; the slices summed in slice order (the cluster reduce); the
    result rounded to bf16.  Returns (out, plan)."""
    M, K = x.shape
    N = packed.shape[1]
    rows, n_split, sps = tqg.q4_plan(M, K, N, sms)
    groups = tqg.DECODE_WARPS if rows == 8 else 1
    codes = torch.empty((K, N), dtype=torch.float32)
    codes[0::2] = (packed & 15).float() - 8        # low nibble: even k
    codes[1::2] = (packed >> 4).float() - 8
    xf = x.float()
    stages = -(-K // tqg.STAGE_K)
    seen, total = [], torch.zeros((M, N))
    for z in range(n_split):
        slice_stages = range(z * sps, min(stages, (z + 1) * sps))
        part = torch.zeros((M, N))
        for kg in range(groups):
            acc = torch.zeros((M, N))
            for st in slice_stages[kg::groups]:
                for kb in (2 * st, 2 * st + 1):
                    if kb * 32 >= K:
                        break
                    seen.append(kb)
                    blk = xf[:, kb * 32:(kb + 1) * 32] @ codes[kb * 32:
                                                               (kb + 1) * 32]
                    acc = acc + blk * scales[kb]
            part = part + acc
        total = total + part
    assert sorted(seen) == list(range(K // 32)), "each Q4_0 block once"
    return total.to(torch.bfloat16), (rows, n_split, sps)


@pytest.mark.parametrize("M", [1, 8, 16, 64, 127, 129])
@pytest.mark.parametrize("K,N,bk", [(320, 36, 64), (2048, 64, 256),
                                    (256, 128, 256)])
def test_q4_mma_emulation_matches_plain_and_pallas(M, K, N, bk):
    """The redesigned bf16 Q4_0 kernel's partition (split-K slices, per
    block sums, fixed-order reduce) in plain torch, against the plain
    version and the Pallas kernel (interpret mode).  Tolerance: the
    kernel's, |d| <= 1e-4 + 1e-5 |plain| plus half a bf16 ulp of the
    plain value (the result is rounded to bf16): every product is exact,
    only the f32 summation order differs."""
    rng = np.random.default_rng(M * 7 + K + N)
    w = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    jp, js = jq4.quantize(jnp.asarray(w))
    tp, ts = torch.from_numpy(_np(jp)), torch.from_numpy(_np(js))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got, (rows, n_split, sps) = _emulate_q4_mma(tx, tp, ts)
    assert rows >= min(M, 64) and n_split >= 1
    if (K, N) == (2048, 64) and M <= 8:
        assert n_split > 1, "decode shapes take several K slices"
    want = tref.q4_gemm_ref(tx, tp, ts)
    pallas = np.asarray(pallas_q4_gemm(jnp.asarray(x, jnp.bfloat16), jp, js,
                                       block_n=N, block_k=bk,
                                       interpret=True))
    for ref_out in (want.numpy(), pallas):
        err = np.abs(got.float().numpy() - ref_out)
        tol = 1e-4 + (1e-5 + 2.0 ** -8) * np.abs(ref_out)
        assert (err <= tol).all(), err.max()


def test_q4_kernel_refuses_cpu_tensors_and_bad_impl():
    p, s = tq4.quantize(torch.randn(64, 32))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_q4_gemm(torch.randn(2, 64), p, s)
    with pytest.raises(ValueError, match="CUDA"):
        ops.q4_matmul(torch.randn(2, 64), p, s, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        ops.q4_matmul(torch.randn(2, 64), p, s, impl="pallas")
    assert isinstance(cuda_q4_gemm.launches, int)


# ----------------------------------------------------------------------
# policy, bridge, qmm hook, int8 cache
# ----------------------------------------------------------------------

def test_policy_validates_like_the_reference():
    for kw in (dict(weights="q8"), dict(kv_dtype="fp16"),
               dict(impl="pallas")):
        with pytest.raises(ValueError):
            jpolicy.QuantPolicy(**kw)
        with pytest.raises(ValueError, match=next(iter(kw))):
            tpolicy.QuantPolicy(**kw)
    for kw in (dict(), dict(kv_dtype="int8"), dict(weights="q4")):
        t, j = tpolicy.QuantPolicy(**kw), jpolicy.QuantPolicy(**kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.active == j.active
    assert tpolicy.Q4_WEIGHT_NAMES == jpolicy.Q4_WEIGHT_NAMES


@pytest.fixture(scope="module")
def tiny_tree():
    jm = jbuild(_tiny_jcfg())
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def test_serving_params_select_the_same_leaves_bit_equal(tiny_tree):
    _, tree = tiny_tree
    jq = jpolicy.quantize_serving_params(jax.tree.map(jnp.asarray, tree))
    tq = tpolicy.quantize_serving_params(params_from_numpy(tree, "cpu"))
    assert tpolicy.count_q4_leaves(tq) == jpolicy.count_q4_leaves(jq) == 7
    assert tpolicy.param_bytes(tq) == jpolicy.param_bytes(jq)
    jflat = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(_np, jq)))
    tflat = jax.tree_util.tree_leaves_with_path(params_to_numpy(tq))
    assert len(tflat) == len(jflat)
    for path, leaf in tflat:
        want = jflat[path]
        assert leaf.dtype == want.dtype, path
        np.testing.assert_array_equal(leaf.view(np.uint8),
                                      want.view(np.uint8), err_msg=str(path))
    assert tpolicy.is_q4_leaf(tq["layers"]["mlp"]["w_down"])
    assert not tpolicy.is_q4_leaf(tq["embed"])
    assert tpolicy.count_q4_leaves(tpolicy.quantize_serving_params(
        params_from_numpy(tree, "cpu"), min_size=10**9)) == 0
    # a tree the reference already quantized crosses the bridge bit-exact
    bridged = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    w = bridged["layers"]["attn"]["w_q"]
    assert w["q4_packed"].dtype == torch.uint8
    assert w["q4_scales"].dtype == torch.float32
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            params_to_numpy(bridged)):
        np.testing.assert_array_equal(leaf, jflat[path], err_msg=str(path))


def test_qmm_dense_passthrough_and_pad_to_block():
    rng = np.random.default_rng(9)
    qmm = tpolicy.make_qmm("ref")
    x = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 5)).astype(np.float32))
    assert torch.equal(qmm(x, w), x @ w)
    jqmm = jpolicy.make_qmm("ref")
    for K, N in ((96, 64), (40, 32)):            # K 40 pads to 64
        wk = rng.normal(size=(K, N)).astype(np.float32)
        xk = rng.normal(size=(2, 3, K)).astype(np.float32)
        jp, js = jq4.quantize(jnp.asarray(wk), pad=True)
        leaf = {"q4_packed": torch.from_numpy(_np(jp)),
                "q4_scales": torch.from_numpy(_np(js))}
        got = qmm(torch.from_numpy(xk), leaf)
        assert got.shape == (2, 3, N) and got.dtype == torch.float32
        jleaf = {"q4_packed": jp, "q4_scales": js}
        want = np.asarray(jqmm(jnp.asarray(xk), jleaf))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        exact = xk @ np.asarray(jq4.dequantize(jp, js))[:K]
        np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5, atol=1e-5)
        # bf16 activations come back in bf16, as the reference casts them
        gb = qmm(torch.from_numpy(xk).bfloat16(), leaf)
        wb = jqmm(jnp.asarray(xk, jnp.bfloat16), jleaf)
        assert gb.dtype == torch.bfloat16
        np.testing.assert_allclose(gb.float().numpy(),
                                   np.asarray(wb.astype(jnp.float32)),
                                   rtol=2 ** -8, atol=1e-5)
    with pytest.raises(ValueError, match="impl"):
        tpolicy.make_qmm("pallas")


def test_int8_cache_structure_and_raises():
    jm, tm = jbuild(_tiny_jcfg()), tbuild(_port_cfg(_tiny_jcfg()))
    jc = jm.init_cache(2, 64, page_size=8, n_pages=16, kv_dtype="int8")
    tc = tm.init_cache(2, 64, page_size=8, n_pages=16, kv_dtype="int8",
                       device="cpu")
    jl, tl = jc["layers"][0]["self"], tc["layers"][0]["self"]
    assert sorted(tl) == sorted(jl) == ["k", "k_scale", "v", "v_scale"]
    for name in tl:
        assert tuple(tl[name].shape) == jl[name].shape
        assert str(tl[name].dtype).split(".")[-1] == str(jl[name].dtype)
    assert len(tc["layers"]) == 4
    fp = tm.init_cache(2, 64, page_size=8, n_pages=16, device="cpu")
    assert "k_scale" not in fp["layers"][0]["self"]
    with pytest.raises(ValueError, match="kv_dtype"):
        tm.init_cache(2, 64, kv_dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        tm.init_cache(2, 64, page_size=8, kv_dtype="fp8", device="cpu")


# ----------------------------------------------------------------------
# model and engine against the reference
# ----------------------------------------------------------------------

def _teacher_forced(tree, jcfg):
    """Drive both packages' q4 + int8 tiny model through one-shot and
    resumed paged prefills and six decode steps; yield
    (what, port, reference) logits and the two int8 caches at the end."""
    jm, tm = jbuild(jcfg), tbuild(_port_cfg(jcfg))
    jm.qmm, tm.qmm = jpolicy.make_qmm("ref"), tpolicy.make_qmm("ref")
    jparams = jpolicy.quantize_serving_params(jax.tree.map(jnp.asarray,
                                                           tree))
    tparams = tpolicy.quantize_serving_params(params_from_numpy(tree, "cpu"))
    B, max_len, ps = 3, 48, 4
    jcache = jm.init_cache(B, max_len, page_size=ps, kv_dtype="int8")
    tcache = tm.init_cache(B, max_len, page_size=ps, kv_dtype="int8",
                           device="cpu")
    rng = np.random.default_rng(17)
    bt = (rng.permutation(B * max_len // ps) + 1).reshape(B, -1)
    jcache["block_tables"] = jnp.asarray(bt, jnp.int32)
    tcache["block_tables"].copy_(torch.from_numpy(bt.astype(np.int32)))
    prompts = [rng.integers(0, jcfg.vocab_size, n) for n in (13, 17, 9)]

    def prefill(slot, toks, Sp, **kw):
        nonlocal jcache
        padded = np.zeros((1, Sp), np.int64)
        padded[0, :len(toks)] = toks
        jl, jcache = jm.prefill_paged(jparams, {"tokens": jnp.asarray(padded)},
                                      jcache, slot, len(toks), page_size=ps,
                                      **kw)
        tl, _ = tm.prefill_paged(tparams, {"tokens": torch.from_numpy(padded)},
                                 tcache, slot, len(toks), page_size=ps, **kw)
        return tl, jl

    yield ("prefill one-shot",) + prefill(0, prompts[0], 16)
    yield ("prefill chunk 1",) + prefill(1, prompts[1][:8], 8)
    yield ("prefill resumed over int8 pages",) + prefill(
        1, prompts[1][8:], 16, start=8, ctx_pages=8)
    yield ("prefill one-shot 2",) + prefill(2, prompts[2], 16)
    pos = np.array([13, 17, 9])
    for step in range(6):
        toks = rng.integers(0, jcfg.vocab_size, (B, 1))
        p = pos.copy()
        if step < 2:
            p[2] = -1                            # an idle lane
        jl, jcache = jm.decode_step(jparams, jcache, jnp.asarray(toks),
                                    jnp.asarray(p), page_size=ps)
        tl, _ = tm.decode_step(tparams, tcache, torch.from_numpy(toks),
                               torch.from_numpy(p), page_size=ps)
        live = p >= 0
        yield (f"decode {step}", tl[live], np.asarray(jl)[live])
        pos = np.where(live, pos + 1, pos)
    yield ("caches", tcache, jcache)


def test_q4_int8_teacher_forced_logits_match_the_reference(tiny_tree):
    """Tolerance.  The q4 weights and the int8 write path are bit-equal
    on equal inputs (tests above), but K and V come out of two matmul
    implementations that sum in other orders (~1e-7 relative), so a value
    at a rounding boundary may quantize one code apart.  Every code must
    agree within one, and at most 0.1 % of them may differ at all (6 of
    73,728 here).  One code step moves its element by one scale, 1/127
    (0.8 %) of its row's largest value; through the softmax weight and
    the projections after it, such a move shifts this model's decode
    logits by ~1e-4 of their largest magnitude (at most 2.5e-4 over this
    script).  So logits are held to 1e-3 of the largest |logit|, absolute:
    four times that, and an eighth of one code step.  Later rows' scales
    (max|x|/127 of inputs carrying that shift) are held to 1e-3
    relative; prefill logits, before any code can move, agree to 1e-6."""
    _, tree = tiny_tree
    n = 0
    for what, got, want in _teacher_forced(tree, _tiny_jcfg()):
        if what == "caches":
            tc, jc = got, want
            continue
        got, want = got.numpy(), np.asarray(want)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale,
                                   err_msg=what)
        n += 1
    assert n == 10
    moved = total = 0
    for tl, jl in zip(tc["layers"], jc["layers"]):
        for name in ("k", "v"):
            a = tl["self"][name][4:].numpy().astype(np.int32)
            b = np.asarray(jl["self"][name])[4:].astype(np.int32)
            assert np.abs(a - b).max() <= 1, name
            moved += int((a != b).sum())
            total += a.size
            np.testing.assert_allclose(
                tl["self"][f"{name}_scale"][4:].numpy(),
                np.asarray(jl["self"][f"{name}_scale"])[4:], rtol=1e-3)
    assert moved <= total // 1000, (moved, total)


def _greedy_margin(model, params, quant, prompt):
    """Top-2 logit margin of the next token after ``prompt``, from a
    one-shot prefill of the port's quantized model (the margin rule of
    ROADMAP "held together": a differing greedy token is a fault only
    where this margin is clear of the logit tolerance)."""
    runner = tserving.EngineCore(model, params, max_len=64, max_running=1,
                                 page_size=4, quant=quant,
                                 device="cpu").runner
    pages = -(-len(prompt) // 4)
    table = np.zeros((1, runner.max_pages), np.int32)
    table[0, :pages] = np.arange(1, pages + 1)
    runner.set_block_tables(table)
    logits = runner.prefill_chunk(prompt, slot=0, start=0, fresh=True)
    top2 = torch.topk(logits[0, -1].float(), 2).values
    return float(top2[0] - top2[1])


#: logit tolerance of the margin rule for the engine test: 1e-3 of the
#: largest |logit| of the tiny model (the teacher-forced bound above)
MARGIN_TOL = 1e-3


def test_q4_int8_engine_greedy_tokens_match_the_reference(tiny_tree):
    jm, tree = tiny_tree
    jcfg = _tiny_jcfg()
    tm = tbuild(_port_cfg(jcfg))
    rng = np.random.default_rng(21)
    prompts = [list(map(int, rng.integers(1, 258, 6 + 4 * i)))
               for i in range(3)]
    out = {}
    for pkg, S, model, params, quant, extra in (
            ("repro", jserving, jbuild(jcfg), jax.tree.map(jnp.asarray, tree),
             jpolicy.QuantPolicy("q4", "int8", impl="ref"), {}),
            ("repro_torch", tserving, tm, params_from_numpy(tree, "cpu"),
             tpolicy.QuantPolicy("q4", "int8"), {"device": "cpu"})):
        reqs = [S.Request(uid=i, prompt=p,
                          sampling=S.SamplingParams(max_new_tokens=6))
                for i, p in enumerate(prompts)]
        eng = S.ContinuousServingEngine(model, params, max_len=48,
                                        max_running=4, page_size=8,
                                        clock=S.VirtualClock(), quant=quant,
                                        **extra)
        out[pkg] = [c.tokens for c in eng.generate(reqs)]
        if pkg == "repro_torch":
            reg = eng.registry
            disp = reg.get("runner.quant.q4_dispatch")
            assert disp.value(phase="prefill") > 0
            assert disp.value(phase="decode") > 0
            assert tpolicy.count_q4_leaves(eng.runner.params) == 7
            assert eng.pool.cfg.page_bytes == 2 * 4 * 8 * 2 * (32 + 4)
            gauge = reg.get("kv_pool.page_bytes")
            assert gauge.value(kv_dtype="int8") == eng.pool.cfg.page_bytes
    for i, (t, j) in enumerate(zip(out["repro_torch"], out["repro"])):
        if t == j:
            continue
        d = next(k for k in range(len(j)) if t[k] != j[k])
        margin = _greedy_margin(tm, params_from_numpy(tree, "cpu"),
                                tpolicy.QuantPolicy("q4", "int8"),
                                prompts[i] + j[:d])
        assert margin < MARGIN_TOL, (
            f"request {i} differs at token {d} with a clear top-2 margin "
            f"{margin:.2e}: port {t}, reference {j}")


def test_prefix_sharing_over_int8_pages_copies_codes_and_scales(tiny_tree):
    """Inside the port: shared int8 pages, with a copy-on-write copy of
    codes AND scales, change no greedy token against the same engine
    without the prefix cache."""
    _, tree = tiny_tree
    tm = tbuild(_port_cfg(_tiny_jcfg()))
    rng = np.random.default_rng(31)
    system = list(map(int, rng.integers(1, 258, 28)))   # 3 pages + 4 rows
    reqs = [tserving.Request(
        uid=i, prompt=system + list(map(int, rng.integers(1, 258, 4))),
        sampling=tserving.SamplingParams(max_new_tokens=6))
        for i in range(3)]
    qp = tpolicy.QuantPolicy(kv_dtype="int8")
    toks, engines = {}, {}
    for cached in (False, True):
        eng = tserving.ContinuousServingEngine(
            tm, params_from_numpy(tree, "cpu"), max_len=64, max_running=1,
            page_size=8, prefix_cache=cached, quant=qp, device="cpu")
        toks[cached] = [c.tokens for c in eng.generate(reqs)]
        engines[cached] = eng
    assert toks[True] == toks[False]
    st = engines[True].pool.stats
    assert st["shared_pages"] > 0 and st["cow_copies"] > 0
    # the runner's copier moves codes and scales of every layer alike
    runner = engines[True].runner
    layer = runner.cache["layers"][1]["self"]
    for buf in layer.values():
        buf[16:24] = torch.arange(8).reshape(8, *[1] * (buf.dim() - 1))
    runner.apply_copy_rows(np.arange(16, 24), np.arange(40, 48))
    for name, buf in layer.items():
        assert torch.equal(buf[40:48], buf[16:24]), name
        assert buf.dtype == (torch.float32 if name.endswith("scale")
                             else torch.int8)


def test_serve_cli_quantized_on_cpu():
    # quantized serving runs on the paged engine; the CLI's default
    # engine is the bucket engine, which refuses --quant / --kv-dtype
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "qwen3-1.7b", "--engine", "continuous", "--quant", "q4",
         "--kv-dtype", "int8", "--max-new", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "quant: weights=q4 kv_dtype=int8" in out.stdout
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[")]
    assert len(lines) == 4 and all(" -> " in ln for ln in lines)
    assert "throughput:" in out.stdout
