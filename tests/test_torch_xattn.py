"""Cross-attention in the port vs the reference: Llama-3.2-Vision.

Weights come from the reference ``Model.init`` and cross through the
weight bridge, with every cross-attention ``gate`` drawn nonzero first
(:func:`live_gates`): the reference initialises the gates at zero, and
``tanh(0) = 0`` would switch every cross-attention off, so parity on
``Model.init`` weights would hold with the cross-attention broken.  Each
model test also shows that the image moves the logits.

Covered: ``layer_norm`` and ``_cross_attn`` against the reference's; the
contiguous decode kernel's plain version in the TPU kernel's ``kv_len``
form against ``flash_attention(causal=False)``, the function the
reference computes at a decode step's cross-attention read; ring prefill
logits and caches (the memory included) and teacher-forced decode steps
against the reference's ``prefill`` / ``decode_step`` for reduced
Llama-3.2-Vision in both of the reference's layouts (5 layers: a list;
10: two (4 attn, 1 xattn) super-blocks), in float32 and in bfloat16 with
float32 image stubs (jnp promotes the cross K/V to float32; the port's
``common.matmul`` does the same); the bucket engine's greedy tokens
with ``Request.extra`` against the reference engine's; the 0-d gates
through the weight bridge and an ``.npz``; the data pipeline's stubs and
packed dataset against the reference's; the paged cache refusing the
arch; and the configs with their parameter counts.

Tolerances: float32, 2e-5 absolute and relative (the model tests'
bound: only summation order differs).  bfloat16 logits: 0.125 absolute,
the bf16 logit tolerance of the card's parity checks
(``chip_smoke.LOGIT_TOL``): each package rounds every bf16 operation
once, in its own summation order, and five layers carry one-ulp flips
into logits of size ~3.  bfloat16 layers: 2e-2 absolute and relative, as
the MoE layer's bf16 test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.configs import get_config as jget_config
from repro.data import pipeline as jpipeline
from repro.models import ModelConfig as JModelConfig
from repro.models import attention as jattention
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro.models import reduced_config as jreduced
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tpipeline
from repro_torch.kernels import ops
from repro_torch.models import ModelConfig, build_model, reduced_config
from repro_torch.models import attention as tattention
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf
from repro_torch.models.weights import (load_params_npz, params_from_numpy,
                                        save_params_npz,
                                        tree_leaves_with_path, tree_map)

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_LAYER_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_LOGIT_TOL = 0.125
ARCH = "llama-3.2-vision-11b"


# ----------------------------------------------------------------------
# shared helpers (tests/test_torch_whisper.py and test_torch_cli.py use
# them too)
# ----------------------------------------------------------------------

def port_cfg(jcfg, dtype=torch.float32):
    """The port's ModelConfig with every field of the reference's."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JModelConfig)}
    fields["dtype"] = dtype
    return ModelConfig(**fields)


def live_gates(tree, seed=7):
    """``tree`` (numpy leaves) with every cross-attention ``gate`` leaf
    drawn uniform in [0.5, 1.5] from ``seed``, in its own shape and dtype,
    in the tree's order; returns the tree (changed in place)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        items = (node.items() if isinstance(node, dict)
                 else enumerate(node) if isinstance(node, list) else ())
        for key, leaf in list(items):
            if key == "gate":
                node[key] = rng.uniform(0.5, 1.5, np.shape(leaf)).astype(
                    leaf.dtype)
            else:
                walk(leaf)

    walk(tree)
    return tree


def shared(jcfg, seed=0, dtype=torch.float32):
    """(reference model, reference params, port model, port params) on the
    reference's ``Model.init`` weights with live gates."""
    jm = jbuild(jcfg)
    tree = live_gates(jax.tree.map(np.asarray,
                                   jm.init(jax.random.PRNGKey(seed))))
    assert any(p[-1] == "gate" for p, _ in tree_leaves_with_path(tree))
    return (jm, jax.tree.map(jnp.asarray, tree),
            build_model(port_cfg(jcfg, dtype)), params_from_numpy(tree, "cpu"))


def walk(a, b, path=()):
    """Yield (path, port leaf, reference leaf) over two trees of one
    structure."""
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for key in b:
            yield from walk(a[key], b[key], path + (key,))
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from walk(x, y, path + (i,))
    else:
        yield path, a, b


def to_np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def assert_close(got, want, what, bf16):
    got, want = to_np(got), to_np(want)
    if bf16:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_LOGIT_TOL,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)


def run_both(jcfg, memory_key, memory, dtype, *, B=2, prompt_len=12,
             steps=4, seed=0):
    """Prefill ``B`` prompts with ``memory`` (numpy, float32) as
    ``batch[memory_key]`` into both packages' ring caches, then decode
    ``steps`` teacher-forced tokens; yield (what, port, reference).  The
    last item is the port's logits of one more decode step from a clone
    of the cache with the memory replaced by ``memory[::-1]`` beside the
    same step's logits, both from the port alone."""
    jm, jparams, tm, tparams = shared(jcfg, dtype=dtype)
    max_len = prompt_len + steps + 4
    rng = np.random.default_rng(11)
    V = jcfg.vocab_size
    prompt = rng.integers(0, V, (B, prompt_len))
    jcache = jm.init_cache(B, max_len)
    tcache = tm.init_cache(B, max_len, device="cpu")
    jl, jcache = jax.jit(jm.prefill)(
        jparams, {"tokens": jnp.asarray(prompt),
                  memory_key: jnp.asarray(memory)}, jcache)
    tl, tcache = tm.prefill(
        tparams, {"tokens": torch.from_numpy(prompt),
                  memory_key: torch.from_numpy(memory)}, tcache)
    yield "prefill logits", tl, jl
    for path, a, b in walk(tcache, jax.tree.map(np.asarray, jcache)):
        yield f"cache after prefill {path}", a, b
    jdecode = jax.jit(jm.decode_step)
    for step in range(steps):
        toks = rng.integers(0, V, (B, 1))
        pos = prompt_len + step
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(toks),
                             jnp.asarray(pos))
        tl, tcache = tm.decode_step(tparams, tcache, torch.from_numpy(toks),
                                    pos)
        yield f"decode {step}", tl, jl
    for path, a, b in walk(tcache, jax.tree.map(np.asarray, jcache)):
        yield f"cache after decode {path}", a, b
    toks = torch.from_numpy(rng.integers(0, V, (B, 1)))
    other = dict(tcache, memory=tcache["memory"].flip(0),
                 layers=tree_map(lambda t: t.clone(), tcache["layers"]))
    moved, _ = tm.decode_step(tparams, other, toks, prompt_len + steps)
    same, _ = tm.decode_step(tparams, tcache, toks, prompt_len + steps)
    yield "live", moved, same


def check_run(items, bf16):
    """Assert every (what, port, reference) of :func:`run_both`: logits
    and float caches within the tolerance, in the reference's dtype
    (a bf16 model's cached K/V bf16, a float32 memory float32), integer
    caches equal.  Returns how far the port's logits move when the
    memory changes."""
    n_logits = 0
    for what, got, want in items:
        if what == "live":
            assert n_logits == 5, n_logits
            return float((got.float() - want.float()).abs().max())
        want = np.asarray(want)
        assert str(got.dtype)[6:] == want.dtype.name, what
        if not got.is_floating_point():
            np.testing.assert_array_equal(got.numpy(), want, err_msg=what)
            continue
        assert_close(got, want, what, bf16)
        n_logits += not what.startswith("cache")
    raise AssertionError("no liveness item")


def _llama(n_layers=5, dtype=jnp.float32):
    return dataclasses.replace(jreduced(jget_config(ARCH)),
                               n_layers=n_layers, dtype=dtype)


def _images(jcfg, B=2, seed=0):
    return jpipeline.stub_image_embeds(B, jcfg.n_image_tokens, jcfg.d_model,
                                       seed=seed)


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 7, 64), (2, 1, 128)])
def test_layer_norm_matches_the_reference(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, shape).astype(np.float32) + 0.5
    g = rng.normal(1, 0.2, shape[-1:]).astype(np.float32)
    b = rng.normal(0, 0.2, shape[-1:]).astype(np.float32)
    got = tcommon.layer_norm(*map(torch.from_numpy, (x, g, b)))
    want = jcommon.layer_norm(*map(jnp.asarray, (x, g, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # bf16: the normalised x rounds to bf16 before the gain and the bias,
    # as in the reference, so the bits agree
    got = tcommon.layer_norm(*(torch.from_numpy(a).bfloat16()
                               for a in (x, g, b)))
    want = jcommon.layer_norm(*(jnp.asarray(a, jnp.bfloat16)
                                for a in (x, g, b)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def _xattn_params(jcfg, seed):
    ap = jax.tree.map(np.asarray, jtf._init_attn(jax.random.PRNGKey(seed),
                                                 jcfg, cross=True))
    rng = np.random.default_rng(seed)
    ap["gate"] = np.asarray(rng.uniform(0.5, 1.5), ap["gate"].dtype)
    for name in ("b_q", "b_k", "b_v", "q_norm", "k_norm"):
        if name in ap:          # zero at init: draw them so they compute
            ap[name] = rng.normal(0, 0.5, ap[name].shape).astype(
                ap[name].dtype)
    return ap


@pytest.mark.parametrize("S", [1, 7])
@pytest.mark.parametrize("variant", ["plain", "bias+qknorm", "bf16"])
def test_cross_attn_matches_the_reference(S, variant):
    """One query token (the decode read through the contiguous kernel's
    plain version, ``kv_len`` form) and a prefill of 7 (``flash_attention``
    over the memory), over 37 memory slots; with QKV biases and q/k norms
    drawn; in bf16 with a float32 memory (float32 K/V against a bf16 q,
    a bf16 output)."""
    jcfg = _llama()
    if variant == "bias+qknorm":
        jcfg = dataclasses.replace(jcfg, qkv_bias=True, qk_norm=True)
    bf16 = variant == "bf16"
    if bf16:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    ap = _xattn_params(jcfg, seed=S)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, S, jcfg.d_model)).astype(np.float32)
    mem = rng.normal(0, 1, (2, 37, jcfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    got = ttf._cross_attn(port_cfg(jcfg), params_from_numpy(ap, "cpu"), tx,
                          torch.from_numpy(mem))
    want = jtf._cross_attn(jcfg, jax.tree.map(jnp.asarray, ap), jx,
                           jnp.asarray(mem))
    assert got.dtype == tx.dtype and str(want.dtype) == str(tx.dtype)[6:]
    if bf16:
        np.testing.assert_allclose(to_np(got), to_np(want), **BF16_LAYER_TOL)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got.float().abs().max()) > 0.1          # the gate is live


@pytest.mark.parametrize("M", [1, 37, 600])
@pytest.mark.parametrize("Hkv,G,D", [(2, 4, 128), (4, 1, 64)])
def test_kv_len_decode_read_matches_non_causal_flash(M, Hkv, G, D):
    """The contiguous kernel's plain version in the TPU kernel's form,
    every one of the M slots valid, against the reference's
    ``flash_attention(causal=False)`` and the port's (600 slots cross a
    512-slot chunk with a ragged tail)."""
    rng = np.random.default_rng(M + G)
    q = rng.normal(0, 1, (3, 1, Hkv * G, D)).astype(np.float32)
    k = rng.normal(0, 1, (3, M, Hkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (3, M, Hkv, D)).astype(np.float32)
    got = ops.gqa_decode_attention(*map(torch.from_numpy, (q, k, v)),
                                   kv_len=M, impl="ref")
    want = jattention.flash_attention(*map(jnp.asarray, (q, k, v)),
                                      causal=False, chunk=512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    flash = tattention.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                       causal=False, chunk=512)
    np.testing.assert_allclose(got.numpy(), flash.numpy(), **TOL)
    # a bf16 q over f32 K/V, as the bf16 model's cross-attention reads
    qb = torch.from_numpy(q).bfloat16()
    got = ops.gqa_decode_attention(qb, *map(torch.from_numpy, (k, v)),
                                   kv_len=M)
    want = jattention.flash_attention(jnp.asarray(q, jnp.bfloat16),
                                      *map(jnp.asarray, (k, v)),
                                      causal=False, chunk=512)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(got), to_np(want), **BF16_LAYER_TOL)


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", [5, 10])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_the_reference(n_layers, dtype):
    """Prefill logits and ring caches (the memory included), four
    teacher-forced decode steps and the caches after them; 5 layers keep
    the list layout, 10 the super-blocks.  In bf16 the image stubs stay
    float32, as the reference's pipeline gives them: the memory in the
    cache stays float32 and the self-attention rings bf16."""
    bf16 = dtype == "bfloat16"
    jcfg = _llama(n_layers, getattr(jnp, dtype))
    moved = check_run(run_both(jcfg, "image_embeds", _images(jcfg),
                               getattr(torch, dtype)), bf16)
    assert moved > 0.1, moved           # the image reaches the logits
    tm = build_model(port_cfg(jcfg, getattr(torch, dtype)))
    assert tm.block_period == (5 if n_layers == 10 else 0)


def test_ring_cache_layouts_hold_nothing_for_cross_attention():
    """The list layout keeps ``{}`` for each xattn layer, the super-block
    layout one ``{}`` for the block position, as the reference's; the
    layer loop pairs each layer with its own cache in both; the memory
    entry follows ``memory_len``."""
    for n_layers, jcfg in ((5, _llama(5)), (10, _llama(10))):
        tm = build_model(port_cfg(jcfg))
        jc = jbuild(jcfg).init_cache(2, 8)
        tc = tm.init_cache(2, 8, device="cpu")
        got = {p: tuple(t.shape) for p, t in tree_leaves_with_path(tc)}
        want = {p: np.shape(t) for p, t in tree_leaves_with_path(
            jax.tree.map(np.asarray, jc))}
        assert got == want
        layers = tc["layers"]
        if n_layers == 5:
            assert layers[4] == {} and "self" in layers[0]
        else:
            assert layers["blocks"][4] == {} and layers["tail"] == []
        gen = torch.Generator().manual_seed(0)
        kinds = [(i, "self" in c) for i, _, c in tm._layer_views(
            tm.init(gen)["layers"], layers)]
        assert kinds == [(i, i % 5 != 4) for i in range(n_layers)]
    mem = tm.init_cache(2, 8, memory_len=16, device="cpu")["memory"]
    jmem = jbuild(jcfg).init_cache(2, 8, memory_len=16)["memory"]
    assert tuple(mem.shape) == jmem.shape and mem.dtype == torch.float32
    assert not mem.any()


def test_bucket_engine_with_images_matches_the_reference_engine():
    """``Request.extra['image_embeds']`` (each request its own draw) over
    two length buckets: the port's ``ServingEngine`` gives the reference
    engine's greedy tokens on the same weights; a request without the
    image, or with an input the model does not read, is refused."""
    jcfg = _llama(10)
    jm, jparams, tm, tparams = shared(jcfg, seed=1)
    lens, V = [9, 14, 9, 14], jcfg.vocab_size
    images = _images(jcfg, B=len(lens), seed=4)

    def requests(S):
        rng = np.random.default_rng(3)
        sp = S.SamplingParams(max_new_tokens=6)
        return [S.Request(uid=i, prompt=rng.integers(0, V, n).tolist(),
                          sampling=sp, extra={"image_embeds": images[i]})
                for i, n in enumerate(lens)]

    want = jserving.ServingEngine(jm, jparams, max_len=32).generate(
        requests(jserving), max_batch=2)
    teng = tserving.ServingEngine(tm, tparams, max_len=32, device="cpu")
    got = teng.generate(requests(tserving), max_batch=2)
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert all(len(c.tokens) == 6 for c in got)
    # tensors in the extra inputs serve as their numpy arrays do
    reqs = requests(tserving)
    for r in reqs:
        r.extra["image_embeds"] = torch.from_numpy(r.extra["image_embeds"])
    assert [c.tokens for c in teng.generate(reqs, max_batch=2)] == \
        [c.tokens for c in want]
    for extra in ({}, {"frames": images[0]},
                  {"image_embeds": images[0], "frames": images[0]}):
        req = tserving.Request(uid=0, prompt=[1, 2], extra=extra)
        with pytest.raises(ValueError, match="reads 'image_embeds'"):
            teng.generate([req])


def test_weight_bridge_carries_the_gates_bit_for_bit(tmp_path):
    """The reference's bf16 tree with 0-d gates (the list layout) and
    stacked (2,) gates (the super-blocks) crosses the bridge and an
    ``.npz`` bit for bit, and matches the port's own init leaf for leaf
    in shape and dtype."""
    for n_layers in (5, 10):
        jcfg = _llama(n_layers, jnp.bfloat16)
        tree = live_gates(jax.tree.map(np.asarray, jbuild(jcfg).init(
            jax.random.PRNGKey(2))))
        gates = [(p, np.shape(t)) for p, t in tree_leaves_with_path(tree)
                 if p[-1] == "gate"]
        assert gates == ([(("layers", 4, "xattn", "gate"), ())]
                         if n_layers == 5 else
                         [(("layers", "blocks", 4, "xattn", "gate"), (2,))])
        path = str(tmp_path / f"p{n_layers}.npz")
        save_params_npz(tree, path)
        bridged = params_from_numpy(tree, "cpu")
        loaded = dict(tree_leaves_with_path(load_params_npz(path, "cpu")))
        mine = dict(tree_leaves_with_path(
            build_model(port_cfg(jcfg, torch.bfloat16)).init(
                torch.Generator().manual_seed(0))))
        raw = dict(tree_leaves_with_path(tree))
        flat = tree_leaves_with_path(bridged)
        assert len(flat) == len(loaded) == len(mine) == len(raw)
        for p, t in flat:
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                raw[p].view(np.uint16), err_msg=str(p))
            assert torch.equal(t.view(torch.int16),
                               loaded[p].view(torch.int16)), p
            assert mine[p].dtype == t.dtype == torch.bfloat16, p
            assert mine[p].shape == t.shape, p


# ----------------------------------------------------------------------
# data, configs, refusals
# ----------------------------------------------------------------------

def test_stubs_and_packed_dataset_equal_the_reference():
    for seed in (0, 3):
        np.testing.assert_array_equal(
            tpipeline.stub_image_embeds(2, 16, 32, seed=seed),
            jpipeline.stub_image_embeds(2, 16, 32, seed=seed))
        np.testing.assert_array_equal(
            tpipeline.stub_frames(2, 24, 32, seed=seed),
            jpipeline.stub_frames(2, 24, 32, seed=seed))
    assert tpipeline.stub_frames(1, 4, 8).dtype == np.float32
    assert tpipeline.synth_corpus(20, 5) == jpipeline.synth_corpus(20, 5)
    tds = tpipeline.PackedLMDataset(32, n_docs=200, seed=1, vocab_size=300)
    jds = jpipeline.PackedLMDataset(32, n_docs=200, seed=1, vocab_size=300)
    np.testing.assert_array_equal(tds.tokens, jds.tokens)
    assert tds.n_rows == jds.n_rows > 0

    def extra(step, bs):
        return {"image_embeds": tpipeline.stub_image_embeds(bs, 4, 8,
                                                            seed=step)}

    for tb, jb, _ in zip(tds.batches(3, seed=2, extra_fn=extra),
                         jds.batches(3, seed=2, extra_fn=extra), range(3)):
        assert set(tb) == set(jb) == {"tokens", "labels", "image_embeds"}
        for key in tb:
            np.testing.assert_array_equal(tb[key], jb[key])


def test_configs_match_the_reference():
    """Both registry ids, their reduced variants (the ``cross_attn_every``
    and encoder-decoder branches) and the full-size parameter counts."""
    for arch, count in ((ARCH, 9_775_185_920), ("whisper-medium",
                                                757_875_712)):
        for t, j in ((get_config(arch), jget_config(arch)),
                     (reduced_config(get_config(arch)),
                      jreduced(jget_config(arch)))):
            for f in dataclasses.fields(JModelConfig):
                if f.name != "dtype":
                    assert getattr(t, f.name) == getattr(j, f.name), \
                        (arch, f.name)
            assert t.param_count() == j.param_count()
            assert t.layer_kinds == j.layer_kinds
        assert get_config(arch).dtype == torch.bfloat16
        assert get_config(arch).param_count() == count
    red = reduced_config(get_config(ARCH))
    assert (red.n_layers, red.n_image_tokens) == (5, 16)
    assert red.layer_kinds == ("attn",) * 4 + ("xattn",)


@pytest.mark.parametrize("arch", [ARCH, "whisper-medium"])
def test_paged_cache_refuses_the_arch_as_the_reference(arch):
    jcfg = jreduced(jget_config(arch))
    with pytest.raises(NotImplementedError) as want:
        jbuild(jcfg).init_cache(2, 16, page_size=4)
    with pytest.raises(NotImplementedError) as got:
        build_model(port_cfg(jcfg)).init_cache(2, 16, page_size=4,
                                               device="cpu")
    assert str(got.value) == str(want.value)
