"""The port's paged transformer vs the JAX reference on shared weights.

Weights come from the reference ``Model.init`` and cross through the
weight bridge (``repro_torch.models.weights``), so both packages compute
the same function.  The same hand-built block tables, prompts and
teacher-forced decode tokens (numpy, seeded) go through
``prefill_paged`` (one-shot, resumed, and a padded bucket that overruns
``max_pages``) and eight decode steps with an idle lane; logits and the
KV pages must agree.  Tolerance: float32 throughout, only summation
order differs, so 2e-5 absolute and relative at these widths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ModelConfig as JModelConfig
from repro.models import build_model as jbuild
from repro.models import reduced_config as jreduced
from repro_torch.configs import BENCH_TINY, get_config, list_archs
from repro_torch.models import ModelConfig, build_model, reduced_config
from repro_torch.models.weights import (load_params_like, load_params_npz,
                                        params_from_numpy, params_to_numpy,
                                        save_params_npz,
                                        tree_leaves_with_path)

TOL = dict(rtol=2e-5, atol=2e-5)


def _port_cfg(jcfg, dtype=torch.float32):
    """The port's ModelConfig with every field of the reference's."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JModelConfig)}
    fields["dtype"] = dtype
    return ModelConfig(**fields)


def _np_params(jcfg, seed=0):
    """The reference model and its ``Model.init`` tree as numpy; QKV
    biases (zero at init) drawn at random so their branch computes
    something."""
    jm = jbuild(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    attn = tree["layers"].get("attn", {}) if isinstance(
        tree["layers"], dict) else {}
    rng = np.random.default_rng(seed + 100)
    for name in ("b_q", "b_k", "b_v"):
        if name in attn:
            attn[name] = rng.normal(0, 0.5, attn[name].shape).astype(
                attn[name].dtype)
    return jm, tree


CONFIGS = {
    "bench-tiny": lambda: JModelConfig(
        name="bench-tiny", arch_type="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=259,
        dtype=jnp.float32),
    "qwen3-1.7b-reduced": lambda: dataclasses.replace(
        jreduced(jget_config("qwen3-1.7b")), dtype=jnp.float32),
    # 6 layers keep one global layer of the 5:1 pattern: two windows and
    # two RoPE bases in one stack
    "gemma3-1b-reduced": lambda: dataclasses.replace(
        jreduced(jget_config("gemma3-1b"), n_layers=6, d_model=64),
        dtype=jnp.float32),
    "tiny-softcap": lambda: JModelConfig(
        name="tiny-softcap", arch_type="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=300,
        attn_logit_softcap=30.0, act="gelu", dtype=jnp.float32),
    "granite-3-8b-reduced": lambda: dataclasses.replace(
        jreduced(jget_config("granite-3-8b")), dtype=jnp.float32),
    # the only arch with QKV biases
    "qwen2-72b-reduced": lambda: dataclasses.replace(
        jreduced(jget_config("qwen2-72b")), dtype=jnp.float32),
    # MoE FFNs (4 experts, top-2, capacity factor 1.25: the padded
    # prefill rows and the idle lane take capacity, and tokens drop);
    # Grok-1 adds the attention logit softcap
    "phi3.5-moe-reduced": lambda: dataclasses.replace(
        jreduced(jget_config("phi3.5-moe-42b-a6.6b")), dtype=jnp.float32),
    "grok-1-reduced": lambda: dataclasses.replace(
        jreduced(jget_config("grok-1-314b")), dtype=jnp.float32),
}


def test_port_configs_match_the_reference():
    for arch in list_archs():
        j, t = jget_config(arch), get_config(arch)
        for f in dataclasses.fields(JModelConfig):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.dtype == torch.bfloat16
        assert t.param_count() == j.param_count()
        rt, rj = reduced_config(t), jreduced(j)
        assert rt.layer_windows(0) == rj.layer_windows(0)
        assert rt.layer_thetas() == rj.layer_thetas()
        assert rt.resolved_head_dim == rj.resolved_head_dim
    tiny = CONFIGS["bench-tiny"]()
    for f in dataclasses.fields(JModelConfig):
        if f.name not in ("dtype",):
            assert getattr(BENCH_TINY, f.name) == getattr(tiny, f.name)
    gem = reduced_config(get_config("gemma3-1b"), n_layers=6, d_model=64)
    assert len(set(gem.layer_thetas())) == 2
    assert len(set(gem.layer_windows(0))) == 2


def test_weight_bridge_round_trip_is_bit_exact():
    jcfg = jreduced(jget_config("qwen3-1.7b"))          # bf16 leaves
    _, tree = _np_params(jcfg, seed=3)
    assert tree["embed"].dtype.name == "bfloat16"
    port = params_from_numpy(tree, "cpu")
    assert port["embed"].dtype == torch.bfloat16
    assert port["layers"]["attn"]["w_q"].shape == (
        jcfg.n_layers, jcfg.d_model, jcfg.n_heads * jcfg.resolved_head_dim)
    back = params_to_numpy(port)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert b.shape == a.shape
        np.testing.assert_array_equal(b, np.asarray(a).view(np.uint16))


def test_port_shapes_match_the_reference():
    from repro.configs import SHAPES as JSHAPES
    from repro_torch.configs import SHAPES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-2b",
                                  "phi3.5-moe-42b-a6.6b", "mamba2-370m"])
def test_params_npz_round_trip_is_bit_exact(arch, tmp_path):
    """The reference's tree through ``save_params_npz`` (bf16 leaves as
    their bits; RecurrentGemma's blocks-and-tail lists; the MoE expert
    stacks (L, E, d, f) / (L, E, f, d) and the f32 router; the SSD
    block's f32 A_log, D and dt_bias) and back with ``load_params_npz``
    equals the bridge's tree, leaf for leaf, bit for bit, and fits the
    port's own init through ``load_params_like``."""
    jcfg = jreduced(jget_config(arch))                  # bf16 leaves
    if arch == "recurrentgemma-2b":
        jcfg = dataclasses.replace(jcfg, n_layers=7)    # 2 blocks + a tail
    _, tree = _np_params(jcfg, seed=4)
    path = str(tmp_path / "p.npz")
    save_params_npz(tree, path)
    got = load_params_npz(path, "cpu")
    want = params_from_numpy(tree, "cpu")
    flat_got = dict(tree_leaves_with_path(got))
    flat_want = tree_leaves_with_path(want)
    assert len(flat_got) == len(flat_want) > 0
    for p, w in flat_want:
        g = flat_got[p]
        assert g.dtype == w.dtype and g.shape == w.shape, p
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8)), p
    mine = build_model(_port_cfg(jcfg, torch.bfloat16)).init(
        torch.Generator().manual_seed(0))
    for p, leaf in tree_leaves_with_path(load_params_like(path, mine,
                                                          "cpu")):
        assert leaf.dtype == dict(tree_leaves_with_path(mine))[p].dtype, p


def _run_both(jcfg):
    """Drive both packages through the same paged prefill/decode script;
    yield (what, port logits, reference logits) pairs."""
    jm, tree = _np_params(jcfg)
    tm = build_model(_port_cfg(jcfg))
    tparams = params_from_numpy(tree, "cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    B, max_len, ps = 3, 48, 4
    max_pages = max_len // ps
    jcache = jm.init_cache(B, max_len, page_size=ps)
    tcache = tm.init_cache(B, max_len, page_size=ps, device="cpu")
    n_pages = 1 + B * max_pages
    rng = np.random.default_rng(7)
    bt = (rng.permutation(n_pages - 1) + 1).reshape(B, max_pages)
    bt = bt.astype(np.int32)
    jcache["block_tables"] = jnp.asarray(bt)
    tcache["block_tables"].copy_(torch.from_numpy(bt))
    V = jcfg.vocab_size
    prompts = [rng.integers(0, V, n) for n in (13, 17, 36)]

    def prefill(slot, toks, Sp, start=None, ctx_pages=None):
        nonlocal jcache
        padded = np.zeros((1, Sp), np.int64)
        padded[0, :len(toks)] = toks
        kw = dict(page_size=ps)
        if start is not None:
            kw.update(start=start, ctx_pages=ctx_pages)
        jl, jcache = jax.jit(
            lambda p_, b_, c_, plen_: jm.prefill_paged(p_, b_, c_, slot,
                                                       plen_, **kw))(
            jparams, {"tokens": jnp.asarray(padded)}, jcache, len(toks))
        tl, _ = tm.prefill_paged(tparams,
                                 {"tokens": torch.from_numpy(padded)},
                                 tcache, slot, len(toks), **kw)
        return tl, jl

    # slot 0: one-shot fresh prefill, padded 13 -> 16
    yield ("prefill one-shot",) + prefill(0, prompts[0], 16)
    # slot 1: chunked — fresh first chunk, then resumed at start=8
    yield ("prefill chunk 1",) + prefill(1, prompts[1][:8], 8)
    yield ("prefill resumed",) + prefill(1, prompts[1][8:], 16, start=8,
                                         ctx_pages=8)
    # slot 2: a padded bucket (36 -> 64 rows) that runs past max_pages
    # (12 pages = 48 rows): padding must land on the scratch page only
    yield ("prefill overrun",) + prefill(2, prompts[2], 64)
    pos = np.array([13, 17, 36])
    jdecode = jax.jit(lambda p_, c_, t_, pos_: jm.decode_step(
        p_, c_, t_, pos_, page_size=ps))
    for step in range(8):
        # slot 2 idles for the first four steps although its block table
        # and prompt are resident: its writes must go to scratch
        p = pos.copy()
        if step < 4:
            p[2] = -1
        toks = rng.integers(0, V, (B, 1))
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(toks),
                             jnp.asarray(p))
        tl, _ = tm.decode_step(tparams, tcache, torch.from_numpy(toks),
                               torch.from_numpy(p), page_size=ps)
        live = p >= 0
        yield (f"decode {step}", tl[live], np.asarray(jl)[live])
        pos = np.where(live, pos + 1, pos)
    # every real page agrees (page 0 is scratch: duplicate writes land
    # there in an unspecified order)
    for i in range(jcfg.n_layers):
        for name in ("k", "v"):
            a = tcache["layers"][i]["self"][name][ps:]
            b = np.asarray(jcache["layers"][i]["self"][name])[ps:]
            yield (f"layer {i} {name} pages", a, b)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_paged_prefill_and_decode_match_the_reference(name):
    n = 0
    for what, got, want in _run_both(CONFIGS[name]()):
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_allclose(got, np.asarray(want), err_msg=what,
                                   **TOL)
        n += 1
    assert n >= 14


def test_unsupported_features_raise():
    """The paged cache refuses a hybrid (RG-LRU + attention), an SSD, a
    cross-attention or an encoder-decoder stack, as the reference's does.
    (Those stacks serve through the bucket engine: ``tests/test_torch_
    {bucket,ssm,xattn,whisper}.py``; MoE layers and speculative verify
    through the paged engines too: ``tests/test_torch_moe.py``,
    ``tests/test_torch_spec.py``.)"""
    for kinds in (dict(block_pattern=("rglru", "attn")),
                  dict(arch_type="ssm", ssm_heads=4, ssm_state=8),
                  dict(cross_attn_every=2), dict(is_encoder_decoder=True)):
        model = build_model(dataclasses.replace(BENCH_TINY, **kinds))
        with pytest.raises(NotImplementedError, match="paged KV cache"):
            model.init_cache(2, 16, page_size=4, device="cpu")
