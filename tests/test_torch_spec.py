"""Speculative decoding in the port vs the JAX reference.

* ``Model.verify_step`` logits against the reference's on shared weights
  (bridged from the reference ``Model.init``) over one hand-built paged
  state: float and int8 pages, an idle lane, a lane whose last column
  points past its block table, drafts of every length; a window and a
  softcap; the ``qkv_bias`` branch (reduced qwen2-72b, random biases).
  Tolerance: float32 throughout, only summation order differs, so 2e-5
  absolute and relative, as ``tests/test_torch_model.py``.
* Port twins of ``tests/test_spec_decode.py::TestGreedyByteParity``:
  greedy tokens with ``spec_decode`` k in {2, 4} byte-identical to k=0
  inside the port (plain decode, shared prefix with mid-page copy-on-
  write, chunked prefill, forced preemption, EOS inside an accepted
  draft), with the free pages back at their start.
* The port's k=2 tokens and ``spec.*`` counters equal the reference
  engine's on the same run; a sampled lane riding beside a drafting
  greedy lane sees the same tokens with k=2 as with k=0.
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
from repro.models import ModelConfig as JModelConfig
from repro.models import build_model as jbuild
from repro.models import reduced_config as jreduced
from repro_torch.models import ModelConfig, build_model
from repro_torch.models.weights import params_from_numpy

TOL = dict(rtol=2e-5, atol=2e-5)


def _port_cfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JModelConfig)}
    fields["dtype"] = torch.float32
    return ModelConfig(**fields)


def _shared(jcfg, seed=0):
    """(reference model, reference params, port model, port params); the
    zero-initialised QKV biases are drawn at random so the branch
    computes something."""
    jm = jbuild(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    attn = tree["layers"]["attn"]
    for name in ("b_q", "b_k", "b_v"):
        if name in attn:
            attn[name] = rng.normal(0, 0.5, attn[name].shape).astype(
                attn[name].dtype)
    return (jm, jax.tree.map(jnp.asarray, tree), build_model(_port_cfg(jcfg)),
            params_from_numpy(tree, "cpu"))


VERIFY_CONFIGS = {
    "spec-tiny": lambda: JModelConfig(
        name="spec-tiny", arch_type="dense", n_layers=2, d_model=32,
        n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=67,
        dtype=jnp.float32),
    "bench-tiny": lambda: JModelConfig(
        name="bench-tiny", arch_type="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=259,
        dtype=jnp.float32),
    "gemma3-1b-reduced": lambda: dataclasses.replace(
        jreduced(jget_config("gemma3-1b"), n_layers=6, d_model=64),
        dtype=jnp.float32),
    "tiny-softcap": lambda: JModelConfig(
        name="tiny-softcap", arch_type="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=300,
        attn_logit_softcap=30.0, act="gelu", dtype=jnp.float32),
    "granite-3-8b-reduced": lambda: dataclasses.replace(
        jreduced(jget_config("granite-3-8b")), dtype=jnp.float32),
    "qwen2-72b-reduced": lambda: dataclasses.replace(
        jreduced(jget_config("qwen2-72b")), dtype=jnp.float32),
    # MoE FFNs: a verify step routes all B * S columns (idle lanes and
    # columns past n_fed included) under one capacity
    "phi3.5-moe-reduced": lambda: dataclasses.replace(
        jreduced(jget_config("phi3.5-moe-42b-a6.6b")), dtype=jnp.float32),
    "grok-1-reduced": lambda: dataclasses.replace(
        jreduced(jget_config("grok-1-314b")), dtype=jnp.float32),
}


def _sync_int8_pages(tcache, jcache, ps):
    """Hold the port's int8 pages to one code of the reference's, then
    give it the reference's codes and scales.  K and V come out of two
    matmuls that sum in other orders (~1e-7 relative), so a value at a
    rounding boundary may quantize one code apart (the rule of
    ``test_torch_quant.py``: within one code, at most 0.1 % moved); the
    verify step is then held on the same pages in both packages.  Page
    0 is scratch: duplicate writes land there in an unspecified order."""
    moved = total = 0
    for tl, jl in zip(tcache["layers"], jcache["layers"]):
        for name, buf in tl["self"].items():
            want = np.asarray(jl["self"][name])
            if name in ("k", "v"):
                d = np.abs(buf[ps:].numpy().astype(np.int32)
                           - want[ps:])
                assert d.max() <= 1, name
                moved += int((d != 0).sum())
                total += d.size
            buf.copy_(torch.from_numpy(np.array(want)))
    assert moved <= total // 1000, (moved, total)


def _verify_both(jcfg, kv_dtype):
    """Prefill three prompts into both packages' paged caches (shuffled
    block tables), then run verify steps with drafts of every length, an
    idle lane and a lane at the end of its table, and a decode step after
    them; yield (what, port, reference) for every real column and for the
    pages.  Int8 pages are synchronised before each step
    (:func:`_sync_int8_pages`)."""
    jm, jparams, tm, tparams = _shared(jcfg)
    B, max_len, ps = 3, 48, 4
    max_pages = max_len // ps
    jcache = jm.init_cache(B, max_len, page_size=ps, kv_dtype=kv_dtype)
    tcache = tm.init_cache(B, max_len, page_size=ps, kv_dtype=kv_dtype,
                           device="cpu")
    rng = np.random.default_rng(5)
    bt = (rng.permutation(B * max_pages) + 1).reshape(B, max_pages)
    bt = bt.astype(np.int32)
    jcache["block_tables"] = jnp.asarray(bt)
    tcache["block_tables"].copy_(torch.from_numpy(bt))
    V = jcfg.vocab_size
    lens = (13, 17, 42)
    for slot, n in enumerate(lens):
        toks = np.zeros((1, 64), np.int64)
        toks[0, :n] = rng.integers(0, V, n)
        _, jcache = jax.jit(lambda p_, b_, c_, s=slot, n=n: jm.prefill_paged(
            p_, b_, c_, s, n, page_size=ps))(
            jparams, {"tokens": jnp.asarray(toks)}, jcache)
        tm.prefill_paged(tparams, {"tokens": torch.from_numpy(toks)},
                         tcache, slot, n, page_size=ps)
    jverify = jax.jit(lambda p_, c_, t_, pos_, nf_: jm.verify_step(
        p_, c_, t_, pos_, nf_, page_size=ps))
    S = 3
    pos = np.array(lens)
    # (n_fed per lane, lanes idle this step): lane 2 stands at position
    # 46 of max_len 48 after two steps, so in the third its last column
    # (past n_fed = 2) points past the block table; then it idles
    script = [((3, 1, 2), ()), ((2, 3, 2), (1,)), ((1, 2, 2), ()),
              ((3, 3, 1), (2,))]
    for step, (n_fed, idle) in enumerate(script):
        if kv_dtype == "int8":
            _sync_int8_pages(tcache, jcache, ps)
        n_fed = np.array(n_fed, np.int32)
        p = pos.copy()
        p[list(idle)] = -1
        toks = rng.integers(0, V, (B, S))
        jl, jcache = jverify(jparams, jcache, jnp.asarray(toks),
                             jnp.asarray(p), jnp.asarray(n_fed))
        tl, _ = tm.verify_step(tparams, tcache, torch.from_numpy(toks),
                               torch.from_numpy(p), torch.from_numpy(n_fed),
                               page_size=ps)
        jl = np.asarray(jl)
        for b in range(B):
            if p[b] < 0:
                continue
            for j in range(n_fed[b]):
                yield f"verify {step} lane {b} column {j}", tl[b, j], jl[b, j]
        # accept every fed column of the live lanes
        pos = np.where(p >= 0, pos + n_fed, pos)
    assert pos[2] == max_len
    toks = rng.integers(0, V, (B, 1))
    p = np.where(pos < max_len, pos, -1)
    if kv_dtype == "int8":
        _sync_int8_pages(tcache, jcache, ps)
    jl, jcache = jax.jit(lambda p_, c_, t_, pos_: jm.decode_step(
        p_, c_, t_, pos_, page_size=ps))(jparams, jcache, jnp.asarray(toks),
                                          jnp.asarray(p))
    tl, _ = tm.decode_step(tparams, tcache, torch.from_numpy(toks),
                           torch.from_numpy(p), page_size=ps)
    yield "decode after verify", tl, np.asarray(jl)
    if kv_dtype == "int8":
        _sync_int8_pages(tcache, jcache, ps)
        return
    # every real page agrees (page 0 is scratch: duplicate writes land
    # there in an unspecified order)
    for i in range(jcfg.n_layers):
        for name, buf in tcache["layers"][i]["self"].items():
            yield (f"layer {i} {name} pages", buf[ps:],
                   np.asarray(jcache["layers"][i]["self"][name])[ps:])


VERIFY_CASES = [(name, "fp32") for name in sorted(VERIFY_CONFIGS)] + [
    ("spec-tiny", "int8"), ("gemma3-1b-reduced", "int8")]


@pytest.mark.parametrize("name,kv_dtype", VERIFY_CASES)
def test_verify_step_matches_the_reference(name, kv_dtype):
    n = 0
    for what, got, want in _verify_both(VERIFY_CONFIGS[name](), kv_dtype):
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_allclose(got, np.asarray(want), err_msg=what,
                                   **TOL)
        n += 1
    assert n >= 20


# ----------------------------------------------------------------------
# byte parity k in {2, 4} vs k = 0, and the port vs the reference engine
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The reference's spec-decode tiny model (``test_spec_decode._tiny``)
    in both packages."""
    return _shared(VERIFY_CONFIGS["spec-tiny"]())


#: repetitive prompts so prompt lookup drafts (``test_spec_decode.REP``)
REP = [[7, 8, 9, 7, 8, 9, 7, 8], [3, 4, 3, 4, 3, 4, 3, 4, 3],
       [5, 6, 7, 5, 6, 7, 5, 6, 7, 5]]
_BASE = [1, 2, 3, 4, 1, 2]
SCENARIOS = {
    "plain": (REP, dict(max_len=64, page_size=4)),
    # one full shared page + mid-page divergence: adoption, CoW clones and
    # speculative writes on the same pages
    "shared-prefix-midpage-cow": (
        [_BASE + [3, 4, 1, 2], _BASE + [9, 9, 1, 2], _BASE + [3, 4, 1, 9]],
        dict(max_len=64, page_size=4, arrivals=[0.0, 1.0, 1.0])),
    "chunked-prefill": (REP, dict(max_len=64, page_size=4, prefill_chunk=4)),
    # a pool too small for three worst-case speculative spans: grows fail,
    # victims recompute — order changes, bytes must not
    "forced-preemption": (REP, dict(max_len=64, page_size=4, n_pages=13,
                                    max_running=3)),
}
SPEC_COUNTERS = ("spec.drafted", "spec.accepted", "spec.rollbacks",
                 "spec.pages_returned", "spec.auto_disabled")


def _generate(S, model, params, prompts, k, *, max_new=12, eos_id=None,
              arrivals=None, **kw):
    if S is tserving:
        kw["device"] = "cpu"
    eng = S.ContinuousServingEngine(model, params, spec_decode=k,
                                    clock=S.VirtualClock(), **kw)
    reqs = [S.Request(uid=i, prompt=list(p),
                      sampling=S.SamplingParams(max_new_tokens=max_new,
                                                eos_id=eos_id))
            for i, p in enumerate(prompts)]
    free0 = eng.pool.n_free()
    comps = eng.generate(reqs, arrivals=arrivals)
    assert eng.pool.n_free() == free0, "pages leaked"
    return [c.tokens for c in comps], eng


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_greedy_tokens_byte_identical_to_k0(tiny, scenario):
    _, _, tm, tparams = tiny
    prompts, kw = SCENARIOS[scenario]
    base, _ = _generate(tserving, tm, tparams, prompts, 0, **kw)
    for k in (2, 4):
        spec, eng = _generate(tserving, tm, tparams, prompts, k, **kw)
        assert spec == base, f"k={k} diverged from k=0"
        reg = eng.registry
        assert reg.get("spec.drafted").value() > 0
        if scenario == "forced-preemption":
            assert eng.scheduler.n_preemptions > 0
        if scenario == "shared-prefix-midpage-cow":
            assert eng.pool.stats["cow_copies"] >= 1


def test_eos_inside_an_accepted_draft(tiny):
    """eos_id equal to a token the greedy continuation first emits
    mid-sequence: the engine stops at it exactly where sequential decode
    would, though a draft may carry tokens past it."""
    _, _, tm, tparams = tiny
    kw = dict(max_len=64, page_size=4, max_new=8)
    base, _ = _generate(tserving, tm, tparams, REP[:1], 0, **kw)
    idx, eos = next((i, t) for i, t in enumerate(base[0])
                    if i >= 1 and t not in base[0][:i])
    outs = [_generate(tserving, tm, tparams, REP[:1], k, eos_id=int(eos),
                      **kw)[0] for k in (0, 2, 4)]
    assert outs[0] == outs[1] == outs[2]
    assert outs[0][0][-1] == eos and len(outs[0][0]) == idx + 1


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_k2_tokens_and_spec_counters_match_the_reference(tiny, scenario):
    jm, jparams, tm, tparams = tiny
    prompts, kw = SCENARIOS[scenario]
    jtoks, jeng = _generate(jserving, jm, jparams, prompts, 2, **kw)
    ttoks, teng = _generate(tserving, tm, tparams, prompts, 2, **kw)
    assert ttoks == jtoks
    for name in SPEC_COUNTERS:
        assert (teng.registry.get(name).value()
                == jeng.registry.get(name).value()), name
    assert teng.pool.stats == jeng.pool.stats
    assert teng.registry.get("spec.drafted").value() > 0
    verify = teng.registry.get("runner.verify.dispatch_ms")
    assert verify.value(shards="1")[1] > 0      # (sum, count): verify ran


def test_sampled_lane_keeps_its_tokens_beside_a_drafting_lane(tiny):
    """One sampled lane (never drafts) beside a greedy lane that drafts:
    a verify step draws from the sampling generator exactly what a decode
    step draws, so the sampled lane's tokens do not depend on k.  The
    greedy lane outlives the sampled one in both runs, so every step
    samples the same groups of lanes."""
    _, _, tm, tparams = tiny
    reqs = [tserving.Request(uid=0, prompt=[11, 12, 13, 14],
                             sampling=tserving.SamplingParams(
                                 temperature=1.0, max_new_tokens=6)),
            tserving.Request(uid=1, prompt=REP[1],
                             sampling=tserving.SamplingParams(
                                 max_new_tokens=30))]
    out = {}
    for k in (0, 2):
        eng = tserving.ContinuousServingEngine(
            tm, tparams, max_len=64, page_size=4, max_running=2,
            spec_decode=k, seed=3, clock=tserving.VirtualClock(),
            device="cpu")
        out[k] = [c.tokens for c in eng.generate(reqs)]
        if k:
            assert eng.registry.get("spec.drafted").value() > 0
    assert out[2][0] == out[0][0]
    assert out[2][1] == out[0][1]
