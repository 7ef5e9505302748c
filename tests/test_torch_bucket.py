"""The port's bucket engine, ring cache and hybrid stack vs the reference.

Weights come from the reference ``Model.init`` and cross through the
weight bridge, so both packages compute the same function.  The same
prompts and teacher-forced decode tokens (numpy, seeded) go through the
ring-cache ``prefill`` and the scalar-position ``decode_step`` of both
packages, for uniform stacks (bench-tiny, reduced Qwen3, reduced Gemma3
with its window and local:global pattern) and for reduced
RecurrentGemma in both of the reference's layouts: 3 layers (a list of
layers) and 7 (two (R, R, A) super-blocks plus a one-layer tail); and
for rings shorter than the sequence (``cache_len < max_len``), which
wrap.  Logits at every step and the cache after prefill must agree.

Tolerance: float32 throughout, 2e-5 absolute and relative (the model
tests' bound): the port differs from the reference only in summation
order and, in the RG-LRU layers, in the scan's rounding (sequential
here, an associative tree there).

The engines: the port's ``ServingEngine`` gives the reference's greedy
tokens from the same weights over two length buckets, and the port's
bucket and continuous engines give each other's (greedy tokens are
compared exactly; these workloads have no near-ties).
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
from repro.configs import get_config as jget_config
from repro.models import ModelConfig as JModelConfig
from repro.models import build_model as jbuild
from repro.models import reduced_config as jreduced
from repro_torch.configs import get_config
from repro_torch.models import ModelConfig, build_model, reduced_config
from repro_torch.models.weights import params_from_numpy

TOL = dict(rtol=2e-5, atol=2e-5)
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _port_cfg(jcfg):
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JModelConfig)}
    fields["dtype"] = torch.float32
    return ModelConfig(**fields)


def _rg(n_layers):
    return dataclasses.replace(jreduced(jget_config("recurrentgemma-2b")),
                               n_layers=n_layers, dtype=jnp.float32)


CONFIGS = {
    "bench-tiny": lambda: JModelConfig(
        name="bench-tiny", arch_type="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=259,
        dtype=jnp.float32),
    "qwen3-1.7b-reduced": lambda: dataclasses.replace(
        jreduced(jget_config("qwen3-1.7b")), dtype=jnp.float32),
    "gemma3-1b-reduced": lambda: dataclasses.replace(
        jreduced(jget_config("gemma3-1b"), n_layers=6, d_model=64),
        dtype=jnp.float32),
    "granite-3-8b-reduced": lambda: dataclasses.replace(
        jreduced(jget_config("granite-3-8b")), dtype=jnp.float32),
    "qwen2-72b-reduced": lambda: dataclasses.replace(
        jreduced(jget_config("qwen2-72b")), dtype=jnp.float32),
    "recurrentgemma-3-layers": lambda: _rg(3),
    "recurrentgemma-7-layers": lambda: _rg(7),
    # MoE FFNs (4 experts, top-2, capacity factor 1.25: tokens drop)
    "phi3.5-moe-reduced": lambda: dataclasses.replace(
        jreduced(jget_config("phi3.5-moe-42b-a6.6b")), dtype=jnp.float32),
    "grok-1-reduced": lambda: dataclasses.replace(
        jreduced(jget_config("grok-1-314b")), dtype=jnp.float32),
    # the attention-free SSD stack: 20 prompt tokens cross two 8-token
    # chunks, each decode step is a chunk padded with zeros; the cache is
    # each layer's f32 state and conv tail
    "mamba2-370m-reduced": lambda: dataclasses.replace(
        jreduced(jget_config("mamba2-370m")), dtype=jnp.float32),
}


def _shared(jcfg, seed=0):
    """(reference model, reference params, port model, port params); QKV
    biases (zero at init) drawn at random so their branch computes
    something."""
    jm = jbuild(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed + 100)
        attn = tree["layers"]["attn"]
        for name in ("b_q", "b_k", "b_v"):
            attn[name] = rng.normal(0, 0.5, attn[name].shape).astype(
                attn[name].dtype)
    tm = build_model(_port_cfg(jcfg))
    return jm, jax.tree.map(jnp.asarray, tree), tm, \
        params_from_numpy(tree, "cpu")


def _walk(a, b, path=()):
    """Yield (path, port leaf, reference leaf) over two trees of one
    structure."""
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for key in b:
            yield from _walk(a[key], b[key], path + (key,))
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _walk(x, y, path + (i,))
    else:
        yield path, a, b


def _run_both(jcfg, cache_len=None, prompt_len=20, steps=6):
    """Prefill three prompts into both packages' ring caches, then decode
    ``steps`` teacher-forced tokens; yield (what, port, reference)."""
    jm, jparams, tm, tparams = _shared(jcfg)
    B, max_len = 3, prompt_len + steps + 4
    rng = np.random.default_rng(11)
    V = jcfg.vocab_size
    prompt = rng.integers(0, V, (B, prompt_len))
    jcache = jm.init_cache(B, max_len, cache_len=cache_len)
    tcache = tm.init_cache(B, max_len, cache_len=cache_len, device="cpu")
    jl, jcache = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(prompt)},
                                     jcache)
    tl, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(prompt)},
                            tcache)
    yield "prefill logits", tl, jl
    for path, a, b in _walk(tcache, jax.tree.map(np.asarray, jcache)):
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
    for path, a, b in _walk(tcache, jax.tree.map(np.asarray, jcache)):
        yield f"cache after decode {path}", a, b


CASES = [(name, None) for name in sorted(CONFIGS)] + [
    ("bench-tiny", 12), ("recurrentgemma-7-layers", 12)]


@pytest.mark.parametrize("name,cache_len", CASES)
def test_ring_prefill_and_decode_match_the_reference(name, cache_len):
    n_logits = n_cache = 0
    for what, got, want in _run_both(CONFIGS[name](), cache_len):
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        np.testing.assert_allclose(got, np.asarray(want), err_msg=what,
                                   **TOL)
        n_logits += "logits" in what or what.startswith("decode")
        n_cache += what.startswith("cache")
    assert n_logits == 7 and n_cache >= 2


def test_ring_cache_layouts_follow_the_reference():
    """Pattern list for 3 RecurrentGemma layers, two super-blocks plus a
    tail for 7, the stacked layout for a uniform stack; the ring slots of
    a wrapped cache hold the last positions, and RG-LRU state is f32."""
    m3 = build_model(_port_cfg(_rg(3)))
    m7 = build_model(_port_cfg(_rg(7)))
    assert (m3.block_period, m7.block_period) == (0, 3)
    assert (m7.n_full_blocks, m7.n_tail) == (2, 1)
    c3 = m3.init_cache(2, 10, device="cpu")
    assert isinstance(c3["layers"], list) and len(c3["layers"]) == 3
    assert c3["layers"][0]["rglru"]["h"].dtype == torch.float32
    assert c3["layers"][2]["self"]["pos"].tolist() == [-1] * 10
    c7 = m7.init_cache(2, 10, cache_len=4, device="cpu")
    assert [b["rglru"]["h"].shape[0] if "rglru" in b
            else b["self"]["k"].shape[:3] for b in c7["layers"]["blocks"]] \
        == [2, 2, (2, 2, 4)]
    assert len(c7["layers"]["tail"]) == 1
    tm = build_model(_port_cfg(CONFIGS["bench-tiny"]()))
    gen = torch.Generator().manual_seed(0)
    params = tm.init(gen)
    cache = tm.init_cache(1, 16, cache_len=4, device="cpu")
    assert cache["layers"]["self"]["k"].shape == (4, 1, 4, 2, 32)
    tm.prefill(params, {"tokens": torch.arange(6)[None]}, cache)
    assert cache["layers"]["self"]["pos"][0].tolist() == [4, 5, 2, 3]
    assert int(cache["length"]) == 6


def test_weight_bridge_carries_blocks_tail_and_lambda():
    """The reference's super-block tree (bf16, the config default) loads
    unchanged: stacked blocks, an unstacked tail, f32 Lambda leaves."""
    jcfg = dataclasses.replace(jreduced(jget_config("recurrentgemma-2b")),
                               n_layers=8)
    jm = jbuild(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    port = params_from_numpy(tree, "cpu")
    blocks, tail = port["layers"]["blocks"], port["layers"]["tail"]
    assert len(blocks) == 3 and len(tail) == 2
    assert blocks[0]["rglru"]["Lambda"].dtype == torch.float32
    assert blocks[0]["rglru"]["Lambda"].shape == (2, jcfg.lru_width)
    assert blocks[2]["attn"]["w_q"].dtype == torch.bfloat16
    assert tail[1]["rglru"]["Lambda"].shape == (jcfg.lru_width,)
    for path, a, b in _walk(port, tree):
        want = b.view(np.uint16) if b.dtype.name == "bfloat16" else b
        got = (a.view(torch.int16).numpy().view(np.uint16)
               if a.dtype == torch.bfloat16 else a.numpy())
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    # the port's own init draws the same tree structure
    mine = build_model(dataclasses.replace(
        get_config("recurrentgemma-2b"), **{
            f: getattr(jcfg, f) for f in ("n_layers", "d_model", "n_heads",
                                          "n_kv_heads", "head_dim", "d_ff",
                                          "vocab_size", "lru_width")}))
    gen = torch.Generator().manual_seed(0)
    for path, a, b in _walk(mine.init(gen), tree):
        assert tuple(a.shape) == b.shape, path


def test_reduced_hybrid_config_matches_the_reference():
    j = jreduced(jget_config("recurrentgemma-2b"))
    t = reduced_config(get_config("recurrentgemma-2b"))
    for f in dataclasses.fields(JModelConfig):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.lru_width, t.n_layers, t.sliding_window) == (128, 3, 16)
    assert t.layer_kinds == ("rglru", "rglru", "attn")


# ----------------------------------------------------------------------
# the engines
# ----------------------------------------------------------------------

def _requests(S, lens, V, max_new, seed=3):
    rng = np.random.default_rng(seed)
    sp = S.SamplingParams(max_new_tokens=max_new)
    return [S.Request(uid=i, prompt=rng.integers(0, V, n).tolist(),
                      sampling=sp) for i, n in enumerate(lens)]


@pytest.mark.parametrize("name", ["bench-tiny", "recurrentgemma-7-layers",
                                  "phi3.5-moe-reduced", "grok-1-reduced",
                                  "mamba2-370m-reduced"])
def test_bucket_engine_matches_the_reference_engine(name):
    """Two length buckets of two requests each (``max_batch=2``) and a
    third bucket of one; 8 greedy tokens per request.  The MoE archs run
    at their capacity factor, 1.25, so a bucket's tokens can drop, as in
    the reference."""
    jcfg = CONFIGS[name]()
    jm, jparams, tm, tparams = _shared(jcfg, seed=1)
    lens, V = [9, 14, 9, 14, 5], jcfg.vocab_size
    jeng = jserving.ServingEngine(jm, jparams, max_len=32)
    teng = tserving.ServingEngine(tm, tparams, max_len=32, device="cpu")
    want = jeng.generate(_requests(jserving, lens, V, 8), max_batch=2)
    got = teng.generate(_requests(tserving, lens, V, 8), max_batch=2)
    assert len(teng._buckets(_requests(tserving, lens, V, 8), 2)) == 3
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert all(len(c.tokens) == 8 for c in got)
    assert [c.prompt_len for c in got] == lens
    rep = tserving.throughput_report(got, **teng.last_phase_s)
    assert rep["new_tokens"] == 40 and rep["wall_s"] > 0


def test_bucket_engine_matches_the_continuous_engine():
    """Inside the port: the bucket engine over the ring cache and the
    paged continuous engine give the same greedy tokens (uniform arch)."""
    jcfg = CONFIGS["qwen3-1.7b-reduced"]()
    _, _, tm, tparams = _shared(jcfg, seed=2)
    lens, V = [7, 12, 7, 19], jcfg.vocab_size
    bucket = tserving.ServingEngine(tm, tparams, max_len=40, device="cpu")
    cont = tserving.ContinuousServingEngine(tm, tparams, max_len=40,
                                            max_running=4, page_size=4,
                                            device="cpu")
    got = bucket.generate(_requests(tserving, lens, V, 10), max_batch=4)
    want = cont.generate(_requests(tserving, lens, V, 10))
    assert [c.tokens for c in got] == [c.tokens for c in want]


def test_bucket_engine_refuses_missing_gpu_and_extra_inputs():
    _, _, tm, tparams = _shared(CONFIGS["bench-tiny"]())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserving.ServingEngine(tm, tparams)
    eng = tserving.ServingEngine(tm, tparams, max_len=16, device="cpu")
    req = tserving.Request(uid=0, prompt=[1, 2], extra={"frames": [0.0]})
    # bench-tiny has no cross-attention: it reads no extra input
    with pytest.raises(ValueError, match="extra inputs.*reads none"):
        eng.generate([req])


def test_serve_cli_bucket_recurrentgemma_on_cpu():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "recurrentgemma-2b", "--engine", "bucket", "--max-new",
         "4"], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "arch=recurrentgemma-2b" in out.stdout
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[")]
    assert len(lines) == 4 and all(" -> " in ln for ln in lines)
    assert "throughput:" in out.stdout
    # the bucket engine is the default, and refuses the paged-only flags
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "qwen3-1.7b", "--quant", "q4"], env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and "--engine continuous" in out.stderr
