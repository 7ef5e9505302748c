"""Sequence-sharded flash-decoding on gloo ranks against the reference.

``models.attention.combine_partials`` merges the ranks' blockwise
partials into the full ``flash_attention`` (the port's and the
reference's, f32 within 1e-5, the reference test's tolerance), and
``launch.shardings.make_decode_attn_hook`` decodes over a ring whose
sequence splits over the ranks: its logits against the reference's
unsharded ``decode_step`` (f32, 1e-4), its greedy tokens equal, and each
new token's K/V written by the one rank that owns its ring slot.  Each
world size (2 ranks, the sequence over "model"; 4 ranks, over "data" x
"model") runs in one spawned gloo group for the module.  The decode
cases: reduced Gemma3 (a 16-token window, the ring crossing a rank
boundary at the decode positions), the same at two rows (on 4 ranks the
rows split over "data" and the sequence over "model"), and reduced
Qwen3 with a logit softcap of 30; the prompt fills the ring but two
slots, so the steps wrap around to slot 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tp_ranks import seqshard_ranks
from repro.configs import get_config as jget_config
from repro.models import ModelConfig as JModelConfig
from repro.models import build_model as jbuild
from repro.models import reduced_config as jreduced
from repro.models.attention import flash_attention as jflash
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.attention import flash_attention

COMBINE_TOL = 1e-5
LOGIT_TOL = 1e-4
STEPS = 4

ARCHS = {
    "gemma3-window": lambda: dataclasses.replace(
        jreduced(jget_config("gemma3-1b"), n_layers=2, d_model=64),
        dtype=jnp.float32),
    "qwen3-softcap": lambda: dataclasses.replace(
        jreduced(jget_config("qwen3-1.7b"), d_model=64),
        attn_logit_softcap=30.0, dtype=jnp.float32),
}


#: decode cases: an arch, and "-b2" for two rows, which split over the
#: 4-rank group's "data" axis (the sequence then over "model" alone: one
#: kv head does not split over 2 ranks) and stay whole on the 2-rank
#: group
CASES = ["gemma3-window", "qwen3-softcap", "gemma3-window-b2"]


def _batch_split(batch, world):
    """Whether the rows split over "data": the (2, 2) mesh, B even."""
    return world == 4 and batch % 2 == 0


def _cfg_kw(jcfg):
    return {f.name: getattr(jcfg, f.name)
            for f in dataclasses.fields(JModelConfig) if f.name != "dtype"}


def _combine_case(world, seed):
    rng = np.random.default_rng(seed)
    B, S, H, Hkv, D = 2, 64 * world, 4, 2, 16
    return {"kind": "combine", "chunk": 16,
            "q": rng.normal(size=(B, 1, H, D)).astype(np.float32),
            "k": rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            "v": rng.normal(size=(B, S, Hkv, D)).astype(np.float32)}


def _decode_case(name, world, batch=1):
    jcfg = ARCHS[name]()
    jm = jbuild(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    # 512 slots a block: the sequence splits over every rank, or over
    # "model" alone where two rows split over the 4 ranks' "data" axis
    M = 512 * (world // 2 if _batch_split(batch, world) else world)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, jcfg.vocab_size,
                          (batch, M - 2)).astype(np.int32)
    return jcfg, jm, params, {"kind": "decode", "cfg": _cfg_kw(jcfg),
                              "params": params, "prompt": prompt,
                              "cache_len": M, "steps": STEPS}


def _reference_decode(jcfg, jm, params, prompt, M):
    """The reference's unsharded greedy decode: per step the logits and
    the tokens, and the final ring's k leaves."""
    cache = jm.init_cache(prompt.shape[0], M)
    logits, cache = jm.prefill(params, {"tokens": jnp.asarray(prompt)},
                               cache)
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    pos = prompt.shape[1]
    out = []
    for _ in range(STEPS):
        logits, cache = jm.decode_step(params, cache, tok, jnp.int32(pos))
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        out.append((np.asarray(logits[:, -1]), np.asarray(tok[:, 0])))
        pos += 1
    return out, cache


@pytest.fixture(scope="module", params=[2, 4], ids=["2-ranks", "4-ranks"])
def group(request):
    world = request.param
    jobs = {"combine": _combine_case(world, world)}
    refs = {}
    for case in CASES:
        name, batch = case.rsplit("-b", 1) if "-b" in case else (case, 1)
        jcfg, jm, params, job = _decode_case(name, world, int(batch))
        jobs[case] = job
        refs[case] = (jcfg, jm, params, job)
    torch.set_num_threads(1)
    ranks = run_ranks(seqshard_ranks, world, (jobs,), timeout=300)
    return world, jobs, refs, ranks


def test_combine_partials_matches_full_flash_attention(group):
    world, jobs, _, ranks = group
    job = jobs["combine"]
    S = job["k"].shape[1]
    want = flash_attention(*(torch.from_numpy(job[n]) for n in "qkv"),
                           causal=True, q_offset=S - 1,
                           chunk=job["chunk"]).numpy()
    jwant = np.asarray(jflash(*(jnp.asarray(job[n]) for n in "qkv"),
                              causal=True, q_offset=S - 1,
                              chunk=job["chunk"]))
    for r in ranks:
        got = r["combine"]["out"]
        np.testing.assert_allclose(got, want, rtol=COMBINE_TOL,
                                   atol=COMBINE_TOL)
        np.testing.assert_allclose(got, jwant, rtol=COMBINE_TOL,
                                   atol=COMBINE_TOL)
        assert r["combine"]["counts"] == {"all_reduce_max": 1,
                                          "all_reduce": 2}


@pytest.mark.parametrize("case", CASES)
def test_decode_hook_matches_the_reference_unsharded_decode(group, case):
    world, _, refs, ranks = group
    jcfg, jm, params, job = refs[case]
    M, B = job["cache_len"], job["prompt"].shape[0]
    split = _batch_split(B, world)
    want, jcache = _reference_decode(jcfg, jm, params, job["prompt"], M)
    n_attn = sum(k == "attn" for k in jcfg.layer_kinds)
    n_seq = world // 2 if split else world
    for rank, r in enumerate(ranks):
        got = r[case]
        assert got["seq_axes"] == (("data", "model") if n_seq == 4
                                   else ("model",))
        rows = got["rows"]
        assert rows == ([rank // 2] if split else list(range(B)))
        for step, (logits, tok) in enumerate(want):
            np.testing.assert_allclose(got["logits"][step], logits[rows],
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
            assert got["tokens"][step] == tok[rows].tolist(), step
        # one MAX and two SUMs a layer, nothing else
        assert got["counts"] == {"all_reduce_max": n_attn,
                                 "all_reduce": 2 * n_attn}
    # each new token's slot is written by the block that owns it alone
    P = job["prompt"].shape[1]
    local = M // n_seq
    slots = [(P + s) % M for s in range(STEPS)]
    jk = [np.asarray(x) for p, x in
          jax.tree_util.tree_flatten_with_path(jcache["layers"])[0]
          if str(getattr(p[-1], "key", "")) == "k"]
    for rank, r in enumerate(ranks):
        b = r[case]["seq_block"]
        assert b == (rank % 2 if split else rank)
        own = [s - b * local for s in slots
               if b * local <= s < (b + 1) * local]
        assert r[case]["writes"] == len(own) * n_attn, rank
        for before, after, full in zip(r[case]["k_before"],
                                       r[case]["k_after"], jk):
            changed = np.nonzero(np.any(before != after,
                                        axis=(0, 1, 3, 4)))[0]
            assert sorted(changed.tolist()) == sorted(own), rank
            block = full[:, r[case]["rows"], b * local:(b + 1) * local]
            np.testing.assert_allclose(after, block, rtol=LOGIT_TOL,
                                       atol=LOGIT_TOL)
