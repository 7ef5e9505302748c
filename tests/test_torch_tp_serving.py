"""Tensor-parallel paged serving and data-parallel training of the port:
twins of ``tests/test_tp_serving.py`` and of the reference CLIs'
``--tp-shards`` / ``--devices``.

Host level: shard-striped KV page planning (per-(node, shard) pools,
byte accounting, placement).

Rank level: one 2-rank gloo group (``launch.mesh.run_ranks``, spawned
once for the module, ``_torch_tp_ranks.tp_serving``) serves the
reference test's ``tp-tiny`` workload — prefix sharing, mid-page CoW,
chunked prefill — and the tokens must equal the reference's
single-shard engine's byte for byte (the head merge is an all-reduce
over disjoint head supports: an exact concatenation; the reference's
own test proves its TP tokens equal those).  The same group checks the
pool buffers stay in place with Hkv / S heads, the collective budget
(``n_layers`` all-reduces and nothing else per decode, fresh prefill,
resumed chunk and verify), q4 + int8 pages, ``spec_decode=2`` and the
async engine's leader/follower steps against the port's single-rank
engine.
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as tserving
from _torch_tp_ranks import (TP_TINY, run_spec, run_waves, spec_prompts,
                             tp_serving, tp_tiny_model, train_dp)
from repro.configs import get_config as jget_config
from repro.models import ModelConfig as JModelConfig
from repro.models import build_model as jbuild
from repro.models import reduced_config as jreduced
from repro_torch.core.memory import MemoryManager
from repro_torch.launch.mesh import Mesh, make_mesh, run_ranks
from repro_torch.launch.shardings import Policy
from repro_torch.models import ModelConfig, build_model
from repro_torch.models.weights import params_from_numpy, save_params_npz
from repro_torch.quant import QuantPolicy
from repro_torch.serving import KVCachePool, KVPoolConfig

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


# ----------------------------------------------------------------------
# host-side planning
# ----------------------------------------------------------------------

class TestShardStripedPlanning:
    def test_per_node_per_shard_pools_split_page_bytes(self):
        mm = MemoryManager(2, numa=True)
        mm.plan_kv_pages(8, page_bytes=1024, n_shards=4)
        assert len(mm.kv_pools) == 2 * 4
        assert mm.kv_node_count == 2
        assert mm.kv_shard_count == 4
        peaks = {p.name: p.peak for p in mm.kv_pools}
        assert len(set(peaks.values())) == 1
        assert all(p.peak == 4 * 256 for p in mm.kv_pools)

    def test_node_striping_is_shard_invariant(self):
        flat = MemoryManager(4, numa=True)
        flat.plan_kv_pages(16, page_bytes=512)
        tp = MemoryManager(4, numa=True)
        tp.plan_kv_pages(16, page_bytes=512, n_shards=2)
        for pid in range(16):
            assert flat.kv_page_node(pid) == tp.kv_page_node(pid)
        node, shards = tp.kv_page_placement(5)
        assert node == tp.kv_page_node(5)
        assert shards == (0, 1)
        assert flat.kv_page_placement(5) == (flat.kv_page_node(5), (0,))

    def test_page_bytes_must_split_over_shards(self):
        mm = MemoryManager(1, numa=False)
        with pytest.raises(ValueError, match="split"):
            mm.plan_kv_pages(4, page_bytes=1000, n_shards=3)

    def test_pool_config_validates_kv_head_divisibility(self):
        with pytest.raises(ValueError, match="head-shard"):
            KVCachePool(KVPoolConfig(
                n_pages=9, page_size=4, n_layers=2, n_kv_heads=2,
                head_dim=8, n_shards=4))

    def test_pool_shard_accounting_and_node_hints(self):
        pool = KVCachePool(KVPoolConfig(
            n_pages=9, page_size=4, n_layers=2, n_kv_heads=4,
            head_dim=8, dtype_bytes=4, n_nodes=2, n_shards=2))
        assert pool.cfg.page_shard_bytes * 2 == pool.cfg.page_bytes
        per_shard = pool.capacity_bytes_per_shard()
        assert set(per_shard) == {0, 1}
        assert per_shard[0] == per_shard[1]
        per_node = pool.capacity_bytes_per_node()
        assert sum(per_node.values()) == sum(per_shard.values())
        assert pool.grow(0, 16, node_hint=0)
        assert pool.grow(1, 16, node_hint=1)
        nodes = {pool.mm.kv_page_node(p)
                 for uid in (0, 1) for p in pool.block_table(uid)}
        assert nodes == {0, 1}


# ----------------------------------------------------------------------
# the reference's single-shard engine, and one 2-rank group
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    """The reference's tp-tiny weights (``PRNGKey(0)``) as numpy, and its
    single-shard engine's tokens on the two waves."""
    jm = jbuild(JModelConfig(**TP_TINY, dtype=jnp.float32))
    jparams = jm.init(jax.random.PRNGKey(0))
    _, toks = run_waves(jserving, jm, jparams)
    return jax.tree.map(np.asarray, jparams), toks


@pytest.fixture(scope="module")
def group(reference):
    return run_ranks(tp_serving, 2, (reference[0],), timeout=120)


@pytest.mark.parametrize("shards", [1, 2])
def test_tp_greedy_parity_incl_prefix_cow_chunked(reference, group, shards):
    """Byte-identical tokens at shards {1, 2} vs the reference's plain
    engine on the two-wave workload; the TP run really shared, cloned
    and reused pages."""
    tree, want = reference
    if shards == 1:
        eng, got = run_waves(tserving, tp_tiny_model(),
                             params_from_numpy(tree, "cpu"),
                             make_mesh((1,), ("model",)), device="cpu")
        runs = [(got, dict(eng.pool.stats))]
    else:
        runs = [(r["tokens"], r["stats"]) for r in group]
    for got, st in runs:
        assert got == want, (shards, got, want)
        assert st["shared_pages"] > 0, st
        assert st["cow_copies"] > 0, st
        assert st["retention_hits"] > 0, st


def test_tp_pool_buffers_stay_in_place_with_local_heads(group):
    """The torch form of the reference's donation: each rank's per-layer
    pool buffers keep their storage across a decode and a prefill, and
    hold Hkv / S = 1 of tp-tiny's 2 kv heads."""
    for r in group:
        assert r["in_place"]
        assert r["k_shape"][1:] == (TP_TINY["n_kv_heads"] // 2,
                                    TP_TINY["d_model"] // TP_TINY["n_heads"])


@pytest.mark.parametrize("call", ["decode", "prefill", "chunk", "verify"])
def test_tp_collectives_one_all_reduce_per_layer(group, call):
    """The §3.4 Sync-B budget: each call issues exactly n_layers
    all-reduces (the per-layer head merge) and no other collective —
    KV-page bytes never cross ranks."""
    for r in group:
        assert r["counts"][call] == {"all_reduce": TP_TINY["n_layers"]}


def test_tp_q4_int8_spec_and_async_match_the_single_rank_engine(
        reference, group):
    params = params_from_numpy(reference[0], "cpu")
    qp = QuantPolicy(weights="q4", kv_dtype="int8")
    _, q4 = run_waves(tserving, tp_tiny_model(), params, quant=qp,
                      device="cpu")
    _, spec = run_spec(tserving, tp_tiny_model(), params, device="cpu")
    plain = tserving.ContinuousServingEngine(
        tp_tiny_model(), params, max_len=64, max_running=2, page_size=8,
        device="cpu")
    k0 = [c.tokens for c in plain.generate([
        tserving.Request(uid=i, prompt=p,
                         sampling=tserving.SamplingParams(max_new_tokens=8))
        for i, p in enumerate(spec_prompts())])]
    assert spec == k0
    for r in group:
        assert r["q4_int8"] == q4
        assert r["spec"] == spec and r["spec_drafted"] > 0
    assert group[0]["async"] == k0


def test_tp_async_heartbeats_take_no_step(group):
    """An idle leader's heartbeat records wake every rank but step none:
    ``serving.steps`` stays still while the engine idles, and every rank
    counts the same steps."""
    assert group[0]["async_idle_steps"] == 0
    assert len({r["async_steps"] for r in group}) == 1


def test_tp_refuses_indivisible_heads_and_bad_policy(reference):
    mesh = Mesh(("model",), (2,), 0, {})        # refused before any collective
    odd = build_model(ModelConfig(
        name="odd", arch_type="dense", n_layers=2, d_model=63, n_heads=3,
        n_kv_heads=1, d_ff=64, vocab_size=259, dtype=torch.float32))
    with pytest.raises(ValueError, match="head"):
        tserving.ContinuousServingEngine(
            odd, odd.init(torch.Generator().manual_seed(0)), max_len=32,
            max_running=2, page_size=8, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="head-sharded"):
        tserving.ContinuousServingEngine(
            tp_tiny_model(), params_from_numpy(reference[0], "cpu"),
            max_len=32, max_running=2, page_size=8, mesh=mesh,
            policy=Policy(shard_cache_head_dim=False), device="cpu")


# ----------------------------------------------------------------------
# the CLIs
# ----------------------------------------------------------------------

def _cli(module, args, *, env_extra=None):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", **(env_extra or {}))
    out = subprocess.run([sys.executable, "-m", module] + args, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_tp_serve_cli_prints_the_reference_cli_text(tmp_path):
    """``--tp-shards 2 --engine continuous`` of both CLIs on the
    reference CLI's ``PRNGKey(0)`` weights: the same completions, pool
    line and per-shard / per-node pool lines."""
    cfg = jreduced(jget_config("qwen3-1.7b"))
    cfg = dataclasses.replace(cfg, dtype=jnp.float32, capacity_factor=4.0,
                              vocab_size=max(cfg.vocab_size, 259))
    path = str(tmp_path / "qwen3-reduced.npz")
    save_params_npz(jax.tree.map(
        np.asarray, jbuild(cfg).init(jax.random.PRNGKey(0))), path)
    common = ["--arch", "qwen3-1.7b", "--engine", "continuous",
              "--tp-shards", "2", "--max-new", "8", "--warmup-steps", "0",
              "--prefill-chunk", "8"]
    want = _cli("repro.launch.serve", common)
    got = _cli("repro_torch.launch.serve",
               common + ["--device", "cpu", "--params", path])

    def lines(text):
        return [ln for ln in text.splitlines()
                if ln.startswith(("[", "kv pool:", "tp pool:", "tp pages:"))]

    assert len(lines(want)) == 7
    assert lines(got) == lines(want)
    assert "tp mesh: 2-way 'model' axis over 2 gloo ranks" in got


def _losses(text):
    return [float(x) for x in re.findall(r"step +\d+ loss ([0-9.]+)", text)]


def test_train_cli_devices_matches_one_device():
    """``--devices 2`` (data parallel on two gloo ranks) prints the losses
    of ``--devices 1`` within the f32 tolerance."""
    args = ["--arch", "qwen3-1.7b", "--device", "cpu", "--steps", "3",
            "--batch", "4", "--seq-len", "32"]
    one = _cli("repro_torch.launch.train", args)
    two = _cli("repro_torch.launch.train", args + ["--devices", "2"])
    assert "devices=2" in two
    assert len(_losses(two)) == 2
    np.testing.assert_allclose(_losses(two), _losses(one), rtol=1e-5)


@pytest.fixture(scope="module")
def dp_runs():
    """3 data-parallel steps on 2 ranks, and 3 steps of one process on
    the whole batches (``_torch_tp_ranks.train_dp``)."""
    return (run_ranks(train_dp, 2, (3, 4, 32), timeout=120),
            train_dp(0, 1, 3, 4, 32))


def test_data_parallel_ranks_hold_equal_parameters(dp_runs):
    """After 3 data-parallel steps every rank holds the same parameters
    (the reduced gradient is one value), within the f32 tolerance of one
    process training on the whole batch."""
    ranks, one = dp_runs
    ranks = [r["plain"] for r in ranks]
    losses, leaves = one["plain"]
    for r_losses, r_leaves in ranks:
        np.testing.assert_allclose(r_losses, losses, rtol=1e-5)
        for a, b, c in zip(r_leaves, ranks[0][1], leaves):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-5)


def test_data_parallel_step_is_the_full_batch_under_uneven_masks(dp_runs):
    """Rows that mask different numbers of labels give the ranks unequal
    shares of the loss tokens; the token-weighted reduction still gives
    the full batch's loss and update (a plain 1/N mean of the ranks'
    would not), and a microbatched data-parallel step is refused."""
    ranks, one = dp_runs
    losses, leaves = one["masked"]
    for r_losses, r_leaves in (r["masked"] for r in ranks):
        np.testing.assert_allclose(r_losses, losses, rtol=1e-5)
        for a, c in zip(r_leaves, leaves):
            np.testing.assert_allclose(a, c, rtol=1e-4, atol=1e-5)
    from repro_torch.training.loop import make_train_step
    from repro_torch.training.optimizer import AdamWConfig
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tp_tiny_model(), AdamWConfig(), microbatches=2,
                        mesh=Mesh(("data",), (2,), 0, {}))
