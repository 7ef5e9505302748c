"""The port's ``core/tp.py``, ``launch/mesh.py`` and the serving subset
of ``launch/shardings.py`` against the reference's.

Specs are compared leaf by leaf (the port's ``Spec.dims`` against the
reference's ``PartitionSpec``) on trees of the same config; the blocks
run in one 2-rank gloo group (``launch.mesh.run_ranks``, spawned once
for the module) and are held to the reference's single-device blocks
within 1e-5 (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_tp_ranks import TP_TINY, tp_blocks
from repro.core import tp as jtp
from repro.launch import shardings as jsh
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.models import ModelConfig as JModelConfig
from repro.models import build_model as jbuild
from repro.quant.policy import quantize_serving_params as jquantize
from repro_torch.core import tp
from repro_torch.launch import shardings as tsh
from repro_torch.launch.mesh import Mesh, make_mesh, run_ranks
from repro_torch.models import ModelConfig, build_model
from repro_torch.models.weights import params_from_numpy, tree_leaves_with_path
from repro_torch.quant import quantize_serving_params

TOL = 1e-5
D, F_, T, H = 32, 64, 8, 4


def _ref_specs(specs):
    """path string -> tuple(PartitionSpec) of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s) for path, s in flat}


def _port_specs(specs):
    return {"/".join(str(k) for k in path): s.dims
            for path, s in tree_leaves_with_path(specs)}


@pytest.fixture(scope="module")
def tiny():
    """The reference's tp-tiny model, its weights, and the port's."""
    jm = jbuild(JModelConfig(**TP_TINY, dtype=jnp.float32))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = build_model(ModelConfig(**TP_TINY, dtype=torch.float32))
    return jm, tree, tm, params_from_numpy(tree, "cpu")


def test_partition_plan_specs_match_the_reference(tiny):
    jm, tree, _, tparams = tiny
    tree = dict(tree, lm_head=tree["embed"].T)      # every rule's name
    want = _ref_specs(jtp.PartitionPlan().params_specs(tree))
    got = _port_specs(tp.PartitionPlan().params_specs(
        dict(tparams, lm_head=tparams["embed"].T)))
    assert got == want
    assert set(got.values()) >= {(None, "model"), ("model", None), ()}


@pytest.mark.parametrize("quant", ["none", "q4"])
def test_serving_tp_param_specs_match_the_reference(tiny, quant):
    jm, tree, _, tparams = tiny
    if quant == "q4":
        jtree = jquantize(jax.tree.map(jnp.asarray, tree), min_size=64)
        ttree = quantize_serving_params(tparams, min_size=64)
    else:
        jtree = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        ttree = tparams
    want = _ref_specs(jsh.serving_tp_param_specs(jtree))
    got = _port_specs(tsh.serving_tp_param_specs(ttree))
    assert got == want
    assert sum(d == (None, None, "model") for d in got.values()) == (
        6 if quant == "q4" else 3)


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_paged_cache_specs_match_the_reference(tiny, kv_dtype):
    jm, _, tm, _ = tiny
    jcache = jax.eval_shape(lambda: jm.init_cache(
        4, 64, page_size=8, n_pages=33, kv_dtype=kv_dtype))
    tcache = tm.init_cache(4, 64, page_size=8, n_pages=33,
                           kv_dtype=kv_dtype, device="cpu")
    want = _ref_specs(jsh.paged_cache_specs(jcache))
    got = _port_specs(tsh.paged_cache_specs(tcache))
    assert got == want
    assert got["layers/0/self/k"] == (None, "model", None)


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    mlp = {k: (rng.normal(size=s) * 0.1).astype(np.float32)
           for k, s in [("w_gate", (D, F_)), ("w_up", (D, F_)),
                        ("w_down", (F_, D))]}
    attn = {k: (rng.normal(size=(D, D)) * 0.1).astype(np.float32)
            for k in ("w_q", "w_k", "w_v", "w_o")}
    x = rng.normal(size=(T, D)).astype(np.float32)
    return mlp, attn, x


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def test_reference_blocks_match_the_reference():
    mlp, attn, x = _weights()
    np.testing.assert_allclose(
        tp.mlp_reference(_torch(mlp), torch.from_numpy(x)).numpy(),
        np.asarray(jtp.mlp_reference(mlp, x)), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        tp.attention_reference(_torch(attn), torch.from_numpy(x), H).numpy(),
        np.asarray(jtp.attention_reference(attn, x, n_heads=H)),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["sync_a", "sync_b"])
def test_one_rank_blocks_match_the_reference_one_device_blocks(mode):
    """On one rank / one device both packages' TP blocks are the plain
    block, their collectives the identity: the port counts them as the
    reference's jaxpr holds them."""
    mlp, attn, x = _weights(1)
    jmesh = jmake_mesh((1,), ("model",))
    mesh = make_mesh((1,), ("model",))
    for kind, w, kw in (("mlp", mlp, {}), ("attention", attn,
                                         {"n_heads": H})):
        want = np.asarray(jtp.make_tp_block(jmesh, kind, sync_mode=mode,
                                            **kw)(w, x))
        blk = tp.make_tp_block(mesh, kind, sync_mode=mode, **kw)
        res = {}
        counts = tp.collective_ops_in(
            lambda: res.setdefault("z", blk(_torch(w), torch.from_numpy(x))))
        np.testing.assert_allclose(res["z"].numpy(), want, rtol=TOL,
                                   atol=TOL)
        gathers = (3 if kind == "attention" else 1) if mode == "sync_a" \
            else 0
        assert counts == ({"all_reduce": 1, "all_gather": gathers}
                          if gathers else {"all_reduce": 1}), counts


def test_specs_shard_leaves_and_refuse_uneven_splits():
    mesh = Mesh(("model",), (2,), 1, {})        # rank 1 of 2, no group
    x = torch.arange(24.0).reshape(2, 3, 4)
    got = tp.shard_leaf(x, tp.Spec((None, None, "model")), mesh)
    assert torch.equal(got, x[:, :, 2:]) and got.is_contiguous()
    assert tp.shard_leaf(x, tp.Spec(), mesh) is x
    with pytest.raises(ValueError, match="split"):
        tp.shard_leaf(x, tp.Spec((None, "model")), mesh)
    with pytest.raises(ValueError, match="query heads"):
        tsh.make_paged_head_merge(3, 2, mesh)
    with pytest.raises(ValueError, match="sync mode"):
        tp.make_tp_block(mesh, "mlp", sync_mode="sync_c")


# ----------------------------------------------------------------------
# one 2-rank gloo group for the rest of the module
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def group():
    mlp, attn, x = _weights()
    return (mlp, attn, x), run_ranks(tp_blocks, 2, (mlp, attn, x, H),
                                     timeout=120)


@pytest.mark.parametrize("kind", ["mlp", "attention"])
@pytest.mark.parametrize("mode", ["sync_a", "sync_b"])
def test_tp_blocks_match_the_reference_blocks(group, kind, mode):
    (mlp, attn, x), ranks = group
    want = (np.asarray(jtp.mlp_reference(mlp, x)) if kind == "mlp"
            else np.asarray(jtp.attention_reference(attn, x, n_heads=H)))
    for r in ranks:
        np.testing.assert_allclose(r["blocks"][(kind, mode)], want,
                                   rtol=TOL, atol=TOL)


def test_tp_block_collective_counts(group):
    """Sync B: the Gather's one all-reduce; Sync A: an all-gather per
    partitioned activation besides (1 in the MLP, q/k/v in attention)."""
    for r in group[1]:
        assert r["counts"] == {
            ("mlp", "sync_b"): {"all_reduce": 1},
            ("attention", "sync_b"): {"all_reduce": 1},
            ("mlp", "sync_a"): {"all_gather": 1, "all_reduce": 1},
            ("attention", "sync_a"): {"all_gather": 3, "all_reduce": 1},
        }


def test_shard_params_slices(group):
    (mlp, attn, _), ranks = group
    full = {**mlp, **attn}
    for rank, r in enumerate(ranks):
        for name, w in full.items():
            dims = tp.PartitionPlan().spec_for(name).dims
            dim = dims.index("model")
            n = w.shape[dim] // 2
            want = np.take(w, range(rank * n, (rank + 1) * n), axis=dim)
            np.testing.assert_array_equal(r["shards"][name], want)


def test_mesh_layout_and_broadcast(group):
    for rank, r in enumerate(group[1]):
        assert r["layout"] == {"data": ({"data": 2, "model": 1}, rank),
                               "model": ({"data": 1, "model": 2}, rank)}
        assert r["broadcast"] == [1.0, 1.0, 1.0]       # rank 0's bf16
