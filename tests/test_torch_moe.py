"""The port's MoE FFN (``repro_torch.models.moe``) vs the JAX reference.

The reference's ``init_moe`` draws the weights; they cross through the
weight bridge, and the same seeded numpy inputs go through both
packages' ``moe_dense``, ``moe_scatter`` and ``moe``: silu and gelu
experts, E in {4, 16}, k in {1, 2}, capacity factors that drop tokens
(0.5, 1.25) and one that drops none (8.0), with rows that padding left
at zero (every expert equally likely: a tie the top-k must break toward
the lower expert index, as ``jax.lax.top_k`` does).

* Routing is compared **exactly**: the top-k expert ids, and which
  assignments the capacity keeps (the reference's ``keep``, recomputed
  here in numpy from its ids by the lines of ``moe_scatter``).
* Outputs and the aux loss within 2e-5 (float32; only the summation
  order differs), the tolerance of the port's other parity tests.
* The router is float32 under a bf16 model, in both packages.
* ``quantize_serving_params`` leaves a reduced Phi-3.5-MoE's expert
  stacks dense and quantizes the same leaves as the reference's policy.
* The model's layer loop sums the layers' aux losses as the reference's
  ``_run_layers`` does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.models import reduced_config as jreduced
from repro.quant import policy as jpolicy
from repro_torch.models import moe as tmoe
from repro_torch.models.weights import params_from_numpy
from repro_torch.quant import policy as tpolicy

TOL = dict(rtol=2e-5, atol=2e-5)
D, F_ = 32, 48


def _params(E, act, dtype=jnp.float32, seed=0):
    """(reference params, port params) of one MoE layer."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), D, F_, E, act, dtype)
    tree = jax.tree.map(np.asarray, jp)
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _inputs(seed, B=3, S=11, zero_rows=(0, 5)):
    """x (B, S, D) float32; the listed flat rows set to zero (padding)."""
    x = np.random.default_rng(seed).normal(0, 1, (B, S, D)).astype(
        np.float32)
    x.reshape(-1, D)[list(zero_rows)] = 0.0
    return x


def _ref_keep(topi, E, cf):
    """The reference ``moe_scatter``'s ``keep`` from its expert ids, line
    for line in numpy."""
    T, k = topi.shape
    e_flat = topi.reshape(-1)
    onehot = np.eye(E, dtype=np.int32)[e_flat]
    pos = np.cumsum(onehot, axis=0) - onehot
    pos_in_e = (pos * onehot).sum(-1)
    capacity = max(int(T * k / E * cf), k)
    return pos_in_e < capacity, capacity


CASES = [(act, E, k, cf) for act in ("silu", "gelu") for E in (4, 16)
         for k in (1, 2) for cf in (0.5, 1.25, 8.0)]


@pytest.mark.parametrize("act,E,k,cf", CASES)
def test_scatter_routing_outputs_and_aux_match_the_reference(act, E, k, cf):
    jp, tp = _params(E, act, seed=E + k)
    x = _inputs(seed=E * 10 + k)
    _, _, jtopv, jtopi = jmoe._router(jp, jnp.asarray(x.reshape(-1, D)), k)
    _, _, ttopv, ttopi = tmoe._router(tp, torch.from_numpy(x.reshape(-1, D)),
                                      k)
    np.testing.assert_array_equal(ttopi.numpy(), np.asarray(jtopi))
    np.testing.assert_allclose(ttopv.numpy(), np.asarray(jtopv), **TOL)
    # the zero rows tie every expert: the lowest k ids win, in order
    for row in (0, 5):
        assert ttopi[row].tolist() == list(range(k))
    want_keep, want_cap = _ref_keep(np.asarray(jtopi), E, cf)
    cap, slot, keep = tmoe.moe_routing(ttopi, E, cf)
    assert cap == want_cap
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert bool((slot[~keep] == E * cap).all())
    if cf == 8.0:
        assert bool(keep.all())
    elif cf == 0.5:
        assert not bool(keep.all())          # this case drops tokens
    jy, jaux = jmoe.moe_scatter(jp, jnp.asarray(x), k=k, act=act,
                                capacity_factor=cf)
    ty, taux = tmoe.moe_scatter(tp, torch.from_numpy(x), k=k, act=act,
                                capacity_factor=cf)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)


@pytest.mark.parametrize("act,E,k", [(a, E, k) for a in ("silu", "gelu")
                                     for E in (4, 16) for k in (1, 2)])
def test_dense_oracle_and_dispatch_match_the_reference(act, E, k):
    """``moe_dense`` against the reference's, and ``moe`` dispatching both
    implementations; with no token dropped the scatter path equals the
    dense oracle; ``with_aux=False`` gives the same output and 0.0."""
    jp, tp = _params(E, act, seed=3 * E + k)
    x = _inputs(seed=E + 7 * k)
    jy, jaux = jmoe.moe_dense(jp, jnp.asarray(x), k=k, act=act)
    ty, taux = tmoe.moe_dense(tp, torch.from_numpy(x), k=k, act=act)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)
    for impl in ("dense", "scatter"):
        jy2, _ = jmoe.moe(jp, jnp.asarray(x), k=k, act=act, impl=impl,
                          capacity_factor=8.0)
        ty2, _ = tmoe.moe(tp, torch.from_numpy(x), k=k, act=act, impl=impl,
                          capacity_factor=8.0)
        np.testing.assert_allclose(ty2.numpy(), np.asarray(jy2), **TOL)
        np.testing.assert_allclose(ty2.numpy(), ty.numpy(), **TOL)
        ty3, aux3 = tmoe.moe(tp, torch.from_numpy(x), k=k, act=act,
                             impl=impl, capacity_factor=8.0, with_aux=False)
        assert aux3 == 0.0                   # skipped, not computed
        np.testing.assert_array_equal(ty3.numpy(), ty2.numpy())
    with pytest.raises(ValueError, match="unknown moe impl"):
        tmoe.moe(tp, torch.from_numpy(x), k=k, act=act, impl="sorted")


def test_tied_router_columns_route_to_the_lower_expert():
    """Two experts with the same router column tie on every token: both
    packages pick the lower id first; so do all-zero rows and duplicated
    rows, and the drops that follow from the ties agree."""
    E, k, cf = 8, 2, 1.25
    jp, _ = _params(E, "silu", seed=11)
    tree = jax.tree.map(np.array, jp)
    tree["router"][:, 5] = tree["router"][:, 2]
    tree["router"][:, 6] = tree["router"][:, 1]
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, "cpu")
    x = _inputs(seed=12, zero_rows=(1, 2, 3, 9))
    x.reshape(-1, D)[20] = x.reshape(-1, D)[4]
    x2d = x.reshape(-1, D)
    _, _, _, jtopi = jmoe._router(jp, jnp.asarray(x2d), k)
    _, probs, _, ttopi = tmoe._router(tp, torch.from_numpy(x2d), k)
    np.testing.assert_array_equal(ttopi.numpy(), np.asarray(jtopi))
    assert bool((probs[:, 5] == probs[:, 2]).all())
    top1 = ttopi[:, 0]
    assert not bool((top1 == 5).any()) and not bool((top1 == 6).any())
    assert ttopi[20].tolist() == ttopi[4].tolist()
    want_keep, _ = _ref_keep(np.asarray(jtopi), E, cf)
    _, _, keep = tmoe.moe_routing(ttopi, E, cf)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    jy, _ = jmoe.moe_scatter(jp, jnp.asarray(x), k=k, act="silu",
                             capacity_factor=cf)
    ty, _ = tmoe.moe_scatter(tp, torch.from_numpy(x), k=k, act="silu",
                             capacity_factor=cf)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_router_is_float32_under_bf16():
    """bf16 experts, f32 router, in both packages' init; the port's own
    init draws the same tree structure and dtypes; a bf16 forward routes
    in f32 and keeps x's dtype."""
    jp, tp = _params(16, "silu", dtype=jnp.bfloat16)
    assert jp["router"].dtype == jnp.float32
    assert tp["router"].dtype == torch.float32
    assert tp["w_up"].dtype == torch.bfloat16
    mine = tmoe.init_moe(torch.Generator().manual_seed(0), D, F_, 16,
                         "silu", torch.bfloat16, lead=(3,))
    assert set(mine) == set(tp)
    for name, leaf in tp.items():
        assert mine[name].dtype == leaf.dtype, name
        assert tuple(mine[name].shape) == (3,) + tuple(leaf.shape), name
    assert "w_gate" not in tmoe.init_moe(
        torch.Generator().manual_seed(0), D, F_, 4, "gelu", torch.float32)
    x = _inputs(seed=5)
    jy, _ = jmoe.moe_scatter(jp, jnp.asarray(x, jnp.bfloat16), k=2,
                             act="silu")
    ty, _ = tmoe.moe_scatter(tp, torch.from_numpy(x).to(torch.bfloat16),
                             k=2, act="silu")
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_q4_policy_leaves_expert_stacks_dense():
    """A reduced Phi-3.5-MoE tree under both packages' Q4_0 policy: the
    attention projections are quantized, the router and the expert
    stacks stay dense, and both count the same quantized leaves."""
    cfg = jreduced(jget_config("phi3.5-moe-42b-a6.6b"))
    tree = jax.tree.map(np.asarray,
                        jbuild(cfg).init(jax.random.PRNGKey(0)))
    jq = jpolicy.quantize_serving_params(jax.tree.map(jnp.asarray, tree))
    tq = tpolicy.quantize_serving_params(params_from_numpy(tree, "cpu"))
    n = tpolicy.count_q4_leaves(tq)
    assert n == jpolicy.count_q4_leaves(jq) == 4
    for name in ("w_q", "w_k", "w_v", "w_o"):
        assert tpolicy.is_q4_leaf(tq["layers"]["attn"][name])
    moe_p = tq["layers"]["moe"]
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert isinstance(moe_p[name], torch.Tensor), name
    assert moe_p["router"].dtype == torch.float32
    assert moe_p["w_up"].shape == (cfg.n_layers, cfg.n_experts, cfg.d_model,
                                   cfg.d_ff)
    assert moe_p["w_down"].shape == (cfg.n_layers, cfg.n_experts, cfg.d_ff,
                                     cfg.d_model)


def test_reduced_moe_and_ssd_configs_match_the_reference():
    """``reduced_config`` caps the experts at 4 and keeps top-2 and the
    softcap, and sets the SSD widths, field for field as the
    reference's."""
    from repro.models import ModelConfig as JModelConfig
    from repro_torch.configs import get_config
    from repro_torch.models import reduced_config
    for arch in ("phi3.5-moe-42b-a6.6b", "grok-1-314b", "mamba2-370m"):
        j, t = jreduced(jget_config(arch)), reduced_config(get_config(arch))
        for f in dataclasses.fields(JModelConfig):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.layer_kinds == j.layer_kinds
    assert get_config("phi3.5-moe-42b-a6.6b").n_experts == 16
    assert get_config("grok-1-314b").n_experts == 8
    for arch in ("phi3.5-moe-42b-a6.6b", "grok-1-314b"):
        t = reduced_config(get_config(arch))
        assert (t.n_experts, t.experts_per_token) == (4, 2)
    assert reduced_config(get_config("grok-1-314b")).attn_logit_softcap == 30
    m = reduced_config(get_config("mamba2-370m"))
    assert (m.ssm_heads, m.ssm_head_dim, m.ssm_state, m.ssm_chunk) == (
        4, 32, 16, 8)
    assert m.layer_kinds == ("ssd", "ssd")


def test_stack_aux_loss_is_summed_as_the_reference():
    """The layer loop of a reduced Phi-3.5-MoE over a ring cache returns
    the hidden states and, with ``with_aux``, the router aux loss summed
    over its layers, as the reference's ``_run_layers`` does; without it
    (the serving steps) the same hidden states and 0.0; a dense stack's
    is 0."""
    from repro.models import ModelConfig as JModelConfig
    from repro_torch.models import ModelConfig, build_model
    jcfg = dataclasses.replace(jreduced(jget_config("phi3.5-moe-42b-a6.6b")),
                               dtype=jnp.float32)
    jm = jbuild(jcfg)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JModelConfig)}
    fields["dtype"] = torch.float32
    tm = build_model(ModelConfig(**fields))
    tparams = params_from_numpy(tree, "cpu")
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 9))
    jparams = jax.tree.map(jnp.asarray, tree)
    jx = jnp.take(jparams["embed"], jnp.asarray(toks), axis=0)
    jout, _, jaux = jm._run_layers(jparams, jx, jnp.arange(9),
                                   jm.init_cache(2, 16)["layers"], None,
                                   causal=True)
    tx = tparams["embed"][torch.from_numpy(toks)]
    ring = {"q_pos": None, "single_step": False, "impl": "auto"}
    tout, taux = tm._run_layers(tparams, tx, torch.arange(9),
                                tm.init_cache(2, 16, device="cpu")["layers"],
                                window_override=None, ring=ring,
                                with_aux=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    assert float(jaux) > 0
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)
    sout, saux = tm._run_layers(tparams, tx, torch.arange(9),
                                tm.init_cache(2, 16, device="cpu")["layers"],
                                window_override=None, ring=ring)
    assert saux == 0.0
    np.testing.assert_array_equal(sout.numpy(), tout.numpy())
    dense = build_model(dataclasses.replace(tm.cfg, n_experts=0))
    dparams = dense.init(torch.Generator().manual_seed(0))
    _, daux = dense._run_layers(
        dparams, tx, torch.arange(9),
        dense.init_cache(2, 16, device="cpu")["layers"],
        window_override=None, ring=ring, with_aux=True)
    assert daux == 0.0
