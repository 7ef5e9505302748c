"""The port's MoE hook (``launch.shardings.make_moe_hook``) on a 2 x 2
(data x model) gloo group against the reference's dense oracle.

Both modes, TP inside the experts (every rank its f-slices of all
experts) and expert-parallel (every rank E/2 whole experts), on each
data rank's rows: the outputs within 1e-4 of the reference's
``moe(impl="dense")`` (f32, the tolerance of
``tests/test_tp_distributed.py``; capacity factor 8.0, so no assignment
drops), and the aux loss equal to the mean over the data ranks of the
reference's aux on each rank's rows.  One spawned group for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_tp_ranks import moe_hook_ranks
from repro.models.moe import init_moe, moe
from repro_torch.launch.mesh import run_ranks

TOL = 1e-4
D, F_, E, K = 16, 32, 8, 2
CFG = dict(name="m", arch_type="moe", n_layers=2, d_model=D, n_heads=2,
           n_kv_heads=1, d_ff=F_, vocab_size=64, n_experts=E,
           experts_per_token=K, capacity_factor=8.0)


@pytest.fixture(scope="module")
def group():
    params = jax.tree.map(np.asarray, init_moe(
        jax.random.PRNGKey(0), D, F_, E, "silu", jnp.float32))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 6, D),
                                     jnp.float32))
    torch.set_num_threads(1)
    return params, x, run_ranks(moe_hook_ranks, 4, (CFG, params, x),
                                timeout=120)


@pytest.mark.parametrize("ep", [False, True], ids=["tp", "ep"])
def test_moe_hook_matches_the_dense_oracle(group, ep):
    params, x, ranks = group
    want, _ = moe(params, jnp.asarray(x), k=K, act="silu", impl="dense")
    want = np.asarray(want)
    for rank, r in enumerate(ranks):
        rows = slice((rank // 2) * 2, (rank // 2) * 2 + 2)   # data index
        np.testing.assert_allclose(r[ep]["y"], want[rows], rtol=TOL,
                                   atol=TOL)
        assert r[ep]["w_up"] == ((E // 2, D, F_) if ep else (E, D, F_ // 2))


@pytest.mark.parametrize("ep", [False, True], ids=["tp", "ep"])
def test_moe_hook_aux_and_collectives(group, ep):
    params, x, ranks = group
    auxes = [float(moe(params, jnp.asarray(x[i:i + 2]), k=K, act="silu",
                       impl="scatter", capacity_factor=8.0)[1])
             for i in (0, 2)]
    for r in ranks:
        assert r[ep]["aux"] == pytest.approx(np.mean(auxes), rel=1e-6)
        # one all-reduce over "model" (the Gather), one over "data" (aux)
        assert r[ep]["counts"] == {"all_reduce": 2}

