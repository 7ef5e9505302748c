"""The port's Mamba-2 SSD mixer vs the JAX reference (``repro.models.ssm``).

The same numpy-seeded inputs, and the reference's ``init_ssd``
parameters bridged leaf by leaf, go through both packages: ``_segsum``
(its -inf upper triangle included), ``ssd_chunked`` with and without an
initial state and with T not a multiple of the chunk (the zero padding
to a whole chunk), ``ssd_reference`` (the sequential oracle),
``ssd_decode_step``, and ``ssd_block`` over a prompt and then single
tokens on the carried state (the conv tail and the f32 state).

Tolerance: float32 throughout, 2e-5 absolute and relative, the port's
parity bound: both packages compute the same products and exponentials,
and only the einsums' summation order differs.  The chunked form against
the sequential oracle (another association of the same sums) is held to
1e-4 here, in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm
from repro_torch.models.weights import params_from_numpy

TOL = dict(rtol=2e-5, atol=2e-5)
ORACLE = dict(rtol=1e-4, atol=1e-4)
H, P, G, N = 4, 8, 2, 16


def _inputs(seed, B=2, T=20):
    """x (B,T,H,P), dt (B,T,H) post-softplus, A (H,) < 0, Bm, Cm
    (B,T,G,N), and an initial state (B,H,P,N), all float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(-1, 1, (B, T, H)))).astype(np.float32)
    A = -np.exp(np.log(np.linspace(1.0, 16.0, H))).astype(np.float32) / 4
    Bm = rng.normal(0, 1, (B, T, G, N)).astype(np.float32)
    Cm = rng.normal(0, 1, (B, T, G, N)).astype(np.float32)
    s0 = rng.normal(0, 1, (B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def test_segsum_matches_the_reference():
    x = np.random.default_rng(0).normal(0, 1, (2, 3, 8)).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(x)))
    got = tssm._segsum(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3, 8, 8)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[..., 0, 1]).all() and not np.isinf(
        got[..., 1, 0]).any()
    np.testing.assert_allclose(got[np.isfinite(want)],
                               want[np.isfinite(want)], **TOL)
    np.testing.assert_allclose(np.diagonal(got, axis1=-2, axis2=-1), 0.0)


@pytest.mark.parametrize("T,chunk,with_state", [
    (16, 8, False), (16, 8, True), (20, 8, False), (20, 8, True),
    (5, 8, True), (1, 8, True), (37, 16, True)])
def test_ssd_chunked_matches_the_reference(T, chunk, with_state):
    """y and the final state against the reference's ``ssd_chunked``
    (T = 20, 5, 1 and 37 pad to a whole chunk), and both packages'
    chunked form against their sequential oracle."""
    x, dt, A, Bm, Cm, s0 = _inputs(seed=T + chunk, T=T)
    init = s0 if with_state else None
    jy, jst = jssm.ssd_chunked(*_j(x, dt, A, Bm, Cm), chunk=chunk,
                               initial_state=None if init is None
                               else jnp.asarray(init))
    ty, tst = tssm.ssd_chunked(*_t(x, dt, A, Bm, Cm), chunk=chunk,
                               initial_state=None if init is None
                               else torch.from_numpy(init))
    assert ty.shape == x.shape and tst.shape == (x.shape[0], H, P, N)
    assert tst.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)
    ry, rst = tssm.ssd_reference(*_t(x, dt, A, Bm, Cm),
                                 initial_state=None if init is None
                                 else torch.from_numpy(init))
    jry, jrst = jssm.ssd_reference(*_j(x, dt, A, Bm, Cm),
                                   initial_state=None if init is None
                                   else jnp.asarray(init))
    np.testing.assert_allclose(ry.numpy(), np.asarray(jry), **TOL)
    np.testing.assert_allclose(rst.numpy(), np.asarray(jrst), **TOL)
    np.testing.assert_allclose(ty.numpy(), ry.numpy(), **ORACLE)
    np.testing.assert_allclose(tst.numpy(), rst.numpy(), **ORACLE)


def test_ssd_decode_step_matches_the_reference_and_the_oracle():
    x, dt, A, Bm, Cm, s0 = _inputs(seed=3, T=4)
    jstate, tstate = jnp.asarray(s0), torch.from_numpy(s0)
    for t in range(4):
        jy, jstate = jssm.ssd_decode_step(jstate, *_j(
            x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t]))
        ty, tstate = tssm.ssd_decode_step(tstate, *_t(
            x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t]))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(tstate.numpy(), np.asarray(jstate),
                                   **TOL)
    _, rst = tssm.ssd_reference(*_t(x, dt, A, Bm, Cm),
                                initial_state=torch.from_numpy(s0))
    np.testing.assert_allclose(tstate.numpy(), rst.numpy(), **TOL)


def _block_params(seed=0, d=24, chunk=8, dtype=jnp.float32):
    jp = jssm.init_ssd(jax.random.PRNGKey(seed), d, n_heads=H, head_dim=P,
                       d_state=N, n_groups=G, conv_width=4, dtype=dtype)
    tree = jax.tree.map(np.asarray, jp)
    # a zero-initialised gain and bias computes nothing: draw them
    rng = np.random.default_rng(seed + 50)
    for name in ("norm_gain", "conv_b"):
        tree[name] = rng.normal(0, 0.3, tree[name].shape).astype(
            tree[name].dtype)
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def test_ssd_block_with_a_carried_state_matches_the_reference():
    """A 13-token prompt, then three single tokens on the carried state
    (each a chunk padded with zeros, as the reference decodes)."""
    d, chunk = 24, 8
    jp, tp = _block_params(d=d, chunk=chunk)
    kw = dict(n_heads=H, head_dim=P, d_state=N, n_groups=G, chunk=chunk)
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (2, 16, d)).astype(np.float32)
    jy, jst = jssm.ssd_block(jp, jnp.asarray(x[:, :13]), **kw)
    ty, tst = tssm.ssd_block(tp, torch.from_numpy(x[:, :13]), **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for t in range(13, 16):
        jy, jst = jssm.ssd_block(jp, jnp.asarray(x[:, t:t + 1]), state=jst,
                                 **kw)
        ty, tst = tssm.ssd_block(tp, torch.from_numpy(x[:, t:t + 1]),
                                 state=tst, **kw)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(tst.state.numpy(), np.asarray(jst.state),
                                   **TOL)
        np.testing.assert_allclose(tst.conv.numpy(), np.asarray(jst.conv),
                                   **TOL)
    assert tst.state.dtype == torch.float32
    assert tst.conv.shape == (2, 3, H * P + 2 * G * N)
    # the whole sequence in one call ends in the same state (the input
    # projection of 16 rows against 1 may round apart: the conv tail to
    # the parity bound)
    _, whole = tssm.ssd_block(tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(whole.state.numpy(), tst.state.numpy(),
                               **ORACLE)
    np.testing.assert_allclose(whole.conv.numpy(), tst.conv.numpy(), **TOL)


def test_init_ssd_matches_the_reference_layout():
    """Leaf names, shapes and dtypes of the port's own init equal the
    reference's (bf16 model: A_log, D and dt_bias stay float32), and the
    drawn dt_bias maps to dt in [1e-3, 1e-1] through softplus."""
    jp, tp = _block_params(dtype=jnp.bfloat16)
    mine = tssm.init_ssd(torch.Generator().manual_seed(0), 24, n_heads=H,
                         head_dim=P, d_state=N, n_groups=G, conv_width=4,
                         dtype=torch.bfloat16, lead=(3,))
    assert set(mine) == set(tp) == set(jp)
    for name, leaf in tp.items():
        assert mine[name].dtype == leaf.dtype, name
        assert tuple(mine[name].shape) == (3,) + tuple(leaf.shape), name
    for name in ("A_log", "D", "dt_bias"):
        assert tp[name].dtype == torch.float32
    np.testing.assert_allclose(mine["A_log"][1].numpy(),
                               np.asarray(jp["A_log"]), **TOL)
    dt = F.softplus(mine["dt_bias"])
    assert bool((dt >= 1e-3 * 0.999).all() and (dt <= 1e-1 * 1.001).all())
