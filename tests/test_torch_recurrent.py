"""The port's RG-LRU block vs the JAX reference (``repro.models.recurrent``).

The same numpy-seeded inputs and the reference's ``init_rglru_block``
parameters (bridged leaf by leaf) go through both packages: the causal
conv with and without a carried tail, the gates, the scan's plain
version (``repro_torch.kernels.ref.rglru_scan_ref``, the CPU path of
``ops.rglru_linear_scan``) against the reference's associative-scan
oracle and its model-zoo scan, the decode step and the whole block
(prefill, then single steps on the carried state).

Tolerance: float32 throughout.  The conv, gates and step are the same
operations in the same order (1e-6).  The scan is sequential in the
port and an associative (tree) scan in the reference, so its products
round differently: 2e-5 absolute and relative, the model tests' bound,
covers T = 128 at these widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import recurrent as jrec
from repro.models.ssm import _causal_conv as j_causal_conv
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import recurrent as trec
from repro_torch.models.ssm import _causal_conv as t_causal_conv
from repro_torch.models.weights import params_from_numpy

EXACT = dict(rtol=1e-6, atol=1e-6)
SCAN = dict(rtol=2e-5, atol=2e-5)


def _params(d=16, width=24, conv=4, seed=0):
    jp = jrec.init_rglru_block(jax.random.PRNGKey(seed), d, width, conv,
                               jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    return jp, params_from_numpy(tree, "cpu")


def _rand(shape, seed, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(a)


def test_lambda_crosses_as_float32_and_init_matches_the_reference():
    jp, tp = _params()
    assert tp["Lambda"].dtype == torch.float32
    assert set(tp) == set(jp)
    gen = torch.Generator().manual_seed(0)
    mine = trec.init_rglru_block(gen, 16, 24, 4, torch.float32, lead=(3,))
    assert set(mine) == set(jp)
    for name, leaf in mine.items():
        assert leaf.shape == (3,) + tuple(jp[name].shape), name
    # Griffin's init: a = sigmoid(Lambda) ** 8 lies in (0.9, 0.999)
    a = torch.sigmoid(mine["Lambda"]) ** 8
    assert bool(((a > 0.9) & (a < 0.999)).all())


@pytest.mark.parametrize("with_tail", [False, True])
@pytest.mark.parametrize("T", [1, 5])
def test_causal_conv_matches_the_reference(with_tail, T):
    x, w, b = _rand((2, T, 6), 1), _rand((4, 6), 2), _rand((6,), 3)
    tail = _rand((2, 3, 6), 4) if with_tail else None
    jy, jt = j_causal_conv(*(jnp.asarray(a) for a in (x, w, b)),
                           None if tail is None else jnp.asarray(tail))
    ty, tt = t_causal_conv(*(torch.from_numpy(a) for a in (x, w, b)),
                           None if tail is None else torch.from_numpy(tail))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **EXACT)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **EXACT)


@pytest.mark.parametrize("shape", [(2, 5, 24), (3, 24)])
def test_gates_match_the_reference(shape):
    jp, tp = _params()
    jx, tx = _both(_rand(shape, 5))
    ja, ju = jrec._gates(jp, jx)
    ta, tu = trec._gates(tp, tx)
    assert ta.dtype == tu.dtype == torch.float32
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **EXACT)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **EXACT)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("T", [1, 7, 37, 128])
def test_plain_scan_matches_both_reference_scans(with_h0, T):
    """The scan's plain version against the reference's associative-scan
    oracle on the same (a, u, h0), and the port's model-zoo
    ``rglru_scan`` (gates + ``ops.rglru_linear_scan``) against the
    reference's on the same parameters and input."""
    B, W = 2, 24
    a, u = _rand((B, T, W), 6, 0.5, 1.0), _rand((B, T, W), 7)
    h0 = _rand((B, W), 8) if with_h0 else None
    want = jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(u),
                               None if h0 is None else jnp.asarray(h0))
    got = tref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(u),
                              None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN)
    via_ops = ops.rglru_linear_scan(
        torch.from_numpy(a), torch.from_numpy(u),
        None if h0 is None else torch.from_numpy(h0))
    assert torch.equal(via_ops, got)

    jp, tp = _params()
    jx, tx = _both(_rand((B, T, W), 9))
    jh0 = None if h0 is None else jnp.asarray(h0)
    th0 = None if h0 is None else torch.from_numpy(h0)
    jy, jh = jrec.rglru_scan(jp, jx, jh0)
    ty, th = trec.rglru_scan(tp, tx, th0)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SCAN)
    ty_ref, _ = trec.rglru_scan(tp, tx, th0, impl="ref")
    assert torch.equal(ty_ref, ty)


def test_step_matches_the_reference():
    jp, tp = _params()
    jx, tx = _both(_rand((3, 24), 10))
    jh, th = _both(_rand((3, 24), 11))
    jo, jn = jrec.rglru_step(jp, jx, jh)
    to, tn = trec.rglru_step(tp, tx, th)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **EXACT)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **EXACT)


def test_block_prefill_then_steps_matches_the_reference():
    """Prefill 7 tokens, then 5 single steps on the carried state; every
    output and the final state (h, conv tail) agree, and the port's
    steps continue its own scan (the reference's own identity)."""
    jp, tp = _params(seed=2)
    x = _rand((2, 12, 16), 12)
    jy, jst = jrec.rglru_block(jp, jnp.asarray(x[:, :7]))
    ty, tst = trec.rglru_block(tp, torch.from_numpy(x[:, :7]))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN)
    outs = [ty]
    for t in range(7, 12):
        jy, jst = jrec.rglru_block(jp, jnp.asarray(x[:, t:t + 1]),
                                   state=jst, single_step=True)
        ty, tst = trec.rglru_block(tp, torch.from_numpy(x[:, t:t + 1]),
                                   state=tst, single_step=True)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN)
        outs.append(ty)
    np.testing.assert_allclose(tst.h.numpy(), np.asarray(jst.h), **SCAN)
    np.testing.assert_allclose(tst.conv.numpy(), np.asarray(jst.conv),
                               **EXACT)
    full, _ = trec.rglru_block(tp, torch.from_numpy(x))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               **SCAN)
