"""The port's training forward and its gradients vs the JAX reference.

Weights come from the reference ``Model.init`` and cross through the
weight bridge; every leaf the init leaves at zero (norm gains, biases,
the cross-attention gates) is drawn nonzero first (:func:`live_tree`),
since a zero gate would switch a cross-attention layer off and hide its
gradients.  The same numpy batch (seeded tokens, labels with ignored
positions, and the image or audio stubs) goes through the reference's
``jax.value_and_grad(Model.loss)`` and the port's ``Model.loss`` with
``torch.autograd``, in float32, for reduced configs of every layer kind:
dense Qwen3, Gemma-3's local/global windows, Phi-3.5-MoE at capacity
factor 4.0 with its router aux loss, RecurrentGemma in the block layout
with a tail, Mamba-2, Llama-3.2-Vision's cross-attention and Whisper's
encoder.  Also: ``cross_entropy``, the chunked loss against the dense
one, ``cfg.remat`` against no remat (bit for bit), and the RG-LRU scan's
``torch.autograd.Function`` (``gradcheck`` in float64 on its plain path,
and its gradient, alone and inside ``models.recurrent.rglru_scan`` with
its gates and a carried state, against ``jax.grad`` of the reference).

Tolerances (float32; only summation order differs, and the reference's
associative scan rounds otherwise than the port's sequential one): the
loss within LOSS_RTOL relative, each gradient leaf within GRAD_RTOL of
its own largest |g| (measured: 1.4e-6 to 1.0e-5, the largest on the
RG-LRU block), the scan's gradient within SCAN_GRAD_TOL.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ref as jkref
from repro.models import ModelConfig as JModelConfig
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro.models import reduced_config as jreduced
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tkref
from repro_torch.models import ModelConfig, build_model
from repro_torch.models import common as tcommon
from repro_torch.models.weights import params_from_numpy, tree_leaves_with_path

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
SCAN_GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def port_cfg(jcfg, dtype=torch.float32):
    """The port's ModelConfig with every field of the reference's."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JModelConfig)}
    fields["dtype"] = dtype
    return ModelConfig(**fields)


def live_tree(tree, seed=5):
    """``tree`` (numpy leaves) with every all-zero leaf drawn from
    N(0, 0.3) in its own shape and dtype, in jax's leaf order; the
    cross-attention gates so drawn keep their layers on."""
    rng = np.random.default_rng(seed)

    def live(_path, x):
        if np.any(x):
            return x
        return rng.normal(0, 0.3, np.shape(x)).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(live, tree)


def _key(path):
    return tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)


def jax_leaves(tree):
    """{port path tuple: numpy leaf} of a reference tree."""
    return {_key(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def make_batch(jcfg, B=2, S=12, seed=3):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -100                       # ignored positions
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)).astype(
        np.int32), "labels": labels}
    if jcfg.is_encoder_decoder:
        batch["frames"] = rng.normal(
            0, 1, (B, jcfg.n_audio_frames, jcfg.d_model)).astype(np.float32)
    if jcfg.cross_attn_every:
        batch["image_embeds"] = rng.normal(
            0, 1, (B, jcfg.n_image_tokens, jcfg.d_model)).astype(np.float32)
    return batch


def port_loss_and_grads(tm, tparams, batch):
    leaves = [t for _, t in tree_leaves_with_path(tparams)]
    for t in leaves:
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = tm.loss(tparams, tb)
    grads = torch.autograd.grad(loss, leaves)
    paths = [p for p, _ in tree_leaves_with_path(tparams)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(paths, grads)))


def _reduced(arch, **kw):
    return dataclasses.replace(jreduced(jget_config(arch)), dtype=jnp.float32,
                               capacity_factor=4.0, **kw)


#: one reduced config of every layer kind; RecurrentGemma at 7 layers
#: keeps the block layout (two (R, R, A) blocks) and a tail layer
CONFIGS = {
    "qwen3": lambda: _reduced("qwen3-1.7b"),
    "gemma3-windows": lambda: dataclasses.replace(
        jreduced(jget_config("gemma3-1b"), n_layers=6, d_model=64),
        dtype=jnp.float32),
    "phi3.5-moe": lambda: _reduced("phi3.5-moe-42b-a6.6b"),
    "recurrentgemma-blocks": lambda: _reduced("recurrentgemma-2b",
                                              n_layers=7),
    "mamba2": lambda: _reduced("mamba2-370m"),
    "llama-vision-xattn": lambda: _reduced("llama-3.2-vision-11b"),
    "whisper-encoder": lambda: _reduced("whisper-medium"),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_gradients_match_the_reference(name):
    jcfg = CONFIGS[name]()
    jm = jbuild(jcfg)
    tree = live_tree(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))))
    batch = make_batch(jcfg)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jax.tree.map(jnp.asarray, tree))
    tm = build_model(port_cfg(jcfg))
    tloss, tmet, tgrads = port_loss_and_grads(
        tm, params_from_numpy(tree, "cpu"), batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tmet["aux"]), float(jmet["aux"]),
                               rtol=LOSS_RTOL, atol=1e-7)
    if name == "phi3.5-moe":
        assert float(tmet["aux"]) > 0           # the aux loss is on
    want = jax_leaves(jgrads)
    assert set(want) == set(tgrads)
    for path, g in tgrads.items():
        w = want[path]
        scale = max(np.abs(w).max(), 1e-12)
        err = np.abs(g.numpy() - w).max() / scale
        assert err <= GRAD_RTOL, (path, err)


def test_cross_entropy_matches_the_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (3, 7, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[1, 2:5] = -100
    want = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = tcommon.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # every label ignored: the mean is over max(count, 1), so 0
    none = tcommon.cross_entropy(torch.from_numpy(logits),
                                 torch.full((3, 7), -100))
    assert float(none) == 0.0


def test_chunked_loss_matches_dense_cross_entropy():
    """A sequence longer than LOSS_CHUNK (and not a multiple of it) gives
    the loss of the full logits."""
    jcfg = CONFIGS["qwen3"]()
    tm = build_model(port_cfg(jcfg))
    tm.LOSS_CHUNK = 8
    gen = torch.Generator().manual_seed(0)
    params = tm.init(gen)
    toks = torch.randint(0, jcfg.vocab_size, (2, 19), generator=gen)
    batch = {"tokens": toks, "labels": toks}
    _, metrics = tm.loss(params, batch)
    logits, _ = tm.forward(params, batch)
    want = tcommon.cross_entropy(logits, toks)
    np.testing.assert_allclose(float(metrics["ce"]), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", ["qwen3", "recurrentgemma-blocks",
                                  "llama-vision-xattn"])
def test_remat_matches_no_remat(name):
    """``cfg.remat`` (each layer, or each super-block, checkpointed)
    gives the gradients of the plain backward bit for bit: the same
    operations are recomputed on the same inputs."""
    jcfg = CONFIGS[name]()
    batch = make_batch(jcfg, seed=4)
    tree = live_tree(jax.tree.map(np.asarray,
                                  jbuild(jcfg).init(jax.random.PRNGKey(1))))
    out = {}
    for remat in (False, True):
        tm = build_model(port_cfg(dataclasses.replace(jcfg, remat=remat)))
        out[remat] = port_loss_and_grads(tm, params_from_numpy(tree, "cpu"),
                                         batch)
    assert float(out[True][0]) == float(out[False][0])
    for path, g in out[False][2].items():
        assert torch.equal(out[True][2][path], g), path


def test_training_views_unbind_each_stack_once():
    """On the training path a stacked leaf is split by one ``unbind`` a
    forward: its gradient arrives through one ``stack`` backward, not one
    zero-filled copy of the stack per layer."""
    jcfg = CONFIGS["qwen3"]()
    tm = build_model(port_cfg(jcfg))
    params = tm.init(torch.Generator().manual_seed(0))
    w = params["layers"]["attn"]["w_q"].requires_grad_(True)
    toks = torch.zeros((1, 4), dtype=torch.long)
    loss, _ = tm.loss(params, {"tokens": toks, "labels": toks})
    seen, todo, users = set(), [loss.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for f, _ in fn.next_functions:
            if getattr(f, "variable", None) is w:    # w's AccumulateGrad
                users.append(type(fn).__name__)
            todo.append(f)
    assert users == ["UnbindBackward0"], users
    (g,) = torch.autograd.grad(loss, [w])
    assert g.shape == w.shape and bool(g.abs().sum() > 0)


# ----------------------------------------------------------------------
# the RG-LRU scan's autograd Function
# ----------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_function_passes_gradcheck(with_h0):
    gen = torch.Generator().manual_seed(0)
    a = (0.5 + 0.5 * torch.rand(2, 9, 5, generator=gen,
                                dtype=torch.float64)).requires_grad_()
    u = torch.randn(2, 9, 5, generator=gen,
                    dtype=torch.float64).requires_grad_()
    if with_h0:
        h0 = torch.randn(2, 5, generator=gen,
                         dtype=torch.float64).requires_grad_()
        assert torch.autograd.gradcheck(
            lambda a_, u_, h_: ops.rglru_linear_scan(a_, u_, h_),
            (a, u, h0))
    else:
        assert torch.autograd.gradcheck(
            lambda a_, u_: ops.rglru_linear_scan(a_, u_), (a, u))


@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_gradient_matches_jax_grad_of_the_reference(with_h0):
    rng = np.random.default_rng(2)
    B, T, W = 3, 37, 8
    a = (0.5 + 0.5 * rng.random((B, T, W))).astype(np.float32)
    u = rng.normal(0, 1, (B, T, W)).astype(np.float32)
    h0 = rng.normal(0, 1, (B, W)).astype(np.float32) if with_h0 else None
    g = rng.normal(0, 1, (B, T, W)).astype(np.float32)

    def jloss(a_, u_, h_):
        return jnp.sum(jkref.rglru_scan_ref(a_, u_, h_) * g)

    argnums = (0, 1, 2) if with_h0 else (0, 1)
    want = jax.grad(jloss, argnums=argnums)(
        jnp.asarray(a), jnp.asarray(u),
        None if h0 is None else jnp.asarray(h0))
    ins = [torch.from_numpy(x).requires_grad_()
           for x in (a, u) + ((h0,) if with_h0 else ())]
    h = ops.rglru_linear_scan(*ins[:2], ins[2] if with_h0 else None)
    got = torch.autograd.grad((h * torch.from_numpy(g)).sum(), ins)
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w),
                                   **SCAN_GRAD_TOL)


def test_rglru_scan_layer_gradient_matches_jax_grad():
    """``models.recurrent.rglru_scan`` (the gates, then the scan, with a
    carried state) differentiated in both packages: the gradients of the
    gates' parameters, its input and h0."""
    from repro.models import recurrent as jrec
    from repro_torch.models import recurrent as trec
    rng = np.random.default_rng(6)
    B, T, W = 2, 21, 16
    block = live_tree(jax.tree.map(np.asarray, jrec.init_rglru_block(
        jax.random.PRNGKey(3), W, W, 4, jnp.float32)), seed=8)
    params = {k: block[k] for k in ("w_a", "b_a", "w_i", "b_i", "Lambda")}
    x = rng.normal(0, 1, (B, T, W)).astype(np.float32)
    h0 = rng.normal(0, 1, (B, W)).astype(np.float32)
    gy = rng.normal(0, 1, (B, T, W)).astype(np.float32)
    gh = rng.normal(0, 1, (B, W)).astype(np.float32)

    def jloss(p, x_, h_):
        y, hT = jrec.rglru_scan(p, x_, h_)
        return jnp.sum(y * gy) + jnp.sum(hT * gh)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(h0))
    tp = params_from_numpy(params, "cpu")
    leaves = [t.requires_grad_() for _, t in tree_leaves_with_path(tp)]
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(h0).requires_grad_()
    y, hT = trec.rglru_scan(tp, tx, th)
    loss = (y * torch.from_numpy(gy)).sum() + (hT * torch.from_numpy(gh)).sum()
    got = torch.autograd.grad(loss, leaves + [tx, th])
    wl = jax_leaves(want[0])
    pairs = [(wl[p], g) for (p, _), g in zip(tree_leaves_with_path(tp), got)]
    pairs += [(np.asarray(want[1]), got[-2]), (np.asarray(want[2]), got[-1])]
    for w, g in pairs:
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w).max())


def test_reverse_scan_plain_version_is_the_backward_loop():
    """``rglru_scan_reverse_ref`` is c[t] = a[t+1] * c[t+1] + g[t] run
    backwards, each step a product and then a sum (bit for bit)."""
    gen = torch.Generator().manual_seed(1)
    a = torch.rand(2, 11, 6, generator=gen)
    g = torch.randn(2, 11, 6, generator=gen)
    c = torch.zeros(2, 6)
    want = torch.empty_like(g)
    for t in range(10, -1, -1):
        a_next = a[:, t + 1] if t + 1 < 11 else torch.zeros(2, 6)
        c = a_next * c + g[:, t]
        want[:, t] = c
    assert torch.equal(tkref.rglru_scan_reverse_ref(a, g), want)
