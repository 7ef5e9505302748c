"""The encoder-decoder stack in the port vs the reference: Whisper.

Reduced Whisper-medium (2 encoder and 2 decoder layers, LayerNorm with
biases, GELU, tied embeddings) on the reference's ``Model.init`` weights
with every decoder cross-attention ``gate`` drawn nonzero first
(``test_torch_xattn.live_gates``): at ``gate = 0`` the decoder would
ignore the encoder, and parity would hold with the encoder broken.

Covered: ``_encode`` against the reference's, in float32 and with
bfloat16 weights over float32 frames (jnp promotes the whole encoder to
float32, and so does the port's ``common.matmul``: the memory comes out
float32); ring prefill logits and caches (the memory included) and
teacher-forced decode steps against the reference's; the bucket
engine's greedy tokens with ``Request.extra['frames']`` over two buckets
against the reference engine's; the encoder subtree, the LayerNorm
biases and the decoder's gates through the weight bridge and an
``.npz``, bit for bit, and the port's own init in the same layout.

Tolerances as in ``tests/test_torch_xattn.py``: float32 2e-5; bf16
logits 0.125 absolute.  The encoder over bf16 weights computes in
float32 in both packages, so it keeps the float32 bound.
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
from repro.data import pipeline as jpipeline
from repro.models import build_model as jbuild
from repro.models import reduced_config as jreduced
from repro_torch.models import build_model
from repro_torch.models.weights import (load_params_npz, params_from_numpy,
                                        save_params_npz,
                                        tree_leaves_with_path)
from test_torch_xattn import (TOL, check_run, live_gates, port_cfg,
                              run_both, shared)

ARCH = "whisper-medium"


def _whisper(dtype=jnp.float32):
    return dataclasses.replace(jreduced(jget_config(ARCH)), dtype=dtype)


def _frames(jcfg, B=2, seed=0):
    return jpipeline.stub_frames(B, jcfg.n_audio_frames, jcfg.d_model,
                                 seed=seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_the_reference(dtype):
    """The encoder's output over the same frames; bf16 weights over
    float32 frames give a float32 memory in both packages."""
    jcfg = _whisper(getattr(jnp, dtype))
    jm, jparams, tm, tparams = shared(jcfg, dtype=getattr(torch, dtype))
    frames = _frames(jcfg)
    got = tm._encode(tparams, torch.from_numpy(frames))
    want = jm._encode(jparams, jnp.asarray(frames))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert got.shape == (2, jcfg.n_audio_frames, jcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the encoder is bidirectional: the last frame moves the first output
    moved = frames.copy()
    moved[:, -1] = _frames(jcfg, seed=9)[:, 0]
    other = tm._encode(tparams, torch.from_numpy(moved))
    assert float((other[:, 0] - got[:, 0]).abs().max()) > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_the_reference(dtype):
    """Prefill logits and ring caches (the encoder's float32 memory
    included), four teacher-forced decode steps and the caches after
    them; a decode step over another utterance's memory moves the
    logits."""
    jcfg = _whisper(getattr(jnp, dtype))
    moved = check_run(run_both(jcfg, "frames", _frames(jcfg),
                               getattr(torch, dtype)), dtype == "bfloat16")
    assert moved > 0.1, moved


def test_bucket_engine_with_frames_matches_the_reference_engine():
    """``Request.extra['frames']`` (each request its own draw) over two
    length buckets, so the encoder runs once per bucket: the port's
    ``ServingEngine`` gives the reference engine's greedy tokens; a
    request without frames is refused."""
    jcfg = _whisper()
    jm, jparams, tm, tparams = shared(jcfg, seed=1)
    lens, V = [9, 14, 9, 14], jcfg.vocab_size
    frames = _frames(jcfg, B=len(lens), seed=6)

    def requests(S):
        rng = np.random.default_rng(3)
        sp = S.SamplingParams(max_new_tokens=6)
        return [S.Request(uid=i, prompt=rng.integers(0, V, n).tolist(),
                          sampling=sp, extra={"frames": frames[i]})
                for i, n in enumerate(lens)]

    want = jserving.ServingEngine(jm, jparams, max_len=32).generate(
        requests(jserving), max_batch=2)
    teng = tserving.ServingEngine(tm, tparams, max_len=32, device="cpu")
    encoded = []
    encode = tm._encode
    tm._encode = lambda p, f: encoded.append(f.shape) or encode(p, f)
    got = teng.generate(requests(tserving), max_batch=2)
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert encoded == [(2, jcfg.n_audio_frames, jcfg.d_model)] * 2
    with pytest.raises(ValueError, match="reads 'frames'"):
        teng.generate([tserving.Request(uid=0, prompt=[1, 2])])


def test_weight_bridge_carries_the_encoder_bit_for_bit(tmp_path):
    """The reference's bf16 tree (the stacked encoder layers and its
    final norm, LayerNorm gains and biases, the decoder's ``ln_x`` /
    ``xattn`` with stacked gates) crosses the bridge and an ``.npz`` bit
    for bit, and the port's own init has the same leaves, shapes and
    dtypes, with unit gains and zero biases."""
    jcfg = _whisper(jnp.bfloat16)
    tree = live_gates(jax.tree.map(np.asarray, jbuild(jcfg).init(
        jax.random.PRNGKey(3))))
    raw = dict(tree_leaves_with_path(tree))
    assert np.shape(raw[("layers", "xattn", "gate")]) == (jcfg.n_layers,)
    assert ("encoder", "layers", "xattn", "gate") not in raw
    assert np.shape(raw[("encoder", "layers", "attn", "w_q")])[0] == \
        jcfg.n_encoder_layers
    path = str(tmp_path / "w.npz")
    save_params_npz(tree, path)
    loaded = dict(tree_leaves_with_path(load_params_npz(path, "cpu")))
    bridged = tree_leaves_with_path(params_from_numpy(tree, "cpu"))
    mine = dict(tree_leaves_with_path(build_model(
        port_cfg(jcfg, torch.bfloat16)).init(
            torch.Generator().manual_seed(0))))
    assert len(bridged) == len(loaded) == len(mine) == len(raw)
    for p, t in bridged:
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy().view(np.uint16),
            raw[p].view(np.uint16), err_msg=str(p))
        assert torch.equal(t.view(torch.int16),
                           loaded[p].view(torch.int16)), p
        assert mine[p].dtype == t.dtype and mine[p].shape == t.shape, p
    for p, t in mine.items():
        if p[-2:] in (("final_norm", "g"), ("ln1", "g"), ("ln_x", "g")):
            assert bool((t == 1).all()), p
        if p[-1] == "b":
            assert not t.any(), p
