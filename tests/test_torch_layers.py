"""Port layers vs the JAX reference on the same inputs (CPU, float32).

Inputs come from ``np.random.default_rng(seed)`` and go through both the
``repro`` function and its ``repro_torch`` counterpart.  Tolerance: both
compute in float32 from the same float32 inputs; only the summation
order differs (XLA vs ATen kernels), so 1e-5 absolute/relative covers
it at these widths (values are O(1)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 4, 16)])
def test_rms_norm(shape):
    x, g = _rand(shape, 0), _rand(shape[-1:], 1, 0.1)
    _close(tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(g)),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(g)))


def test_rms_norm_bf16_casts_before_gain():
    """bf16: the normalised x is rounded to bf16 before ``(1 + gain)``;
    the port must round at the same place, so the bits agree."""
    x, g = _rand((4, 32), 2), _rand((32,), 3, 0.5)
    out_t = tcommon.rms_norm(torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(g).bfloat16()).float()
    out_j = jcommon.rms_norm(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(g, jnp.bfloat16)).astype(jnp.float32)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_prefill_and_decode_positions(theta):
    x = _rand((2, 6, 4, 32), 4)
    pos_prefill = np.arange(6) + 5                       # (S,)
    _close(ttf._rope(torch.from_numpy(x), torch.from_numpy(pos_prefill),
                     theta),
           jtf._rope(None, jnp.asarray(x), jnp.asarray(pos_prefill),
                     jnp.asarray(theta, jnp.float32)), rtol=1e-5, atol=2e-5)
    xd = _rand((3, 1, 4, 32), 5)
    pos_dec = np.array([[0], [17], [301]])               # (B, 1)
    _close(ttf._rope(torch.from_numpy(xd), torch.from_numpy(pos_dec), theta),
           jtf._rope(None, jnp.asarray(xd), jnp.asarray(pos_dec),
                     jnp.asarray(theta, jnp.float32)), rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    d, f = 32, 48
    x = _rand((2, 3, d), 6)
    names = ["w_gate", "w_up", "w_down"] if act == "silu" else ["w_up",
                                                                 "w_down"]
    shapes = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    p = {n: _rand(shapes[n], 10 + i, 0.2) for i, n in enumerate(names)}
    _close(tcommon.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), act),
           jcommon.mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), act))


@pytest.mark.parametrize("tied", [True, False])
def test_unembed(tied):
    x = _rand((2, 1, 32), 7)
    w = _rand((50, 32) if tied else (32, 50), 8, 0.02)
    _close(tcommon.unembed(torch.from_numpy(w), torch.from_numpy(x),
                           tied=tied),
           jcommon.unembed(jnp.asarray(w), jnp.asarray(x), tied=tied))


FLASH_CASES = [
    # (Sq, Skv, G, causal, window, q_offset, kv_len, softcap, chunk)
    (16, 16, 1, True, 0, 0, None, 0.0, 512),
    (16, 16, 2, True, 0, 0, None, 0.0, 5),       # ragged last chunk
    (12, 12, 2, True, 4, 0, None, 0.0, 4),       # sliding window
    (5, 24, 2, True, 0, 19, 24, 0.0, 8),         # resumed chunk
    (5, 32, 1, True, 3, 19, 24, 0.0, 8),         # + window, kv_len < Skv
    (9, 9, 2, True, 0, 0, None, 30.0, 4),        # softcap
    (7, 11, 2, False, 0, 0, 9, 0.0, 4),          # non-causal + kv_len
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention(case):
    Sq, Skv, G, causal, window, q_offset, kv_len, softcap, chunk = case
    Hkv, D = 2, 16
    q = _rand((2, Sq, Hkv * G, D), 20)
    k = _rand((2, Skv, Hkv, D), 21)
    v = _rand((2, Skv, Hkv, D), 22)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_len=kv_len, softcap=softcap)
    out_t = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), chunk=chunk, **kw)
    _close(out_t, jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), chunk=chunk, **kw))
    _close(out_t, jattn.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), **kw))
    _close(tattn.attention_reference(torch.from_numpy(q),
                                     torch.from_numpy(k),
                                     torch.from_numpy(v), **kw),
           jattn.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **kw))
