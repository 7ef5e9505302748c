"""Shared layers: norms, MLP, logits, loss, initializers
(``repro.models.common``).

Weight layout convention (as in the reference): every projection is
stored ``(d_in, d_out)`` and applied as ``x @ w``.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# ----------------------------------------------------------------------
# initializers
# ----------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype: Any, *,
               device: Any = None, lead: tuple = ()) -> torch.Tensor:
    """N(0, 1/d_in) weights of shape ``lead + (d_in, d_out)``, drawn in
    float32 from ``gen`` (which must live on ``device``)."""
    w = torch.randn(lead + (d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device (see
    :func:`meta_generator`)."""

    @property
    def device(self) -> torch.device:           # type: ignore[override]
        return torch.device("meta")


def meta_generator() -> torch.Generator:
    """A generator whose ``device`` is meta: the init functions draw on
    ``gen.device``, so ``Model.init(meta_generator())`` builds the
    parameter tree as meta tensors of the right shapes and dtypes and
    draws nothing (a draw on the meta device touches no generator
    state).  The dry run's stand-in for ``jax.eval_shape(model.init)``."""
    return _MetaGenerator()


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: Any, *,
               device: Any = None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ----------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gain: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with a zero-centred gain.  The normalised x is cast to the
    working dtype BEFORE the ``(1 + gain)`` product, as the reference
    does: bf16 rounding depends on that order."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * (1.0 + gain.to(dt))


def layer_norm(x: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm (Whisper's): statistics in float32, the normalised x
    cast to the working dtype, then times the gain plus the bias, as the
    reference orders it."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * gain.to(dt) + bias.to(dt)


# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------

def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in ``torch.promote_types`` of the two: jnp promotes a
    mixed product (the float32 image / audio stubs against bfloat16
    weights) to float32, where torch refuses it."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def proj(x: torch.Tensor, w: Any, qmm=None) -> torch.Tensor:
    """``x @ w`` (:func:`matmul`) with an optional quantized-matmul hook:
    the serving runner's Q4_0 mode passes ``qmm``
    (``repro_torch.quant.make_qmm``) so a projection leaf may be a
    packed-code subtree instead of a dense tensor; every other path
    leaves ``qmm=None``."""
    return matmul(x, w) if qmm is None else qmm(x, w)


def mlp(params: Params, x: torch.Tensor, act: str,
        qmm=None) -> torch.Tensor:
    if act == "silu":
        h = F.silu(proj(x, params["w_gate"], qmm)) \
            * proj(x, params["w_up"], qmm)
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(proj(x, params["w_up"], qmm), approximate="tanh")
    return proj(h, params["w_down"], qmm)


# ----------------------------------------------------------------------
# logits
# ----------------------------------------------------------------------

def unembed(embed_or_head: torch.Tensor, x: torch.Tensor, *,
            tied: bool) -> torch.Tensor:
    if tied:
        return x @ embed_or_head.T
    return x @ embed_or_head


def nll_sum(logits: torch.Tensor, labels: torch.Tensor,
            ignore_id: int = -100):
    """(summed token NLL in float32, count of labels that are not
    ``ignore_id``); labels are clipped into the vocabulary for the
    gather, as in the reference."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    idx = labels.long().clamp(0, lf.shape[-1] - 1)[..., None]
    gold = torch.gather(lf, -1, idx)[..., 0]
    mask = (labels != ignore_id).float()
    return ((logz - gold) * mask).sum(), mask.sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -100) -> torch.Tensor:
    """Mean token-level cross entropy in float32 over the labels that are
    not ``ignore_id``, the mean over ``max(count, 1)``, as in the
    reference."""
    total, count = nll_sum(logits, labels, ignore_id)
    return total / torch.clamp(count, min=1.0)
