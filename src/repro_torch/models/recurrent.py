"""RG-LRU recurrent block — RecurrentGemma / Griffin (arXiv:2402.19427).

Counterpart of ``repro.models.recurrent``.  Block structure (Griffin
"recurrent block"):

    x ── linear ─ GeLU ──────────────────────┐
    x ── linear ─ causal conv1d(4) ─ RG-LRU ─┤ ⊙ ── linear ─ out

RG-LRU recurrence (per channel):
    r_t = σ(W_a x_t + b_a)            recurrence gate
    i_t = σ(W_x x_t + b_x)            input gate
    a_t = a^(c·r_t),  a = σ(Λ), c = 8
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

Prefill computes the gates here and hands ``(a, u, h0)`` to
``kernels.ops.rglru_linear_scan``: the hand-written scan kernel on CUDA
tensors, its plain version on CPU tensors.  Decode is one fused
elementwise update (``rglru_step``), as in the reference, with no
kernel.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ops import rglru_linear_scan
from .common import Params, dense_init
from .ssm import _causal_conv

_C = 8.0  # Griffin's fixed exponent scale


class RGLRUState(NamedTuple):
    h: torch.Tensor      # (B, W) recurrent state (fp32)
    conv: torch.Tensor   # (B, conv_width-1, W) conv tail


def init_rglru_block(gen: torch.Generator, d_model: int, width: int,
                     conv_width: int, dtype: Any,
                     lead: tuple = ()) -> Params:
    """Random block parameters drawn from ``gen``, on ``gen.device``;
    ``lead`` stacks them (a leading layer axis)."""
    dev = gen.device
    # Λ init so that a = σ(Λ) ∈ (0.9, 0.999) — Griffin's init
    u = 0.9 + 0.099 * torch.rand(lead + (width,), generator=gen, device=dev)
    lam = torch.log(u ** (1 / _C) / (1 - u ** (1 / _C)))
    conv_w = torch.randn(lead + (conv_width, width), generator=gen,
                         device=dev) / math.sqrt(conv_width)

    def zeros(n):
        return torch.zeros(lead + (n,), dtype=dtype, device=dev)

    return {
        "w_y": dense_init(gen, d_model, width, dtype, device=dev,
                          lead=lead),                         # GeLU branch
        "w_x": dense_init(gen, d_model, width, dtype, device=dev,
                          lead=lead),                         # recurrent
        "conv_w": conv_w.to(dtype),
        "conv_b": zeros(width),
        "w_a": dense_init(gen, width, width, dtype, device=dev,
                          lead=lead),                         # recurrence gate
        "b_a": zeros(width),
        "w_i": dense_init(gen, width, width, dtype, device=dev,
                          lead=lead),                         # input gate
        "b_i": zeros(width),
        "Lambda": lam,
        "w_out": dense_init(gen, width, d_model, dtype, device=dev,
                            lead=lead),
    }


def _gates(params: Params, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a_t and the scaled input u_t, both float32; x (B,T,W) or (B,W)."""
    r = torch.sigmoid((x @ params["w_a"] + params["b_a"]).float())
    i = torch.sigmoid((x @ params["w_i"] + params["b_i"]).float())
    log_a_base = F.logsigmoid(params["Lambda"].float())         # (W,)
    a = torch.exp(_C * r * log_a_base)                          # ≤ 1
    beta = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-12))
    u = beta * (i * x.float())
    return a, u


def rglru_scan(params: Params, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None, *, impl: str = "auto",
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU over (B, T, W), carried state ``h0`` (B, W) folded into
    step 0.  Returns (y in x.dtype, h_T float32).  ``impl="ref"`` runs
    the scan's plain version on any device."""
    a, u = _gates(params, x)                                    # fp32
    h = rglru_linear_scan(a, u, None if h0 is None else h0.float(),
                          impl=impl)
    return h.to(x.dtype), h[:, -1]


def rglru_step(params: Params, x_t: torch.Tensor, h: torch.Tensor,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. x_t (B, W), h (B, W) fp32."""
    a, u = _gates(params, x_t)
    h_new = a * h.float() + u
    return h_new.to(x_t.dtype), h_new


def rglru_block(params: Params, x: torch.Tensor, *,
                state: Optional[RGLRUState] = None,
                single_step: bool = False, impl: str = "auto",
                ) -> Tuple[torch.Tensor, RGLRUState]:
    """Full Griffin recurrent block on (B, T, d_model)."""
    # jax.nn.gelu defaults to the tanh approximation
    y_branch = F.gelu(x @ params["w_y"], approximate="tanh")
    r = x @ params["w_x"]
    tail = state.conv if state is not None else None
    r, new_tail = _causal_conv(r, params["conv_w"], params["conv_b"], tail)
    h0 = state.h if state is not None else None
    if single_step:
        if h0 is None:
            h0 = torch.zeros(r[:, 0].shape, dtype=torch.float32,
                             device=r.device)
        out_t, h_new = rglru_step(params, r[:, 0], h0)
        rec = out_t[:, None]
    else:
        rec, h_new = rglru_scan(params, r, h0, impl=impl)
    y = (y_branch * rec) @ params["w_out"]
    return y, RGLRUState(h=h_new, conv=new_tail)
