"""Mixture-of-Experts FFN (``repro.models.moe``): Phi-3.5-MoE (16
experts, top-2) and Grok-1 (8 experts, top-2).

Two dispatch implementations, as in the reference:

* ``dense``   — every expert computes every token and the outputs are
  weighted by the router gates: the numerical oracle.
* ``scatter`` — capacity dispatch, the serving path: each (token, k)
  assignment is placed in its expert's capacity buffer in the flattened
  (token, k) order, the experts run as one batched product over
  (E, C, d), and the results gather back.  An assignment past its
  expert's capacity ``max(int(T * k / E * capacity_factor), k)`` is
  dropped, so the capacity, and which tokens are dropped, depend on
  every row fed (padding rows and idle lanes included).

The router runs in float32 whatever the model's dtype (its weight is
float32, as the reference draws it).  The top k are taken with a stable
descending sort, so equal probabilities go to the lower expert index, as
``jax.lax.top_k`` breaks ties; ``torch.topk`` makes no such promise.
The expert products are plain ``torch.bmm`` calls: in the reference they
are ``jnp.einsum``s outside any Pallas kernel.

The serving path runs in four spans (``repro_torch.obs.spans.traced``),
ranges while a profiler records: ``moe.route`` (:func:`_router`),
``moe.dispatch`` (:func:`_dispatch`: the routing and the scatter into
the capacity buffer), ``moe.experts`` (:func:`_expert_ffn`) and
``moe.combine`` (:func:`_combine`: the gather and the weighted sum back
onto the tokens).

``with_aux=False`` returns the float 0.0 for the load-balance loss
without computing it: the serving steps discard it (in the reference,
``jit`` drops the dead computation).
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from ..obs.spans import traced
from .common import Params, dense_init


def init_moe(gen: torch.Generator, d: int, f: int, n_experts: int, act: str,
             dtype: Any, lead: tuple = ()) -> Params:
    """Random MoE parameters drawn from ``gen`` on ``gen.device``,
    stacked over ``lead``: a float32 router (d, E) and expert stacks
    (E, d, f) / (E, f, d) in ``dtype``, N(0, 1/fan_in).  Each expert
    stack is drawn in float32 one leading index at a time and cast into
    its ``dtype`` buffer, so no float32 copy of a whole layer stack
    exists (one full-width Phi-3.5-MoE draw is 16 x 4096 x 6400)."""
    dev = gen.device
    p: Params = {"router": dense_init(gen, d, n_experts, torch.float32,
                                      device=dev, lead=lead)}

    def e_init(shape):
        out = torch.empty(lead + shape, dtype=dtype, device=dev)
        flat = out.view((-1,) + shape)
        scale = 1.0 / math.sqrt(shape[1])
        for i in range(flat.shape[0]):
            w = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32)
            flat[i].copy_(w.mul_(scale))
        return out

    if act == "silu":
        p["w_gate"] = e_init((n_experts, d, f))
    p["w_up"] = e_init((n_experts, d, f))
    p["w_down"] = e_init((n_experts, f, d))
    return p


@traced("moe.experts")
def _expert_ffn(params: Params, h: torch.Tensor, act: str) -> torch.Tensor:
    """h: (E, C, d) -> (E, C, d) through each expert's FFN."""
    up = torch.bmm(h, params["w_up"])
    if act == "silu":
        mid = F.silu(torch.bmm(h, params["w_gate"])) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        mid = F.gelu(up, approximate="tanh")
    return torch.bmm(mid, params["w_down"])


@traced("moe.route")
def _router(params: Params, x2d: torch.Tensor, k: int,
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """(logits, probs, renormalised top-k probs, top-k expert ids), all
    (T, E) or (T, k); ties go to the lower expert index."""
    logits = x2d.float() @ params["router"]                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    topv = topv / topv.sum(dim=-1, keepdim=True)                # renorm
    return logits, probs, topv, topi


def _aux_loss(probs: torch.Tensor, topi: torch.Tensor,
              n_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    assign = F.one_hot(topi[..., 0], n_experts).float()
    f = assign.mean(dim=0)
    p = probs.mean(dim=0)
    return n_experts * (f * p).sum()


def moe_dense(params: Params, x: torch.Tensor, *, k: int, act: str,
              with_aux: bool = True) -> Tuple[torch.Tensor, Any]:
    """Oracle: all experts on all tokens, gate-masked combine."""
    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    _, probs, topv, topi = _router(params, x2d, k)
    n_experts = params["w_up"].shape[0]
    outs = _expert_ffn(params, x2d[None].expand(n_experts, -1, -1),
                       act)                                     # (E, T, d)
    weights = torch.zeros((x2d.shape[0], n_experts), dtype=x.dtype,
                          device=x.device)
    for j in range(k):
        weights = weights + F.one_hot(topi[:, j], n_experts).to(x.dtype) \
            * topv[:, j:j + 1].to(x.dtype)
    y = torch.einsum("etd,te->td", outs, weights)
    return y.reshape(x.shape), (_aux_loss(probs, topi, n_experts)
                                if with_aux else 0.0)


def moe_routing(topi: torch.Tensor, n_experts: int, capacity_factor: float,
                ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Capacity dispatch of the assignments ``topi`` (T, k): (capacity,
    each assignment's buffer slot (T * k,) in the flattened (token, k)
    order — the overflow row ``n_experts * capacity`` where dropped —
    and ``keep`` (T * k,), False for a dropped assignment)."""
    T, k = topi.shape
    e_flat = topi.reshape(-1)                                   # (T*k,)
    onehot = F.one_hot(e_flat, n_experts)                       # (T*k, E)
    pos = torch.cumsum(onehot, dim=0) - onehot                  # before me
    pos_in_e = (pos * onehot).sum(dim=-1)                       # (T*k,)
    capacity = max(int(T * k / n_experts * capacity_factor), k)
    keep = pos_in_e < capacity
    slot = torch.where(keep, e_flat * capacity + pos_in_e,
                       torch.full_like(e_flat, n_experts * capacity))
    return capacity, slot, keep


@traced("moe.dispatch")
def _dispatch(x2d: torch.Tensor, topv: torch.Tensor, topi: torch.Tensor,
              n_experts: int, capacity_factor: float):
    """Each token's k assignments copied into the capacity buffer
    (E * capacity + 1, d), whose last row takes the dropped ones: returns
    (capacity, the buffer, the assignments for :func:`_combine`)."""
    T, k = topi.shape
    capacity, slot, keep = moe_routing(topi, n_experts, capacity_factor)
    w_flat = topv.reshape(-1).to(x2d.dtype)
    tok_idx = torch.arange(T, device=x2d.device).repeat_interleave(k)
    keep_x = keep[:, None].to(x2d.dtype)
    buf = torch.zeros((n_experts * capacity + 1, x2d.shape[1]),
                      dtype=x2d.dtype, device=x2d.device)
    buf.index_add_(0, slot, x2d[tok_idx] * keep_x)
    return capacity, buf, (slot, keep, keep_x, tok_idx, w_flat)


@traced("moe.combine")
def _combine(h: torch.Tensor, x2d: torch.Tensor, assign) -> torch.Tensor:
    """The experts' rows ``h`` (E, capacity, d) gathered back onto the
    tokens (T, d), each weighted by its gate."""
    slot, keep, keep_x, tok_idx, w_flat = assign
    h = h.reshape(-1, h.shape[-1])
    gathered = h[torch.where(keep, slot, torch.zeros_like(slot))] * keep_x
    return torch.zeros_like(x2d).index_add_(0, tok_idx,
                                            gathered * w_flat[:, None])


def moe_scatter(params: Params, x: torch.Tensor, *, k: int, act: str,
                capacity_factor: float = 1.25, with_aux: bool = True,
                ) -> Tuple[torch.Tensor, Any]:
    """Capacity-buffer dispatch (the serving path)."""
    d = x.shape[-1]
    x2d = x.reshape(-1, d)
    n_experts = params["w_up"].shape[0]
    _, probs, topv, topi = _router(params, x2d, k)
    capacity, buf, assign = _dispatch(x2d, topv, topi, n_experts,
                                      capacity_factor)
    h = _expert_ffn(params, buf[:-1].reshape(n_experts, capacity, d), act)
    y2d = _combine(h, x2d, assign)
    return y2d.reshape(x.shape), (_aux_loss(probs, topi, n_experts)
                                  if with_aux else 0.0)


def moe(params: Params, x: torch.Tensor, *, k: int, act: str,
        impl: str = "scatter", capacity_factor: float = 1.25,
        with_aux: bool = True) -> Tuple[torch.Tensor, Any]:
    if impl == "dense":
        return moe_dense(params, x, k=k, act=act, with_aux=with_aux)
    if impl == "scatter":
        return moe_scatter(params, x, k=k, act=act,
                           capacity_factor=capacity_factor,
                           with_aux=with_aux)
    raise ValueError(f"unknown moe impl {impl!r}")
