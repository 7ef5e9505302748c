"""Plain float32 reference of the Phi-3.5-MoE family
(hf:microsoft/Phi-3.5-MoE-instruct) as the configuration runs it:
grouped-query attention, split-half RoPE, and a mixture of SiLU-gated
experts in place of the MLP.  The router is a float32 matmul; each token
goes to its k most probable experts (softmax over all, ties to the lower
index), weighted by their renormalised probabilities, and no token is
ever dropped.  Departures from the published model, as in the program:
RMSNorm (zero-centred gain) where it has LayerNorm, no attention or head
biases, softmax top-k where it has sparsemixer routing, plain RoPE where
it has LongRoPE scaling."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ._plain import decoder_logits, linear


def moe(lp, h: torch.Tensor, precision: str, k: int,
        margins=None) -> torch.Tensor:
    m = lp["moe"]
    probs = torch.softmax(h @ m["router"].float(), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    if margins is not None:     # how near each token's routing is a tie
        margins.append(topv[:, k - 1] - topv[:, k])
    topv, topi = topv[:, :k], topi[:, :k]
    topv = topv / topv.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(m["router"].shape[-1]):
        tok, slot = (topi == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        mid = F.silu(linear(x, m["w_gate"][e], precision)) \
            * linear(x, m["w_up"][e], precision)
        y = linear(mid, m["w_down"][e], precision)
        out.index_add_(0, tok, y * topv[tok, slot][:, None])
    return out


def logits(params, cfg, tokens: torch.Tensor, rows: torch.Tensor,
           precision: str = "f32", margins=None) -> torch.Tensor:
    """Float32 logits (len(rows), V) of ``tokens`` (S,) at ``rows``.
    ``margins`` (a list) collects, per layer, each token's gap between
    its k-th and (k+1)-th router probabilities."""
    ffn = functools.partial(moe, k=int(cfg["num_experts_per_tok"]),
                            margins=margins)
    return decoder_logits(params, cfg, tokens, rows, precision, ffn)
