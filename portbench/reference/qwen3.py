"""Plain float32 reference of the Qwen3 dense family (hf:Qwen/Qwen3-*):
grouped-query attention with RMSNorm on each query and key head, split-half
RoPE, a SiLU-gated MLP, RMSNorm before each block, tied embeddings where
the configuration says so.  Departure from the published model: the norm
gains are zero-centred, x / rms(x) * (1 + g), which is the published
weight g + 1 under another name."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._plain import decoder_logits, linear


def mlp(lp, h: torch.Tensor, precision: str) -> torch.Tensor:
    m = lp["mlp"]
    gate = F.silu(linear(h, m["w_gate"], precision))
    return linear(gate * linear(h, m["w_up"], precision), m["w_down"],
                  precision)


def logits(params, cfg, tokens: torch.Tensor, rows: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    """Float32 logits (len(rows), V) of ``tokens`` (S,) at ``rows``."""
    return decoder_logits(params, cfg, tokens, rows, precision, mlp)
