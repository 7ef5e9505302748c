"""Token samplers: greedy / temperature / top-k (``repro.serving.sampler``).

Greedy is ``argmax`` with first-index ties, as ``jnp.argmax``.
Temperature / top-k sampling draws from an explicit ``torch.Generator``
that lives on the logits' device; it matches the reference in
distribution only (JAX keys and torch generators give different bits).
``sample_grouped`` samples the lanes that share (temperature, top_k)
together, so a mixed-policy batch stays a handful of device calls.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0      # 0 -> greedy
    top_k: int = 0                # 0 -> full distribution
    max_new_tokens: int = 64
    eos_id: Optional[int] = None


def sample(logits: torch.Tensor, params: SamplingParams,
           gen: Optional[torch.Generator]) -> torch.Tensor:
    """logits (B, 1, V) -> tokens (B, 1) int32."""
    lf = logits[:, -1].float()
    if params.temperature <= 0.0:
        return lf.argmax(dim=-1, keepdim=True).to(torch.int32)
    lf = lf / params.temperature
    if params.top_k > 0:
        kth = torch.topk(lf, params.top_k, dim=-1).values[:, -1:]
        lf = torch.where(lf < kth, torch.full_like(lf, -float("inf")), lf)
    probs = torch.softmax(lf, dim=-1)
    return torch.multinomial(probs, 1, generator=gen).to(torch.int32)


def sample_grouped(logits: torch.Tensor, params: Sequence[SamplingParams],
                   gen: Optional[torch.Generator]) -> np.ndarray:
    """logits (B, 1, V), one SamplingParams per lane -> tokens (B, 1).

    Lanes with identical (temperature, top_k) sample together; greedy
    lanes ignore the generator, so a fully-greedy batch is one argmax."""
    B = logits.shape[0]
    if len(params) != B:
        raise ValueError(f"{len(params)} params for batch {B}")
    groups = {}
    for b, sp in enumerate(params):
        groups.setdefault((sp.temperature, sp.top_k), []).append(b)
    out = np.zeros((B, 1), np.int32)
    for _, lanes in sorted(groups.items()):
        idx = torch.as_tensor(lanes, device=logits.device)
        out[lanes] = sample(logits[idx], params[lanes[0]], gen).cpu().numpy()
    return out
