"""AdamW + cosine schedule + global-norm clipping (``repro.training.
optimizer``), over the port's parameter trees.

The arithmetic is the reference's: moments ``m`` and ``v`` in float32,
the gradient clipped by its global norm in float32 and cast back to its
own dtype, the update computed in float32 and cast back to the leaf's
dtype, weight decay only on leaves with ``ndim >= 2``, and the step,
learning rate and bias corrections as 0-d device tensors (float32, the
step int32), so a step never waits on the host.

Unlike the reference's pure functions, :func:`adamw_update` updates the
parameters, the moments and the gradients **in place** (under
``torch.no_grad``) and returns the same tensors: at full width a second
copy of them would not fit beside the first (Qwen3-1.7B holds 3.4 GB of
bf16 parameters and 13.8 GB of moments).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..models.weights import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine decay to
    ``cfg.min_lr_ratio * cfg.lr`` at ``cfg.total_steps``; float32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(tree)))


def clip_by_global_norm(tree: Any, max_norm: float,
                        ) -> Tuple[Any, torch.Tensor]:
    """Every leaf scaled by ``min(1, max_norm / (norm + 1e-9))`` in
    float32 and cast back to its dtype, **in place**; returns (tree, the
    norm before clipping)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    with torch.no_grad():
        for g in tree_leaves(tree):
            g.copy_(g.float() * scale)
    return tree, norm


def adamw_init(params: Any) -> AdamWState:
    """Zero float32 moments shaped as the parameters, step 0."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else "cpu"

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def _is_decayed(p: torch.Tensor) -> bool:
    """Decay matrices only: no decay for norms, biases and scalars
    (leaves of ``ndim < 2``), as the reference decides per leaf."""
    return p.dim() >= 2


def adamw_update(cfg: AdamWConfig, grads: Any, state: AdamWState,
                 params: Any) -> Tuple[Any, AdamWState,
                                       Dict[str, torch.Tensor]]:
    """One AdamW step over ``params`` with ``grads`` (same trees), **in
    place**: the gradients are clipped, the moments and the parameters
    updated where they are.  Returns (params, the new state, ``{"lr",
    "grad_norm"}``), the norm taken before clipping."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.betas
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)
    with torch.no_grad():
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.m),
                              tree_leaves(state.v), tree_leaves(params)):
            gf = g.float()
            m.mul_(b1).add_((1 - b1) * gf)
            v.mul_(b2).add_((1 - b2) * gf.square())
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            pf = p.float()
            if _is_decayed(p):
                delta = delta + cfg.weight_decay * pf
            p.copy_(pf - lr * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v), \
        {"lr": lr, "grad_norm": gnorm}
