"""Model registry: config -> Model, plus reduced smoke variants."""

from __future__ import annotations

import dataclasses
from typing import Dict

from .config import ModelConfig
from .transformer import Model, build_model


def reduced_config(cfg: ModelConfig, *, n_layers: int = 2,
                   d_model: int = 128, vocab: int = 512) -> ModelConfig:
    """A tiny same-family variant for CPU smoke tests (the reference's
    ``repro.models.registry.reduced_config``; ≤2 layers, d_model ≤ 512,
    ≤4 experts)."""
    hd = max(d_model // max(cfg.n_heads, 1), 16)
    n_heads = max(min(cfg.n_heads, d_model // hd), 1)
    n_kv = max(min(cfg.n_kv_heads, n_heads), 1)
    while n_heads % n_kv:
        n_kv -= 1
    changes: Dict = dict(
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=hd,
        d_ff=d_model * 3,
        vocab_size=vocab,
    )
    if cfg.n_experts:
        changes.update(n_experts=min(cfg.n_experts, 4))
    if cfg.arch_type == "ssm":
        changes.update(ssm_heads=4, ssm_head_dim=32, ssm_state=16,
                       ssm_groups=1, ssm_chunk=8)
    if cfg.lru_width:
        changes.update(lru_width=d_model)
    if cfg.block_pattern:
        changes.update(n_layers=len(cfg.block_pattern))
    if cfg.cross_attn_every:
        changes.update(n_layers=cfg.cross_attn_every,
                       n_image_tokens=min(cfg.n_image_tokens, 16))
    if cfg.is_encoder_decoder:
        changes.update(n_encoder_layers=2,
                       n_audio_frames=min(cfg.n_audio_frames, 24))
    if cfg.sliding_window:
        changes.update(sliding_window=min(cfg.sliding_window, 16))
    return dataclasses.replace(cfg, **changes)


__all__ = ["Model", "build_model", "reduced_config"]
