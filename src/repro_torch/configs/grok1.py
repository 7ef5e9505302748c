"""grok-1-314b [moe] — 8 experts, top-2, attention logit softcap.

[hf:xai-org/grok-1]"""

import torch

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32_768,
    vocab_size=131_072,
    n_experts=8,
    experts_per_token=2,
    attn_logit_softcap=30.0,
    rope_theta=10_000.0,
    tie_embeddings=True,
    long_context="sliding_window",
    long_context_window=16_384,
    remat=True,
    dtype=torch.bfloat16,
    source="hf:xai-org/grok-1",
)
