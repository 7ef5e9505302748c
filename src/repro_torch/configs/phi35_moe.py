"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2.

[hf:microsoft/Phi-3.5-MoE-instruct]"""

import torch

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32_064,
    n_experts=16,
    experts_per_token=2,
    rope_theta=10_000.0,
    tie_embeddings=False,
    long_context="sliding_window",
    long_context_window=16_384,
    remat=True,
    dtype=torch.bfloat16,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
