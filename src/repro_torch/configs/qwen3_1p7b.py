"""qwen3-1.7b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B]"""

import torch

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    arch_type="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    long_context="sliding_window",
    long_context_window=16_384,
    dtype=torch.bfloat16,
    source="hf:Qwen/Qwen3-8B",
)
