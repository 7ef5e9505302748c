"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 2:1 pattern.

[arXiv:2402.19427]"""

import torch

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,                      # MQA in the attention blocks
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "attn"),
    lru_width=2560,
    sliding_window=2048,               # local attention
    tie_embeddings=True,
    long_context="native",             # RG-LRU state + window cache
    dtype=torch.bfloat16,
    source="arXiv:2402.19427",
)
