"""qwen2-72b [dense] — GQA, QKV bias. [arXiv:2407.10671]"""

import torch

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    arch_type="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29_568,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    long_context="sliding_window",
    long_context_window=16_384,
    remat=True,
    dtype=torch.bfloat16,
    source="arXiv:2407.10671",
)
