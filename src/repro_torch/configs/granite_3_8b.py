"""granite-3-8b [dense] — GQA. [hf:ibm-granite/granite-3.0-2b-base]"""

import torch

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    arch_type="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12_800,
    vocab_size=49_155,
    rope_theta=10_000.0,
    tie_embeddings=False,
    long_context="sliding_window",     # full-attention arch: long_500k
    long_context_window=16_384,        # runs only under this window (SW)
    remat=True,
    dtype=torch.bfloat16,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
