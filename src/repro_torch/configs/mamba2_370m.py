"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060]"""

import torch

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_heads=32,                      # d_inner = 2*d_model, head_dim 64
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=64,
    tie_embeddings=True,
    long_context="native",             # O(1)-state decode
    dtype=torch.bfloat16,
    source="arXiv:2405.21060",
)
