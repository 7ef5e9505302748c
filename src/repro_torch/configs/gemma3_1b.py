"""gemma3-1b [dense] — 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt]"""

import torch

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    arch_type="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    sliding_window=512,
    local_global_pattern=(5, 1),       # 5 local : 1 global
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    tie_embeddings=True,
    long_context="native",             # window layers native; kv=1 keeps
                                       # the global-layer cache tiny
    dtype=torch.bfloat16,
    source="hf:google/gemma-3-1b-pt",
)
