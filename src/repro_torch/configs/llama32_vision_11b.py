"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5th layer;
ViT/projector STUBBED (input_specs supplies patch embeddings).

[hf:meta-llama/Llama-3.2-11B-Vision]"""

import torch

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=128_256,
    cross_attn_every=5,                # layers 5,10,...,40 are image layers
    n_image_tokens=6404,               # 4 tiles x 1601 patches
    rope_theta=500_000.0,
    tie_embeddings=False,
    long_context="sliding_window",
    long_context_window=16_384,
    remat=True,
    dtype=torch.bfloat16,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
