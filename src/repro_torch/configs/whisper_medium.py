"""whisper-medium [audio] — enc-dec transformer backbone; mel+conv
frontend STUBBED (input_specs supplies frame embeddings).

[arXiv:2212.04356]"""

import torch

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    n_layers=24,                       # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,                     # MHA
    head_dim=64,
    d_ff=4096,
    vocab_size=51_865,
    act="gelu",
    is_encoder_decoder=True,
    n_audio_frames=1500,
    tie_embeddings=True,
    long_context="sliding_window",     # decoder windowed for long_500k
    long_context_window=16_384,        # (far outside Whisper's native
    dtype=torch.bfloat16,              # 448-token regime; exercised
    source="arXiv:2212.04356",         # mechanically per DESIGN.md)
)
