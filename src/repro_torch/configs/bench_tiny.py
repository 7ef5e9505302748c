"""bench-tiny — the benchmark suite's smoke model (the reference's
``repro.serving.worker.build_tiny`` config), as a plain config."""

import torch

from ..models.config import ModelConfig

CONFIG = ModelConfig(name="bench-tiny", arch_type="dense", n_layers=4,
                     d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                     vocab_size=259, dtype=torch.float32)
