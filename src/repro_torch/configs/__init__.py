"""Architectures the port serves (``--arch <id>``), and input shapes.

Uniform self-attention stacks (Gemma3, Granite, Qwen2, Qwen3) and the
MoE stacks (Phi-3.5-MoE, Grok-1) serve through both engines; the hybrid
RG-LRU + local-attention stack (RecurrentGemma), the attention-free
Mamba-2 SSD stack, the cross-attention stack (Llama-3.2-Vision) and the
encoder-decoder stack (Whisper) through the bucket engine: every arch of
the reference registry (``repro.configs``).
``BENCH_TINY`` is the benchmark suite's tiny model (``--arch tiny``);
``SHAPES`` the four assigned input shapes, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List

from ..models.config import ModelConfig
from .bench_tiny import CONFIG as BENCH_TINY
from .gemma3_1b import CONFIG as _gemma3_1b
from .granite_3_8b import CONFIG as _granite_3_8b
from .grok1 import CONFIG as _grok1
from .llama32_vision_11b import CONFIG as _llama32_vision_11b
from .mamba2_370m import CONFIG as _mamba2_370m
from .phi35_moe import CONFIG as _phi35_moe
from .qwen2_72b import CONFIG as _qwen2_72b
from .qwen3_1p7b import CONFIG as _qwen3_1p7b
from .recurrentgemma_2b import CONFIG as _recurrentgemma_2b
from .shapes import SHAPES, InputShape
from .whisper_medium import CONFIG as _whisper_medium

ARCHS: Dict[str, ModelConfig] = {
    "gemma3-1b": _gemma3_1b,
    "granite-3-8b": _granite_3_8b,
    "qwen3-1.7b": _qwen3_1p7b,
    "llama-3.2-vision-11b": _llama32_vision_11b,
    "whisper-medium": _whisper_medium,
    "phi3.5-moe-42b-a6.6b": _phi35_moe,
    "grok-1-314b": _grok1,
    "mamba2-370m": _mamba2_370m,
    "qwen2-72b": _qwen2_72b,
    "recurrentgemma-2b": _recurrentgemma_2b,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from "
                       f"{sorted(ARCHS)}")
    return ARCHS[arch]


def list_archs() -> List[str]:
    return sorted(ARCHS)


__all__ = ["ARCHS", "BENCH_TINY", "SHAPES", "InputShape", "get_config",
           "list_archs"]
