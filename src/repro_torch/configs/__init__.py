"""Architectures the port serves (``--arch <id>``).

Uniform self-attention stacks serve through both engines; the hybrid
RG-LRU + local-attention stack (RecurrentGemma) through the bucket
engine.  The reference registry (``repro.configs``) lists the rest.
``BENCH_TINY`` is the benchmark suite's tiny model (``--arch tiny``).
"""

from __future__ import annotations

from typing import Dict, List

from ..models.config import ModelConfig
from .bench_tiny import CONFIG as BENCH_TINY
from .gemma3_1b import CONFIG as _gemma3_1b
from .qwen3_1p7b import CONFIG as _qwen3_1p7b
from .recurrentgemma_2b import CONFIG as _recurrentgemma_2b

ARCHS: Dict[str, ModelConfig] = {
    "gemma3-1b": _gemma3_1b,
    "qwen3-1.7b": _qwen3_1p7b,
    "recurrentgemma-2b": _recurrentgemma_2b,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from "
                       f"{sorted(ARCHS)}")
    return ARCHS[arch]


def list_archs() -> List[str]:
    return sorted(ARCHS)


__all__ = ["ARCHS", "BENCH_TINY", "get_config", "list_archs"]
