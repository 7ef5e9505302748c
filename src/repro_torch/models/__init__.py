"""repro_torch.models — the paged serving subset of the model zoo."""

from .config import GLOBAL_ATTENTION, ModelConfig
from .registry import Model, build_model, reduced_config

__all__ = ["GLOBAL_ATTENTION", "Model", "ModelConfig", "build_model",
           "reduced_config"]
