from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCHS", "get_config",
           "get_smoke_config"]
