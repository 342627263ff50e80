from repro_torch.configs.base import ArchConfig, smoke_variant
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape

__all__ = ["ArchConfig", "smoke_variant", "ARCH_IDS", "get_config",
           "INPUT_SHAPES", "InputShape"]
