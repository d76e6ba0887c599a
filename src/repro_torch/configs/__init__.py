from repro_torch.configs.base import ArchConfig, ShapeCell, SHAPES, smoke_config
from repro_torch.configs.registry import (
    ARCHS, get_arch, LONG_CONTEXT_OK, LONG_CONTEXT_SKIP_REASON)

__all__ = [
    "ArchConfig", "ShapeCell", "SHAPES", "smoke_config", "ARCHS", "get_arch",
    "LONG_CONTEXT_OK", "LONG_CONTEXT_SKIP_REASON",
]
