"""Architecture configs (one per assigned arch) + shape grid."""
from repro_torch.configs.base import (
    SHAPES,
    SHAPES_BY_NAME,
    ArchConfig,
    ShapeSpec,
    applicable_shapes,
    reduce_for_smoke,
    smoke_config,
)
from repro_torch.configs.registry import ARCHS, get_config, list_archs

__all__ = [
    "SHAPES", "SHAPES_BY_NAME", "ArchConfig", "ShapeSpec",
    "applicable_shapes", "reduce_for_smoke", "smoke_config", "ARCHS", "get_config",
    "list_archs",
]
