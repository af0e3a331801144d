from .base import (ArchConfig, MambaConfig, MoEConfig, ShapeConfig, SHAPES,
                   get_config, list_archs, register, shape_applicable)

__all__ = ["ArchConfig", "MambaConfig", "MoEConfig", "ShapeConfig", "SHAPES",
           "get_config", "list_archs", "register", "shape_applicable"]
