from .base import ArchConfig, SHAPES, ShapeConfig, runnable_cells
from .registry import ARCHS, ARCH_NAMES, PORT_ARCHS, all_cells, get_arch, get_shape

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ARCHS", "ARCH_NAMES", "PORT_ARCHS",
           "get_arch", "get_shape", "all_cells", "runnable_cells"]
