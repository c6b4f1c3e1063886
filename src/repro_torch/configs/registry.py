"""Registry: ``--arch <id>`` resolution for every assigned architecture."""

from typing import Dict, List

from .arctic_480b import CONFIG as _arctic
from .base import ArchConfig, SHAPES, ShapeConfig, runnable_cells
from .chameleon_34b import CONFIG as _chameleon
from .codeqwen15_7b import CONFIG as _codeqwen
from .minicpm_2b import CONFIG as _minicpm
from .mixtral_8x22b import CONFIG as _mixtral
from .musicgen_large import CONFIG as _musicgen
from .phi3_medium_14b import CONFIG as _phi3
from .qwen15_32b import CONFIG as _qwen32
from .rwkv6_1b6 import CONFIG as _rwkv6
from .zamba2_7b import CONFIG as _zamba2
from .zamba2_7b_instruct import CONFIG as _zamba2_instruct

ARCHS: Dict[str, ArchConfig] = {
    c.name: c
    for c in [
        _codeqwen, _phi3, _minicpm, _qwen32, _rwkv6,
        _arctic, _mixtral, _zamba2, _musicgen, _chameleon,
    ]
}

ARCH_NAMES: List[str] = list(ARCHS)

# configs of the port alone, which the JAX package does not have: resolved by
# ``get_arch`` and served, outside ARCH_NAMES and the dry run's grid
PORT_ARCHS: Dict[str, ArchConfig] = {c.name: c for c in [_zamba2_instruct]}


def get_arch(name: str) -> ArchConfig:
    if name in PORT_ARCHS:
        return PORT_ARCHS[name]
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES + list(PORT_ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells():
    return runnable_cells(ARCH_NAMES)
