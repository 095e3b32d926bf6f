"""Config registry of the port: ``get_arch(id)`` and ``all_archs()`` for
the reference's ten architectures, in the reference's order, and the
input shapes (``get_shape``, ``supports_shape``) the dry run lowers."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, InputShape,
                                      LayerSpec)

__all__ = ["ARCH_IDS", "get_arch", "all_archs", "get_shape",
           "supports_shape", "ArchConfig", "InputShape", "LayerSpec",
           "INPUT_SHAPES"]

_ARCH_MODULES = {
    "internvl2-26b": "internvl2_26b",
    "hymba-1.5b": "hymba_1_5b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "gemma2-2b": "gemma2_2b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen2-72b": "qwen2_72b",
    "qwen2-1.5b": "qwen2_1_5b",
    "musicgen-medium": "musicgen_medium",
    "qwen2.5-14b": "qwen2_5_14b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_arch(arch_id: str) -> ArchConfig:
    """The ``ArchConfig`` of ``arch_id``."""
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(ARCH_IDS)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG


def all_archs() -> Dict[str, ArchConfig]:
    """Every registered arch's config, in ``ARCH_IDS`` order."""
    return {a: get_arch(a) for a in ARCH_IDS}


def get_shape(name: str) -> InputShape:
    """The named input shape of ``INPUT_SHAPES``."""
    return INPUT_SHAPES[name]


def supports_shape(cfg: ArchConfig, shape: InputShape) -> bool:
    """long_500k only for sub-quadratic archs; every other shape for
    every arch, as the reference."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True
