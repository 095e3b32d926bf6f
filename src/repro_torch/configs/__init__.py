"""Config registry of the port: ``get_arch(id)`` for the architectures the
port runs.  The reference registers ten; the other seven are still to be
ported (ROADMAP Queue 1 item 16) and raise a ``KeyError`` saying so."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, InputShape,
                                      LayerSpec)

__all__ = ["ARCH_IDS", "get_arch", "ArchConfig", "InputShape", "LayerSpec",
           "INPUT_SHAPES"]

_ARCH_MODULES = {
    "hymba-1.5b": "hymba_1_5b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "qwen2-1.5b": "qwen2_1_5b",
}
_NOT_PORTED = ("internvl2-26b", "gemma2-2b", "qwen2-moe-a2.7b", "qwen2-72b",
               "musicgen-medium", "qwen2.5-14b",
               "llama4-maverick-400b-a17b")

ARCH_IDS = tuple(_ARCH_MODULES)


def get_arch(arch_id: str) -> ArchConfig:
    """The ``ArchConfig`` of ``arch_id``."""
    if arch_id in _NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet (ROADMAP Queue 1 "
                       f"item 16); the port runs {list(ARCH_IDS)}")
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(ARCH_IDS)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG
