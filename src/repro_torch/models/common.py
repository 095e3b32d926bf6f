"""Shared model building blocks (counterpart of ``repro/models/common.py``;
this slice needs ``dense_init`` only)."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import resolve_device

__all__ = ["dense_init", "truncated_normal"]


def truncated_normal(generator: torch.Generator, shape: Tuple[int, ...],
                     device=None) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], drawn on the CPU from
    ``generator`` (so a seed gives the same weights on every device) and
    then moved to ``device``: ``cuda`` unless named (raises without a
    card)."""
    device = resolve_device(device)
    out = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return out.to(device)


def dense_init(generator: torch.Generator, shape: Tuple[int, ...], dtype,
               scale: float | None = None, device=None) -> torch.Tensor:
    """Fan-in scaled truncated-normal init: std = fan_in^-0.5 unless
    ``scale`` is given, fan_in being ``shape[-2]`` (or ``shape[-1]`` for a
    vector).  ``device``: ``cuda`` unless named (raises without a card)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    return (std * truncated_normal(generator, shape, device)).to(dtype)
