"""Learning-rate schedules (counterpart of ``repro/optim/schedules.py``):
functions of the step count, fp32 0-d tensors on the count's device."""

from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine_decay", "warmup_cosine"]


def _f32(count) -> torch.Tensor:
    return torch.as_tensor(count).to(torch.float32)


def constant(value: float):
    """The same rate at every step."""
    return lambda count: torch.full((), value, dtype=torch.float32,
                                    device=torch.as_tensor(count).device)


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0):
    """``init_value`` decayed along a half cosine to ``alpha *
    init_value`` over ``decay_steps``, then held."""
    def fn(count):
        frac = torch.clamp(_f32(count) / decay_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return init_value * ((1 - alpha) * cos + alpha)
    return fn


def warmup_cosine(peak: float, warmup_steps: int, decay_steps: int,
                  floor: float = 0.0):
    """Linear warm-up to ``peak`` over ``warmup_steps``, then a half
    cosine down to ``floor`` at ``decay_steps``."""
    def fn(count):
        c = _f32(count)
        warm = peak * c / max(warmup_steps, 1)
        frac = torch.clamp((c - warmup_steps)
                           / max(decay_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(c < warmup_steps, warm, cos)
    return fn
