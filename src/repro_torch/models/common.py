"""Shared model building blocks (counterpart of ``repro/models/common.py``):
norms, RoPE, soft-capping and initialisers.

Every function keeps the reference's dtype behaviour: the norms and RoPE
compute in fp32 and cast back to the input's dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import resolve_device

__all__ = [
    "rmsnorm", "layernorm", "norm_apply", "init_norm",
    "rope_frequencies", "apply_rope", "softcap",
    "dense_init", "embed_init", "truncated_normal", "standard_normal",
    "init_device",
]


# ---- norms ---------------------------------------------------------------
def init_norm(d: int, kind: str, dtype, device=None) -> dict:
    """``{"scale": ones}``, plus ``{"bias": zeros}`` for a layernorm."""
    dev = resolve_device(device)
    p = {"scale": torch.ones((d,), dtype=dtype, device=dev)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=dev)
    return p


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis, fp32 inside, x's dtype out."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis, fp32 inside, x's dtype out."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    xc = x - mu
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    x = xc * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dtype)


def norm_apply(x: torch.Tensor, params: dict, kind: str) -> torch.Tensor:
    """``rmsnorm`` or ``layernorm`` with the norm's parameters."""
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params["bias"])


# ---- rotary position embeddings -------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim / 2,) fp32 inverse frequencies theta^(-i / half)."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, D); positions: broadcastable to (..., T).  fp32
    inside, cast back to x's dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)          # (D/2,)
    angles = positions[..., None].float() * freqs                   # (..., T, D/2)
    angles = angles[..., None, :]                                    # (..., T, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---- init ------------------------------------------------------------------
def init_device(generator: torch.Generator, device=None) -> torch.device:
    """Where an initialiser puts its leaves: the generator's card when the
    generator lives on one, else ``device`` (``cuda`` unless named)."""
    if generator.device.type != "cpu":
        return generator.device
    return resolve_device(device)


def standard_normal(generator: torch.Generator, shape: Tuple[int, ...],
                    device=None) -> torch.Tensor:
    """fp32 standard normal from ``generator``: on its card, or on the CPU
    and then moved to ``device``."""
    if generator.device.type != "cpu":
        return torch.randn(shape, generator=generator,
                           device=generator.device)
    return torch.randn(shape, generator=generator).to(resolve_device(device))


def truncated_normal(generator: torch.Generator, shape: Tuple[int, ...],
                     device=None) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] from ``generator``.

    A CPU generator draws on the CPU (so a seed gives the same weights on
    every device) and the result moves to ``device``: ``cuda`` unless named
    (raises without a card).  A generator on a card draws there, on its own
    device, which is what makes a billion-parameter init take no time; the
    numbers then differ from a CPU generator's."""
    if generator.device.type != "cpu":
        out = torch.empty(shape, dtype=torch.float32, device=generator.device)
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return out
    device = resolve_device(device)
    out = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return out.to(device)


def dense_init(generator: torch.Generator, shape: Tuple[int, ...], dtype,
               scale: float | None = None, device=None) -> torch.Tensor:
    """Fan-in scaled truncated-normal init: std = fan_in^-0.5 unless
    ``scale`` is given, fan_in being ``shape[-2]`` (or ``shape[-1]`` for a
    vector), so a stack of matrices (G, fan_in, fan_out) scales as each
    matrix does.  ``device``: ``cuda`` unless named (raises without a
    card); a generator on a card draws on it."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    return (std * truncated_normal(generator, shape, device)).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype,
               device=None) -> torch.Tensor:
    """std = d^-0.5, truncated at two standard deviations."""
    return (d ** -0.5 * truncated_normal(generator, (vocab, d), device)
            ).to(dtype)
