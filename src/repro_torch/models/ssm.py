"""Selective SSM (Mamba-style) branch of the Hymba hybrid heads
[arXiv:2411.13676] (counterpart of ``repro/models/ssm.py``).

Recurrence (per channel c, state lane n):

    h_t = exp(dt_t * A_c) * h_{t-1} + dt_t * B_t[n] * x_t[c]
    y_t[c] = sum_n C_t[n] * h_t[c, n] + D_c * x_t[c]

with data-dependent B_t, C_t, dt_t.  Over a whole prompt the recurrence runs
on the CUDA kernel ``ops.ssm_scan`` (:func:`ssm_forward`); decode is one
plain step per token (:func:`ssm_step`).  Everything after the input
projection is fp32, as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, init_device

__all__ = ["init_ssm_params", "ssm_forward", "ssm_step"]


def init_ssm_params(generator: torch.Generator, d_model: int, d_inner: int,
                    state: int, dtype, *, stack: Tuple[int, ...] = (),
                    device=None) -> dict:
    """Input/gate, B/C/dt, dt and output projections, the dt bias, log(-A)
    (S4D-real, A = -[1..N] per channel) and the skip, each leaf with the
    leading ``stack`` axes (the layer groups)."""
    dev = init_device(generator, device)
    dt_rank = max(8, d_inner // 16)
    a0 = torch.arange(1, state + 1, dtype=torch.float32, device=dev
                      ).expand(stack + (d_inner, state))

    def dense(shape):
        return dense_init(generator, stack + shape, dtype, device=device)

    def full(value):
        return torch.full(stack + (d_inner,), value, dtype=dtype, device=dev)

    return {
        "w_in": dense((d_model, 2 * d_inner)),       # x and gate
        "w_bcdt": dense((d_inner, 2 * state + dt_rank)),
        "w_dt": dense((dt_rank, d_inner)),
        "dt_bias": full(-2.0),                       # softplus(-2) ~ 0.13
        "log_a": torch.log(a0).to(dtype),
        "d_skip": full(1.0),
        "w_out": dense((d_inner, d_model)),
    }


def _selective_terms(params, xz):
    """Shared by scan and step: returns (x, z, a (decay), bx (input), C)."""
    state = params["log_a"].shape[1]
    x, z = torch.chunk(xz, 2, dim=-1)                   # (..., d_inner) each
    bcdt = x.float() @ params["w_bcdt"].float()
    Bm, Cm, dt_lr = (bcdt[..., :state], bcdt[..., state:2 * state],
                     bcdt[..., 2 * state:])
    dt = torch.nn.functional.softplus(
        dt_lr @ params["w_dt"].float() + params["dt_bias"].float())
    A = -torch.exp(params["log_a"].float())             # (d_inner, N)
    a = torch.exp(dt[..., None] * A)                    # (..., d_inner, N)
    bx = (dt * x.float())[..., None] * Bm[..., None, :]  # (..., d, N)
    return x, z, a, bx, Cm


def ssm_forward(params: dict, xz: torch.Tensor, h0: torch.Tensor):
    """xz: (B, T, 2 * d_inner), already projected; h0: (B, d_inner, N).
    Returns (y (B, T, d_inner) in xz's dtype, before ``w_out``; hT)."""
    x, z, a, bx, Cm = _selective_terms(params, xz)      # a, bx: (B,T,d,N)
    y, hT = ops.ssm_scan(a, bx, Cm, h0)
    y = y + params["d_skip"].float() * x.float()
    y = y * torch.nn.functional.silu(z.float())
    return y.to(xz.dtype), hT


def ssm_step(params: dict, xz: torch.Tensor, h: torch.Tensor):
    """Decode: xz (B, 1, 2 * d_inner), h (B, d_inner, N)."""
    x, z, a, bx, Cm = _selective_terms(params, xz[:, 0])
    h = a * h + bx                                      # (B, d, N)
    y = torch.einsum("bdn,bn->bd", h, Cm)
    y = y + params["d_skip"].float() * x.float()
    y = y * torch.nn.functional.silu(z.float())
    return y[:, None].to(xz.dtype), h
