"""Selective SSM (Mamba-style) branch of the Hymba hybrid heads
[arXiv:2411.13676] (counterpart of ``repro/models/ssm.py``).

Recurrence (per channel c, state lane n):

    h_t = exp(dt_t * A_c) * h_{t-1} + dt_t * B_t[n] * x_t[c]
    y_t[c] = sum_n C_t[n] * h_t[c, n] + D_c * x_t[c]

with data-dependent B_t, C_t, dt_t.  Over a whole prompt the recurrence runs
on the CUDA kernel ``ops.ssm_scan`` (:func:`ssm_forward`); decode is one
plain step per token (:func:`ssm_step`).  Everything after the input
projection is fp32, as in the reference.

Under ``hints`` (``models/hints.py``; DTensor parameters on a mesh) the
scan runs on each rank's channels and batch rows through ``local_map``,
channels over "model" where they divide it: the recurrence is per
(batch row, channel), so a shard's launch is exact, and C's gradient is a
partial sum over the channel ranks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import hints as hints_lib
from repro_torch.models.hints import apply_feature
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


def _sharded_scan(a, bx, c, h0, hints):
    """``ops.ssm_scan`` on DTensors through ``local_map``."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    B, _, d, _ = a.shape
    rows = Shard(0) if hints.splits_batch(B) else None
    chans = hints._ok(d)

    def pl(chan_dim):
        return hints.layout(rows, Shard(chan_dim) if chans else None)

    # C's gradient: each channel rank's partial sum
    c_grad = hints.layout(rows, Partial() if chans else None)
    if not isinstance(h0, DTensor):     # a plain state: every rank's whole
        h0 = hints_lib.replicated(hints, h0)
    return local_map(ops.ssm_scan, out_placements=(pl(2), pl(1)),
                     in_placements=(pl(2), pl(2), hints.layout(rows), pl(1)),
                     in_grad_placements=(pl(2), pl(2), c_grad, pl(1)),
                     device_mesh=hints.mesh,
                     redistribute_inputs=True)(a, bx, c, h0)


def ssm_forward(params: dict, xz: torch.Tensor, h0: torch.Tensor,
                hints=None):
    """xz: (B, T, 2 * d_inner), already projected; h0: (B, d_inner, N).
    Returns (y (B, T, d_inner) in xz's dtype, before ``w_out``; hT)."""
    x, z, a, bx, Cm = _selective_terms(params, xz)      # a, bx: (B,T,d,N)
    if hints is not None:
        y, hT = _sharded_scan(apply_feature(hints, a, 2),
                              apply_feature(hints, bx, 2), Cm, h0, hints)
    else:
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
