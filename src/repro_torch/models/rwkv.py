"""RWKV6 "Finch" blocks [arXiv:2404.05892] (counterpart of
``repro/models/rwkv.py``): data-dependent per-channel decay time mix (wkv6)
and squared-ReLU channel mix.

The recurrence

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (per head, S in R^{D x D})
    y_t = r_t^T S_{t-1} + (r_t . u . k_t) v_t

runs on the CUDA kernel ``ops.wkv6`` over a whole prompt
(:func:`wkv6_chunked`) and as one plain step per token in decode
(:func:`wkv6_step`).  The kernel computes every pair decay as one exponent
of a sum of log decays, so it stays finite where the reference's factored
form overflows (ROADMAP Queue 3).

dtypes follow the reference's promotion exactly: the token-shift state is
fp32, so ``_token_shift`` and every lerp, projection and block output after
it are fp32 even when the parameters and the stream are bf16.  The
reference's ``hints`` argument (sharding anchors) has no counterpart on
one card and is dropped.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import (dense_init, init_device,
                                       standard_normal)

__all__ = ["init_rwkv_params", "wkv6_chunked", "wkv6_step", "rwkv_time_mix",
           "rwkv_channel_mix"]


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as ``jnp.matmul``
    promotes (bf16 with fp32 is fp32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def init_rwkv_params(generator: torch.Generator, d_model: int, head_dim: int,
                     d_ff: int, dtype, *, stack: Tuple[int, ...] = (),
                     device=None) -> dict:
    """Time mix (r, k, v, w, g projections, u bonus, output) and channel
    mix, each leaf with the leading ``stack`` axes (the layer groups)."""
    H = d_model // head_dim

    def full(shape, value):
        return torch.full(stack + shape, value, dtype=dtype,
                          device=init_device(generator, device))

    def dense(shape):
        return dense_init(generator, stack + shape, dtype, device=device)

    p = {
        "mu_r": full((d_model,), 0.5),
        "mu_k": full((d_model,), 0.5),
        "mu_v": full((d_model,), 0.5),
        "mu_w": full((d_model,), 0.5),
        "mu_g": full((d_model,), 0.5),
        "wr": dense((d_model, d_model)),
        "wk": dense((d_model, d_model)),
        "wv": dense((d_model, d_model)),
        "ww1": dense((d_model, 64)),
        "ww2": dense((64, d_model)),
        "w_bias": full((d_model,), -5.0),
        "wg": dense((d_model, d_model)),
        "u": (0.1 * standard_normal(generator, stack + (H, head_dim), device)
              ).to(dtype),
        "wo": dense((d_model, d_model)),
        "mu_ck": full((d_model,), 0.5),
        "ck": dense((d_model, d_ff)),
        "cv": dense((d_ff, d_model)),
    }
    return p


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Shift right by one along T; position 0 takes ``prev`` (B, 1, d)."""
    dt = torch.promote_types(x.dtype, prev.dtype)
    return torch.cat([prev.to(dt), x[:, :-1].to(dt)], dim=1)


def _lerp(x, xs, mu):
    return x + (xs - x) * mu


def wkv6_chunked(r, k, v, logw, u, state):
    """wkv6 over a whole sequence on the CUDA kernel.  r, k, v: (B, T, H, D);
    logw: (B, T, H, D) log decay in (-inf, 0); u: (H, D); state:
    (B, H, D, D).  Returns (y (B, T, H, D) fp32, final state fp32)."""
    return ops.wkv6(r, k, v, logw, u, state)


def wkv6_step(r, k, v, logw, u, state):
    """Single-token recurrence (decode).  r, k, v, logw: (B, 1, H, D)."""
    rb = r[:, 0].float()
    kb = k[:, 0].float()
    vb = v[:, 0].float()
    w = torch.exp(logw[:, 0].float())                        # (B,H,D)
    y = torch.einsum("bhd,bhde->bhe", rb, state) + \
        torch.sum(rb * u[None] * kb, -1, keepdim=True) * vb
    state = w[..., None] * state + torch.einsum("bhd,bhe->bhde", kb, vb)
    return y[:, None], state


def rwkv_time_mix(params: dict, x: torch.Tensor, head_dim: int,
                  state: torch.Tensor, shift_prev: torch.Tensor,
                  *, decode: bool = False):
    """x: (B, T, d).  Returns (out, new_state, new_shift_prev)."""
    B, T, d = x.shape
    H = d // head_dim
    xs = _token_shift(x, shift_prev) if not decode else shift_prev
    xr = _lerp(x, xs, params["mu_r"])
    xk = _lerp(x, xs, params["mu_k"])
    xv = _lerp(x, xs, params["mu_v"])
    xw = _lerp(x, xs, params["mu_w"])
    xg = _lerp(x, xs, params["mu_g"])

    r = _matmul(xr, params["wr"]).reshape(B, T, H, head_dim)
    k = _matmul(xk, params["wk"]).reshape(B, T, H, head_dim)
    v = _matmul(xv, params["wv"]).reshape(B, T, H, head_dim)
    g = torch.nn.functional.silu(_matmul(xg, params["wg"]))
    # Finch decay: w = exp(-exp(bias + tanh(x ww1) ww2)) in (0, 1)
    wexp = params["w_bias"].float() + \
        torch.tanh(xw.float() @ params["ww1"].float()) @ \
        params["ww2"].float()
    logw = -torch.exp(torch.clamp(wexp, -12.0, 4.0)).reshape(
        B, T, H, head_dim)

    u = params["u"].float()
    if decode:
        y, state = wkv6_step(r, k, v, logw, u, state)
    else:
        y, state = wkv6_chunked(r, k, v, logw, u, state)
    y = y.reshape(B, T, d).to(x.dtype) * g
    out = _matmul(y, params["wo"])
    new_prev = x[:, -1:]
    return out, state, new_prev


def rwkv_channel_mix(params: dict, x: torch.Tensor, shift_prev: torch.Tensor,
                     *, decode: bool = False):
    """Squared-ReLU channel mix.  Returns (out, new_shift_prev)."""
    xs = _token_shift(x, shift_prev) if not decode else shift_prev
    xk = _lerp(x, xs, params["mu_ck"])
    h = torch.square(torch.relu(_matmul(xk, params["ck"])))
    return _matmul(h, params["cv"]), x[:, -1:]
