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
it are fp32 even when the parameters and the stream are bf16.

Under ``hints`` (``models/hints.py``; DTensor parameters on a mesh) r, k,
v and the log decay take the reference's head-sharded layout, and the
wkv6 kernel runs on each rank's local heads and batch rows through
``local_map``: the recurrence is per (batch row, head), so a shard's
launch is exact.  The bonus u's gradient is a partial sum over the data
ranks' rows.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import hints as hints_lib
from repro_torch.models.hints import apply_feature
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


def _heads(hints, x: torch.Tensor, H: int, head_dim: int) -> torch.Tensor:
    """(B, T, H * head_dim) -> (B, T, H, head_dim); under hints the heads
    over "model" where it divides them, the features gathered first where
    it does not."""
    B, T, _ = x.shape
    if hints is not None:       # whole heads on each rank before the split
        x = (apply_feature(hints, x, 2) if hints._ok(H)
             else hints_lib.apply_batch(hints, x))
    return apply_feature(hints, x.reshape(B, T, H, head_dim), 2)


def _sharded_wkv6(fn, r, k, v, logw, u, state, hints):
    """``fn`` (:func:`wkv6_chunked`, or :func:`wkv6_step` in decode) on
    DTensors: each rank's (batch, head) shard through ``local_map``; heads
    over "model" where they divide it."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    B, _, H, _ = r.shape
    rows = Shard(0) if hints.splits_batch(B) else None
    heads = hints._ok(H)

    def pl(batch, head_dim):
        return hints.layout(batch, Shard(head_dim) if heads else None)

    x4, st = pl(rows, 2), pl(rows, 1)
    # u's gradient: each data rank's rows' partial sum
    u_grad = pl(Partial() if rows is not None else None, 0)
    if not isinstance(state, DTensor):     # a plain state: every rank's whole
        state = hints_lib.replicated(hints, state)
    return local_map(fn, out_placements=(x4, st),
                     in_placements=(x4, x4, x4, x4, pl(None, 0), st),
                     in_grad_placements=(x4, x4, x4, x4, u_grad, st),
                     device_mesh=hints.mesh,
                     redistribute_inputs=True)(r, k, v, logw, u, state)


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
                  *, decode: bool = False, hints=None):
    """x: (B, T, d).  Returns (out, new_state, new_shift_prev)."""
    B, T, d = x.shape
    H = d // head_dim
    xs = _token_shift(x, shift_prev) if not decode else shift_prev
    xr = _lerp(x, xs, params["mu_r"])
    xk = _lerp(x, xs, params["mu_k"])
    xv = _lerp(x, xs, params["mu_v"])
    xw = _lerp(x, xs, params["mu_w"])
    xg = _lerp(x, xs, params["mu_g"])

    r, k, v = (_heads(hints, _matmul(xi, params[w]), H, head_dim)
               for xi, w in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
    g = torch.nn.functional.silu(_matmul(xg, params["wg"]))
    # Finch decay: w = exp(-exp(bias + tanh(x ww1) ww2)) in (0, 1)
    wexp = params["w_bias"].float() + \
        torch.tanh(xw.float() @ params["ww1"].float()) @ \
        params["ww2"].float()
    # the row-parallel ww2 leaves wexp partial over "model": whole first
    logw = _heads(hints, -torch.exp(torch.clamp(
        hints_lib.apply_batch(hints, wexp), -12.0, 4.0)), H, head_dim)

    u = params["u"].float()
    if hints is not None:
        y, state = _sharded_wkv6(wkv6_step if decode else wkv6_chunked,
                                 r, k, v, logw, u, state, hints)
    elif decode:
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
