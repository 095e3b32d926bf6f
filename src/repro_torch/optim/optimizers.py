"""SGD, Adam, AdamW and Adafactor (counterpart of
``repro/optim/optimizers.py``), optax-style: ``opt.init(params) -> state``,
``opt.update(grads, state, params) -> (updates, state)``, applied with
:func:`apply_updates`.

Parameters, gradients and updates are the port's flat ``{name: tensor}``
dicts.  A state holds the reference's layout with every per-leaf tree a
flat dict under the same names (``count``, ``velocity``, ``mu``, ``nu``,
``v`` with ``{"vr", "vc"}`` or ``{"v"}`` a leaf), so it converts to the
reference's pytree through ``bridge``.  The functions are pure: nothing is
updated in place.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Union

import torch

__all__ = ["Optimizer", "sgd", "adam", "adamw", "adafactor", "apply_updates",
           "clip_by_global_norm", "global_norm_scale"]

Tree = Dict[str, torch.Tensor]
Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class Optimizer(NamedTuple):
    """An ``(init, update)`` pair."""
    init: Callable[[Tree], dict]
    update: Callable[..., tuple]


def _count0(tree: Tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=next(iter(tree.values())).device)


def _lr_at(lr: Schedule, count: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(count)
    return torch.full((), lr, dtype=torch.float32, device=count.device)


def sgd(learning_rate: Schedule, momentum: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    """SGD with optional (Nesterov) momentum: ``v = m v + g``."""
    def init(params):
        vel = ({k: torch.zeros_like(p) for k, p in params.items()}
               if momentum else None)
        return {"count": _count0(params), "velocity": vel}

    def update(grads, state, params=None):
        count = state["count"] + 1
        lr = _lr_at(learning_rate, count)
        if momentum:
            vel = {k: momentum * state["velocity"][k] + g
                   for k, g in grads.items()}
            step = ({k: momentum * vel[k] + g for k, g in grads.items()}
                    if nesterov else vel)
        else:
            vel, step = None, grads
        updates = {k: -lr * s for k, s in step.items()}
        return updates, {"count": count, "velocity": vel}

    return Optimizer(init, update)


def adam(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Adam with bias correction; decoupled weight decay (AdamW) when
    ``weight_decay`` is nonzero.  ``nu`` is kept in fp32."""
    def init(params):
        return {"count": _count0(params),
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
                       for k, p in params.items()}}

    def update(grads, state, params=None):
        count = state["count"] + 1
        lr = _lr_at(learning_rate, count)
        mu = {k: b1 * state["mu"][k] + (1 - b1) * g for k, g in grads.items()}
        nu = {k: b2 * state["nu"][k] + (1 - b2) * torch.square(g.float())
              for k, g in grads.items()}
        c = count.to(torch.float32)
        mu_hat_scale = 1.0 / (1 - b1 ** c)
        nu_hat_scale = 1.0 / (1 - b2 ** c)
        updates = {}
        for k in grads:
            upd = (mu[k] * mu_hat_scale) / (
                torch.sqrt(nu[k] * nu_hat_scale) + eps)
            if weight_decay:
                upd = upd + weight_decay * params[k]
            updates[k] = -lr * upd
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def adamw(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    """Adam with decoupled weight decay 0.1 and b2 = 0.95 (the training
    driver's default)."""
    return adam(learning_rate, b1, b2, eps, weight_decay)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``p + u`` in each parameter's dtype."""
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def global_norm_scale(grads: Tree, max_norm: float):
    """(``min(1, max_norm / (norm + 1e-9))``, the fp32 global norm): the
    factor :func:`clip_by_global_norm` scales every gradient by."""
    sq = [torch.sum(torch.square(g.float())) for g in grads.values()]
    gnorm = torch.sqrt(torch.stack(sq).sum())
    return torch.clamp(max_norm / (gnorm + 1e-9), max=1.0), gnorm


def clip_by_global_norm(grads: Tree, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-9))``;
    returns (clipped grads, the fp32 global norm before clipping)."""
    scale, gnorm = global_norm_scale(grads, max_norm)
    return {k: g * scale for k, g in grads.items()}, gnorm


def _in_layout(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` in the DTensor placements of ``old`` (its state leaf); a
    no-op for plain tensors.  A factored moment's mean over a dim that a
    mesh axis shards comes out partial over that axis: reduced here,
    before the update uses it, it is a row or column of numbers, where
    the partial product of the two moments would be the whole gradient's
    size on every rank."""
    placements = getattr(old, "placements", None)
    if placements is None or tuple(new.placements) == tuple(placements):
        return new
    return new.redistribute(old.device_mesh, placements)


def adafactor(learning_rate: Schedule, decay: float = 0.8,
              eps: float = 1e-30, clip_threshold: float = 1.0) -> Optimizer:
    """Adafactor (Shazeer and Stern, 2018): factored second moments for
    ndim >= 2 leaves (row and column means over the last two axes), no
    first moment, updates clipped to RMS ``clip_threshold``."""
    def init(params):
        def leaf(p):
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)}
        return {"count": _count0(params),
                "v": {k: leaf(p) for k, p in params.items()}}

    def update(grads, state, params=None):
        count = state["count"] + 1
        c = count.to(torch.float32)
        beta = 1.0 - c ** -decay
        lr = _lr_at(learning_rate, count)
        updates, new_v = {}, {}
        for k, g in grads.items():
            v = state["v"][k]
            g32 = g.float()
            g2 = torch.square(g32) + eps
            if g.dim() >= 2:
                vr = _in_layout(beta * v["vr"] + (1 - beta) * g2.mean(-1),
                                v["vr"])
                vc = _in_layout(beta * v["vc"] + (1 - beta) * g2.mean(-2),
                                v["vc"])
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1, keepdim=True)[..., None],
                                       min=eps))
                upd = g32 * torch.rsqrt(denom + eps)
                new_v[k] = {"vr": vr, "vc": vc}
            else:
                nv = beta * v["v"] + (1 - beta) * g2
                upd = g32 * torch.rsqrt(nv + eps)
                new_v[k] = {"v": nv}
            rms = torch.sqrt(torch.mean(torch.square(upd)) + eps)
            upd = upd / torch.clamp(rms / clip_threshold, min=1.0)
            updates[k] = -lr * upd
        return updates, {"count": count, "v": new_v}

    return Optimizer(init, update)
