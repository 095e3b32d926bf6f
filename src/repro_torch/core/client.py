"""On-device client update (paper Alg. 2 / Alg. 4 lines 4-8; counterpart of
``repro/core/client.py``).

A client downloads the global parameters, runs ``E`` local epochs of
mini-batch SGD on its shard, computes the parameter delta, masks it and
uploads.  The reference vmaps one client's update over the cohort; here the
cohort is a batch dimension written out: ``torch.func.vmap`` of the
per-client gradient over the stacked parameters, then ONE masking call for
the whole stacked delta (``masking.mask_stacked``, which on the kernel
backend is one launch of each segmented kernel per round).

Upload semantics: ``"delta"`` (default) uploads ``mask(W_{t+1} - W_t)``;
``"zero"`` is the literal Alg. 4 line 14, masked *weights*.

The local loss is the objective's (``objectives.LocalObjective.localize``):
FedProx and FedDyn add their terms around the round's global parameters,
and FedDyn's per-client drift rows enter the vmap beside the parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.masking import MaskingConfig, mask_stacked
from repro_torch.core.objectives import LocalObjective

Tree = Dict[str, torch.Tensor]
LossFn = Callable[[Tree, Sequence[torch.Tensor]], torch.Tensor]

__all__ = ["ClientConfig", "local_sgd", "local_sgd_stacked", "client_update",
           "stacked_client_update", "local_update_flops"]


@dataclasses.dataclass(frozen=True)
class ClientConfig:
    """Per-client hyperparameters: local SGD (epochs, lr, momentum), the
    mask policy applied to the delta, the upload semantics
    ("delta" | "zero") and the local objective."""

    local_epochs: int = 1
    learning_rate: float = 0.01
    momentum: float = 0.0
    masking: MaskingConfig = MaskingConfig()
    upload: str = "delta"  # delta | zero
    objective: LocalObjective = LocalObjective()


def local_sgd_stacked(loss_fn: LossFn, params: Tree,
                      batches: Sequence[torch.Tensor], cfg: ClientConfig,
                      drift: Optional[Tree] = None
                      ) -> Tuple[Tree, torch.Tensor]:
    """E epochs of SGD for C clients at once.

    ``params``: client-stacked tree (leading C axis); ``batches``: tensors
    with leading (C, num_batches, ...) axes; ``drift``: client-stacked rows
    passed to ``loss_fn(params, batch, drift)`` when given.  Returns
    ``(params, mean_loss (C,))``, the loss averaged over each epoch's
    batches and then over epochs, as the reference does.
    """
    step_fn = vmap(grad_and_value(loss_fn))
    extra = () if drift is None else (drift,)
    vel = {k: torch.zeros_like(v) for k, v in params.items()}
    num_batches = batches[0].shape[1]
    epoch_losses = []
    for _ in range(cfg.local_epochs):
        losses = []
        for b in range(num_batches):
            grads, loss = step_fn(params, tuple(x[:, b] for x in batches),
                                  *extra)
            if cfg.momentum > 0.0:
                vel = {k: cfg.momentum * vel[k] + grads[k] for k in grads}
                step = vel
            else:
                step = grads
            params = {k: p - cfg.learning_rate * step[k].to(p.dtype)
                      for k, p in params.items()}
            losses.append(loss)
        epoch_losses.append(torch.stack(losses, 1).mean(1))
    return params, torch.stack(epoch_losses, 1).mean(1)


def local_sgd(loss_fn: LossFn, params: Tree, batches: Sequence[torch.Tensor],
              cfg: ClientConfig) -> Tuple[Tree, torch.Tensor]:
    """E epochs of SGD for one client over ``batches`` (leading
    (num_batches, ...) axes).  Returns ``(new_params, mean_loss)``."""
    out, losses = local_sgd_stacked(loss_fn,
                                    {k: v[None] for k, v in params.items()},
                                    [x[None] for x in batches], cfg)
    return {k: v[0] for k, v in out.items()}, losses[0]


def stacked_client_update(loss_fn: LossFn, global_params: Tree,
                          stacked_batches: Sequence[torch.Tensor],
                          cfg: ClientConfig, stacked_residuals: Optional[Tree],
                          error_feedback: bool,
                          mask_scores: Optional[Tree] = None,
                          stacked_drift: Optional[Tree] = None,
                          ) -> Tuple[Tree, Tree, Optional[Tree],
                                     torch.Tensor]:
    """One round of local work for a cohort of C clients: local SGD ->
    delta -> (error feedback) -> mask.

    Returns stacked ``(uploads, new_residuals, new_drift, losses)``.
    ``new_residuals`` is the masked-out remainder when ``error_feedback``,
    else zeros.  ``mask_scores`` feeds random masking its per-entry uniform
    draws.  ``stacked_drift`` holds the FedDyn drift rows (required iff
    ``cfg.objective.uses_drift``); ``new_drift`` is their post-round update
    on the honest pre-mask delta, or None without drift.
    """
    num_clients = stacked_batches[0].shape[0]
    obj = cfg.objective
    if obj.uses_drift:
        if stacked_drift is None:
            raise ValueError("the dyn objective needs stacked_drift")

        def local_loss(params, batch, drift):
            return obj.localize(loss_fn, global_params, drift)(params, batch)
    else:
        local_loss, stacked_drift = obj.localize(loss_fn, global_params), None
    start = {k: v.expand((num_clients,) + v.shape).clone()
             for k, v in global_params.items()}
    local, losses = local_sgd_stacked(local_loss, start, stacked_batches, cfg,
                                      stacked_drift)
    delta = {k: local[k] - global_params[k] for k in local}
    new_drift = obj.update_drift(stacked_drift, delta)
    if error_feedback:
        delta = {k: delta[k] + stacked_residuals[k] for k in delta}

    masked = mask_stacked(delta, cfg.masking, mask_scores)

    if error_feedback:
        new_residuals = {k: delta[k] - masked[k] for k in delta}
    else:
        new_residuals = {k: torch.zeros_like(d) for k, d in delta.items()}

    if cfg.upload == "delta":
        uploads = masked
    elif cfg.upload == "zero":
        # Literal Alg. 4: masked *weights*, +0.0 where the mask dropped.
        # With masking disabled nothing is dropped.
        local_w = {k: global_params[k] + delta[k] for k in delta}
        if cfg.masking.mode == "none" or cfg.masking.gamma >= 1.0:
            uploads = local_w
        else:
            uploads = {k: torch.where(masked[k] != 0, w, torch.zeros_like(w))
                       if w.dim() > 1 else w for k, w in local_w.items()}
    else:
        raise ValueError(f"unknown upload semantics {cfg.upload!r}")
    return uploads, new_residuals, new_drift, losses


def client_update(loss_fn: LossFn, global_params: Tree,
                  batches: Sequence[torch.Tensor], cfg: ClientConfig,
                  residual: Optional[Tree] = None,
                  mask_scores: Optional[Tree] = None,
                  drift: Optional[Tree] = None,
                  ) -> Tuple[Tree, Tree, Optional[Tree], torch.Tensor]:
    """One client's round: ``(upload, new_residual, new_drift,
    mean_loss)``; pass a ``residual`` tree to turn on error feedback and
    the client's ``drift`` tree under FedDyn."""
    def one(tree):
        return None if tree is None else {k: v[None] for k, v in tree.items()}

    def first(tree):
        return None if tree is None else {k: v[0] for k, v in tree.items()}

    uploads, res, new_drift, losses = stacked_client_update(
        loss_fn, global_params, [x[None] for x in batches], cfg,
        one(residual), residual is not None, one(mask_scores), one(drift))
    return first(uploads), first(res), first(new_drift), losses[0]


def local_update_flops(stacked_batches: Sequence[torch.Tensor],
                       num_params: int, cfg: ClientConfig) -> int:
    """Per-client FLOP proxy for one round: 6 * params * examples seen,
    times local epochs (leading axes: clients, num_batches, batch)."""
    leaf = stacked_batches[0]
    examples = int(leaf.shape[1]) * int(leaf.shape[2])
    return 6 * int(num_params) * examples * int(cfg.local_epochs)
