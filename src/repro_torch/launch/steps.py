"""Step functions (counterpart of ``repro/launch/steps.py``): the training
step, the prefill step and the decode (serve) step, plus ``params_specs``,
the parameters' shapes without allocating them.

The reference's ``batch_specs``, ``decode_state_specs`` and ``mesh_hints``
describe inputs and shardings for its XLA dry-run; one card lowers nothing
ahead of time, so they have no counterpart (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tr
from repro_torch.optim import (adafactor, adamw, apply_updates,
                               clip_by_global_norm, sgd)

__all__ = ["params_specs", "make_train_step", "make_prefill_step",
           "make_serve_step"]


def params_specs(cfg: ArchConfig, dtype_name: Optional[str] = None
                 ) -> tr.Params:
    """The parameters as ``meta`` tensors: names, shapes and dtypes of
    :func:`transformer.init_params` with nothing allocated or drawn."""
    with torch.device("meta"):
        return tr.init_params(torch.Generator(), cfg, dtype_name,
                              device="meta")


def make_train_step(cfg: ArchConfig, *, learning_rate: float = 3e-4,
                    optimizer: str = "auto", clip_norm: float = 1.0,
                    remat: bool = True) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: one step of ``lm_loss`` with gradients
    clipped to ``clip_norm``.

    ``optimizer="auto"`` takes Adafactor for models past 3e10 of
    ``num_layers * d_model^2`` or with 64 experts or more, AdamW
    otherwise, as the reference.  fp32 master weights of ndim >= 2 are
    cast once a step to the compute dtype and the loss runs on the casts;
    the gradients flow back through the casts to fp32.  The returned step
    carries ``.optimizer`` for ``opt.init(params)``."""
    if optimizer == "auto":
        big = cfg.num_layers * cfg.d_model ** 2 > 3e10 or \
            cfg.moe_experts >= 64
        optimizer = "adafactor" if big else "adamw"
    opt = {"adamw": adamw, "adafactor": adafactor,
           "sgd": sgd}[optimizer](learning_rate)
    cdt = tr._dt(cfg.compute_dtype)

    def cast(p: torch.Tensor) -> torch.Tensor:
        if p.dtype != torch.float32 or p.dim() < 2:
            return p
        return p.to(cdt)

    def train_step(params, opt_state, batch):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with torch.enable_grad():
            logits, aux = tr.forward({k: cast(p) for k, p in leaves.items()},
                                     cfg, batch["tokens"],
                                     batch.get("prefix_embeds"), remat=remat)
            loss = tr.cross_entropy(logits, batch["labels"]) + \
                cfg.router_aux_coef * aux
            grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(dict(zip(params, grads)),
                                               clip_norm)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    train_step.optimizer = opt
    return train_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """``prefill(params, batch) -> (B, padded vocab) fp32``: the forward
    over ``batch["tokens"]`` (B, T), returning the last position's logits
    (what serving needs)."""
    def prefill(params, batch):
        with torch.no_grad():
            logits, _ = tr.forward(params, cfg, batch["tokens"],
                                   batch.get("prefix_embeds"), remat=False)
            return logits[:, -1].float()
    return prefill


def make_serve_step(cfg: ArchConfig) -> Callable:
    """``serve_step(params, state, batch) -> (logits (B, 1, vocab) fp32,
    new state)``: one decode step for ``batch["tokens"]`` (B, 1).  A loop
    passes ``transformer.layer_view(params, cfg)`` as ``params`` so that
    no step splits the flat dict again."""
    def serve_step(params, state, batch):
        with torch.no_grad():
            return tr.decode_step(params, cfg, state, batch["tokens"])
    return serve_step
