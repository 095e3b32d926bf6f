"""Step functions (counterpart of ``repro/launch/steps.py``): the training
step, the prefill step and the decode (serve) step, plus ``params_specs``,
the parameters' shapes without allocating them.

Every step takes the three modalities' batches: (B, T) text tokens, (B,
K, T) audio codebook grids, and a vision config's ``"prefix_embeds"`` (B,
P, d) beside its tokens.

The reference's ``batch_specs``, ``decode_state_specs`` and ``mesh_hints``
describe inputs and shardings for its XLA dry-run; one card lowers nothing
ahead of time, so they have no counterpart.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tr
from repro_torch.optim import (adafactor, adamw, apply_updates,
                               global_norm_scale, sgd)

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
    the gradients flow back through the casts to fp32.  As in the
    reference, that includes the MoE router (fp32 in every tree): routing
    widens the cast back to fp32.  The returned step
    carries ``.optimizer`` for ``opt.init(params)``.

    The step consumes ``params`` and ``opt_state``: it clips, updates and
    applies one leaf at a time, writing each leaf's new value and state
    into the dicts it was given, and returns them.  So beside the fp32
    weights, gradients and moments (16 bytes a parameter under AdamW) it
    holds one leaf's temporaries, not whole trees of clipped gradients,
    updates, new moments and new weights.  The values are those of the
    whole-tree update, bit for bit: every leaf's update depends only on
    its own gradient, state and the shared step count and clip factor.
    Leaves are replaced, never written in place: a caller that needs the
    pre-step weights keeps ``dict(params)``, at the cost of holding both."""
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
            loss = tr.lm_loss({k: cast(p) for k, p in leaves.items()},
                              cfg, batch, remat=remat)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        del leaves
        with torch.no_grad():
            grads = dict(zip(params, grads))
            scale, gnorm = global_norm_scale(grads, clip_norm)
            count = opt_state["count"]
            for k in list(grads):
                updates, new = opt.update({k: grads.pop(k) * scale},
                                          _leaf_state(opt_state, k, count),
                                          {k: params[k]})
                params[k] = apply_updates({k: params[k]}, updates)[k]
                for name, tree in new.items():
                    if isinstance(tree, dict):
                        opt_state[name][k] = tree[k]
                    else:               # the step count, the same each leaf
                        opt_state[name] = tree
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    train_step.optimizer = opt
    return train_step


def _leaf_state(state: dict, name: str, count: torch.Tensor) -> dict:
    """The optimizer state of leaf ``name``: each per-leaf tree cut to that
    leaf, the step count as it was before this step."""
    return {key: ({name: tree[name]} if isinstance(tree, dict) else
                  count if key == "count" else tree)
            for key, tree in state.items()}


def make_prefill_step(cfg: ArchConfig) -> Callable:
    """``prefill(params, batch) -> (B, padded vocab) fp32``: the forward
    over ``batch["tokens"]`` (B, T) (and a vision config's
    ``"prefix_embeds"``), returning the last position's logits (what
    serving needs); audio: (B, K, T) tokens give (B, K, V)."""
    def prefill(params, batch):
        with torch.no_grad():
            logits, _ = tr.forward(params, cfg, batch["tokens"],
                                   batch.get("prefix_embeds"), remat=False)
            return logits[:, -1].float()
    return prefill


def make_serve_step(cfg: ArchConfig) -> Callable:
    """``serve_step(params, state, batch) -> (logits (B, 1, vocab) fp32,
    new state)``: one decode step for ``batch["tokens"]`` (B, 1), or (B,
    K, 1) for audio, whose logits are (B, 1, K, V).  A loop
    passes ``transformer.layer_view(params, cfg)`` as ``params`` so that
    no step splits the flat dict again."""
    def serve_step(params, state, batch):
        with torch.no_grad():
            return tr.decode_step(params, cfg, state, batch["tokens"])
    return serve_step
