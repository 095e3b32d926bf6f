"""Step functions (counterpart of ``repro/launch/steps.py``): the training
step, the prefill step and the decode (serve) step, plus the inputs'
shapes without allocating them (``params_specs``, ``batch_specs``,
``decode_state_specs``: ``meta`` tensors) and ``mesh_hints``.

Every step takes the three modalities' batches: (B, T) text tokens, (B,
K, T) audio codebook grids, and a vision config's ``"prefix_embeds"`` (B,
P, d) beside its tokens.

Sharded execution: give a step ``hints=mesh_hints(mesh)`` and DTensor
inputs laid out by ``launch/shardings.py`` (parameters, optimizer state,
batch, decode state).  The step then runs on ``torch.distributed`` (NCCL
on cards, gloo on the CPU, the fake backend in the dry run) under
``implicit_replication`` (plain tensors made inside the model, positions
and masks, count as replicated), and every parameter and state leaf it
returns keeps the layout it came in.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import transformer as tr
from repro_torch.models.hints import grad_layout
from repro_torch.optim import (adafactor, adamw, apply_updates,
                               global_norm_scale, sgd)

__all__ = ["params_specs", "batch_specs", "decode_state_specs",
           "mesh_hints", "make_train_step", "make_prefill_step",
           "make_serve_step"]


def params_specs(cfg: ArchConfig, dtype_name: Optional[str] = None
                 ) -> tr.Params:
    """The parameters as ``meta`` tensors: names, shapes and dtypes of
    :func:`transformer.init_params` with nothing allocated or drawn."""
    with torch.device("meta"):
        return tr.init_params(torch.Generator(), cfg, dtype_name,
                              device="meta")


def batch_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for the batch of the step ``shape`` runs: train
    {"tokens", "labels"}, prefill {"tokens"} ((B, T) int32, (B, K, T) for
    audio; a vision config's (B, P, d) bf16 ``"prefix_embeds"`` too), and
    decode one new token {"tokens": (B, 1)} against a seq_len cache."""
    B, T = shape.global_batch, shape.seq_len
    audio = tr.is_audio(cfg)
    t = 1 if shape.mode == "decode" else T
    dims = (B, cfg.num_codebooks, t) if audio else (B, t)
    toks = torch.empty(dims, dtype=torch.int32, device="meta")
    if shape.mode == "decode":
        return {"tokens": toks}
    batch = {"tokens": toks}
    if shape.mode == "train":
        batch["labels"] = torch.empty_like(toks)
    if cfg.modality == "vision_stub":
        batch["prefix_embeds"] = torch.empty(
            (B, cfg.num_prefix_embeddings, cfg.d_model),
            dtype=torch.bfloat16, device="meta")
    return batch


def decode_state_specs(cfg: ArchConfig, shape: InputShape) -> tr.DecodeState:
    """The decode state of ``shape`` (global batch, seq_len slots) as
    ``meta`` tensors."""
    return tr.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                device="meta")


def mesh_hints(mesh):
    """Sharding hints (``models/hints.py``) of a mesh with a "model" axis;
    None without a mesh or that axis (the single-device paths)."""
    from repro_torch.models.hints import Hints
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return None
    dp = tuple(a for a in mesh.mesh_dim_names if a != "model")
    return Hints(mesh=mesh, dp=dp, model="model",
                 model_size=int(mesh.shape[mesh.mesh_dim_names.index(
                     "model")]))


def _sharded(hints):
    """``implicit_replication`` under hints, else nothing."""
    if hints is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def make_train_step(cfg: ArchConfig, *, learning_rate: float = 3e-4,
                    optimizer: str = "auto", clip_norm: float = 1.0,
                    remat: bool = True, hints=None) -> Callable:
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
    pre-step weights keeps ``dict(params)``, at the cost of holding both.

    With ``hints`` (sharded execution) the leaves are DTensors; the loss
    runs with the hints, and each new leaf and state leaf comes out in the
    layout its old one had (``launch/shardings.params_shardings_like``'s
    for the factored moments, which Adafactor reduces to it before it
    uses them), so nothing moves after the update.  Each layer gathers its weights' compute
    dtype casts over the data axes just before use (``hints.gathered``:
    FSDP's gather, bf16 under a bf16 compute dtype) and lets them go after
    it; remat gathers them again in the backward.  The gradients are
    reduced where the backward makes them, before ``autograd.grad``
    returns: an FSDP weight's is reduce-scattered over the data axes in
    the compute dtype (the gather's backward), as the reference's HLO
    reduces the bf16 gradient of the cast; a replicated leaf's (a norm
    scale, fp32) is all-reduced, once over the flattened mesh dims where
    it is partial over several (``hints.grad_layout`` on every leaf).  So
    every gradient reaches ``global_norm_scale`` and the optimizer in its
    parameter's placements, and at the step's peak a rank holds its
    shards of the weights, gradients and moments, its rows' activations
    saved at the remat boundaries, and one layer's gathered weights and
    their whole gradient before it is reduce-scattered."""
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
        with _sharded(hints):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with torch.enable_grad():
            loss = tr.lm_loss({k: grad_layout(hints, cast(p))
                               for k, p in leaves.items()},
                              cfg, batch, remat=remat, hints=hints)
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


def make_prefill_step(cfg: ArchConfig, hints=None) -> Callable:
    """``prefill(params, batch) -> (B, padded vocab) fp32``: the forward
    over ``batch["tokens"]`` (B, T) (and a vision config's
    ``"prefix_embeds"``), returning the last position's logits (what
    serving needs); audio: (B, K, T) tokens give (B, K, V)."""
    def prefill(params, batch):
        with torch.no_grad(), _sharded(hints):
            logits, _ = tr.forward(params, cfg, batch["tokens"],
                                   batch.get("prefix_embeds"), remat=False,
                                   hints=hints)
            return logits[:, -1].float()
    return prefill


def make_serve_step(cfg: ArchConfig, hints=None) -> Callable:
    """``serve_step(params, state, batch) -> (logits (B, 1, vocab) fp32,
    new state)``: one decode step for ``batch["tokens"]`` (B, 1), or (B,
    K, 1) for audio, whose logits are (B, 1, K, V).  A loop
    passes ``transformer.layer_view(params, cfg)`` as ``params`` so that
    no step splits the flat dict again."""
    def serve_step(params, state, batch):
        with torch.no_grad(), _sharded(hints):
            return tr.decode_step(params, cfg, state, batch["tokens"],
                                  hints=hints)
    return serve_step
