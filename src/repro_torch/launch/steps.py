"""Step functions of the serving path (counterpart of
``repro/launch/steps.py``): the prefill step and the decode (serve) step,
plus ``params_specs``, the parameters' shapes without allocating them.

The reference's training step, input specs and mesh hints belong to the
training and pod paths, which are not ported yet (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tr

__all__ = ["params_specs", "make_prefill_step", "make_serve_step"]


def params_specs(cfg: ArchConfig, dtype_name: Optional[str] = None
                 ) -> tr.Params:
    """The parameters as ``meta`` tensors: names, shapes and dtypes of
    :func:`transformer.init_params` with nothing allocated or drawn."""
    with torch.device("meta"):
        return tr.init_params(torch.Generator(), cfg, dtype_name,
                              device="meta")


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
