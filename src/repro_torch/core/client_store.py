"""Per-client server state (counterpart of ``repro/core/client_store.py``).

This slice ports the part of ``DenseStore`` the server reads: the dense
``(M, …)`` stacked error-feedback residuals.  Norm EMAs, extra state trees,
the sharded backend and checkpointing wait for ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

from typing import Dict

import torch

Tree = Dict[str, torch.Tensor]

__all__ = ["DenseStore"]


class DenseStore:
    """The dense ``(M, …)`` stacked residual arrays, zeros at start."""

    kind = "dense"

    def __init__(self, num_clients: int, template: Tree):
        """Zero residual rows shaped like ``template`` for ``num_clients``
        clients, on the template's device."""
        if num_clients < 1:
            raise ValueError(f"num_clients must be >= 1, got {num_clients}")
        self.num_clients = int(num_clients)
        self._residuals: Tree = {
            k: torch.zeros((num_clients,) + tuple(v.shape), dtype=v.dtype,
                           device=v.device)
            for k, v in template.items()}

    def residuals_dense(self) -> Tree:
        """The stacked residual backing itself (no copy)."""
        return self._residuals

    def set_dense(self, value: Tree) -> None:
        """Replace the whole stacked residual tree (the round bodies
        gather/scatter rows themselves)."""
        self._residuals = value
