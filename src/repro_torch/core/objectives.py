"""Local objectives: what each client minimizes besides the task loss
(counterpart of ``repro/core/objectives.py``).

* ``none`` — the plain FedAvg local loss.
* ``prox(mu)`` — FedProx: ``L(w) + (mu/2)·‖w − Θ_t‖²``, pulling each local
  trajectory back toward the round's global model.
* ``dyn(alpha)`` — client-side FedDyn: ``L(w) − ⟨h_k, w⟩ +
  (alpha/2)·‖w − Θ_t‖²`` with a per-client drift tree ``h_k``, updated
  after local training as ``h_k ← h_k − alpha·(θ_k − Θ_t)`` on the honest
  pre-mask delta.  The drift rides the client-state store (tree
  ``"drift"``) beside the error-feedback residuals.

Degeneration contract: an inactive objective (``none``, ``prox(0)``,
``dyn(0)``) returns the caller's ``loss_fn`` object itself from
:meth:`LocalObjective.localize`, and carries no drift, so its round is the
plain one.  Sums over the parameter tree run in sorted leaf order, as the
reference's ``tree_leaves`` visits a dict.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

Tree = Dict[str, torch.Tensor]

__all__ = ["LocalObjective"]


def _sq_dist(params: Tree, anchor: Tree) -> torch.Tensor:
    """‖params − anchor‖² over every leaf (float32)."""
    return sum(torch.sum(torch.square((params[k] - anchor[k]).float()))
               for k in sorted(params))


def _inner(a: Tree, b: Tree) -> torch.Tensor:
    """⟨a, b⟩ over every leaf (float32)."""
    return sum(torch.sum(a[k].float() * b[k].float()) for k in sorted(a))


@dataclasses.dataclass(frozen=True)
class LocalObjective:
    """The client-side objective axis: ``kind`` in {"none", "prox",
    "dyn"} with FedProx strength ``mu`` and FedDyn strength ``alpha``.  A
    zero strength makes the objective inactive."""

    kind: str = "none"
    mu: float = 0.0
    alpha: float = 0.0

    def __post_init__(self):
        """Validate the kind and strengths."""
        if self.kind not in ("none", "prox", "dyn"):
            raise ValueError(f"unknown objective kind {self.kind!r}")
        if self.mu < 0.0:
            raise ValueError(f"mu must be >= 0, got {self.mu}")
        if self.alpha < 0.0:
            raise ValueError(f"alpha must be >= 0, got {self.alpha}")

    @classmethod
    def none(cls) -> "LocalObjective":
        """Plain FedAvg local loss (the default)."""
        return cls()

    @classmethod
    def prox(cls, mu: float) -> "LocalObjective":
        """FedProx: ``L(w) + (mu/2)·‖w − Θ_t‖²``."""
        return cls(kind="prox", mu=mu)

    @classmethod
    def dyn(cls, alpha: float) -> "LocalObjective":
        """FedDyn (client-side): ``L(w) − ⟨h_k, w⟩ + (alpha/2)·‖w − Θ_t‖²``
        with per-client drift ``h_k ← h_k − alpha·delta_k``."""
        return cls(kind="dyn", alpha=alpha)

    @property
    def active(self) -> bool:
        """True when the objective changes the local loss at all."""
        if self.kind == "prox":
            return self.mu > 0.0
        if self.kind == "dyn":
            return self.alpha > 0.0
        return False

    @property
    def uses_drift(self) -> bool:
        """True when the objective carries per-client drift state."""
        return self.kind == "dyn" and self.alpha > 0.0

    def localize(self, loss_fn: Callable, global_params: Optional[Tree] = None,
                 drift: Optional[Tree] = None) -> Callable:
        """The loss the client minimizes this round: ``loss_fn`` itself when
        inactive, else ``loss_fn`` plus the proximal (and, for FedDyn, the
        drift) term around ``global_params``.  ``drift`` is the client's
        ``h_k`` tree, required iff :attr:`uses_drift`."""
        if not self.active:
            return loss_fn
        if self.kind == "prox":
            mu = self.mu

            def prox_loss(params, batch):
                return (loss_fn(params, batch)
                        + 0.5 * mu * _sq_dist(params, global_params))

            return prox_loss
        if drift is None:
            raise ValueError("the dyn objective needs the client's drift "
                             "state (stacked_client_update's stacked_drift)")
        alpha = self.alpha

        def dyn_loss(params, batch):
            return (loss_fn(params, batch) - _inner(drift, params)
                    + 0.5 * alpha * _sq_dist(params, global_params))

        return dyn_loss

    def update_drift(self, drift: Optional[Tree],
                     delta: Tree) -> Optional[Tree]:
        """Post-round drift ``h ← h − alpha·delta`` on the honest pre-mask
        delta ``θ_k − Θ_t``; None when the objective carries no drift."""
        if not self.uses_drift:
            return None
        return {k: (h - self.alpha * delta[k].to(h.dtype)).to(h.dtype)
                for k, h in drift.items()}
