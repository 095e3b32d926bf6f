"""Local objectives: what each client minimizes besides the task loss
(counterpart of ``repro/core/objectives.py``).

This slice carries the inactive path only: ``none`` (and a zero-strength
``prox``/``dyn``, which the reference also treats as inactive) returns the
caller's ``loss_fn`` itself.  Active FedProx and FedDyn wait for ROADMAP
Queue 1 item 11 (the client-state store, which holds FedDyn's drift):
building one raises ``NotImplementedError`` until then.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["LocalObjective"]

_WAITS = ("active FedProx/FedDyn objectives are not ported yet "
          "(ROADMAP Queue 1 item 11)")


@dataclasses.dataclass(frozen=True)
class LocalObjective:
    """The client-side objective axis: ``kind`` in {"none", "prox",
    "dyn"} with FedProx strength ``mu`` and FedDyn strength ``alpha``."""

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
        if self.active:
            raise NotImplementedError(_WAITS)

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
        """FedDyn (client-side): ``L(w) − ⟨h_k, w⟩ + (alpha/2)·‖w − Θ_t‖²``."""
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

    def localize(self, loss_fn: Callable) -> Callable:
        """The loss the client minimizes: ``loss_fn`` itself (only inactive
        objectives can be built in this slice)."""
        return loss_fn
