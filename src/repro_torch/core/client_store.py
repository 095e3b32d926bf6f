"""Per-client server state (counterpart of ``repro/core/client_store.py``).

``DenseStore`` holds, for all M clients, the named per-client state trees
as dense ``(M, …)`` stacked tensors — ``"residuals"`` (error feedback)
always, plus any ``extra_trees`` (FedDyn's ``"drift"``) — and, for the
adaptive samplers, the ``(M,)`` EMA of each client's observed update norm
(ones at start: every client looks equally important until data
arrives).  The sharded backend, ``state``/``load_state`` and checkpoints
wait for ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]

__all__ = ["DenseStore"]


class DenseStore:
    """Dense ``(M, …)`` stacked state trees, zeros at start, on the
    template's device."""

    kind = "dense"

    def __init__(self, num_clients: int, template: Tree,
                 track_norms: bool = False,
                 extra_trees: Optional[Dict[str, Tree]] = None):
        """Zero rows shaped like ``template`` (and like each extra tree)
        for ``num_clients`` clients; ``track_norms`` adds the norm EMA."""
        if num_clients < 1:
            raise ValueError(f"num_clients must be >= 1, got {num_clients}")
        if extra_trees and "residuals" in extra_trees:
            raise ValueError("extra_trees may not shadow the 'residuals' tree")
        self.num_clients = int(num_clients)
        device = next(iter(template.values())).device
        self._data: Dict[str, Tree] = {
            name: {k: torch.zeros((num_clients,) + tuple(v.shape),
                                  dtype=v.dtype, device=v.device)
                   for k, v in tree.items()}
            for name, tree in {"residuals": template,
                               **(extra_trees or {})}.items()}
        self._norms: Optional[torch.Tensor] = (
            torch.ones(num_clients, dtype=torch.float32, device=device)
            if track_norms else None)

    @property
    def trees(self) -> Tuple[str, ...]:
        """Names of the per-client state trees this store holds."""
        return tuple(self._data)

    def _tree(self, tree: str) -> Tree:
        if tree not in self._data:
            raise KeyError(f"store holds no state tree {tree!r}; trees: "
                           f"{', '.join(self._data)}")
        return self._data[tree]

    def gather(self, ids, tree: str = "residuals") -> Tree:
        """Stacked ``tree`` rows for ``ids``."""
        idx = torch.as_tensor(ids, dtype=torch.int64)
        return {k: v.index_select(0, idx.to(v.device))
                for k, v in self._tree(tree).items()}

    def scatter(self, ids, rows: Tree, commit, tree: str = "residuals"
                ) -> None:
        """Write back ``rows[i]`` for every i with ``commit[i] > 0``; the
        other rows keep their state (the upload was dropped or
        quarantined)."""
        data = self._tree(tree)
        idx = torch.as_tensor(ids, dtype=torch.int64)
        commit = torch.as_tensor(commit, dtype=torch.float32)
        out = {}
        for k, old in data.items():
            i = idx.to(old.device)
            keep = commit.to(old.device).reshape(
                (-1,) + (1,) * (old.dim() - 1))
            out[k] = old.index_copy(0, i, torch.where(
                keep > 0, rows[k], old.index_select(0, i)))
        self._data[tree] = out

    def dense_view(self, tree: str = "residuals") -> Tree:
        """The stacked backing of one tree itself (no copy)."""
        return self._tree(tree)

    def residuals_dense(self) -> Tree:
        """``dense_view("residuals")``."""
        return self.dense_view("residuals")

    def set_dense(self, value: Tree, tree: str = "residuals") -> None:
        """Replace a whole stacked tree (the round bodies gather and
        scatter rows themselves)."""
        self._tree(tree)
        self._data[tree] = value

    @property
    def norms(self) -> Optional[torch.Tensor]:
        """The per-client update-norm EMA, or None without tracking."""
        return self._norms

    def _check_norms(self) -> None:
        if self._norms is None:
            raise ValueError("the store was built without norm tracking "
                             "(track_norms=False)")

    def set_norms(self, norms) -> None:
        """Replace the whole norm-EMA vector."""
        self._check_norms()
        self._norms = torch.as_tensor(norms, dtype=torch.float32).to(
            self._norms.device)

    def update_norms(self, ids, values) -> None:
        """Set the norm rows at ``ids`` to ``values``."""
        self._check_norms()
        idx = torch.as_tensor(ids, dtype=torch.int64).to(self._norms.device)
        self._norms = self._norms.index_copy(
            0, idx, torch.as_tensor(values, dtype=torch.float32).to(
                self._norms.device))
