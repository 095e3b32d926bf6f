"""Carry parameters between the reference's nested-dict pytrees and the
port's flat dict of tensors.

The port names a leaf by its dotted path (``"fc1.w"``) and keeps leaves in
the order ``jax.tree_util.tree_flatten`` visits them: sorted keys at every
level.  Segment ids, per-leaf k and the COO wire all follow that order, so
keeping it makes them match the reference one to one.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["flatten_tree", "params_from_numpy", "params_to_numpy"]


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> flat ``{dotted path: leaf}`` in sorted-key order."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key in sorted(tree):
        path = f"{prefix}.{key}" if prefix else str(key)
        out.update(flatten_tree(tree[key], path))
    return out


def params_from_numpy(tree: Any, device=None) -> Dict[str, torch.Tensor]:
    """Reference parameter pytree (nested dicts of arrays) -> the port's
    flat dict of tensors on ``device`` (``cuda`` unless named)."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(leaf, copy=True)).to(dev)
            for name, leaf in flatten_tree(tree).items()}


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's flat dict of tensors -> nested dicts of numpy arrays,
    the layout the reference's parameter pytrees use."""
    out: Dict[str, Any] = {}
    for name, leaf in params.items():
        node = out
        *parents, last = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf.detach().cpu().numpy()
    return out
