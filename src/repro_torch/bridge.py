"""Carry parameters between the reference's pytrees and the port's flat
dict of tensors.

The port names a leaf by its dotted path (``"fc1.w"``,
``"layers.0.time_mix.wr"``) and keeps leaves in the order
``jax.tree_util.tree_flatten`` visits them: sorted keys at every dict
level, tuple items in their order (a tuple item's name part is its index).
Segment ids, per-leaf k and the COO wire all follow that order, so keeping
it makes them match the reference one to one.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["flatten_tree", "unflatten_tree", "tree_map", "params_from_numpy",
           "params_to_numpy"]


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts and tuples -> flat ``{dotted path: leaf}`` in the
    reference's leaf order."""
    if isinstance(tree, dict):
        items = [(str(key), tree[key]) for key in sorted(tree)]
    elif isinstance(tree, tuple):
        items = [(str(i), item) for i, item in enumerate(tree)]
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, sub in items:
        out.update(flatten_tree(sub, f"{prefix}.{key}" if prefix else key))
    return out


def _freeze(node: Dict[str, Any]) -> Any:
    """A node whose keys are exactly "0", "1", ... becomes a tuple."""
    node = {key: _freeze(sub) if isinstance(sub, dict) else sub
            for key, sub in node.items()}
    if node and all(key.isdigit() for key in node):
        if sorted(int(key) for key in node) == list(range(len(node))):
            return tuple(node[str(i)] for i in range(len(node)))
    return node


def unflatten_tree(flat: Dict[str, Any]) -> Any:
    """Flat ``{dotted path: leaf}`` -> nested dicts, with a tuple wherever
    a level's names are the indices 0, 1, ... (``params["layers"]``)."""
    out: Dict[str, Any] = {}
    for name, leaf in flat.items():
        node = out
        *parents, last = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return _freeze(out)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` on every leaf of nested dicts and tuples, same structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, sub) for key, sub in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, sub) for sub in tree)
    return fn(tree)


def params_from_numpy(tree: Any, device=None) -> Dict[str, torch.Tensor]:
    """Reference parameter pytree (nested dicts and tuples of arrays) ->
    the port's flat dict of tensors on ``device`` (``cuda`` unless
    named)."""
    dev = resolve_device(device)
    return {name: _to_tensor(np.array(leaf, copy=True)).to(dev)
            for name, leaf in flatten_tree(tree).items()}


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    """numpy -> tensor; a bfloat16 array keeps its bits."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_to_numpy(params: Dict[str, torch.Tensor]) -> Any:
    """The port's flat dict of tensors -> nested dicts (and tuples) of
    numpy arrays, the layout the reference's parameter pytrees use.  A
    bfloat16 leaf keeps its bits (as an ``ml_dtypes`` bfloat16 array)."""
    return unflatten_tree({name: _to_numpy(leaf)
                           for name, leaf in params.items()})


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes        # numpy has no bfloat16 of its own
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
