"""Checkpoints of nested trees of tensors (counterpart of
``repro/checkpoint/checkpoint.py``), in the reference's on-disk format, so a
checkpoint written by either package restores in the other.

Layout: ``<dir>/step_%08d/arrays.npz`` holds the leaves as ``a0 … an``;
``manifest.json`` beside it holds ``step``, ``keys``, ``dtypes``, ``shapes``
and ``extra``.  A step is written to ``step_N.tmp`` and renamed into place,
so a crash never leaves a half-written step visible to :func:`latest_step`.

A leaf's key is the string JAX's ``keystr`` gives for its path in the same
nested dict: dict keys sorted and written ``['params']['conv1.w']``, list
and tuple items ``[0]``; ``None`` holds no leaf.  npz has no bf16, so a
bf16 leaf is stored as its ``uint16`` bits under the manifest dtype
``"bfloat16"`` and restored through ``Tensor.view(torch.bfloat16)``
(fp8 likewise through ``uint8``), with no ``ml_dtypes``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "read_manifest"]

# Manifest dtype names of the types npz cannot hold, with the unsigned
# integer type of their bits and the torch type they restore to.
_BITS = {"bfloat16": (np.uint16, torch.bfloat16),
         "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
         "float8_e5m2": (np.uint8, torch.float8_e5m2)}
_TORCH_NAMES = {torch_dtype: name for name, (_, torch_dtype)
                in _BITS.items()}


def _flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``(keystr, leaf)`` pairs in JAX's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for key in sorted(tree)
                for pair in _flatten(tree[key], f"{path}[{key!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, sub in enumerate(tree)
                for pair in _flatten(sub, f"{path}[{i}]")]
    return [(path, tree)]


def _rebuild(like: Any, leaves: Dict[str, Any], path: str = "") -> Any:
    """``like``'s structure with each leaf taken from ``leaves`` by key."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {key: _rebuild(sub, leaves, f"{path}[{key!r}]")
                for key, sub in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(sub, leaves, f"{path}[{i}]")
                          for i, sub in enumerate(like))
    return leaves[path]


def _to_savable(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as an array npz can hold, and its manifest dtype name."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        name = _TORCH_NAMES.get(leaf.dtype)
        if name is not None:
            bits = _BITS[name][0]
            signed = torch.int16 if bits == np.uint16 else torch.int8
            return leaf.view(signed).numpy().view(bits), name
        leaf = leaf.numpy()
    v = np.asarray(leaf)
    name = str(v.dtype)
    if name in _BITS:
        return v.view(_BITS[name][0]), name
    return v, name


def _from_savable(v: np.ndarray, dtype_name: str) -> torch.Tensor:
    """The stored array as a tensor of its manifest dtype."""
    if dtype_name in _BITS:
        signed = np.int16 if _BITS[dtype_name][0] == np.uint16 else np.int8
        return torch.from_numpy(v.view(signed)).view(_BITS[dtype_name][1])
    return torch.from_numpy(v)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Write ``tree`` (nested dicts, lists and tuples of tensors or arrays)
    as step ``step`` under ``ckpt_dir``, atomically; returns the step's
    directory.  ``extra`` is stored in the manifest as it is (JSON)."""
    flat = _flatten(tree)
    saved = [_to_savable(leaf) for _, leaf in flat]
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": v for i, (v, _) in enumerate(saved)})
    manifest = {"step": step, "keys": [key for key, _ in flat],
                "dtypes": [name for _, name in saved],
                "shapes": [list(v.shape) for v, _ in saved],
                "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest complete step under ``ckpt_dir`` (``.tmp`` steps are
    ignored), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _resolve(ckpt_dir: str, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    return step


def read_manifest(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The manifest of one step (the latest unless given), without loading
    the arrays."""
    path = _step_dir(ckpt_dir, _resolve(ckpt_dir, step))
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def restore_checkpoint(ckpt_dir: str, like: Any, step: Optional[int] = None
                       ) -> Tuple[Any, int, dict]:
    """Restore a step (the latest unless given) into the structure of
    ``like``: ``(tree, step, extra)``.  Each leaf comes back as a tensor
    with the ``like`` leaf's dtype and device (a non-tensor ``like`` leaf
    gives a CPU tensor of the stored dtype).  A structure or shape
    mismatch raises before anything is returned."""
    step = _resolve(ckpt_dir, step)
    manifest = read_manifest(ckpt_dir, step)
    flat_like = _flatten(like)
    keys = [key for key, _ in flat_like]
    if keys != manifest["keys"]:
        raise ValueError("checkpoint structure mismatch: "
                         f"{sorted(set(keys) ^ set(manifest['keys']))}")
    for (key, leaf), shape in zip(flat_like, manifest["shapes"]):
        if tuple(np.shape(leaf)) != tuple(shape):
            raise ValueError(f"shape mismatch at {key}: checkpoint "
                             f"{tuple(shape)}, expected "
                             f"{tuple(np.shape(leaf))}")
    leaves = {}
    with np.load(os.path.join(_step_dir(ckpt_dir, step), "arrays.npz")) \
            as data:
        for i, (key, leaf) in enumerate(flat_like):
            v = _from_savable(data[f"a{i}"], manifest["dtypes"][i])
            if isinstance(leaf, torch.Tensor):
                v = v.to(device=leaf.device, dtype=leaf.dtype)
            leaves[key] = v
    return (_rebuild(like, leaves), manifest["step"],
            manifest.get("extra", {}))
