"""Sparse COO payloads for masked uploads (counterpart of
``repro/core/compression.py``; this slice ports the coordinate encoding).

``encode_sparse`` ships the k nonzero (index, value) pairs of a masked
tensor with int32 indices, plus the tensor's int32 ``shape`` vector.  Slots
are ranked by magnitude with a stable index tie-break, so a tensor with at
most k nonzeros round-trips bit-exactly and one that overflows its budget
sheds its smallest values.  ``decode_sparse`` scatters a payload back and
raises ``ValueError`` on a malformed one.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

__all__ = ["pytree_num_params", "encode_sparse", "decode_sparse",
           "encode_sparse_rows", "decode_sparse_rows"]


def pytree_num_params(tree: Dict[str, torch.Tensor]) -> int:
    """Total number of parameters in a flat tree."""
    return int(sum(leaf.numel() for leaf in tree.values()))


def encode_sparse_rows(flat: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise COO encoding of (C, n) masked rows: (C, k) int32 indices and
    (C, k) values, magnitude-ranked with a stable index tie-break and zeros
    ranked last."""
    nz = flat != 0
    key = torch.where(nz, -flat.abs().to(torch.float32),
                      torch.full_like(flat, float("inf"), dtype=torch.float32))
    idx = torch.argsort(key, dim=1, stable=True)[:, :k]
    vals = torch.gather(flat, 1, idx)
    vals = torch.where(torch.gather(nz, 1, idx), vals, torch.zeros_like(vals))
    return idx.to(torch.int32), vals


def decode_sparse_rows(indices: torch.Tensor, values: torch.Tensor,
                       size: int) -> torch.Tensor:
    """Scatter (C, k) COO rows back to dense (C, size) rows."""
    out = torch.zeros((values.shape[0], size), dtype=values.dtype,
                      device=values.device)
    return out.scatter_add_(1, indices.long(), values)


def encode_sparse(masked: torch.Tensor, k: int) -> Dict[str, torch.Tensor]:
    """Coordinate-encode a masked tensor: ``{"indices": (k,) int32,
    "values": (k,), "shape": (ndim,) int32}``, zero-padded when fewer than k
    entries are nonzero."""
    if k < 1:
        raise ValueError(f"encode_sparse needs k >= 1, got {k}")
    flat = masked.reshape(-1)
    if k > flat.numel():
        raise ValueError(
            f"encode_sparse k={k} exceeds tensor size {flat.numel()}")
    idx, vals = encode_sparse_rows(flat[None], k)
    return {"indices": idx[0], "values": vals[0],
            "shape": torch.tensor(tuple(masked.shape), dtype=torch.int32)}


def _check_array(x: Any, name: str) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    try:
        arr = np.asarray(x)
    except Exception as e:  # noqa: BLE001 - any failure means "not array-like"
        raise ValueError(f"{name} is not array-like: {type(x).__name__}") from e
    if arr.dtype == object:
        raise ValueError(f"{name} is not array-like: {type(x).__name__}")
    return torch.from_numpy(arr)


def decode_sparse(payload: Dict[str, Any]) -> torch.Tensor:
    """Decode a COO payload back to a dense tensor.

    Missing keys, non-integer indices, an index/value length mismatch, a
    negative shape, more slots than elements, out-of-range indices or
    non-finite values raise ``ValueError``.
    """
    missing = {"indices", "values", "shape"} - set(payload)
    if missing:
        raise ValueError(f"sparse payload missing keys {sorted(missing)}")
    indices = _check_array(payload["indices"], "sparse indices")
    values = _check_array(payload["values"], "sparse values")
    if indices.dtype.is_floating_point or indices.dtype.is_complex \
            or indices.dtype == torch.bool:
        raise ValueError(
            f"sparse indices must be integers, got {indices.dtype}")
    if indices.shape != values.shape or indices.dim() != 1:
        raise ValueError(
            f"sparse indices/values must be matching 1-D arrays, got "
            f"{tuple(indices.shape)} vs {tuple(values.shape)}")
    shape = tuple(int(s) for s in payload["shape"])
    if any(s < 0 for s in shape):
        raise ValueError(f"sparse payload has negative shape {shape}")
    size = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if indices.shape[0] > size:
        raise ValueError(
            f"sparse payload has {indices.shape[0]} slots for a tensor of "
            f"{size} elements")
    if indices.numel():
        lo, hi = int(indices.min()), int(indices.max())
        if lo < 0 or hi >= size:
            raise ValueError(
                f"sparse indices out of range [0, {size}): [{lo}, {hi}]")
    if values.dtype.is_floating_point and values.numel() \
            and not bool(torch.isfinite(values).all()):
        raise ValueError("sparse payload values contain non-finite entries")
    indices = indices.to(values.device)
    return decode_sparse_rows(indices[None], values[None], size)[0].reshape(
        shape)
