"""Wire codecs: real ``encode -> wire tree -> decode`` upload transforms
(counterpart of ``repro/core/codecs.py``; this slice ports the identity and
COO codecs).

* ``IdentityCodec`` — dense pass-through.
* ``SparseCodec``   — per-leaf COO of a masked delta: ``k = max(1,
  round(gamma * n))`` int32 index + value slots per maskable leaf, plus the
  leaf's int32 shape vector; leaves under ``min_leaf_size`` ship dense.

Every codec reports **exact** wire bytes: ``wire_bytes(tree)`` encodes a
shape-only (``meta`` device) template and sums the bytes of every wire
leaf.  ``roundtrip_stacked`` applies a codec to a client-stacked upload tree
inside the round — for the COO codec as one batched sort/scatter per leaf —
so what aggregation consumes is exactly what survived the wire.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.core.compression import (decode_sparse, decode_sparse_rows,
                                          encode_sparse, encode_sparse_rows)

Tree = Dict[str, torch.Tensor]

__all__ = ["UploadCodec", "IdentityCodec", "SparseCodec", "tree_wire_nbytes",
           "roundtrip_stacked"]


def _wire_leaves(wire: Any):
    if isinstance(wire, dict):
        for value in wire.values():
            yield from _wire_leaves(value)
    else:
        yield wire


def tree_wire_nbytes(wire: Any) -> int:
    """Exact serialized bytes of a wire tree: sum of leaf nbytes (COO
    indices, values AND shape vectors)."""
    return int(sum(leaf.numel() * leaf.element_size()
                   for leaf in _wire_leaves(wire)))


def _reject_nonfinite(leaf: torch.Tensor, codec_name: str) -> torch.Tensor:
    """Decode-boundary validation: a float payload carrying NaN/Inf
    raises ``ValueError`` before it can reach aggregation."""
    if leaf.dtype.is_floating_point and leaf.numel() \
            and not bool(torch.isfinite(leaf).all()):
        raise ValueError(
            f"{codec_name} decode: payload contains non-finite values")
    return leaf


@dataclasses.dataclass(frozen=True)
class UploadCodec:
    """Base wire codec with static wire shapes."""

    name = "identity"

    def encode(self, tree: Tree) -> Dict[str, Any]:
        """Upload tree -> wire tree."""
        raise NotImplementedError

    def decode(self, wire: Dict[str, Any]) -> Tree:
        """Wire tree -> upload tree (inverse of :meth:`encode`)."""
        raise NotImplementedError

    def roundtrip(self, tree: Tree) -> Tree:
        """What the server sees after the upload crosses the wire."""
        return self.decode(self.encode(tree))

    def roundtrip_stacked(self, stacked: Tree) -> Tree:
        """:meth:`roundtrip` of every client of a client-stacked tree."""
        raise NotImplementedError

    def wire_bytes(self, tree: Tree) -> int:
        """EXACT bytes of ``encode(tree)``, from a shape-only template."""
        template = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                    for k, v in tree.items()}
        return tree_wire_nbytes(self.encode(template))


@dataclasses.dataclass(frozen=True)
class IdentityCodec(UploadCodec):
    """Dense pass-through: the wire is the tree itself."""

    name = "identity"

    def encode(self, tree: Tree) -> Tree:
        """The wire IS the upload tree."""
        return tree

    def decode(self, wire: Tree) -> Tree:
        """The upload IS the wire tree — after the non-finite gate."""
        return {k: _reject_nonfinite(v, "identity") for k, v in wire.items()}

    def roundtrip(self, tree: Tree) -> Tree:
        """Free: dense pass-through loses nothing."""
        return tree

    def roundtrip_stacked(self, stacked: Tree) -> Tree:
        """Free for every client."""
        return stacked


def _is_coo(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "indices" in leaf and "values" in leaf


@dataclasses.dataclass(frozen=True)
class SparseCodec(UploadCodec):
    """Per-leaf COO wire format for masked uploads (see module docstring).
    Round-trip is bit-exact whenever a leaf has at most k nonzeros."""

    gamma: float = 0.1
    min_leaf_size: int = 256

    @property
    def name(self) -> str:  # type: ignore[override]
        """Wire-format label surfaced in ``FederatedServer.summary()``."""
        return f"sparse(gamma={self.gamma})"

    def _slots(self, size: int) -> int:
        return min(max(1, int(round(self.gamma * size))), size)

    def _sparse(self, size: int) -> bool:
        return size >= self.min_leaf_size and self.gamma < 1.0

    def encode(self, tree: Tree) -> Dict[str, Any]:
        """COO-encode every maskable leaf (small leaves ship dense)."""
        return {k: encode_sparse(v, self._slots(v.numel()))
                if self._sparse(v.numel()) else v for k, v in tree.items()}

    def decode(self, wire: Dict[str, Any]) -> Tree:
        """Scatter every COO leaf back to dense (validated); dense leaves
        pass the non-finite gate."""
        return {k: decode_sparse(v) if _is_coo(v)
                else _reject_nonfinite(v, self.name) for k, v in wire.items()}

    def roundtrip_stacked(self, stacked: Tree) -> Tree:
        """Encode and decode every client's leaves in one batched sort and
        scatter per leaf.  Like the reference's round, which traces the
        codec, it skips the value checks: non-finite rows are the round's
        quarantine gate's to catch."""
        out = {}
        for k, v in stacked.items():
            size = v[0].numel()
            if not self._sparse(size):
                out[k] = v
                continue
            flat = v.reshape(v.shape[0], size)
            idx, vals = encode_sparse_rows(flat, self._slots(size))
            out[k] = decode_sparse_rows(idx, vals, size).reshape(v.shape)
        return out


def roundtrip_stacked(codec: UploadCodec | None, stacked: Tree) -> Tree:
    """Round-trip a client-stacked upload tree through ``codec``, keeping
    each leaf's dtype.  ``None`` / identity are free."""
    if codec is None or isinstance(codec, IdentityCodec):
        return stacked
    wired = codec.roundtrip_stacked(stacked)
    return {k: wired[k].to(stacked[k].dtype) for k in stacked}
