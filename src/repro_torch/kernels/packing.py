"""Leaf packing for the segmented masking kernels (counterpart of
``repro/kernels/packing.py``).

Every maskable leaf is flattened, cast to fp32, zero-padded up to whole
``SEG_LANE``-wide rows and concatenated, so each row belongs to exactly one
leaf (segment) and a per-row int32 segment id tells the kernels which
histogram / count / tau row the data row feeds.  Padding zeros never survive
masking because every selected threshold is > 0.

The port adds a *stacked* form: a leading client axis of C clients packs as
C consecutive copies of the per-client layout, client c's leaf l becoming
segment ``c * L + l``.  Every segment keeps its own k and thresholds, so one
sweep over the whole cohort gives the same result as masking each client on
its own.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

__all__ = ["SEG_LANE", "LeafSpec", "PackSpec", "build_pack_spec",
           "pack_leaves", "unpack_leaves", "pack_stacked", "unpack_stacked"]

# Lane width of the packed buffer; also the per-leaf padding granularity.
SEG_LANE = 1024


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Static placement of one leaf inside the packed buffer."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    size: int
    offset: int      # element offset of the leaf's first entry
    num_rows: int    # SEG_LANE-wide rows this leaf occupies (size padded up)


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Static description of a packed multi-leaf buffer (one client)."""

    leaves: Tuple[LeafSpec, ...]
    total_rows: int

    @property
    def num_segments(self) -> int:
        """Number of packed leaves (segments)."""
        return len(self.leaves)

    @property
    def rows(self) -> int:
        """Total SEG_LANE-wide rows in the packed buffer."""
        return self.total_rows

    def seg_ids(self, num_clients: int = 1, device=None) -> torch.Tensor:
        """(rows * num_clients,) int32 row -> segment map.  With
        ``num_clients`` > 1 it describes the stacked layout, where client
        c's leaf l is segment ``c * num_segments + l``."""
        one = torch.empty((self.total_rows,), dtype=torch.int32)
        for s, leaf in enumerate(self.leaves):
            start = leaf.offset // SEG_LANE
            one[start:start + leaf.num_rows] = s
        shift = torch.arange(num_clients, dtype=torch.int32)[:, None]
        out = (one[None, :] + shift * self.num_segments).reshape(-1)
        return out if device is None else out.to(device)


def build_pack_spec(leaves: Sequence[torch.Tensor]) -> PackSpec:
    """Derive the static packing layout from leaf shapes/dtypes only."""
    specs: List[LeafSpec] = []
    offset = 0
    for leaf in leaves:
        size = leaf.numel()
        num_rows = max(1, -(-size // SEG_LANE))
        specs.append(LeafSpec(tuple(leaf.shape), leaf.dtype, size, offset,
                              num_rows))
        offset += num_rows * SEG_LANE
    return PackSpec(tuple(specs), offset // SEG_LANE)


def pack_stacked(leaves: Sequence[torch.Tensor],
                 spec: PackSpec) -> torch.Tensor:
    """Pack client-stacked leaves ((C, *leaf.shape) each) into one
    (C * spec.rows, SEG_LANE) fp32 buffer, client-major."""
    num_clients = leaves[0].shape[0]
    buf = torch.zeros((num_clients, spec.rows * SEG_LANE),
                      dtype=torch.float32, device=leaves[0].device)
    for leaf, ls in zip(leaves, spec.leaves):
        buf[:, ls.offset:ls.offset + ls.size] = leaf.reshape(num_clients, -1)
    return buf.reshape(num_clients * spec.rows, SEG_LANE)


def unpack_stacked(x2d: torch.Tensor, spec: PackSpec) -> List[torch.Tensor]:
    """Invert :func:`pack_stacked`: client-stacked leaves in their original
    shapes and dtypes."""
    flat = x2d.reshape(-1, spec.rows * SEG_LANE)
    num_clients = flat.shape[0]
    return [flat[:, ls.offset:ls.offset + ls.size]
            .reshape((num_clients,) + ls.shape).to(ls.dtype)
            for ls in spec.leaves]


def pack_leaves(leaves: Sequence[torch.Tensor],
                spec: PackSpec | None = None
                ) -> Tuple[torch.Tensor, PackSpec]:
    """Pack ``leaves`` into one (rows, SEG_LANE) fp32 buffer; returns
    ``(x2d, spec)``."""
    if spec is None:
        spec = build_pack_spec(leaves)
    return pack_stacked([leaf[None] for leaf in leaves], spec), spec


def unpack_leaves(x2d: torch.Tensor, spec: PackSpec) -> List[torch.Tensor]:
    """Invert :func:`pack_leaves`: slices back to original shapes/dtypes."""
    return [leaf[0] for leaf in unpack_stacked(x2d, spec)]
