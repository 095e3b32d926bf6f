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

A leaf may also be packed as ``slices`` segments, one per first-axis slice
(the pod round masks an ndim >= 2 leaf slice by slice): each slice is
padded to whole rows on its own, and the row -> segment map is built with
tensor ops, so a leaf of 152,064 slices costs no Python loop over them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

__all__ = ["SEG_LANE", "LeafSpec", "PackSpec", "build_pack_spec",
           "pack_leaves", "unpack_leaves", "pack_stacked", "unpack_stacked",
           "keep_device_constants", "device_constant"]

# Lane width of the packed buffer; also the per-leaf padding granularity.
SEG_LANE = 1024

# The stores of the enclosing ``keep_device_constants`` blocks, innermost
# last.
_STORES: List[Dict[Any, torch.Tensor]] = []


@contextlib.contextmanager
def keep_device_constants(store: Dict[Any, torch.Tensor]):
    """Within the block, :func:`device_constant` builds each constant once
    into ``store`` and hands out that tensor after.  A round captured into
    a CUDA graph warms up and is captured inside one block with the graph's
    own store: the capture then copies nothing from the host, and the
    constants live as long as the graph that reads them."""
    _STORES.append(store)
    try:
        yield store
    finally:
        _STORES.pop()


def device_constant(key, build: Callable[[], torch.Tensor],
                    device) -> torch.Tensor:
    """``build()``, a tensor made on the host, on ``device``: built anew on
    each call, or once per (key, device) inside
    :func:`keep_device_constants`, where callers must not write into it."""
    if not _STORES:
        return build().to(device)
    store, key = _STORES[-1], (key, torch.device(device))
    if key not in store:
        store[key] = build().to(device)
    return store[key]


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Static placement of one leaf inside the packed buffer."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    size: int
    offset: int      # element offset of the leaf's first entry
    num_rows: int    # SEG_LANE-wide rows this leaf occupies (size padded up)
    slices: int = 1  # segments: one per first-axis slice, each padded alone

    @property
    def slice_size(self) -> int:
        """Elements of one segment of this leaf."""
        return self.size // self.slices

    @property
    def slice_rows(self) -> int:
        """Rows of one segment of this leaf."""
        return self.num_rows // self.slices

    def segment_view(self, flat: torch.Tensor) -> torch.Tensor:
        """This leaf's (C, slices, slice_size) entries within ``flat``, the
        (C, rows * SEG_LANE) packed buffer (a view)."""
        part = flat[:, self.offset:self.offset + self.num_rows * SEG_LANE]
        return part.reshape(flat.shape[0], self.slices,
                            self.slice_rows * SEG_LANE)[:, :, :self.slice_size]


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Static description of a packed multi-leaf buffer (one client)."""

    leaves: Tuple[LeafSpec, ...]
    total_rows: int

    @property
    def num_segments(self) -> int:
        """Number of segments: one per leaf, or per slice of a sliced
        leaf."""
        return sum(ls.slices for ls in self.leaves)

    @property
    def rows(self) -> int:
        """Total SEG_LANE-wide rows in the packed buffer."""
        return self.total_rows

    def segment_sizes(self) -> torch.Tensor:
        """(num_segments,) int64 elements of each segment, in order."""
        return torch.cat([torch.full((ls.slices,), ls.slice_size,
                                     dtype=torch.int64)
                          for ls in self.leaves])

    def seg_ids(self, num_clients: int = 1, device=None) -> torch.Tensor:
        """(rows * num_clients,) int32 row -> segment map.  With
        ``num_clients`` > 1 it describes the stacked layout, where client
        c's leaf l is segment ``c * num_segments + l``.  On a ``device``
        it is a :func:`device_constant`."""
        if device is not None:
            return device_constant(("seg_ids", self, num_clients),
                                   lambda: self.seg_ids(num_clients), device)
        rows = torch.cat([torch.full((ls.slices,), ls.slice_rows,
                                     dtype=torch.int64)
                          for ls in self.leaves])
        one = torch.repeat_interleave(
            torch.arange(self.num_segments, dtype=torch.int32), rows)
        shift = torch.arange(num_clients, dtype=torch.int32)[:, None]
        return (one[None, :] + shift * self.num_segments).reshape(-1)



def build_pack_spec(leaves: Sequence[torch.Tensor],
                    slices: Sequence[int] | None = None) -> PackSpec:
    """Derive the static packing layout from leaf shapes/dtypes only;
    ``slices[i]`` segments for leaf i (which must divide its size), one by
    default."""
    specs: List[LeafSpec] = []
    offset = 0
    for i, leaf in enumerate(leaves):
        size = leaf.numel()
        parts = 1 if slices is None else int(slices[i])
        if parts < 1 or size % parts:
            raise ValueError(f"leaf {i} of {size} entries cannot be cut "
                             f"into {parts} slices")
        num_rows = parts * max(1, -(-(size // parts) // SEG_LANE))
        specs.append(LeafSpec(tuple(leaf.shape), leaf.dtype, size, offset,
                              num_rows, parts))
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
        ls.segment_view(buf)[...] = leaf.reshape(num_clients, ls.slices, -1)
    return buf.reshape(num_clients * spec.rows, SEG_LANE)


def unpack_stacked(x2d: torch.Tensor, spec: PackSpec) -> List[torch.Tensor]:
    """Invert :func:`pack_stacked`: client-stacked leaves in their original
    shapes and dtypes."""
    flat = x2d.reshape(-1, spec.rows * SEG_LANE)
    num_clients = flat.shape[0]
    return [ls.segment_view(flat).reshape((num_clients,) + ls.shape)
            .to(ls.dtype) for ls in spec.leaves]


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
