"""Wire codecs: real ``encode -> wire tree -> decode`` upload transforms
(counterpart of ``repro/core/codecs.py``).

* ``IdentityCodec``    — dense pass-through.
* ``SparseCodec``      — per-leaf COO of a masked delta: ``k = max(1,
  round(gamma * n))`` int32 index + value slots per maskable leaf, plus the
  leaf's int32 shape vector; leaves under ``min_leaf_size`` ship dense.
  With ``axis0_slices`` an ndim >= 2 leaf gets ``shape[0] * max(1,
  round(gamma * shape[0]-slice size))`` slots instead: the budget of the
  pod round's per-first-axis-slice masks (``with_axis0_slices``).
* ``Int8Codec``        — symmetric per-tensor int8 quantisation of every
  float leaf (zeros stay zero); 4 -> 1 value bytes.
* ``BitmapCodec``      — per-leaf 1-bit/element membership bitmap + k
  values in index order: ``ceil(n/8) + k*vb`` bytes against COO's
  ``k*(4+vb)``.
* ``ChainCodec``       — composition, e.g. ``ChainCodec((SparseCodec(g),
  Int8Codec()))`` ships int8-quantised COO values; decode runs in reverse.
* ``FusedSparseCodec`` — the kernel-backed wire: the COO or bitmap payload
  (optionally int8) comes out of one ``segmented_encode`` sweep over the
  cohort's packed masked delta (``kernels.ops.topk_encode_stacked``)
  instead of a sort per leaf.  Its wire is byte-identical to the matching
  codec above (its *oracle*), and ``decode`` is the oracle's.

Every codec reports **exact** wire bytes: ``wire_bytes(tree)`` encodes a
shape-only (``meta`` device) template and sums the bytes of every wire
leaf; the fused codec reports its oracle's count, which is the same by
contract.  ``roundtrip_stacked`` applies a codec to a client-stacked upload
tree inside the round, as one batched encode and decode per leaf
(``encode_stacked`` / ``decode_stacked``), so what aggregation consumes is
exactly what survived the wire.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.compression import (decode_bitmap, decode_bitmap_rows,
                                          decode_sparse, decode_sparse_rows,
                                          dequantize_int8,
                                          dequantize_int8_rows, encode_bitmap,
                                          encode_bitmap_rows, encode_sparse,
                                          encode_sparse_rows, quantize_int8,
                                          quantize_int8_rows)

Tree = Dict[str, torch.Tensor]

__all__ = ["UploadCodec", "IdentityCodec", "SparseCodec", "Int8Codec",
           "BitmapCodec", "ChainCodec", "FusedSparseCodec",
           "tree_wire_nbytes", "roundtrip_stacked", "with_axis0_slices"]


def _wire_leaves(wire: Any):
    if isinstance(wire, dict):
        for value in wire.values():
            yield from _wire_leaves(value)
    else:
        yield wire


def tree_wire_nbytes(wire: Any) -> int:
    """Exact serialized bytes of a wire tree: sum of leaf nbytes (indices,
    values, bitmaps, scales AND shape vectors)."""
    return int(sum(leaf.numel() * leaf.element_size()
                   for leaf in _wire_leaves(wire)))


def _map_wire(fn: Callable, wire: Any, is_leaf: Callable = lambda _: False):
    """Apply ``fn`` to every leaf of a nested wire dict; a dict for which
    ``is_leaf`` holds counts as one leaf."""
    if isinstance(wire, dict) and not is_leaf(wire):
        return {k: _map_wire(fn, v, is_leaf) for k, v in wire.items()}
    return fn(wire)


def _reject_nonfinite(leaf: torch.Tensor, codec_name: str) -> torch.Tensor:
    """Decode-boundary validation: a float payload carrying NaN/Inf
    raises ``ValueError`` before it can reach aggregation."""
    if leaf.dtype.is_floating_point and leaf.numel() \
            and not bool(torch.isfinite(leaf).all()):
        raise ValueError(
            f"{codec_name} decode: payload contains non-finite values")
    return leaf


def _is_q8(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "q" in leaf and "scale" in leaf


def _is_float(leaf: Any) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.dtype.is_floating_point


def _quantize_rows(leaf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A client-stacked float leaf as ``{"q": int8, "scale": (C,) fp32}``."""
    q, scale = quantize_int8_rows(leaf)
    return {"q": q, "scale": scale}


@dataclasses.dataclass(frozen=True)
class UploadCodec:
    """Base wire codec with static wire shapes.

    ``encode``/``decode`` act on one client's tree; ``encode_stacked`` /
    ``decode_stacked`` on a client-stacked tree, where every wire array
    gains a leading client axis (shape vectors stay per leaf) and the
    decoders skip the value checks: inside the round, non-finite rows are
    the quarantine gate's to catch.
    """

    name = "identity"

    def encode(self, tree: Tree) -> Dict[str, Any]:
        """Upload tree -> wire tree."""
        raise NotImplementedError

    def decode(self, wire: Dict[str, Any]) -> Tree:
        """Wire tree -> upload tree (inverse of :meth:`encode`)."""
        raise NotImplementedError

    def encode_stacked(self, stacked: Tree) -> Dict[str, Any]:
        """:meth:`encode` of every client of a client-stacked tree."""
        raise NotImplementedError

    def decode_stacked(self, wire: Dict[str, Any]) -> Tree:
        """Inverse of :meth:`encode_stacked`."""
        raise NotImplementedError

    def roundtrip(self, tree: Tree) -> Tree:
        """What the server sees after the upload crosses the wire."""
        return self.decode(self.encode(tree))

    def roundtrip_stacked(self, stacked: Tree) -> Tree:
        """:meth:`roundtrip` of every client of a client-stacked tree."""
        return self.decode_stacked(self.encode_stacked(stacked))

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

    def encode_stacked(self, stacked: Tree) -> Tree:
        """The wire IS the stacked tree."""
        return stacked

    def decode_stacked(self, wire: Tree) -> Tree:
        """The stacked tree IS the wire."""
        return wire

    def roundtrip(self, tree: Tree) -> Tree:
        """Free: dense pass-through loses nothing."""
        return tree

    def roundtrip_stacked(self, stacked: Tree) -> Tree:
        """Free for every client."""
        return stacked


@dataclasses.dataclass(frozen=True)
class _SlotCodec(UploadCodec):
    """Shared body of the COO and bitmap wires: leaves under
    ``min_leaf_size`` ship dense, every other leaf gets ``k = max(1,
    round(gamma * n))`` value slots and ships as ``{<membership>, "values",
    "shape"}``.  Round-trip is bit-exact whenever a leaf has at most k
    nonzeros.  A wire sets ``_key`` (its membership array) and its
    one-tensor and row-batched encoders and decoders."""

    gamma: float = 0.1
    min_leaf_size: int = 256

    _key = ""

    def _slots(self, size: int) -> int:
        return min(max(1, int(round(self.gamma * size))), size)

    def _leaf_slots(self, shape) -> int:
        """Slots of a leaf of ``shape`` (one client's)."""
        return self._slots(math.prod(shape))

    def _sparse(self, size: int) -> bool:
        return size >= self.min_leaf_size and self.gamma < 1.0

    def _is_payload(self, leaf: Any) -> bool:
        return isinstance(leaf, dict) and self._key in leaf \
            and "values" in leaf

    def encode(self, tree: Tree) -> Dict[str, Any]:
        """Encode every maskable leaf (small leaves ship dense)."""
        return {k: self._encode_one(v, self._leaf_slots(tuple(v.shape)))
                if self._sparse(v.numel()) else v for k, v in tree.items()}

    def decode(self, wire: Dict[str, Any]) -> Tree:
        """Expand every payload leaf (validated); dense leaves pass the
        non-finite gate."""
        return {k: self._decode_one(v) if self._is_payload(v)
                else _reject_nonfinite(v, self.name) for k, v in wire.items()}

    def encode_stacked(self, stacked: Tree) -> Dict[str, Any]:
        """One batched encode per maskable leaf for all clients."""
        out: Dict[str, Any] = {}
        for k, v in stacked.items():
            size = v[0].numel()
            if not self._sparse(size):
                out[k] = v
                continue
            member, vals = self._encode_rows(
                v.reshape(v.shape[0], size),
                self._leaf_slots(tuple(v.shape[1:])))
            out[k] = {self._key: member, "values": vals,
                      "shape": torch.tensor(tuple(v.shape[1:]),
                                            dtype=torch.int32)}
        return out

    def decode_stacked(self, wire: Dict[str, Any]) -> Tree:
        """One batched expansion per payload leaf for all clients."""
        out: Tree = {}
        for k, v in wire.items():
            if not self._is_payload(v):
                out[k] = v
                continue
            shape = tuple(int(s) for s in v["shape"])
            rows = self._decode_rows(v[self._key], v["values"],
                                     math.prod(shape))
            out[k] = rows.reshape((rows.shape[0],) + shape)
        return out


@dataclasses.dataclass(frozen=True)
class SparseCodec(_SlotCodec):
    """Per-leaf COO wire format for masked uploads (see module docstring):
    one batched stable sort per leaf.

    ``axis0_slices`` (default False) budgets an ndim >= 2 leaf per
    first-axis slice, ``shape[0] * max(1, round(gamma * slice size))``
    slots, as the pod round's masks keep per slice
    (``launch.fedtrain``); a vector keeps the whole-leaf budget."""

    axis0_slices: bool = False

    _key = "indices"
    _encode_one = staticmethod(encode_sparse)
    _decode_one = staticmethod(decode_sparse)
    _encode_rows = staticmethod(encode_sparse_rows)
    _decode_rows = staticmethod(decode_sparse_rows)

    @property
    def name(self) -> str:  # type: ignore[override]
        """Wire-format label surfaced in ``FederatedServer.summary()``."""
        suffix = ", per-slice" if self.axis0_slices else ""
        return f"sparse(gamma={self.gamma}{suffix})"

    def _leaf_slots(self, shape) -> int:
        """Per-first-axis-slice budget with ``axis0_slices``."""
        if self.axis0_slices and len(shape) >= 2:
            return shape[0] * self._slots(math.prod(shape[1:]))
        return self._slots(math.prod(shape))


@dataclasses.dataclass(frozen=True)
class BitmapCodec(_SlotCodec):
    """Per-leaf bitmap wire format for masked uploads: the COO codec's
    slot budget, with membership as 1 bit per element.  Cheaper than COO
    whenever the kept density exceeds 1/32."""

    _key = "bitmap"
    _encode_one = staticmethod(encode_bitmap)
    _decode_one = staticmethod(decode_bitmap)
    _encode_rows = staticmethod(encode_bitmap_rows)
    _decode_rows = staticmethod(decode_bitmap_rows)

    @property
    def name(self) -> str:  # type: ignore[override]
        """Wire-format label surfaced in ``FederatedServer.summary()``."""
        return f"bitmap(gamma={self.gamma})"


@dataclasses.dataclass(frozen=True)
class Int8Codec(UploadCodec):
    """Symmetric per-tensor int8 quantisation of every float leaf.

    Composable after :class:`SparseCodec` / :class:`BitmapCodec`: int32
    indices, uint8 bitmaps and shape vectors pass through untouched; only
    float payloads quantise, to ``{"q": int8, "scale": fp32}``.
    """

    name = "int8"

    def encode(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """Quantise every float leaf to (int8 q, fp32 scale)."""
        return _map_wire(lambda leaf: quantize_int8(leaf)
                         if _is_float(leaf) else leaf, tree)

    def decode(self, wire: Dict[str, Any]) -> Dict[str, Any]:
        """Dequantise every (q, scale) leaf (validated); float leaves that
        passed through meet the non-finite gate."""
        return _map_wire(lambda leaf: dequantize_int8(leaf) if _is_q8(leaf)
                         else _reject_nonfinite(leaf, "int8"), wire, _is_q8)

    def encode_stacked(self, stacked: Dict[str, Any]) -> Dict[str, Any]:
        """One scale per client row of every float leaf."""
        return _map_wire(lambda leaf: _quantize_rows(leaf)
                         if _is_float(leaf) else leaf, stacked)

    def decode_stacked(self, wire: Dict[str, Any]) -> Dict[str, Any]:
        """``q * scale`` per client row."""
        return _map_wire(lambda leaf: dequantize_int8_rows(
            leaf["q"], leaf["scale"]) if _is_q8(leaf) else leaf, wire, _is_q8)


@dataclasses.dataclass(frozen=True)
class ChainCodec(UploadCodec):
    """Left-to-right composition: ``encode`` folds forward through
    ``stages``, ``decode`` unwinds in reverse."""

    stages: Tuple[UploadCodec, ...] = ()

    def __post_init__(self):
        """A chain needs at least one stage."""
        if not self.stages:
            raise ValueError("ChainCodec needs at least one stage")

    @property
    def name(self) -> str:  # type: ignore[override]
        """Stage names joined with "+" (e.g. ``sparse(gamma=0.5)+int8``)."""
        return "+".join(s.name for s in self.stages)

    def encode(self, tree: Tree) -> Dict[str, Any]:
        """Fold every stage's encode left to right."""
        for stage in self.stages:
            tree = stage.encode(tree)
        return tree

    def decode(self, wire: Dict[str, Any]) -> Tree:
        """Unwind every stage's decode in reverse order."""
        for stage in reversed(self.stages):
            wire = stage.decode(wire)
        return wire

    def encode_stacked(self, stacked: Tree) -> Dict[str, Any]:
        """Fold every stage's stacked encode left to right."""
        for stage in self.stages:
            stacked = stage.encode_stacked(stacked)
        return stacked

    def decode_stacked(self, wire: Dict[str, Any]) -> Tree:
        """Unwind every stage's stacked decode in reverse order."""
        for stage in reversed(self.stages):
            wire = stage.decode_stacked(wire)
        return wire


@dataclasses.dataclass(frozen=True)
class FusedSparseCodec(UploadCodec):
    """Kernel-backed wire path: the masked delta -> COO (``wire="coo"``) or
    bitmap (``wire="bitmap"``) payload, int8-quantised in the same sweep
    when ``quantized``, from one ``segmented_encode`` launch for the whole
    cohort (plus one ``segmented_stats`` launch for the int8 scales).

    The wire is structurally and byte-identical to :meth:`_oracle`'s, and
    ``decode`` is the oracle's.  Decoded values are bit-exact against the
    oracle whenever each leaf's nonzero count fits its slot budget (the
    threshold masks guarantee it off tie plateaus); on an overflowing
    plateau the fused path sheds by highest index where the oracle sheds
    the smallest magnitudes.  The device of the tensors decides whether
    the CUDA kernels or their plain versions run.
    """

    gamma: float = 0.1
    min_leaf_size: int = 256
    quantized: bool = False
    wire: str = "coo"           # coo | bitmap

    def __post_init__(self):
        """Validate the wire format."""
        if self.wire not in ("coo", "bitmap"):
            raise ValueError(f"unknown wire format {self.wire!r}")

    @property
    def name(self) -> str:  # type: ignore[override]
        """Wire-format label surfaced in ``FederatedServer.summary()``."""
        kind = "bitmap" if self.wire == "bitmap" else "sparse"
        suffix = "+int8" if self.quantized else ""
        return f"fused-{kind}(gamma={self.gamma}){suffix}"

    def _oracle(self) -> UploadCodec:
        """The codec whose wire this codec reproduces byte for byte."""
        base = (BitmapCodec if self.wire == "bitmap" else SparseCodec)(
            gamma=self.gamma, min_leaf_size=self.min_leaf_size)
        return ChainCodec((base, Int8Codec())) if self.quantized else base

    def _quantize_small(self, wire: Dict[str, Any], quantize) -> Dict[str, Any]:
        # The kernel path only touches maskable leaves; the oracle's int8
        # stage also quantises the small dense float leaves.
        if not self.quantized:
            return wire
        return {k: quantize(v) if _is_float(v) else v
                for k, v in wire.items()}

    def encode(self, tree: Tree) -> Dict[str, Any]:
        """One fused sweep from masked delta to wire payload."""
        from repro_torch.kernels import ops
        wire = ops.topk_encode_pytree(
            tree, self.gamma, min_leaf_size=self.min_leaf_size,
            quantize=self.quantized, wire=self.wire, assume_masked=True)
        return self._quantize_small(wire, quantize_int8)

    def decode(self, wire: Dict[str, Any]) -> Tree:
        """The oracle's decode (same wire, same validation)."""
        return self._oracle().decode(wire)

    def encode_stacked(self, stacked: Tree) -> Dict[str, Any]:
        """One fused sweep for the whole cohort."""
        from repro_torch.kernels import ops
        wire = ops.topk_encode_stacked(
            stacked, self.gamma, min_leaf_size=self.min_leaf_size,
            quantize=self.quantized, wire=self.wire, assume_masked=True)
        return self._quantize_small(wire, _quantize_rows)

    def decode_stacked(self, wire: Dict[str, Any]) -> Tree:
        """The oracle's stacked decode."""
        return self._oracle().decode_stacked(wire)

    def wire_bytes(self, tree: Tree) -> int:
        """The oracle's exact count, which this wire equals by contract;
        the kernels need real tensors, so the shape-only template goes
        through the oracle."""
        return self._oracle().wire_bytes(tree)


def with_axis0_slices(codec: UploadCodec) -> UploadCodec:
    """Re-budget every :class:`SparseCodec` stage (chains included) to the
    pod round's per-first-axis-slice masks (``SparseCodec.axis0_slices``);
    every other codec, the whole-leaf bitmap and fused wires among them,
    comes back as it is."""
    if isinstance(codec, SparseCodec):
        return dataclasses.replace(codec, axis0_slices=True)
    if isinstance(codec, ChainCodec):
        return ChainCodec(tuple(with_axis0_slices(s) for s in codec.stages))
    return codec


def roundtrip_stacked(codec: UploadCodec | None, stacked: Tree) -> Tree:
    """Round-trip a client-stacked upload tree through ``codec``, keeping
    each leaf's dtype.  ``None`` / identity are free (the tree itself comes
    back)."""
    if codec is None or isinstance(codec, IdentityCodec):
        return stacked
    wired = codec.roundtrip_stacked(stacked)
    return {k: wired[k].to(stacked[k].dtype) for k in stacked}
