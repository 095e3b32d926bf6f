"""Wire payloads for masked uploads and their byte accounting (counterpart
of ``repro/core/compression.py``).

* **COO** — ``encode_sparse`` ships the k nonzero (index, value) pairs of a
  masked tensor with int32 indices, plus the tensor's int32 ``shape``
  vector.  Slots are ranked by magnitude with a stable index tie-break, so
  a tensor with at most k nonzeros round-trips bit-exactly and one that
  overflows its budget sheds its smallest values.
* **Bitmap** — ``encode_bitmap`` ships a 1-bit/element membership bitmap,
  LSB-first (byte ``b`` bit ``j`` is element ``8 b + j``), and the k kept
  values in index order: ``ceil(n / 8) + k * vb`` bytes against COO's
  ``k * (4 + vb)``.  Same slot choice as COO.
* **int8** — ``quantize_int8`` maps a float tensor to int8 codes against
  one per-tensor scale ``max(max|x| * float32(1/127), 1e-12)``, rounding
  half to even; zeros stay exactly zero.  A NaN quotient codes as 0 and
  the clip saturates infinities at +-127, as XLA's float-to-int
  conversion does.

Every encoder has a row-batched form (``*_rows``) over a (C, n)
client-stacked leaf, which the codecs' ``roundtrip_stacked`` uses inside
the round.  The decoders of single payloads (``decode_sparse``,
``decode_bitmap``, ``dequantize_int8``) raise ``ValueError`` on a
malformed payload; the batched decoders trust their encoders.
``payload_bytes`` / ``pytree_payload_bytes`` are the analytic byte model.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["payload_bytes", "pytree_num_params", "pytree_payload_bytes",
           "CompressionStats", "encode_sparse", "decode_sparse",
           "encode_sparse_rows", "decode_sparse_rows", "encode_bitmap",
           "decode_bitmap", "encode_bitmap_rows", "decode_bitmap_rows",
           "pack_bits_rows", "unpack_bits_rows", "quantize_int8",
           "dequantize_int8", "quantize_int8_rows", "dequantize_int8_rows",
           "quantize_pytree", "dequantize_pytree",
           "int8_scales", "int8_codes", "INT8_RECIPROCAL"]

# The int8 scale is ``amax * float32(1 / 127)``, a multiply and not a
# division, exactly as the reference pins it; the fused wire kernel path
# (``kernels/ops.py``) uses the same constant.
INT8_RECIPROCAL = float(np.float32(1.0 / 127.0))


@dataclasses.dataclass(frozen=True)
class CompressionStats:
    """``encoding`` is the single encoding used, or "mixed" when leaves
    chose differently; ``encoding_bytes`` holds the exact per-encoding byte
    totals."""

    dense_bytes: int
    sparse_bytes: int
    encoding: str
    encoding_bytes: Mapping[str, int] = dataclasses.field(
        default_factory=dict)

    @property
    def ratio(self) -> float:
        """Sparse over dense bytes."""
        return self.sparse_bytes / max(self.dense_bytes, 1)


def payload_bytes(num_params: int, gamma: float, value_bytes: int = 4,
                  encoding: str = "auto") -> Tuple[int, str]:
    """Bytes to ship ``gamma * num_params`` kept values of one tensor."""
    kept = int(round(gamma * num_params))
    dense = num_params * value_bytes
    if gamma >= 1.0:
        return dense, "dense"
    bitmap = kept * value_bytes + (num_params + 7) // 8
    coord = kept * (value_bytes + 4)
    if encoding == "bitmap":
        return bitmap, "bitmap"
    if encoding == "coordinate":
        return coord, "coordinate"
    if encoding == "auto":
        return (bitmap, "bitmap") if bitmap <= coord else (coord, "coordinate")
    raise ValueError(f"unknown encoding {encoding!r}")


def pytree_num_params(tree: Dict[str, torch.Tensor]) -> int:
    """Total number of parameters in a flat tree."""
    return int(sum(leaf.numel() for leaf in tree.values()))


def pytree_payload_bytes(tree: Dict[str, torch.Tensor], gamma: float,
                         min_leaf_size: int = 256, value_bytes: int = 4,
                         encoding: str = "auto") -> CompressionStats:
    """Account a whole upload under per-leaf masking (small leaves dense),
    with byte totals kept per encoding."""
    dense = sparse = 0
    per_enc: Dict[str, int] = {}
    for leaf in tree.values():
        n = int(leaf.numel())
        dense += n * value_bytes
        if n < min_leaf_size or gamma >= 1.0:
            b, enc = n * value_bytes, "dense"
        else:
            b, enc = payload_bytes(n, gamma, value_bytes, encoding)
        sparse += b
        per_enc[enc] = per_enc.get(enc, 0) + b
    if len(per_enc) == 1:
        label = next(iter(per_enc))
    else:
        label = "mixed" if per_enc else "dense"
    return CompressionStats(dense, sparse, label, per_enc)


def _shape_vector(shape) -> torch.Tensor:
    return torch.tensor(tuple(shape), dtype=torch.int32)


def _check_budget(name: str, k: int, size: int) -> None:
    if k < 1:
        raise ValueError(f"{name} needs k >= 1, got {k}")
    if k > size:
        raise ValueError(f"{name} k={k} exceeds tensor size {size}")


# ---------------------------------------------------------------------------
# COO
# ---------------------------------------------------------------------------
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
    flat = masked.reshape(-1)
    _check_budget("encode_sparse", k, flat.numel())
    idx, vals = encode_sparse_rows(flat[None], k)
    return {"indices": idx[0], "values": vals[0],
            "shape": _shape_vector(masked.shape)}


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


def _payload_size(payload, kind: str) -> Tuple[Tuple[int, ...], int]:
    shape = tuple(int(s) for s in payload["shape"])
    if any(s < 0 for s in shape):
        raise ValueError(f"{kind} payload has negative shape {shape}")
    return shape, int(np.prod(shape, dtype=np.int64)) if shape else 1


def _reject_nonfinite_values(values: torch.Tensor, kind: str) -> None:
    if values.dtype.is_floating_point and values.numel() \
            and not bool(torch.isfinite(values).all()):
        raise ValueError(f"{kind} payload values contain non-finite entries")


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
    shape, size = _payload_size(payload, "sparse")
    if indices.shape[0] > size:
        raise ValueError(
            f"sparse payload has {indices.shape[0]} slots for a tensor of "
            f"{size} elements")
    if indices.numel():
        lo, hi = int(indices.min()), int(indices.max())
        if lo < 0 or hi >= size:
            raise ValueError(
                f"sparse indices out of range [0, {size}): [{lo}, {hi}]")
    _reject_nonfinite_values(values, "sparse")
    indices = indices.to(values.device)
    return decode_sparse_rows(indices[None], values[None], size)[0].reshape(
        shape)


# ---------------------------------------------------------------------------
# Bitmap
# ---------------------------------------------------------------------------
def pack_bits_rows(bits: torch.Tensor) -> torch.Tensor:
    """(C, n) bool -> (C, ceil(n / 8)) uint8, LSB-first, trailing padding
    bits zero (``np.packbits(..., bitorder="little")``).  Nothing is copied
    from the host, so a captured round may pack bits."""
    pad = (-bits.shape[1]) % 8
    b = torch.nn.functional.pad(bits.to(torch.int32), (0, pad))
    b = b.reshape(bits.shape[0], -1, 8)
    shifts = torch.arange(8, dtype=torch.int32, device=b.device)
    return (b << shifts).sum(2).to(torch.uint8)


def unpack_bits_rows(bitmap: torch.Tensor, size: int) -> torch.Tensor:
    """Invert :func:`pack_bits_rows`: (C, nb) uint8 -> (C, size) bool."""
    b = (bitmap.to(torch.int32)[:, :, None]
         >> torch.arange(8, device=bitmap.device)) & 1
    return b.reshape(bitmap.shape[0], -1)[:, :size].to(torch.bool)


def encode_bitmap_rows(flat: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise bitmap encoding of (C, n) masked rows: (C, ceil(n/8)) uint8
    membership bits and (C, k) values in index order.  The k slots go to
    the largest magnitudes (stable index tie-break, zeros never kept)."""
    num_rows, n = flat.shape
    idx, _ = encode_sparse_rows(flat, k)
    idx = idx.long()
    keep = torch.zeros((num_rows, n), dtype=torch.bool, device=flat.device)
    keep.scatter_(1, idx, torch.gather(flat != 0, 1, idx))
    slot = torch.cumsum(keep.to(torch.int64), 1) - 1
    dest = torch.where(keep, slot, torch.full_like(slot, k))
    vals = torch.zeros((num_rows, k + 1), dtype=flat.dtype, device=flat.device)
    vals.scatter_(1, dest, torch.where(keep, flat, torch.zeros_like(flat)))
    return pack_bits_rows(keep), vals[:, :k]


def decode_bitmap_rows(bitmap: torch.Tensor, values: torch.Tensor,
                       size: int) -> torch.Tensor:
    """Expand (C, nb) bitmaps and (C, k) index-order values back to dense
    (C, size) rows; set bits beyond the k slots clip to the last slot."""
    bits = unpack_bits_rows(bitmap, size)
    k = values.shape[1]
    slot = torch.clamp(torch.cumsum(bits.to(torch.int64), 1) - 1, 0, k - 1)
    return torch.where(bits, torch.gather(values, 1, slot),
                       torch.zeros((), dtype=values.dtype,
                                   device=values.device))


def encode_bitmap(masked: torch.Tensor, k: int) -> Dict[str, torch.Tensor]:
    """Bitmap-encode a masked tensor: ``{"bitmap": (ceil(n/8),) uint8,
    "values": (k,), "shape": (ndim,) int32}``."""
    flat = masked.reshape(-1)
    _check_budget("encode_bitmap", k, flat.numel())
    bm, vals = encode_bitmap_rows(flat[None], k)
    return {"bitmap": bm[0], "values": vals[0],
            "shape": _shape_vector(masked.shape)}


def decode_bitmap(payload: Dict[str, Any]) -> torch.Tensor:
    """Decode a bitmap payload back to a dense tensor.

    Missing keys, a non-uint8 or wrongly sized bitmap, non-1-D arrays, a
    negative shape, a value-slot count outside [1, size], bits set in the
    trailing padding, a popcount above the value slots and non-finite
    values raise ``ValueError``.
    """
    missing = {"bitmap", "values", "shape"} - set(payload)
    if missing:
        raise ValueError(f"bitmap payload missing keys {sorted(missing)}")
    bitmap = _check_array(payload["bitmap"], "bitmap payload bitmap")
    values = _check_array(payload["values"], "bitmap payload values")
    if bitmap.dtype != torch.uint8:
        raise ValueError(
            f"bitmap payload bitmap must be uint8, got {bitmap.dtype}")
    if bitmap.dim() != 1 or values.dim() != 1:
        raise ValueError(
            f"bitmap payload bitmap/values must be 1-D, got shapes "
            f"{tuple(bitmap.shape)} vs {tuple(values.shape)}")
    shape, size = _payload_size(payload, "bitmap")
    nb = (size + 7) // 8
    if bitmap.shape[0] != nb:
        raise ValueError(
            f"bitmap payload has {bitmap.shape[0]} bytes for a tensor of "
            f"{size} elements (expected {nb})")
    k = int(values.shape[0])
    if k < 1 or k > size:
        raise ValueError(
            f"bitmap payload has {k} value slots for a tensor of "
            f"{size} elements")
    bits = unpack_bits_rows(bitmap[None], 8 * nb)[0]
    if bool(bits[size:].any()):
        raise ValueError(
            "bitmap payload has membership bits set in the trailing padding")
    popcount = int(bits.sum())
    if popcount > k:
        raise ValueError(
            f"bitmap payload popcount {popcount} exceeds its {k} value slots")
    _reject_nonfinite_values(values, "bitmap")
    bitmap = bitmap.to(values.device)
    return decode_bitmap_rows(bitmap[None], values[None], size)[0].reshape(
        shape)


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------
def int8_scales(amax: torch.Tensor) -> torch.Tensor:
    """The int8 scale of a tensor whose largest magnitude is ``amax``:
    ``max(amax * float32(1/127), 1e-12)`` (NaN stays NaN)."""
    return torch.clamp(amax * INT8_RECIPROCAL, min=1e-12)


def int8_codes(v: torch.Tensor) -> torch.Tensor:
    """The int8 code of a quotient ``v = x / scale``: round half to even,
    clip to [-127, 127], NaN -> 0 — what the reference's ``clip(round(v),
    -127, 127).astype(int8)`` gives under XLA, whose float-to-int
    conversion maps NaN to 0.  The fused encode kernel computes the same."""
    q = torch.clamp(torch.round(v), -127.0, 127.0)
    return torch.where(torch.isnan(q), torch.zeros_like(q), q).to(torch.int8)


def quantize_int8_rows(x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantisation of a client-stacked leaf (C, ...): int8
    codes shaped like ``x`` and (C,) fp32 scales, one per row."""
    if not x.dtype.is_floating_point:
        raise ValueError(f"quantize_int8 expects a float tensor, got {x.dtype}")
    amax = x.abs().reshape(x.shape[0], -1).amax(1).to(torch.float32)
    scale = int8_scales(amax)
    q = int8_codes(x / scale.reshape((-1,) + (1,) * (x.dim() - 1)))
    return q, scale


def dequantize_int8_rows(q: torch.Tensor, scale: torch.Tensor
                         ) -> torch.Tensor:
    """Invert :func:`quantize_int8_rows`: ``q * scale`` per row, fp32."""
    return q.to(torch.float32) * scale.reshape((-1,) + (1,) * (q.dim() - 1))


def quantize_int8(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation: ``{"q": int8 like x,
    "scale": () fp32}``."""
    x = _check_array(x, "quantize_int8 input")
    q, scale = quantize_int8_rows(x[None])
    return {"q": q[0], "scale": scale[0]}


def dequantize_int8(payload: Dict[str, Any]) -> torch.Tensor:
    """Dequantise an int8 payload; missing keys, non-int8 codes and a
    non-scalar or non-finite scale raise ``ValueError``."""
    missing = {"q", "scale"} - set(payload)
    if missing:
        raise ValueError(f"int8 payload missing keys {sorted(missing)}")
    q = _check_array(payload["q"], "int8 payload q")
    scale = _check_array(payload["scale"], "int8 payload scale")
    if q.dtype != torch.int8:
        raise ValueError(f"int8 payload q must be int8, got {q.dtype}")
    if scale.dim() != 0:
        raise ValueError(
            f"int8 payload scale must be a scalar, got shape "
            f"{tuple(scale.shape)}")
    if not bool(torch.isfinite(scale)):
        raise ValueError(f"int8 payload scale is non-finite: {float(scale)}")
    return dequantize_int8_rows(q[None], scale[None].to(q.device))[0]


def quantize_pytree(tree: Mapping[str, torch.Tensor]
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """:func:`quantize_int8` on every leaf: ``{name: {"q", "scale"}}``."""
    return {k: quantize_int8(v) for k, v in tree.items()}


def dequantize_pytree(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """:func:`dequantize_int8` on every leaf payload (inverse of
    :func:`quantize_pytree` up to the int8 rounding)."""
    return {k: dequantize_int8(v) for k, v in tree.items()}
