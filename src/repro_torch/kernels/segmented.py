"""Segmented kernels over the packed buffer (counterpart of
``repro/kernels/segmented.py``).

The packed buffer from ``kernels.packing`` — every SEG_LANE-wide row belongs
to exactly one segment — is swept a leaf-count-independent number of times:

1. ``segmented_histogram`` — (S, SEG_NBINS) magnitude histogram in SUFFIX
   form, ``out[s, j] = #{|x| >= 2^(EXPO_MIN + 4 j)}``;
2. ``segmented_count``     — counts of ``|x| >= taus[s, c]`` for any C >= 1
   candidate thresholds per segment in one sweep;
3. ``segmented_apply``     — ``x * [|x| >= tau[s]]`` plus kept counts;
4. ``segmented_stats``     — the histogram plus a per-segment ``max|x|``,
   the int8 wire scale's input;
5. ``segmented_encode``    — the wire-path sweep: threshold select,
   optional int8 quantisation against per-segment scales, an LSB-first
   keep bitmap and kept counts, from one read of the buffer.

Each is a wrapper around a hand-written CUDA kernel
(``csrc/segmented.cu``) with a plain PyTorch version beside it
(``*_plain``).  A wrapper takes the plain version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises.  Every launch adds
one to the wrapper's count (:func:`launch_counts`).

A row whose segment id lies outside ``[0, S)`` counts nowhere and is masked
against tau = 0 — what the reference's one-hot gathers give such a row.

The threshold selection/refinement math (tiny (S, .) tensor code, no sweeps
over the data) lives here too: ``select_thresholds``, ``candidate_taus`` and
``shrink_brackets``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.compression import int8_codes, pack_bits_rows
from repro_torch.kernels.packing import SEG_LANE, device_constant
from repro_torch.kernels.ref import EXPO_MIN, NBINS

__all__ = [
    "SEG_NBINS",
    "OCTAVES_PER_BIN",
    "segmented_histogram",
    "segmented_count",
    "segmented_apply",
    "segmented_stats",
    "segmented_encode",
    "segmented_histogram_plain",
    "segmented_count_plain",
    "segmented_apply_plain",
    "segmented_stats_plain",
    "segmented_encode_plain",
    "launch_counts",
    "reset_launch_counts",
    "select_thresholds",
    "candidate_taus",
    "shrink_brackets",
]

OCTAVES_PER_BIN = 4
SEG_NBINS = NBINS // OCTAVES_PER_BIN

_LAUNCHES: Dict[str, int] = {"segmented_histogram": 0,
                             "segmented_count": 0,
                             "segmented_apply": 0,
                             "segmented_stats": 0,
                             "segmented_encode": 0}
# The CUDA count kernel sorts a segment's candidates in shared memory.
MAX_CANDIDATES = 4096


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset (CUDA only)."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def bin_edges(device=None) -> torch.Tensor:
    """(SEG_NBINS,) fp32 bin-edge magnitudes 2^(EXPO_MIN + 4 j): a new CPU
    tensor without ``device``, a
    :func:`~repro_torch.kernels.packing.device_constant` with one."""
    if device is not None:
        return device_constant(("bin_edges",), bin_edges, device)
    j = torch.arange(SEG_NBINS, dtype=torch.float32)
    return torch.ldexp(torch.ones(SEG_NBINS), j * OCTAVES_PER_BIN + EXPO_MIN)


# --------------------------------------------------------------------------
# Argument checks shared by the wrappers.
# --------------------------------------------------------------------------
def _check_buffer(x2d: torch.Tensor, seg_ids: torch.Tensor) -> torch.Tensor:
    """Validate the packed buffer and return the (R,) segment-id view."""
    if x2d.dim() != 2 or x2d.shape[1] != SEG_LANE:
        raise ValueError(f"x2d must be (R, {SEG_LANE}), got {tuple(x2d.shape)}")
    if x2d.dtype != torch.float32:
        raise TypeError(f"x2d must be float32, got {x2d.dtype}")
    if seg_ids.dtype != torch.int32:
        raise TypeError(f"seg_ids must be int32, got {seg_ids.dtype}")
    if seg_ids.numel() != x2d.shape[0] or seg_ids.dim() not in (1, 2):
        raise ValueError(f"seg_ids must hold one id per row: (R,) or (R, 1) "
                         f"with R = {x2d.shape[0]}, got {tuple(seg_ids.shape)}")
    if seg_ids.device != x2d.device:
        raise ValueError("x2d and seg_ids must be on the same device")
    if not (x2d.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("x2d and seg_ids must be contiguous")
    if x2d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x2d.device}")
    return seg_ids.reshape(-1)


def _check_taus(taus: torch.Tensor, x2d: torch.Tensor, shape,
                name: str = "taus") -> None:
    if taus.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {taus.dtype}")
    if tuple(taus.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(taus.shape)}")
    if taus.device != x2d.device or not taus.is_contiguous():
        raise ValueError(f"{name} must be contiguous and on x2d's device")


def _check_aligned(x2d: torch.Tensor) -> None:
    """The histogram, count, stats and encode kernels read rows as
    float4."""
    if x2d.data_ptr() % 16:
        raise ValueError("x2d must start on a 16-byte boundary for the CUDA "
                         "kernels that read rows as float4")


def _launch(name: str, fn, *args, counts: Dict[str, int] = _LAUNCHES
            ) -> None:
    """Run one C launcher on the current stream; add one to ``counts[name]``
    (the wrappers' launch counts); raise on error."""
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    counts[name] += 1


def _library():
    from repro_torch.kernels.build import library
    return library()


# --------------------------------------------------------------------------
# Plain versions: the same functions in plain PyTorch.
# --------------------------------------------------------------------------
def _segment_sum(rows: torch.Tensor, seg: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Sum per-row statistics (R, K) into (S, K) int32, ignoring rows whose
    id is outside [0, S)."""
    valid = (seg >= 0) & (seg < num_segments)
    out = torch.zeros((num_segments, rows.shape[1]), dtype=torch.int64,
                      device=rows.device)
    out.index_add_(0, seg[valid].long(), rows[valid].long())
    return out.to(torch.int32)


def _row_taus(taus: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Gather per-segment taus (S, K) onto rows (R, K); tau 0 off-range."""
    num_segments = taus.shape[0]
    valid = (seg >= 0) & (seg < num_segments)
    rows = taus[seg.long().clamp(0, max(num_segments - 1, 0))]
    return torch.where(valid[:, None], rows, torch.zeros_like(rows))


def segmented_histogram_plain(x2d: torch.Tensor, seg_ids: torch.Tensor,
                              num_segments: int) -> torch.Tensor:
    """Plain version of :func:`segmented_histogram`."""
    seg = seg_ids.reshape(-1)
    mag = x2d.abs()
    row_counts = torch.stack([(mag >= edge).sum(1)
                              for edge in bin_edges(x2d.device)], 1)
    return _segment_sum(row_counts, seg, num_segments)


def segmented_count_plain(x2d: torch.Tensor, seg_ids: torch.Tensor,
                          taus: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`segmented_count`."""
    seg = seg_ids.reshape(-1)
    mag = x2d.abs()
    row_taus = _row_taus(taus, seg)
    row_counts = torch.stack([(mag >= row_taus[:, c:c + 1]).sum(1)
                              for c in range(taus.shape[1])], 1)
    return _segment_sum(row_counts, seg, taus.shape[0])


def segmented_apply_plain(x2d: torch.Tensor, seg_ids: torch.Tensor,
                          taus: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`segmented_apply`."""
    seg = seg_ids.reshape(-1)
    keep = x2d.abs() >= _row_taus(taus.reshape(-1, 1), seg)
    out = torch.where(keep, x2d, torch.zeros_like(x2d))
    kept = _segment_sum(keep.sum(1, keepdim=True), seg, taus.numel())
    return out, kept


def segmented_stats_plain(x2d: torch.Tensor, seg_ids: torch.Tensor,
                          num_segments: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`segmented_stats`."""
    seg = seg_ids.reshape(-1)
    hist = segmented_histogram_plain(x2d, seg, num_segments)
    valid = (seg >= 0) & (seg < num_segments)
    rows = x2d.abs().amax(1)[valid]
    ids = seg[valid].long()
    nan = torch.isnan(rows)
    amax = torch.zeros((num_segments,), dtype=torch.float32,
                       device=x2d.device)
    amax.scatter_reduce_(0, ids, torch.where(nan, torch.zeros_like(rows),
                                             rows), "amax")
    has_nan = torch.zeros((num_segments,), dtype=torch.int32,
                          device=x2d.device)
    has_nan.index_add_(0, ids, nan.to(torch.int32))
    amax = torch.where(has_nan > 0, torch.full_like(amax, float("nan")), amax)
    return hist, amax[:, None]


def segmented_encode_plain(x2d: torch.Tensor, seg_ids: torch.Tensor,
                           taus: torch.Tensor,
                           scales: torch.Tensor | None = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Plain version of :func:`segmented_encode`."""
    seg = seg_ids.reshape(-1)
    keep = x2d.abs() >= _row_taus(taus.reshape(-1, 1), seg)
    out = torch.where(keep, x2d, torch.zeros_like(x2d))
    if scales is not None:
        out = int8_codes(out / _row_taus(scales.reshape(-1, 1), seg))
    kept = _segment_sum(keep.sum(1, keepdim=True), seg, taus.numel())
    return out, pack_bits_rows(keep), kept


# --------------------------------------------------------------------------
# The kernel wrappers.
# --------------------------------------------------------------------------
def segmented_histogram(x2d: torch.Tensor, seg_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """x2d: (R, SEG_LANE) fp32; seg_ids: (R,) or (R, 1) int32.

    Returns (num_segments, SEG_NBINS) int32 per-segment 4-octave-bin
    histograms in SUFFIX form — ``out[s, j] = count(|x_s| >= 2^(EXPO_MIN +
    4 j))`` — from one sweep of the packed buffer.  Zeros, magnitudes below
    2^EXPO_MIN and NaN count nowhere.
    """
    seg = _check_buffer(x2d, seg_ids)
    if x2d.device.type == "cpu":
        return segmented_histogram_plain(x2d, seg, num_segments)
    _check_aligned(x2d)
    out = torch.zeros((num_segments, SEG_NBINS), dtype=torch.int32,
                      device=x2d.device)
    if x2d.shape[0]:
        lib = _library()
        _launch("segmented_histogram", lib.seg_histogram_launch,
                x2d.data_ptr(), seg.data_ptr(), x2d.shape[0], num_segments,
                out.data_ptr())
    return out


def segmented_count(x2d: torch.Tensor, seg_ids: torch.Tensor,
                    taus: torch.Tensor) -> torch.Tensor:
    """Counts of |x| >= tau per segment for ALL C candidate taus in one
    sweep.  taus: (num_segments, C) fp32 with 1 <= C <= MAX_CANDIDATES, in
    any order, duplicates included.  NaN in x never counts; a NaN tau
    counts nothing and a tau <= 0 every non-NaN entry (the reference asks
    for taus > 0).  Returns (num_segments, C) int32."""
    seg = _check_buffer(x2d, seg_ids)
    if taus.dim() != 2 or not 1 <= taus.shape[1] <= MAX_CANDIDATES:
        raise ValueError(f"taus must be (S, C) with 1 <= C <= "
                         f"{MAX_CANDIDATES}, got {tuple(taus.shape)}")
    _check_taus(taus, x2d, taus.shape)
    if x2d.device.type == "cpu":
        return segmented_count_plain(x2d, seg, taus)
    _check_aligned(x2d)
    out = torch.zeros(tuple(taus.shape), dtype=torch.int32, device=x2d.device)
    if x2d.shape[0]:
        _launch("segmented_count", _library().seg_count_launch,
                x2d.data_ptr(), seg.data_ptr(), taus.data_ptr(),
                x2d.shape[0], taus.shape[0], taus.shape[1], out.data_ptr())
    return out


def segmented_apply(x2d: torch.Tensor, seg_ids: torch.Tensor,
                    taus: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply per-segment thresholds ``taus`` ((S,) fp32); returns
    ``(masked (R, SEG_LANE), kept (S, 1) int32)``.  Masked values are
    ``x`` where ``|x| >= tau`` and +0.0 elsewhere (NaN included): the
    reference writes ``x * float(keep)``, which XLA turns into exactly this
    select."""
    seg = _check_buffer(x2d, seg_ids)
    _check_taus(taus, x2d, (taus.numel(),))
    if x2d.device.type == "cpu":
        return segmented_apply_plain(x2d, seg, taus)
    out = torch.empty_like(x2d)
    kept = torch.zeros((taus.numel(), 1), dtype=torch.int32,
                       device=x2d.device)
    if x2d.shape[0]:
        lib = _library()
        _launch("segmented_apply", lib.seg_apply_launch, x2d.data_ptr(),
                seg.data_ptr(), taus.data_ptr(), x2d.shape[0], taus.numel(),
                out.data_ptr(), kept.data_ptr())
    return out, kept


def segmented_stats(x2d: torch.Tensor, seg_ids: torch.Tensor,
                    num_segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`segmented_histogram` plus the (num_segments, 1) fp32
    per-segment ``max|x|`` from the same sweep.  The max is NaN when the
    segment holds a NaN and inf when it holds an infinity, each in its own
    segment only, as the reference's compiled kernel gives; an empty
    segment's max is 0."""
    seg = _check_buffer(x2d, seg_ids)
    if x2d.device.type == "cpu":
        return segmented_stats_plain(x2d, seg, num_segments)
    _check_aligned(x2d)
    hist = torch.zeros((num_segments, SEG_NBINS), dtype=torch.int32,
                       device=x2d.device)
    amax = torch.zeros((num_segments, 1), dtype=torch.float32,
                       device=x2d.device)
    if x2d.shape[0]:
        _launch("segmented_stats", _library().seg_stats_launch,
                x2d.data_ptr(), seg.data_ptr(), x2d.shape[0], num_segments,
                hist.data_ptr(), amax.data_ptr())
    return hist, amax


def segmented_encode(x2d: torch.Tensor, seg_ids: torch.Tensor,
                     taus: torch.Tensor, scales: torch.Tensor | None = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused wire-path sweep: apply the per-segment thresholds ``taus``
    ((S,) fp32, > 0) and return

    * ``out``    — (R, SEG_LANE): the masked fp32 values (x where |x| >=
      tau, +0.0 elsewhere), or with ``scales`` ((S,) fp32) the int8 codes
      ``clip(round_half_even(masked / scale), -127, 127)``, NaN -> 0;
    * ``bitmap`` — (R, SEG_LANE // 8) uint8 keep mask, LSB-first;
    * ``kept``   — (S, 1) int32 kept entries per segment.
    """
    seg = _check_buffer(x2d, seg_ids)
    num_segments = taus.numel()
    _check_taus(taus, x2d, (num_segments,))
    if scales is not None:
        _check_taus(scales, x2d, (num_segments,), name="scales")
    if x2d.device.type == "cpu":
        return segmented_encode_plain(x2d, seg, taus, scales)
    _check_aligned(x2d)
    out = torch.empty(x2d.shape, device=x2d.device,
                      dtype=torch.float32 if scales is None else torch.int8)
    bitmap = torch.empty((x2d.shape[0], SEG_LANE // 8), dtype=torch.uint8,
                         device=x2d.device)
    kept = torch.zeros((num_segments, 1), dtype=torch.int32,
                       device=x2d.device)
    if x2d.shape[0]:
        _launch("segmented_encode", _library().seg_encode_launch,
                x2d.data_ptr(), seg.data_ptr(), taus.data_ptr(),
                None if scales is None else scales.data_ptr(),
                x2d.shape[0], num_segments, out.data_ptr(),
                bitmap.data_ptr(), kept.data_ptr())
    return out, bitmap, kept


# --------------------------------------------------------------------------
# Threshold selection + multi-candidate bracket refinement (tiny (S, .)
# tensors; no sweeps over the packed data).
# --------------------------------------------------------------------------
def select_thresholds(suffix: torch.Tensor, k: torch.Tensor):
    """Bracket every segment's k-th largest magnitude at once.

    suffix: (S, SEG_NBINS) int32 suffix-form histogram; k: (S,) int32.
    Returns ``(lo, hi, cnt_lo, cnt_hi)`` — per-segment 4-octave bounds
    [lo, hi) holding the k-th largest magnitude plus the EXACT counts at
    both ends, so refinement never needs an extra counting sweep.
    """
    num_segments = suffix.shape[0]
    jstar = torch.clamp((suffix >= k[:, None]).sum(1) - 1, min=0)
    ones = torch.ones(jstar.shape, dtype=torch.float32, device=suffix.device)
    lo = torch.ldexp(ones, (jstar * OCTAVES_PER_BIN + EXPO_MIN).float())
    hi = float(2 ** OCTAVES_PER_BIN) * lo
    suffix_ext = torch.cat(
        [suffix, torch.zeros((num_segments, 1), dtype=suffix.dtype,
                             device=suffix.device)], 1)
    cnt_lo = suffix_ext.gather(1, jstar[:, None])[:, 0]
    cnt_hi = suffix_ext.gather(1, (jstar + 1)[:, None])[:, 0]
    # k exceeds the number of nonzeros: keep everything nonzero by dropping
    # the lower bound below the smallest bin edge.
    underfull = suffix[:, 0] < k
    lo = torch.where(underfull, torch.full_like(lo, 2.0 ** (EXPO_MIN - 1)), lo)
    cnt_lo = torch.where(underfull, suffix[:, 0], cnt_lo)
    return lo, hi, cnt_lo, cnt_hi


def candidate_taus(lo: torch.Tensor, hi: torch.Tensor, num: int,
                   geometric: bool = False) -> torch.Tensor:
    """(S, num) interior candidate thresholds of each [lo, hi] bracket,
    spaced by constant ratio when ``geometric`` (the first refine over the
    histogram's 16x bracket) and linearly otherwise.  Same fp32 formula as
    the reference."""
    frac = (torch.arange(1, num + 1, dtype=torch.float32, device=lo.device)
            / (num + 1.0))
    if geometric:
        ratio = torch.exp(frac[None, :] * torch.log(hi / lo)[:, None])
        return lo[:, None] * ratio
    return lo[:, None] + frac[None, :] * (hi - lo)[:, None]


def shrink_brackets(lo, hi, cnt_lo, cnt_hi, cand, counts, k):
    """Tighten every segment's bracket around the k-th magnitude.

    ``cand``/``counts``: (S, C) ascending candidate taus and their counts
    from one ``segmented_count`` sweep.  Counts are non-increasing along
    [lo, cand..., hi], so the number of entries with count > k locates the
    tightest bracket; counts at the new ends come for free.
    """
    ext_taus = torch.cat([lo[:, None], cand, hi[:, None]], 1)
    ext_cnts = torch.cat([cnt_lo[:, None], counts, cnt_hi[:, None]], 1)
    last = ext_taus.shape[1] - 1
    num_gt = (ext_cnts > k[:, None]).sum(1)
    lo_idx = torch.clamp(num_gt - 1, 0, last)[:, None]
    hi_idx = torch.clamp(num_gt, 0, last)[:, None]
    return (ext_taus.gather(1, lo_idx)[:, 0], ext_taus.gather(1, hi_idx)[:, 0],
            ext_cnts.gather(1, lo_idx)[:, 0], ext_cnts.gather(1, hi_idx)[:, 0])
