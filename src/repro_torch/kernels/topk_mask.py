"""Per-array selective-masking kernels (counterpart of
``repro/kernels/topk_mask.py``).

Instead of a global sort, top-k masking of one array (``ops.topk_mask``)
(1) builds a per-octave magnitude histogram in one sweep, (2) locates the
octave holding the k-th largest magnitude, (3) refines the threshold with a
few count sweeps and (4) applies ``x * [|x| >= tau]``:

1. ``exponent_histogram`` — (NBINS,) int32 counts of nonzero ``|x|`` per
   octave, bin ``clamp(e + 96, 0, 127)`` with ``e`` the exponent;
2. ``count_ge``           — 0-d int32 count of ``|x| >= tau``;
3. ``apply_threshold``    — ``x`` where ``|x| >= tau``, +0.0 elsewhere.

Each takes the flat fp32 vector and is a wrapper around a hand-written CUDA
kernel (``csrc/topk_mask.cu``) with a plain PyTorch version beside it
(``*_plain``).  A wrapper takes the plain version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises.  ``tau`` is a 0-d
fp32 tensor on the same device, read by the kernels through a device
pointer, so the refinement loop needs no host sync.  Every launch adds one
to the wrapper's count (:func:`launch_counts`).

``select_threshold_counts`` / ``select_threshold`` turn the histogram into
the octave bracket around the k-th magnitude, with exact powers of two.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.ref import EXPO_MIN, NBINS, exponent_histogram_ref
from repro_torch.kernels.segmented import _launch, _library

__all__ = [
    "exponent_histogram",
    "count_ge",
    "apply_threshold",
    "exponent_histogram_plain",
    "count_ge_plain",
    "apply_threshold_plain",
    "launch_counts",
    "reset_launch_counts",
    "select_threshold_counts",
    "select_threshold",
]

_LAUNCHES: Dict[str, int] = {"exponent_histogram": 0, "count_ge": 0,
                             "apply_threshold": 0}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset (CUDA only)."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _check_flat(x: torch.Tensor) -> None:
    if x.dim() != 1 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 1-D float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _check_tau(tau: torch.Tensor, x: torch.Tensor) -> None:
    if tau.dtype != torch.float32 or tau.numel() != 1:
        raise ValueError(f"tau must be one float32 value, got {tau.dtype} "
                         f"{tuple(tau.shape)}")
    if tau.device != x.device or not tau.is_contiguous():
        raise ValueError("tau must be contiguous and on x's device")


# --------------------------------------------------------------------------
# Plain versions: the same functions in plain PyTorch.
# --------------------------------------------------------------------------
def exponent_histogram_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`exponent_histogram`."""
    return exponent_histogram_ref(x)


def count_ge_plain(x: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`count_ge`."""
    return (x.abs() >= tau.reshape(())).sum().to(torch.int32)


def apply_threshold_plain(x: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`apply_threshold`."""
    return torch.where(x.abs() >= tau.reshape(()), x, torch.zeros_like(x))


# --------------------------------------------------------------------------
# The kernel wrappers.
# --------------------------------------------------------------------------
def exponent_histogram(x: torch.Tensor) -> torch.Tensor:
    """x: (n,) fp32.  Returns (NBINS,) int32: bin ``j`` counts the nonzero
    ``|x|`` in ``[2^(j + EXPO_MIN), 2^(j + EXPO_MIN + 1))``, bin 0 also
    everything smaller and bin NBINS - 1 everything larger (inf included).
    Zeros and NaN count nowhere."""
    _check_flat(x)
    if x.device.type == "cpu":
        return exponent_histogram_plain(x)
    out = torch.empty((NBINS,), dtype=torch.int32, device=x.device)
    _launch("exponent_histogram", _library().topk_histogram_launch,
            x.data_ptr(), x.numel(), out.data_ptr(), counts=_LAUNCHES)
    return out


def count_ge(x: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """0-d int32 count of the entries of ``x`` ((n,) fp32) with ``|x| >=
    tau`` (one fp32 value on x's device).  NaN never counts."""
    _check_flat(x)
    _check_tau(tau, x)
    if x.device.type == "cpu":
        return count_ge_plain(x, tau)
    out = torch.empty((), dtype=torch.int32, device=x.device)
    _launch("count_ge", _library().topk_count_launch, x.data_ptr(),
            x.numel(), tau.data_ptr(), out.data_ptr(), counts=_LAUNCHES)
    return out


def apply_threshold(x: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """``x`` ((n,) fp32) where ``|x| >= tau``, +0.0 elsewhere (NaN and
    negatives included): the select the reference's ``x * keep`` compiles
    to.  On the card, for an ``x`` that starts off a 16-byte boundary (a
    view), the result is a view at the same offset into n + 3 elements;
    for n = 0 nothing is launched."""
    _check_flat(x)
    _check_tau(tau, x)
    if x.device.type == "cpu":
        return apply_threshold_plain(x, tau)
    out = _empty_congruent(x)
    if x.numel() == 0:
        return out
    _launch("apply_threshold", _library().topk_apply_launch, x.data_ptr(),
            x.numel(), tau.data_ptr(), out.data_ptr(), counts=_LAUNCHES)
    return out


def _empty_congruent(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor like ``x`` (flat) whose data lies as far past
    a 16-byte boundary as x's, so that the apply kernel's 16-byte stores
    line up with its 16-byte loads: for a view of x that starts off the
    boundary, the view at that offset into n + 3 fresh elements."""
    if x.data_ptr() % 16 == 0:
        return torch.empty_like(x)
    buf = torch.empty(x.numel() + 3, dtype=x.dtype, device=x.device)
    shift = (x.data_ptr() - buf.data_ptr()) % 16 // 4
    return buf[shift:shift + x.numel()]


# --------------------------------------------------------------------------
# Threshold selection from the histogram (0-d tensors; no host sync).
# --------------------------------------------------------------------------
def _pow2(exponent: torch.Tensor) -> torch.Tensor:
    """Exact fp32 2^exponent for integer exponents in the normal range,
    built from the exponent bits."""
    return ((exponent.to(torch.int32) + 127) << 23).view(torch.float32)


def select_threshold_counts(hist: torch.Tensor, k):
    """Octave bounds ``[tau_lo, tau_hi)`` holding the k-th largest
    magnitude, plus the exact counts at both bounds, as 0-d tensors on
    ``hist``'s device.

    The suffix sums of the histogram ARE the counts at the octave bounds
    (``suffix[j] = count(|x| >= 2^(j + EXPO_MIN))``), so refinement starts
    from known bracket counts.  When even the lowest bin holds fewer than
    k entries, everything nonzero is kept: ``tau_lo`` drops below the
    smallest bin edge."""
    suffix = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))
    jstar = torch.clamp((suffix >= k).sum() - 1, min=0).reshape(1)
    tau_lo = _pow2(jstar + EXPO_MIN)[0]
    tau_hi = 2.0 * tau_lo
    suffix_ext = torch.cat([suffix, suffix.new_zeros((1,))])
    cnt_lo = suffix_ext.index_select(0, jstar)[0]
    cnt_hi = suffix_ext.index_select(0, jstar + 1)[0]
    underfull = suffix[0] < k
    tau_lo = torch.where(underfull, torch.full_like(tau_lo,
                                                    2.0 ** (EXPO_MIN - 1)),
                         tau_lo)
    cnt_lo = torch.where(underfull, suffix[0], cnt_lo)
    return tau_lo, tau_hi, cnt_lo, cnt_hi


def select_threshold(hist: torch.Tensor, k):
    """Octave bounds only (see :func:`select_threshold_counts`)."""
    tau_lo, tau_hi, _, _ = select_threshold_counts(hist, k)
    return tau_lo, tau_hi
