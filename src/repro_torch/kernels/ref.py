"""Plain-torch oracles for the masking kernels (counterpart of
``repro/kernels/ref.py``).

* ``topk_mask_ref``      — exact top-k-by-|x| mask (full sort), the paper's
  Alg. 4 as written.
* ``threshold_mask_ref`` — keep entries with |x| >= tau.
* ``exponent_histogram_ref`` / ``group_histogram_ref`` — per-octave and
  4-octave magnitude counts, the quantities the histogram kernels
  accumulate.
* ``ssm_scan_ref``       — the selective-SSM recurrence one step at a time,
  in the reference oracle's (B, T, N, D) layout.

The reference writes its masks as ``x * float(keep)``; XLA compiles that
product into a select, so a masked-out entry comes out +0.0 whatever its
sign.  The port writes the select itself and matches those bits.
"""

from __future__ import annotations

import torch

__all__ = ["NBINS", "EXPO_MIN", "topk_mask_ref", "threshold_mask_ref",
           "count_ge_ref", "exponent_bins", "exponent_histogram_ref",
           "group_histogram_ref", "ssm_scan_ref"]

NBINS = 128
EXPO_MIN = -96  # bin j counts magnitudes in [2^(j+EXPO_MIN), 2^(j+EXPO_MIN+1))


def topk_mask_ref(x: torch.Tensor, gamma: float) -> torch.Tensor:
    """Keep the k = max(1, round(gamma*size)) largest-|x| entries (exact);
    surplus ties at the k-th magnitude are dropped in index order."""
    flat = x.reshape(-1)
    k = max(1, int(round(gamma * flat.numel())))
    mag = flat.abs()
    thresh = torch.sort(mag).values[flat.numel() - k]
    keep = mag >= thresh
    keep = keep & ~(torch.cumsum(keep.to(torch.int64), 0) > k)
    return torch.where(keep, flat, torch.zeros_like(flat)).reshape(x.shape)


def threshold_mask_ref(x: torch.Tensor, tau) -> torch.Tensor:
    """``x`` with every entry of magnitude below ``tau`` set to +0.0."""
    return torch.where(x.abs() >= tau, x, torch.zeros_like(x))


def count_ge_ref(x: torch.Tensor, tau) -> torch.Tensor:
    """int32 count of entries with |x| >= tau."""
    return (x.abs() >= tau).sum().to(torch.int32)


def exponent_bins(mag: torch.Tensor) -> torch.Tensor:
    """int64 bin of each fp32 magnitude: its exponent field minus the bias,
    minus EXPO_MIN, clamped to [0, NBINS).  Exact at every power of two,
    where ``floor(log2(.))`` in fp32 is not: it puts ``nextafter(2^j, 0)``
    in bin j for many j.  Subnormals go to bin 0, inf to NBINS - 1."""
    field = (mag.contiguous().view(torch.int32) >> 23) & 0xFF
    return torch.clamp(field.to(torch.int64) - 127 - EXPO_MIN, 0, NBINS - 1)


def exponent_histogram_ref(x: torch.Tensor) -> torch.Tensor:
    """(NBINS,) int32 counts of nonzero |x| per power-of-two bin; NaN
    counts nowhere."""
    mag = x.reshape(-1).abs().to(torch.float32)
    valid = mag > 0
    return torch.bincount(exponent_bins(mag)[valid],
                          minlength=NBINS).to(torch.int32)


def group_histogram_ref(x: torch.Tensor,
                        octaves_per_bin: int = 4) -> torch.Tensor:
    """Octave bins grouped ``octaves_per_bin`` at a time — the per-bin
    (not suffix) form of what the segmented histogram kernel counts."""
    h = exponent_histogram_ref(x)
    return h.reshape(-1, octaves_per_bin).sum(1).to(torch.int32)


def ssm_scan_ref(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                 h0: torch.Tensor):
    """Oracle for the SSM-scan kernel.  a, bx: (B, T, N, D); c: (B, T, N);
    h0: (B, N, D).  Returns (y (B, T, D), hT (B, N, D)), fp32."""
    h = h0.float()
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + bx[:, t].float()
        ys.append(torch.einsum("bnd,bn->bd", h, c[:, t].float()))
    return torch.stack(ys, 1), h
