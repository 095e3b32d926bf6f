"""Selective-SSM scan (counterpart of ``repro/kernels/ssm_scan.py``).

Per batch row, channel c and state lane n:

    h_t[c, n] = a_t[c, n] h_{t-1}[c, n] + bx_t[c, n]
    y_t[c]    = sum_n C_t[n] h_t[c, n]

in the layout the model uses: a, bx (B, T, d, N), c (B, T, N), h0 (B, d, N)
-> y (B, T, d), hT (B, d, N).

``ssm_scan`` is the wrapper around the hand-written CUDA kernel
(``csrc/ssm_scan.cu``, any N that divides 32); ``ssm_scan_plain`` is the
same recurrence in plain PyTorch.  The wrapper takes the plain version only
for a tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
Every launch adds one to the count (:func:`launch_counts`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.segmented import _launch, _library

__all__ = ["CUDA_STATE_DIMS", "ssm_scan", "ssm_scan_plain", "launch_counts",
           "reset_launch_counts"]

CUDA_STATE_DIMS = (1, 2, 4, 8, 16, 32)

_LAUNCHES: Dict[str, int] = {"ssm_scan": 0}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset (CUDA only)."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    """Set the launch count to 0."""
    _LAUNCHES["ssm_scan"] = 0


def _check(a, bx, c, h0) -> None:
    if a.dim() != 4:
        raise ValueError(f"a must be (B, T, d, N), got {tuple(a.shape)}")
    B, T, d, N = a.shape
    want = {"a": (a, (B, T, d, N)), "bx": (bx, (B, T, d, N)),
            "c": (c, (B, T, N)), "h0": (h0, (B, d, N))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{x.dtype}")
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, a on {a.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")


def ssm_scan_plain(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                   h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`ssm_scan`: one step at a time."""
    B, T, d, _ = a.shape
    h = h0.float()
    y = torch.empty((B, T, d), dtype=torch.float32, device=a.device)
    for t in range(T):
        h = a[:, t] * h + bx[:, t]
        y[:, t] = torch.einsum("bdn,bn->bd", h, c[:, t])
    return y, h


def ssm_scan(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
             h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, bx: (B, T, d, N) fp32; c: (B, T, N); h0: (B, d, N).  Returns
    (y (B, T, d), hT (B, d, N)), fp32.  Any T and d; on the card N must
    divide 32.

    The CUDA kernel has no backward: on the card, under grad mode with any
    input requiring a gradient, this raises rather than return outputs
    that would silently cut the gradient.  The plain version (the CPU)
    is differentiable."""
    _check(a, bx, c, h0)
    if a.device.type == "cpu":
        return ssm_scan_plain(a, bx, c, h0)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (a, bx, c, h0)):
        raise RuntimeError("the CUDA ssm_scan kernel has no backward yet "
                           "(ROADMAP Queue 1): call it under torch.no_grad() "
                           "or on detached inputs")
    B, T, d, N = a.shape
    if N not in CUDA_STATE_DIMS:
        raise ValueError(f"the CUDA ssm_scan kernel takes state dims that "
                         f"divide 32 {CUDA_STATE_DIMS}, got {N}")
    y = torch.empty((B, T, d), dtype=torch.float32, device=a.device)
    hT = torch.empty_like(h0)
    _launch("ssm_scan", _library().ssm_scan_launch, a.data_ptr(),
            bx.data_ptr(), c.data_ptr(), h0.data_ptr(), y.data_ptr(),
            hT.data_ptr(), B, T, d, N, counts=_LAUNCHES)
    return y, hT
