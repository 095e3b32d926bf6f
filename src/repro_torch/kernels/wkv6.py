"""RWKV6 wkv recurrence (counterpart of ``repro/kernels/wkv6.py``).

Per (batch, head), with a (D, D) fp32 state S and ``w_t = exp(logw_t)``:

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T S_{t-1} + (r_t . u . k_t) v_t

evaluated in chunks of ``CHUNK`` steps.  Inside a chunk, with ``cum`` the
inclusive prefix sum of ``logw`` and ``cp_t = cum_{t-1}`` (0 at the first
step):

    y_t = (r_t e^{cp_t}) S + sum_{s<t} A[t,s] v_s + (r_t . u . k_t) v_t
    A[t,s] = sum_d r_t[d] k_s[d] exp(cp_t[d] - cum_s[d])
    S' = diag(e^{cum_L}) S + sum_s (k_s e^{cum_L - cum_s}) v_s^T

Every exponent is a sum of log decays, so it is <= 0 and nothing overflows.
The reference factors the pair decay into ``e^{cp_t} e^{-cum_s}``
(``repro/models/rwkv.py``, ``repro/kernels/wkv6.py``), whose second factor
overflows fp32 once a channel's decay summed over one chunk goes below
about -88.7 (ROADMAP Queue 3); this module does not.

``wkv6`` is the wrapper around the hand-written CUDA kernel
(``csrc/wkv6.cu``, head dims 32 and 64); ``wkv6_plain`` is the same function
in plain PyTorch.  The wrapper takes the plain version only for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises.  Every launch
adds one to the count (:func:`launch_counts`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.segmented import _launch, _library

__all__ = ["CHUNK", "CUDA_HEAD_DIMS", "wkv6", "wkv6_plain", "launch_counts",
           "reset_launch_counts"]

CHUNK = 64
CUDA_HEAD_DIMS = (32, 64)

_LAUNCHES: Dict[str, int] = {"wkv6": 0}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset (CUDA only)."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    """Set the launch count to 0."""
    _LAUNCHES["wkv6"] = 0


def _check(r, k, v, logw, u, s0) -> None:
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, D), got {tuple(r.shape)}")
    B, T, H, D = r.shape
    want = {"r": (r, (B, T, H, D)), "k": (k, (B, T, H, D)),
            "v": (v, (B, T, H, D)), "logw": (logw, (B, T, H, D)),
            "u": (u, (H, D)), "s0": (s0, (B, H, D, D))}
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32, got "
                             f"{x.dtype}")
        if x.device != r.device:
            raise ValueError(f"{name} is on {x.device}, r on {r.device}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {r.device}")


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor,
               s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`wkv6`: the same chunks and exponents."""
    B, T, H, D = r.shape
    rh, kh, vh, lh = (x.float().transpose(1, 2) for x in (r, k, v, logw))
    S = s0.float().clone()                                    # (B,H,D,D)
    uu = u.float()[None, :, None, :]                          # (1,H,1,D)
    y = torch.empty((B, H, T, D), dtype=torch.float32, device=r.device)
    for t0 in range(0, T, CHUNK):
        rb, kb, vb, lb = (x[:, :, t0:t0 + CHUNK] for x in (rh, kh, vh, lh))
        L = rb.shape[2]
        cum = torch.cumsum(lb, dim=2)                         # (B,H,L,D)
        cp = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], 2)
        lower = torch.ones((L, L), dtype=torch.bool, device=r.device
                           ).tril(-1)[:, :, None]             # s < t
        expo = torch.where(lower, cp[:, :, :, None] - cum[:, :, None],
                           -torch.inf)                        # (B,H,t,s,D)
        pair = (rb[:, :, :, None] * kb[:, :, None]) * torch.exp(expo)
        A = pair.sum(-1)                                      # (B,H,t,s)
        diag = (rb * uu * kb).sum(-1, keepdim=True)
        y[:, :, t0:t0 + L] = ((rb * torch.exp(cp)) @ S + A @ vb
                              + diag * vb)
        last = cum[:, :, -1:]                                 # (B,H,1,D)
        kc = kb * torch.exp(last - cum)
        S = torch.exp(last).transpose(2, 3) * S + kc.transpose(2, 3) @ vb
    return y.transpose(1, 2).contiguous(), S


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor,
         s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, logw: (B, T, H, D) fp32 (``logw`` < 0, the log decay);
    u: (H, D); s0: (B, H, D, D).  Returns (y (B, T, H, D), sT (B, H, D, D)),
    all contiguous fp32.  Any T; on the card D must be 32 or 64."""
    _check(r, k, v, logw, u, s0)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, logw, u, s0)
    B, T, H, D = r.shape
    if D not in CUDA_HEAD_DIMS:
        raise ValueError(f"the CUDA wkv6 kernel takes head dims "
                         f"{CUDA_HEAD_DIMS}, got {D}")
    y = torch.empty_like(r)
    sT = torch.empty_like(s0)
    _launch("wkv6", _library().wkv6_launch, r.data_ptr(), k.data_ptr(),
            v.data_ptr(), logw.data_ptr(), u.data_ptr(), s0.data_ptr(),
            y.data_ptr(), sT.data_ptr(), B, T, H, D, counts=_LAUNCHES)
    return y, sT
