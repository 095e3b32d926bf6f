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
(``csrc/wkv6.cu``, head dims 32 and 64), which replaces the TPU kernel
``src/repro/kernels/wkv6.py:72`` (``wkv6_tiled``).  Its bound on an H100 is
the function's bytes (r, k, v, logw read once, y written once: 679.5 MB,
0.2028 ms at rwkv6-1.6b's prefill of 8 x 2048 tokens); the issue of its
phases, not its exponentials or its products, sets its pace (PERF.md).
The kernel:

- cuts each chunk into sub-chunks of ``SUBCHUNK`` steps and splits the pair
  decay of a row t in sub-chunk i at the boundary ``b = 16 i - 1``:
  ``e^{cp_t - cum_s} = e^{cp_t - cum_b} e^{cum_b - cum_s}``, both factors
  <= 1, so A's off-diagonal blocks are products; inside each diagonal
  block the lower-left 8 x 8 quarter splits again, and only the diagonal
  8 x 8 quarters take a per-pair exponent (none for s >= t);
- takes exponentials as ``exp2`` of log2e-scaled prefix sums, added in
  order so that they never increase and no exponent is positive;
- runs q S, A v, the state update and the off-diagonal blocks on the tensor
  cores as 3xTF32 (``a = a_hi + a_lo``, three TF32 products summed in fp32,
  about fp32 accuracy; plain TF32 would miss atol 1e-3 on outputs near 134);
- gives each block one (b, h) and half of the value columns, D/2 columns of
  S in registers (512 blocks at the serving shape), and streams the next
  chunk into a second shared-memory stage while the current one computes:
  r, k and logw as TMA boxes on an mbarrier, the v slice with ``cp.async``
  (222,208 bytes of shared memory a block at D = 64).

``wkv6_plain`` is the same function in plain PyTorch with one exponent per
pair, an oracle independent of that factorization; ``_wkv6_subchunk_plain``
mirrors the kernel's own formulation on the CPU and is called only by the
tests.  The wrapper takes the plain version only for a tensor on the CPU;
for a CUDA tensor it launches the kernel or raises.  Every launch adds one
to the count (:func:`launch_counts`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.segmented import _launch, _library

__all__ = ["CHUNK", "SUBCHUNK", "CUDA_HEAD_DIMS", "wkv6", "wkv6_plain",
           "launch_counts", "reset_launch_counts"]

CHUNK = 64
SUBCHUNK = 16
CUDA_HEAD_DIMS = (32, 64)
LOG2E = 1.4426950408889634

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


def _wkv6_subchunk_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's formulation in plain PyTorch: log2e-scaled prefix
    sums taken in order, ``exp2``, sub-chunks of ``SUBCHUNK`` with the pair
    decay split at each boundary (off-diagonal blocks as products), and
    inside each diagonal block the lower-left quarter split again at its
    middle; per-pair exponents only in the diagonal quarters.  For the
    tests; nothing on the main path calls it."""
    B, T, H, D = r.shape
    rh, kh, vh, lh = (x.float().transpose(1, 2) for x in (r, k, v, logw))
    S = s0.float().clone()
    uu = u.float()[None, :, None, :]
    y = torch.empty((B, H, T, D), dtype=torch.float32, device=r.device)
    for t0 in range(0, T, CHUNK):
        rb, kb, vb, lb = (x[:, :, t0:t0 + CHUNK] for x in (rh, kh, vh, lh))
        L = rb.shape[2]
        cum = torch.cumsum(lb * LOG2E, dim=2)
        cp = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], 2)
        A = torch.zeros((B, H, L, L), dtype=torch.float32, device=r.device)
        for i0 in range(0, L, SUBCHUNK):
            i1 = min(i0 + SUBCHUNK, L)
            n = i1 - i0
            lower = torch.ones((n, n), dtype=torch.bool, device=r.device
                               ).tril(-1)[:, :, None]
            expo = torch.where(lower, cp[:, :, i0:i1, None]
                               - cum[:, :, None, i0:i1], -torch.inf)
            pair = (rb[:, :, i0:i1, None] * kb[:, :, None, i0:i1]) \
                * torch.exp2(expo)
            A[:, :, i0:i1, i0:i1] = pair.sum(-1)
            h = i0 + SUBCHUNK // 2
            if i1 > h:                  # the lower-left quarter, split again
                mid = cum[:, :, h - 1:h]
                q_lo = rb[:, :, h:i1] * torch.exp2(cp[:, :, h:i1] - mid)
                k_lo = kb[:, :, i0:h] * torch.exp2(mid - cum[:, :, i0:h])
                A[:, :, h:i1, i0:h] = q_lo @ k_lo.transpose(2, 3)
            if i0:
                bnd = cum[:, :, i0 - 1:i0]                    # (B,H,1,D)
                qt = rb[:, :, i0:i1] * torch.exp2(cp[:, :, i0:i1] - bnd)
                kt = kb[:, :, :i0] * torch.exp2(bnd - cum[:, :, :i0])
                A[:, :, i0:i1, :i0] = qt @ kt.transpose(2, 3)
        diag = (rb * uu * kb).sum(-1, keepdim=True)
        y[:, :, t0:t0 + L] = ((rb * torch.exp2(cp)) @ S + A @ vb
                              + diag * vb)
        last = cum[:, :, -1:]
        kc = kb * torch.exp2(last - cum)
        S = torch.exp2(last).transpose(2, 3) * S + kc.transpose(2, 3) @ vb
    return y.transpose(1, 2).contiguous(), S


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor,
         s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, logw: (B, T, H, D) fp32 (``logw`` < 0, the log decay);
    u: (H, D); s0: (B, H, D, D).  Returns (y (B, T, H, D), sT (B, H, D, D)),
    all contiguous fp32.  Any T; on the card D must be 32 or 64.

    The CUDA kernel has no backward: on the card, under grad mode with any
    input requiring a gradient, this raises rather than return outputs
    that would silently cut the gradient.  The plain version (the CPU)
    is differentiable."""
    _check(r, k, v, logw, u, s0)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, logw, u, s0)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (r, k, v, logw, u, s0)):
        raise RuntimeError("the CUDA wkv6 kernel has no backward yet "
                           "(ROADMAP Queue 1): call it under torch.no_grad() "
                           "or on detached inputs")
    B, T, H, D = r.shape
    if D not in CUDA_HEAD_DIMS:
        raise ValueError(f"the CUDA wkv6 kernel takes head dims "
                         f"{CUDA_HEAD_DIMS}, got {D}")
    for name, x in (("r", r), ("k", k), ("v", v), ("logw", logw),
                    ("s0", s0)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             f"the CUDA wkv6 kernel")
    y = torch.empty_like(r)
    sT = torch.empty_like(s0)
    _launch("wkv6", _library().wkv6_launch, r.data_ptr(), k.data_ptr(),
            v.data_ptr(), logw.data_ptr(), u.data_ptr(), s0.data_ptr(),
            y.data_ptr(), sT.data_ptr(), B, T, H, D, counts=_LAUNCHES)
    return y, sT
