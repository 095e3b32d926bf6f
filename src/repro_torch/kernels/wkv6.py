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
tests.

The gradient is :class:`Wkv6Function`, whose backward is ``wkv6_backward``:
a second hand-written kernel (``csrc/wkv6_backward.cu``) with
``wkv6_backward_plain`` beside it.  Per chunk, in reverse chunk order, with
S and S' the chunk's start and end states, dS' the adjoint carried in from
the next chunk (dsT for the last), beta_t = r_t.u.k_t and delta_t =
dy_t.v_t:

    dA[t,s] = dy_t . v_s                                          (s < t)
    dv_s = sum_{t>s} A[t,s] dy_t + beta_s dy_s + (k_s e^{cum_L - cum_s})^T dS'
    dr_t = e^{cp_t} (S dy_t) + sum_{s<t} dA[t,s] k_s e^{cp_t - cum_s}
           + delta_t u k_t
    dk_s = sum_{t>s} dA[t,s] r_t e^{cp_t - cum_s} + delta_s u r_s
           + e^{cum_L - cum_s} (dS' v_s)
    du  += sum_t delta_t r_t k_t                    (also summed over B)
    dS   = diag(e^{cum_L}) dS' + sum_t (r_t e^{cp_t}) dy_t^T
    P_t = r_t (dr_t - delta_t u k_t),  Q_s = k_s (dk_s - delta_s u r_s),
    Z = rowsum(dS' * S')
    dlogw_i = sum_{t>i} P_t - sum_{s>=i} Q_s + Z

and ds0 is dS after the first chunk.  P_t and -Q_s are the adjoints of
cp_t = cum_{t-1} and cum_s, Z that of cum_L through S', so dlogw is their
reverse prefix within the chunk.  Every exponent is <= 0, as in the
forward.

The backward kernels run in three passes, so that each chunk's gradients
get a block of their own (2,048 blocks at rwkv6-1.6b's training shape):
each chunk's state terms K = (k e^{cum_L - cum})^T v and G = (r
e^{cp})^T dy; the serial scans over the chunks, the chunk-start states
forward from s0 and their adjoints back from dsT, into two scratch buffers
(B, H, chunks + 1, D, D) and (B, H, chunks, D, D); then every chunk's dv,
dr, dk, dlogw and partial of du over all D value columns.  The pair decays
are split at the end of the earlier step's sub-chunk, so that A's, dr's
and dk's off-diagonal blocks are 3xTF32 products on the tensor cores and
only the diagonal 16 x 16 blocks take a per-pair exponent, shared by the
three sums.  ``_wkv6_backward_chunked_plain`` mirrors that formulation on
the CPU for the tests.

Each wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.  Every launch adds one to
the wrapper's count (:func:`launch_counts`).

Both directions are also ``torch.library`` custom ops,
``repro_torch::wkv6_forward`` and ``repro_torch::wkv6_backward``, which
:class:`Wkv6Function` calls: their fake implementations give the output
shapes without running anything, so ``FakeTensorMode`` (the dry run,
``launch/dryrun.py``) traces a step through them as one op each.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.segmented import _launch, _library

__all__ = ["CHUNK", "SUBCHUNK", "CUDA_HEAD_DIMS", "wkv6", "wkv6_plain",
           "wkv6_backward", "wkv6_backward_plain", "Wkv6Function",
           "backward_scratch_shapes",
           "launch_counts", "reset_launch_counts"]

CHUNK = 64
SUBCHUNK = 16
CUDA_HEAD_DIMS = (32, 64)
LOG2E = 1.4426950408889634

_LAUNCHES: Dict[str, int] = {"wkv6": 0, "wkv6_backward": 0}


def launch_counts() -> Dict[str, int]:
    """Kernel launches of each wrapper since the last reset (CUDA only)."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    """Set the launch counts to 0."""
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


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


def _check_head_dim(D: int) -> None:
    if D not in CUDA_HEAD_DIMS:
        raise ValueError(f"the CUDA wkv6 kernels take head dims "
                         f"{CUDA_HEAD_DIMS}, got {D}")


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


def _chunk_states(kh, vh, lh, s0) -> list:
    """The state at the start of every chunk and after the last, from the
    (B, H, T, D) inputs: len = number of chunks + 1."""
    S = s0.float()
    states = [S]
    for t0 in range(0, kh.shape[2], CHUNK):
        kb, vb, lb = (x[:, :, t0:t0 + CHUNK] for x in (kh, vh, lh))
        cum = torch.cumsum(lb, dim=2)
        last = cum[:, :, -1:]
        S = torch.exp(last).transpose(2, 3) * S + \
            (kb * torch.exp(last - cum)).transpose(2, 3) @ vb
        states.append(S)
    return states


def wkv6_backward_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                        dy: torch.Tensor, dsT: torch.Tensor
                        ) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`wkv6_backward`: the module docstring's
    formulas chunk by chunk, one exponent per pair, the chunk-start states
    recomputed from s0."""
    B, T, H, D = r.shape
    rh, kh, vh, lh, dyh = (x.float().transpose(1, 2)
                           for x in (r, k, v, logw, dy))
    uu = u.float()[None, :, None, :]
    states = _chunk_states(kh, vh, lh, s0)
    dr, dk, dv, dlw = (torch.empty((B, H, T, D), dtype=torch.float32,
                                   device=r.device) for _ in range(4))
    du = torch.zeros((H, D), dtype=torch.float32, device=r.device)
    dS = dsT.float().clone()
    for c in range(len(states) - 2, -1, -1):
        t0 = c * CHUNK
        rb, kb, vb, lb, dyb = (x[:, :, t0:t0 + CHUNK]
                               for x in (rh, kh, vh, lh, dyh))
        L = rb.shape[2]
        cum = torch.cumsum(lb, dim=2)                         # (B,H,L,D)
        cp = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], 2)
        last = cum[:, :, -1:]
        lower = torch.ones((L, L), dtype=torch.bool, device=r.device
                           ).tril(-1)                         # s < t
        pair = torch.exp(torch.where(lower[:, :, None],
                                     cp[:, :, :, None] - cum[:, :, None],
                                     -torch.inf))             # (B,H,t,s,D)
        A = (rb[:, :, :, None] * kb[:, :, None] * pair).sum(-1)
        dA = torch.where(lower, dyb @ vb.transpose(2, 3), 0.0)
        beta = (rb * uu * kb).sum(-1, keepdim=True)           # (B,H,L,1)
        delta = (dyb * vb).sum(-1, keepdim=True)
        kd = torch.exp(last - cum)
        q_part = torch.exp(cp) * (dyb @ states[c].transpose(2, 3))
        r_pair = (dA[..., None] * kb[:, :, None] * pair).sum(3)
        k_pair = (dA[..., None] * rb[:, :, :, None] * pair).sum(2)
        k_state = kd * (vb @ dS.transpose(2, 3))
        dv[:, :, t0:t0 + L] = (A.transpose(2, 3) @ dyb + beta * dyb
                               + (kb * kd) @ dS)
        dr[:, :, t0:t0 + L] = q_part + r_pair + delta * uu * kb
        dk[:, :, t0:t0 + L] = k_pair + k_state + delta * uu * rb
        du += (delta * rb * kb).sum((0, 2))
        P = rb * (q_part + r_pair)
        Q = kb * (k_pair + k_state)
        Z = (dS * states[c + 1]).sum(-1)[:, :, None]          # (B,H,1,D)
        p_after = torch.flip(torch.cumsum(torch.flip(P, [2]), 2), [2]) - P
        q_from = torch.flip(torch.cumsum(torch.flip(Q, [2]), 2), [2])
        dlw[:, :, t0:t0 + L] = p_after - q_from + Z
        dS = torch.exp(last).transpose(2, 3) * dS + \
            (rb * torch.exp(cp)).transpose(2, 3) @ dyb
    return (*(x.transpose(1, 2).contiguous() for x in (dr, dk, dv, dlw)),
            du, dS)


def _wkv6_backward_chunked_plain(r: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, logw: torch.Tensor,
                                 u: torch.Tensor, s0: torch.Tensor,
                                 dy: torch.Tensor, dsT: torch.Tensor
                                 ) -> Tuple[torch.Tensor, ...]:
    """The CUDA backward's three passes in plain PyTorch, split as the
    kernels split them: chunks of ``CHUNK`` padded with zero rows,
    log2e-scaled prefix sums and ``exp2``; (1) each chunk's own state
    terms K = kd^T v and G = qe^T dy and its decay 2^{cum_L}; (2) the two
    serial scans over the chunks, the states forward from s0 and their
    adjoints back from dsT; (3) every chunk's gradients at once, with the
    pair decays split at the end of the earlier step's sub-chunk b = 16 m
    + 15 (K' = k 2^{cum_b - cum}, R_m = r 2^{cp - cum_b}, both <= 1) so
    that every off-diagonal block of A, of dr's pair sum and of dk's pair
    sum is a product, and inside each diagonal 16 x 16 block the
    lower-left 8 x 8 quarter split again at the block's step 7; one
    exponent per (pair, channel) in the diagonal blocks, shared by A, dr
    and dk.  For the tests; nothing on the main path calls it."""
    B, T, H, D = r.shape
    L, SC = CHUNK, SUBCHUNK
    n = -(-T // L)
    pad = n * L - T

    def chunks(x):
        x = torch.nn.functional.pad(x.float().transpose(1, 2),
                                    (0, 0, 0, pad))
        return x.reshape(B, H, n, L, D)
    rb, kb, vb, lb, dyb = (chunks(x) for x in (r, k, v, logw, dy))
    uu = u.float()[None, :, None, None, :]
    cum = torch.cumsum(lb * LOG2E, dim=3)                     # (B,H,n,L,D)
    cp = torch.cat([torch.zeros_like(cum[..., :1, :]), cum[..., :-1, :]], 3)
    last = cum[..., -1:, :]
    # 1. Each chunk's state terms and decay.
    kd = kb * torch.exp2(last - cum)
    qe = rb * torch.exp2(cp)
    Kc = kd.transpose(-1, -2) @ vb                            # (B,H,n,D,D)
    Gc = qe.transpose(-1, -2) @ dyb
    dec = torch.exp2(last).transpose(-1, -2)                  # (B,H,n,D,1)
    # 2. The serial scans.
    S = s0.float()
    states = [S]
    for c in range(n):
        S = dec[:, :, c] * S + Kc[:, :, c]
        states.append(S)
    G = dsT.float()
    adj = [G] * n
    for c in range(n - 1, -1, -1):
        adj[c] = G
        G = dec[:, :, c] * G + Gc[:, :, c]
    ds0 = G
    S0, S1 = torch.stack(states[:-1], 2), torch.stack(states[1:], 2)
    dS = torch.stack(adj, 2)                                  # (B,H,n,D,D)
    # 3. The gradients.
    dA = dyb @ vb.transpose(-1, -2)                           # (B,H,n,t,s)
    delta = torch.diagonal(dA, dim1=-2, dim2=-1)[..., None]   # (B,H,n,L,1)
    beta = (rb * uu * kb).sum(-1, keepdim=True)
    A = torch.zeros_like(dA)
    DR, DK = torch.zeros_like(rb), torch.zeros_like(kb)
    lower = torch.ones((SC, SC), dtype=torch.bool, device=r.device).tril(-1)
    half = SC // 2
    for j in range(L // SC):
        sl = slice(SC * j, SC * (j + 1))
        cu, cpj = cum[..., sl, :], cp[..., sl, :]
        e = torch.exp2(torch.where(lower[:, :, None],
                                   cpj[..., :, None, :] - cu[..., None, :, :],
                                   -torch.inf))              # (...,t,s,D)
        mid = cu[..., half - 1:half, :]
        qb = torch.exp2(cpj[..., half:, :] - mid)             # rows t >= 8
        kq = torch.exp2(mid - cu[..., :half, :])              # columns s < 8
        e[..., half:, :half, :] = qb[..., :, None, :] * kq[..., None, :, :]
        rk = rb[..., sl, None, :] * kb[..., None, sl, :] * e
        A[..., sl, sl] = rk.sum(-1)
        dAj = torch.where(lower, dA[..., sl, sl], 0.0)[..., None]
        DR[..., sl, :] = (dAj * kb[..., None, sl, :] * e).sum(-2)
        DK[..., sl, :] = (dAj * rb[..., sl, None, :] * e).sum(-3)
    Kp = torch.zeros_like(kb)
    R = {}
    for m in range(L // SC - 1):
        sl, b = slice(SC * m, SC * (m + 1)), SC * m + SC - 1
        Kp[..., sl, :] = kb[..., sl, :] * torch.exp2(
            cum[..., b:b + 1, :] - cum[..., sl, :])
        R[m] = rb[..., b + 1:, :] * torch.exp2(cp[..., b + 1:, :]
                                               - cum[..., b:b + 1, :])
    dr = torch.exp2(cp) * (dyb @ S0.transpose(-1, -2)) + DR
    dk = torch.exp2(last - cum) * (vb @ dS.transpose(-1, -2)) + DK
    for m in range(L // SC - 1):
        sl, b = slice(SC * m, SC * (m + 1)), SC * m + SC - 1
        for j in range(m + 1, L // SC):
            tl = slice(SC * j, SC * (j + 1))
            Rj = R[m][..., SC * j - b - 1:SC * (j + 1) - b - 1, :]
            A[..., tl, sl] = Rj @ Kp[..., sl, :].transpose(-1, -2)
            dr[..., tl, :] += torch.exp2(cp[..., tl, :]
                                         - cum[..., b:b + 1, :]) * (
                dA[..., tl, sl] @ Kp[..., sl, :])
        dk[..., sl, :] += torch.exp2(cum[..., b:b + 1, :]
                                     - cum[..., sl, :]) * (
            dA[..., b + 1:, sl].transpose(-1, -2) @ R[m])
    dv = A.transpose(-1, -2) @ dyb + beta * dyb + kd @ dS
    P, Q = rb * dr, kb * dk
    dr = dr + delta * uu * kb
    dk = dk + delta * uu * rb
    Z = (dS * S1).sum(-1)[..., None, :]                       # (B,H,n,1,D)
    W = torch.cat([P[..., 1:, :], torch.zeros_like(P[..., :1, :])], 3) - Q
    dlw = Z + torch.flip(torch.cumsum(torch.flip(W, [3]), 3), [3])
    du = (delta * rb * kb).sum((0, 2, 3))

    def unchunk(x):
        return x.reshape(B, H, n * L, D)[:, :, :T].transpose(1, 2) \
            .contiguous()
    return (*(unchunk(x) for x in (dr, dk, dv, dlw)), du, ds0)


def _forward(r, k, v, logw, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward on the tensors' device: the plain version on the CPU,
    the kernel on the card."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, logw, u, s0)
    B, T, H, D = r.shape
    _check_head_dim(D)
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


def backward_scratch_shapes(B: int, T: int, H: int, D: int) -> tuple:
    """The CUDA backward's scratch buffers: the chunk-start states and the
    last end state (B, H, chunks + 1, D, D), each chunk's end-state adjoint
    (B, H, chunks, D, D), each chunk's decay 2^{cum_L} and its partial of
    du (B, H, chunks, D)."""
    chunks = ctypes.c_int()
    err = _library().wkv6_backward_config(T, D, ctypes.byref(chunks))
    if err:
        raise RuntimeError(f"wkv6_backward_config failed: {err}")
    n = chunks.value
    return (B, H, n + 1, D, D), (B, H, n, D, D), (B, H, n, D), (B, H, n, D)


def wkv6_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                  dy: torch.Tensor, dsT: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`wkv6`: its inputs, dy (B, T, H, D) and dsT
    (B, H, D, D) the outputs' adjoints.  Returns (dr, dk, dv, dlogw, du,
    ds0), fp32, shaped as r, k, v, logw, u and s0; du is summed over B
    and T.

    The kernels (``csrc/wkv6_backward.cu``) run in three passes: each
    chunk's state terms, the serial scans of the states and their adjoints
    over the chunks (nothing is saved by the forward), then a block a
    chunk for its gradients; du adds the chunks' partials in a fixed order,
    so two runs give the same bits.  On the card r, k, v, logw and dy must
    start on 16-byte boundaries."""
    _check(r, k, v, logw, u, s0)
    B, T, H, D = r.shape
    for name, x, shape in (("dy", dy, (B, T, H, D)),
                           ("dsT", dsT, (B, H, D, D))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if x.device != r.device:
            raise ValueError(f"{name} is on {x.device}, r on {r.device}")
    if r.device.type == "cpu":
        return wkv6_backward_plain(r, k, v, logw, u, s0, dy, dsT)
    _check_head_dim(D)
    for name, x in (("r", r), ("k", k), ("v", v), ("logw", logw),
                    ("dy", dy)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for "
                             f"the CUDA wkv6 backward kernels")
    lib = _library()
    dr, dk, dv, dlogw = (torch.empty_like(r) for _ in range(4))
    du, ds0 = torch.empty_like(u), torch.empty_like(s0)
    scratch = [torch.empty(shape, dtype=torch.float32, device=r.device)
               for shape in backward_scratch_shapes(B, T, H, D)]
    _launch("wkv6_backward", lib.wkv6_backward_launch, r.data_ptr(),
            k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            s0.data_ptr(), dy.data_ptr(), dsT.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(), du.data_ptr(),
            ds0.data_ptr(), *(x.data_ptr() for x in scratch), B, T, H, D,
            counts=_LAUNCHES)
    return dr, dk, dv, dlogw, du, ds0


@torch.library.custom_op("repro_torch::wkv6_forward", mutates_args=())
def _wkv6_forward_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _forward(r, k, v, logw, u, s0)


@_wkv6_forward_op.register_fake
def _(r, k, v, logw, u, s0):
    return torch.empty_like(r), torch.empty_like(s0)


@torch.library.custom_op("repro_torch::wkv6_backward", mutates_args=())
def _wkv6_backward_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                      dy: torch.Tensor, dsT: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor, torch.Tensor, torch.Tensor]:
    return wkv6_backward(r, k, v, logw, u, s0, dy, dsT)


@_wkv6_backward_op.register_fake
def _(r, k, v, logw, u, s0, dy, dsT):
    return tuple(torch.empty_like(x) for x in (r, k, v, logw, u, s0))


class Wkv6Function(torch.autograd.Function):
    """:func:`wkv6` with its gradient: the forward kernel (or plain
    version) forward, :func:`wkv6_backward` backward.  Keeps the inputs
    only; the chunk-start states are recomputed in the backward."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        ctx.save_for_backward(r, k, v, logw, u, s0)
        return _wkv6_forward_op(r, k, v, logw, u, s0)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dsT):
        r, k, v, logw, u, s0 = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.float().contiguous()
        dsT = torch.zeros_like(s0) if dsT is None else \
            dsT.float().contiguous()
        grads = _wkv6_backward_op(r, k, v, logw, u, s0, dy, dsT)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor,
         s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, logw: (B, T, H, D) fp32 (``logw`` < 0, the log decay);
    u: (H, D); s0: (B, H, D, D).  Returns (y (B, T, H, D), sT (B, H, D, D)),
    all contiguous fp32.  Any T; on the card D must be 32 or 64.

    Under grad mode with an input that requires a gradient this runs
    through :class:`Wkv6Function`, whose backward is the backward kernel
    on the card and its plain version on the CPU."""
    _check(r, k, v, logw, u, s0)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (r, k, v, logw, u, s0)):
        return Wkv6Function.apply(r, k, v, logw, u, s0)
    return _wkv6_forward_op(r, k, v, logw, u, s0)
