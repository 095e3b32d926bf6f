"""Parameter masking (paper §3.2.1 random, §4.2 selective top-k;
counterpart of ``repro/core/masking.py``).

The *masking rate* ``gamma`` is the fraction of parameters KEPT.

* ``selective_mask_exact``     — exact per-leaf top-k via sort (Alg. 4 as
  written; the oracle).
* ``selective_mask_threshold`` — threshold-bisection top-k (24 fp32
  halvings), or the segmented kernels with ``use_kernel``.
* ``mask_pytree`` / ``mask_stacked`` — the configured masking over a delta
  tree, one client or a client-stacked cohort.
* ``client_mask_scores`` — random masking's per-entry uniforms for a set
  of clients, from a counter-based stream keyed by (seed, round, client,
  leaf): a client's draw does not depend on M or on who else is drawn,
  and integer ops give the same bits on the CPU and on the card.

A masked-out entry is +0.0 whatever its sign, as the reference's compiled
``x * float(keep)`` gives (see ``repro_torch.kernels.ref``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

Tree = Dict[str, torch.Tensor]

__all__ = [
    "MaskingConfig",
    "random_keep",
    "random_mask",
    "selective_mask_exact",
    "threshold_for_topk",
    "selective_mask_threshold",
    "mask_pytree",
    "mask_stacked",
    "client_mask_scores",
]


@dataclasses.dataclass(frozen=True)
class MaskingConfig:
    """gamma: fraction kept; mode: none|random|selective; min_leaf_size:
    smaller leaves are always sent dense; use_kernel routes selective
    masking through the segmented CUDA kernels."""

    gamma: float = 1.0
    mode: str = "none"  # none | random | selective
    min_leaf_size: int = 256
    bisect_iters: int = 24
    use_kernel: bool = False


def _kept_count(size: int, gamma: float) -> int:
    return max(1, int(round(gamma * size)))


def _refine_sweeps_for(iters: int) -> int:
    """Bisection budget -> segmented refine sweeps (24 iters ~ 2 sweeps)."""
    return max(2, min(4, iters // 12))


def _keep(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    return torch.where(keep, x, torch.zeros_like(x))


def random_keep(scores: torch.Tensor, gamma: float) -> torch.Tensor:
    """Paper Alg. 2's kept set with an exact count, for each row of the
    (C, n) uniform ``scores``: True at the k = max(1, round(gamma * n))
    lowest scores of the row, equal scores taken lowest index first, as
    ``lax.top_k`` takes them (``torch.topk`` leaves the order of ties
    open, and it differs between devices)."""
    k = _kept_count(scores.shape[1], gamma)
    kth = torch.topk(scores, k, dim=1, largest=False).values[:, -1:]
    below = scores < kth
    tie = scores == kth
    need = k - below.sum(1, keepdim=True)
    return below | (tie & (torch.cumsum(tie, 1) <= need))


def random_mask(delta: torch.Tensor, gamma: float,
                scores: torch.Tensor) -> torch.Tensor:
    """Paper Alg. 2 with an exact kept count: keep the k entries with the
    lowest uniform ``scores`` (one per entry, injected by the caller)."""
    flat = delta.reshape(1, -1)
    keep = random_keep(scores.reshape(1, -1).to(flat.device), gamma)
    return _keep(flat, keep).reshape(delta.shape)


def selective_mask_exact(delta: torch.Tensor, gamma: float) -> torch.Tensor:
    """Paper Alg. 4: keep the k = gamma*|W| entries of largest |delta|;
    surplus ties at the k-th magnitude are dropped in index order."""
    flat = delta.reshape(-1)
    k = _kept_count(flat.numel(), gamma)
    mag = flat.abs()
    thresh = torch.sort(mag).values[flat.numel() - k]
    keep = mag >= thresh
    keep = keep & ~(torch.cumsum(keep.to(torch.int64), 0) > k)
    return _keep(flat, keep).reshape(delta.shape)


def threshold_for_topk(mag: torch.Tensor, k, iters: int = 24) -> torch.Tensor:
    """Per-row tau with count(mag >= tau) <= k by ``iters`` fp32 halvings
    of [0, max + 1e-12].  ``mag``: (..., n); ``k``: int or (...,) tensor.
    Returns the conservative end ``hi`` with the leading shape of ``mag``."""
    mag = mag.to(torch.float32)
    hi = mag.amax(-1) + 1e-12
    lo = torch.zeros_like(hi)
    if isinstance(k, torch.Tensor):      # an int is compared as it is
        k = k.to(mag.device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        raise_lo = (mag >= mid[..., None]).sum(-1) > k
        lo = torch.where(raise_lo, mid, lo)
        hi = torch.where(raise_lo, hi, mid)
    return hi


def selective_mask_threshold(delta: torch.Tensor, gamma: float,
                             iters: int = 24,
                             use_kernel: bool = False) -> torch.Tensor:
    """Threshold-bisection top-k of one tensor; with ``use_kernel`` the
    tensor goes through the segmented kernels instead."""
    if use_kernel:
        from repro_torch.kernels import ops
        return ops.topk_mask_pytree({"x": delta}, gamma, min_leaf_size=0,
                                    refine_sweeps=_refine_sweeps_for(iters)
                                    )["x"]
    flat = delta.reshape(-1)
    tau = threshold_for_topk(flat.abs(), _kept_count(flat.numel(), gamma),
                             iters)
    return _keep(flat, flat.abs() >= tau).reshape(delta.shape)


def mask_stacked(delta: Tree, cfg: MaskingConfig,
                 scores: Optional[Tree] = None) -> Tree:
    """Apply the configured masking to a client-stacked delta tree (leading
    client axis on every leaf); per client it is :func:`mask_pytree`.

    Selective masking with ``cfg.use_kernel`` masks the whole cohort in
    one pass of each segmented kernel.  Random masking needs the per-entry
    uniform ``scores``: a tree with one (C, *shape) tensor per maskable
    leaf of ``delta``.
    """
    if cfg.mode == "none" or cfg.gamma >= 1.0:
        return delta
    if cfg.mode == "selective" and cfg.use_kernel:
        from repro_torch.kernels import ops
        return ops.topk_mask_stacked(
            delta, cfg.gamma, min_leaf_size=cfg.min_leaf_size,
            refine_sweeps=_refine_sweeps_for(cfg.bisect_iters))
    if cfg.mode not in ("random", "selective"):
        raise ValueError(f"unknown masking mode {cfg.mode!r}")
    if cfg.mode == "random" and scores is None:
        raise ValueError("random masking needs per-entry scores (the server "
                         "draws them each round)")
    out = {}
    for name, leaf in delta.items():
        n = leaf[0].numel()
        if n < cfg.min_leaf_size:
            out[name] = leaf
            continue
        flat = leaf.reshape(leaf.shape[0], n)
        if cfg.mode == "random":
            keep = random_keep(scores[name].reshape(flat.shape), cfg.gamma)
        else:
            tau = threshold_for_topk(flat.abs(), _kept_count(n, cfg.gamma),
                                     cfg.bisect_iters)
            keep = flat.abs() >= tau[:, None]
        out[name] = _keep(flat, keep).reshape(leaf.shape)
    return out


def mask_pytree(delta: Tree, cfg: MaskingConfig,
                scores: Optional[Tree] = None) -> Tree:
    """Apply the configured masking to ONE client's delta tree; small
    leaves (< cfg.min_leaf_size) pass through dense."""
    stacked = mask_stacked(
        {n: leaf[None] for n, leaf in delta.items()}, cfg,
        None if scores is None else {n: s[None] for n, s in scores.items()})
    return {n: leaf[0] for n, leaf in stacked.items()}


# Random-mask scores: splitmix64 (Steele, Lea and Flood 2014) on int64
# tensors.  Sums and products wrap modulo 2^64 on both devices; a logical
# right shift is an arithmetic one with the sign bits masked off.
_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MIX = (0xBF58476D1CE4E5B9, 0x94D049BB133111EB)


def _signed(c: int) -> int:
    """A 64-bit word as the int64 with the same bits."""
    c &= _MASK64
    return c - (1 << 64) if c >> 63 else c


def _mix_host(z: int) -> int:
    """splitmix64's finaliser on a Python int (mod 2^64)."""
    z &= _MASK64
    z = ((z ^ (z >> 30)) * _MIX[0]) & _MASK64
    z = ((z ^ (z >> 27)) * _MIX[1]) & _MASK64
    return z ^ (z >> 31)


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finaliser on an int64 tensor."""
    z = (z ^ _srl(z, 30)) * _signed(_MIX[0])
    z = (z ^ _srl(z, 27)) * _signed(_MIX[1])
    return z ^ _srl(z, 31)


def _stream_key(*words: int) -> int:
    """The 64-bit key of one stream, e.g. (seed, round, leaf)."""
    h = 0
    for word in words:
        h = _mix_host((h ^ (word & _MASK64)) + _GOLDEN)
    return h


def _stream_words(key: int, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Words 0..n-1 of each client's stream under ``key``: ``mix(mix(key ^
    mix(i + G)) + (j + 1) G)`` for client i and entry j, (len(idx), n)
    int64 on ``idx``'s device."""
    rows = _mix(_mix(idx + _signed(_GOLDEN)) ^ _signed(key))
    steps = (np.arange(1, n + 1, dtype=np.uint64)
             * np.uint64(_GOLDEN)).view(np.int64)
    return _mix(rows[:, None] + torch.from_numpy(steps).to(idx.device))


def client_mask_scores(seed: int, t: int, ids,
                       leaves: Dict[str, Sequence[int]],
                       device=None) -> Dict[str, torch.Tensor]:
    """Round ``t``'s random-mask scores for the clients ``ids``: ``{leaf:
    (len(ids), *shape)}`` fp32 uniforms in [0, 1) on ``device`` (``cuda``
    unless named, as every entry point of the port).

    Leaf ``l`` (its position among ``leaves``' names, sorted) and client
    ``i`` key one splitmix64 stream, ``mix(mix(key(seed, t, l) ^
    mix(i + G)) + (j + 1) G)`` for entry j (G the golden-ratio increment);
    a score is the top 24 bits of its word times 2^-24.  So client i's
    scores are the same whichever clients are drawn with it and however
    many are registered, and the same bits on every device."""
    idx = torch.as_tensor(np.asarray(ids, dtype=np.int64)).to(
        resolve_device(device))
    out = {}
    for ell, name in enumerate(sorted(leaves)):
        shape = tuple(int(d) for d in leaves[name])
        z = _stream_words(_stream_key(seed, t, ell), idx,
                          int(np.prod(shape)))
        out[name] = (_srl(z, 40).to(torch.float32) * 2.0 ** -24).reshape(
            (len(idx),) + shape)
    return out
