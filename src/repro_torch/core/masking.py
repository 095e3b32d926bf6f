"""Parameter masking (paper §3.2.1 random, §4.2 selective top-k;
counterpart of ``repro/core/masking.py``).

The *masking rate* ``gamma`` is the fraction of parameters KEPT.

* ``selective_mask_exact``     — exact per-leaf top-k via sort (Alg. 4 as
  written; the oracle).
* ``selective_mask_threshold`` — threshold-bisection top-k (24 fp32
  halvings), or the segmented kernels with ``use_kernel``.
* ``mask_pytree`` / ``mask_stacked`` — the configured masking over a delta
  tree, one client or a client-stacked cohort.

A masked-out entry is +0.0 whatever its sign, as the reference's compiled
``x * float(keep)`` gives (see ``repro_torch.kernels.ref``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

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
    lowest scores of the row (one ``torch.topk`` for all rows)."""
    k = _kept_count(scores.shape[1], gamma)
    _, idx = torch.topk(-scores, k, dim=1)
    keep = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    return keep.scatter_(1, idx, True)


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
    k = torch.as_tensor(k, device=mag.device)
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
