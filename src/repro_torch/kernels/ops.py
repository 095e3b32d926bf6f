"""Whole-model selective masking on the segmented kernels (counterpart of
``repro/kernels/ops.py``).

``topk_mask_pytree(tree, gamma)`` masks every maskable leaf of a delta tree
in a leaf-count-independent number of sweeps (DESIGN.md §3.4):
1 segmented histogram + ``refine_sweeps`` multi-candidate count sweeps
+ 1 fused count/apply sweep (= 4 for the default config).

``topk_mask_stacked`` is the cohort form the round uses: a tree whose leaves
carry a leading client axis packs as ``clients x leaves`` segments, so one
sweep of each kernel masks the whole cohort — each segment with its own k
and thresholds, identical to masking every client on its own.

Trees are flat ``{name: tensor}`` dicts in the reference's leaf order
(``repro_torch.bridge``).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import packing as pk
from repro_torch.kernels import segmented as seg

Tree = Dict[str, torch.Tensor]

__all__ = ["DEFAULT_REFINE_SWEEPS", "DEFAULT_CANDIDATES",
           "pytree_sweep_count", "topk_mask_pytree", "topk_mask_stacked"]

DEFAULT_REFINE_SWEEPS = 2
DEFAULT_CANDIDATES = 16


def pytree_sweep_count(num_leaves: int, *, segmented: bool = True,
                       iters: int = 8,
                       refine_sweeps: int = DEFAULT_REFINE_SWEEPS) -> int:
    """Sweeps over the data to selectively mask an L-leaf tree (analytic).

    Per-leaf pipeline: every leaf pays 1 histogram + ``iters`` counts + 1
    apply.  Segmented: 1 histogram + ``refine_sweeps`` multi-candidate
    counts + 1 fused count/apply, independent of L.
    """
    if segmented:
        return 1 + refine_sweeps + 1
    return num_leaves * (iters + 2)


def topk_mask_stacked(tree: Tree, gamma: float, *, min_leaf_size: int = 256,
                      refine_sweeps: int = DEFAULT_REFINE_SWEEPS,
                      candidates: int = DEFAULT_CANDIDATES) -> Tree:
    """Selective masking of a client-stacked tree (leading client axis on
    every leaf) in ``refine_sweeps + 2`` kernel launches for the whole
    cohort.  Leaves with fewer than ``min_leaf_size`` elements per client
    pass through dense.  Per client and leaf the result is what
    :func:`topk_mask_pytree` gives: at most k = max(1, round(gamma * size))
    entries kept when the k-th and (k+1)-th magnitudes differ by more than
    the final bracket (~1% of tau), all tied entries kept otherwise.
    """
    names = [n for n, leaf in tree.items() if leaf[0].numel() >= min_leaf_size]
    if gamma >= 1.0 or not names:
        return tree
    leaves = [tree[n] for n in names]
    num_clients = leaves[0].shape[0]
    device = leaves[0].device
    spec = pk.build_pack_spec([leaf[0] for leaf in leaves])
    x2d = pk.pack_stacked(leaves, spec)
    seg_ids = spec.seg_ids(num_clients, device=device)
    k = torch.tensor([max(1, int(round(gamma * ls.size)))
                      for ls in spec.leaves], dtype=torch.int32
                     ).repeat(num_clients).to(device)

    hist = seg.segmented_histogram(x2d, seg_ids, k.numel())
    lo, hi, cnt_lo, cnt_hi = seg.select_thresholds(hist, k)
    for sweep in range(refine_sweeps):
        # Sweep 0 subdivides the histogram's 16x bracket geometrically;
        # later sweeps refine the now-narrow bracket linearly.
        cand = seg.candidate_taus(lo, hi, candidates, geometric=(sweep == 0))
        counts = seg.segmented_count(x2d, seg_ids, cand)
        lo, hi, cnt_lo, cnt_hi = seg.shrink_brackets(
            lo, hi, cnt_lo, cnt_hi, cand, counts, k)
    # Conservative endpoint per segment; lo when hi would keep nothing.
    tau = torch.where(cnt_hi >= 1, hi, lo)
    out2d, _kept = seg.segmented_apply(x2d, seg_ids, tau)

    out = dict(tree)
    for name, masked in zip(names, pk.unpack_stacked(out2d, spec)):
        out[name] = masked
    return out


def topk_mask_pytree(tree: Tree, gamma: float, *, min_leaf_size: int = 256,
                     refine_sweeps: int = DEFAULT_REFINE_SWEEPS,
                     candidates: int = DEFAULT_CANDIDATES) -> Tree:
    """Whole-model selective masking of ONE client's delta tree in
    ``refine_sweeps + 2`` sweeps (see :func:`topk_mask_stacked`)."""
    stacked = topk_mask_stacked({n: leaf[None] for n, leaf in tree.items()},
                                gamma, min_leaf_size=min_leaf_size,
                                refine_sweeps=refine_sweeps,
                                candidates=candidates)
    return {n: leaf[0] for n, leaf in stacked.items()}
