"""Byzantine-robust aggregators (counterpart of ``repro/core/robust.py``).

Every factory here returns a :class:`repro_torch.core.strategy.Aggregator`
with the five-argument contract ``fn(global_params, uploads, weights,
upload_semantics, normalize=True)``, a drop-in for plain FedAvg.

* **Zero-weight rows are absent.**  The reference's oracle hands an
  aggregator all M client rows with zero weights on non-participants; the
  port's rounds hand it the participants' rows, where a quarantined or
  lost upload still has weight 0.  The statistics are weighted ranks in
  which a zero-weight row never changes a bit: the median and trim masses
  skip them, Krum's distances and candidates are the ``weight > 0`` rows.
* **HT compatibility is declared.**  The weighted median and trimmed mean
  take Horvitz-Thompson (``normalize=False``) weights as masses; Krum
  ignores weight magnitudes, so ``krum``/``multi_krum`` are built with
  ``ht_compatible=False`` and a round pairing them with an HT sampler
  raises at build time.
* **Construction-time validation.**  Out-of-range knobs raise
  ``ValueError`` naming the knob.

Sorts are stable (sparse uploads are full of tied zeros), and the
cumulative weights are summed as XLA:CPU sums the reference's
``jnp.cumsum`` (``sampling._cumsum``), so the crossing test ``cum >= half``
sees the reference's values.  Krum's pairwise distances accumulate
squared differences over blocks of rows, never an ``(n, n, P)`` tensor.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.core.federated import _row_l2, fedavg_aggregate
from repro_torch.core.sampling import _cumsum

Tree = Dict[str, torch.Tensor]

__all__ = ["coordinate_median", "trimmed_mean", "krum", "multi_krum",
           "norm_filter"]

# Masked-out score/distance sentinel: a finite "infinity" (inf - inf = NaN
# would poison cumulative sums over absent rows).
_BIG = 1e30
# Bytes of squared differences one step of the pairwise distances may hold:
# a block of r rows against all n is (r, n, P_leaf) fp32.
_PAIRWISE_BYTES = 1 << 28


def _make_aggregator(name, fn, ht_compatible=True):
    # Deferred import: strategy.py imports this module for its registry.
    from repro_torch.core.strategy import Aggregator
    return Aggregator(name, fn, ht_compatible=ht_compatible)


def _combine(global_params: Tree, contribution: Tree,
             upload_semantics: str) -> Tree:
    """Fold a per-leaf aggregate into the parameters under the upload
    semantics (as FedAvg does)."""
    return {k: ((g + contribution[k]) if upload_semantics == "delta"
                else contribution[k]).to(g.dtype)
            for k, g in global_params.items()}


def _per_coordinate(uploads: Tree, reduce_2d) -> Tree:
    """``reduce_2d((rows, coords)) -> (coords,)`` on every leaf, shapes
    restored."""
    return {k: reduce_2d(u.reshape(u.shape[0], math.prod(u.shape[1:])))
            .reshape(u.shape[1:]) for k, u in uploads.items()}


def _sorted_masses(flat: torch.Tensor, w: torch.Tensor):
    """Each column's values in stable ascending order, their weights and
    the cumulative weights (XLA:CPU's association)."""
    order = torch.argsort(flat, dim=0, stable=True)
    vals = torch.take_along_dim(flat, order, dim=0)
    ws = w[order]
    return vals, ws, _cumsum(ws)


def coordinate_median() -> "Aggregator":
    """Coordinate-wise weighted median: per coordinate, the first sorted
    value whose cumulative mass reaches half the total (the lower
    weighted median).  Zero-weight rows carry no mass, so they are never
    the crossing value; an empty round contributes nothing."""

    def agg(global_params, uploads, weights, upload_semantics,
            normalize=True):
        w = weights.to(torch.float32)
        total = w.sum()
        half = 0.5 * total

        def med(flat):
            if not flat.shape[0]:
                return flat.new_zeros(flat.shape[1])
            vals, _, cum = _sorted_masses(flat, w)
            idx = torch.argmax((cum >= half).to(torch.uint8), dim=0)
            picked = torch.take_along_dim(vals, idx[None], dim=0)[0]
            # empty round (total mass 0): contribute nothing
            return torch.where(total > 0, picked, torch.zeros_like(picked))

        return _combine(global_params, _per_coordinate(uploads, med),
                        upload_semantics)

    return _make_aggregator("coordinate_median", agg)


def trimmed_mean(beta: float) -> "Aggregator":
    """Coordinate-wise ``beta``-trimmed weighted mean: the lowest and
    highest ``beta`` of the weight mass are trimmed (partial rows at the
    cuts keep their inside mass) and the rest averaged.  ``beta=0`` is
    ``fedavg_aggregate`` itself.  Under HT weights (``normalize=False``)
    the kept mass is rescaled to the full mass."""
    if not 0.0 <= beta < 0.5:
        raise ValueError(
            f"trimmed_mean: beta must be in [0, 0.5), got {beta}")
    if beta == 0.0:
        return _make_aggregator(f"trimmed_mean({beta})", fedavg_aggregate)

    def agg(global_params, uploads, weights, upload_semantics,
            normalize=True):
        w = weights.to(torch.float32)
        total = w.sum()
        lo = beta * total
        hi = (1.0 - beta) * total

        def tmean(flat):
            if not flat.shape[0]:
                return flat.new_zeros(flat.shape[1])
            vals, ws, cum = _sorted_masses(flat, w)
            # mass of sorted row i inside the kept interval [lo, hi]
            kept = torch.clamp(torch.minimum(cum, hi)
                               - torch.maximum(cum - ws, lo), min=0.0)
            num = (kept * vals).sum(0)
            kept_mass = torch.clamp(kept.sum(0), min=1e-12)
            out = (num / kept_mass if normalize
                   else num * (total / kept_mass))
            return torch.where(total > 0, out, torch.zeros_like(out))

        return _combine(global_params, _per_coordinate(uploads, tmean),
                        upload_semantics)

    return _make_aggregator(f"trimmed_mean({beta})", agg)


def _pairwise_sq_dists(uploads: Tree, present: torch.Tensor) -> torch.Tensor:
    """(n, n) sums of squared distances over every leaf (sorted order),
    with pairs that touch an absent row, and the diagonal, at ``_BIG``.
    Each leaf's squared differences are taken for a block of rows against
    all n at a time, the block sized to ``_PAIRWISE_BYTES``."""
    n = present.shape[0]
    d2 = present.new_zeros((n, n), dtype=torch.float32)
    for k in sorted(uploads):
        leaf = uploads[k]
        flat = leaf.reshape(n, math.prod(leaf.shape[1:])).to(torch.float32)
        step = max(1, _PAIRWISE_BYTES // max(1, 4 * n * flat.shape[1]))
        for i in range(0, n, step):
            diff = flat[i:i + step, None, :] - flat[None, :, :]
            d2[i:i + step] += diff.mul_(diff).sum(-1)
            del diff
    ok = present > 0
    pair_ok = ok[:, None] & ok[None, :] & ~torch.eye(
        n, dtype=torch.bool, device=d2.device)
    return torch.where(pair_ok, d2, torch.full_like(d2, _BIG))


def _krum_scores(uploads: Tree, weights: torch.Tensor, f: int):
    """Krum scores of the ``weight > 0`` rows: the sum of squared
    distances to each one's ``n - f - 2`` nearest present neighbours
    (clamped to [1, n - 1]); absent rows score +inf."""
    present = (weights > 0).to(torch.float32)
    n = present.sum()
    dist = _pairwise_sq_dists(uploads, present)
    ranked = torch.sort(dist, dim=1).values
    cum = _cumsum(ranked.T).T
    # n - f - 2 nearest neighbours; never more than the n - 1 present ones
    # (so the _BIG sentinels stay out of every present row's score).
    k = torch.minimum(torch.clamp(n - f - 2, min=1.0),
                      torch.clamp(n - 1.0, min=1.0)).to(torch.int64)
    score = cum.gather(1, (k - 1).expand(cum.shape[0], 1))[:, 0]
    return torch.where(present > 0, score,
                       torch.full_like(score, float("inf"))), present, n


def krum(f: int) -> "Aggregator":
    """Krum (Blanchard et al., 2017): apply the single most central
    candidate, assuming at most ``f`` Byzantine rows; ties go to the
    lowest row.  Unweighted selection, so not Horvitz-Thompson
    compatible."""
    if f < 0:
        raise ValueError(f"krum: f must be >= 0, got {f}")

    def agg(global_params, uploads, weights, upload_semantics,
            normalize=True):
        rows = weights.shape[0]
        sel = weights.new_zeros(rows, dtype=torch.float32)
        if rows:
            score, _, n = _krum_scores(uploads, weights, f)
            sel = (torch.arange(rows, device=sel.device)
                   == torch.argmin(score)).to(torch.float32)
            # empty round: no candidate, contribute nothing
            sel = sel * (n > 0)
        return fedavg_aggregate(global_params, uploads, sel,
                                upload_semantics, normalize=True)

    return _make_aggregator(f"krum({f})", agg, ht_compatible=False)


def multi_krum(f: int, m: int) -> "Aggregator":
    """Multi-Krum: weighted FedAvg over the ``m`` lowest-Krum-score
    candidates (ranks by a stable double argsort: ties to the lowest
    row).  Not Horvitz-Thompson compatible."""
    if f < 0:
        raise ValueError(f"multi_krum: f must be >= 0, got {f}")
    if m < 1:
        raise ValueError(f"multi_krum: m must be >= 1, got {m}")

    def agg(global_params, uploads, weights, upload_semantics,
            normalize=True):
        sel = torch.zeros_like(weights, dtype=torch.float32)
        if weights.shape[0]:
            score, present, n = _krum_scores(uploads, weights, f)
            rank = torch.argsort(torch.argsort(score, stable=True),
                                 stable=True)
            sel = (rank < torch.clamp(n, max=float(m))).to(
                torch.float32) * present
        return fedavg_aggregate(global_params, uploads, weights * sel,
                                upload_semantics, normalize=True)

    return _make_aggregator(f"multi_krum({f},{m})", agg, ht_compatible=False)


def norm_filter(max_norm: float,
                inner: Optional["Aggregator"] = None) -> "Aggregator":
    """Reject (zero-weight) uploads whose L2 norm exceeds ``max_norm``,
    then delegate to ``inner`` (plain FedAvg by default); HT compatibility
    is ``inner``'s."""
    if max_norm <= 0.0:
        raise ValueError(
            f"norm_filter: max_norm must be > 0, got {max_norm}")
    inner_fn = inner.fn if inner is not None else fedavg_aggregate
    inner_ht = inner.ht_compatible if inner is not None else True
    name = f"norm_filter({max_norm})"
    if inner is not None:
        name += f"+{inner.name}"

    def agg(global_params, uploads, weights, upload_semantics,
            normalize=True):
        keep = (_row_l2(uploads) <= max_norm).to(weights.dtype)
        return inner_fn(global_params, uploads, weights * keep,
                        upload_semantics, normalize=normalize)

    return _make_aggregator(name, agg, ht_compatible=inner_ht)
