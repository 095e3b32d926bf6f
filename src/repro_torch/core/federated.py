"""The federated round (counterpart of ``repro/core/federated.py``; this
slice ports the *plain* bodies: uniform sampler, no hetero fleet, no attack).

One round implements the paper's Alg. 1/3 server loop body with Alg. 2/4
client bodies:

  1. pick the participants from the round's uniform scores (static/dynamic
     m_t),
  2. the clients run their local update and masking,
  3. every upload crosses the wire codec, and
  4. weighted FedAvg (Eq. 2): Θ_{t+1} = Θ_t + Σ_i w_i · upload_i with
     w_i = mask_i·n_i / Σ mask_j·n_j.

Two execution forms of the same round:

* **oracle** (``make_federated_round``): ALL registered clients run,
  non-participants are zero-weighted;
* **cohort** (``make_cohort_round``): only a bucketed cohort of
  ``cohort_size`` clients — the m_t participants, ascending ids, padded
  with the next-ranked non-participants — runs and is zero-weighted where
  it is padding.

The reference threads a ``jax.random`` key; here a round takes the (M,)
uniform ``scores`` that key would have drawn, and under random masking the
per-client mask scores (``{leaf: (M, *shape)}``), so a caller can hand in
the reference's draws.  The cohort body masks client i with row i of them,
as the reference's ``take(split(mask_key, M), cohort_ids)`` does.  Both
bodies gate the decoded payload through the non-finite quarantine
(``metrics["quarantined"]``).

With ``FederatedConfig.error_feedback`` both bodies run the reference's
round-level error feedback (DGC-style residuals): each client adds its
residual to its delta before masking, keeps the masked-out remainder, and —
when the codec is lossy — also the wire loss ``u - w``.  Only participants
whose upload passed the quarantine gate commit their new residual; every
other row keeps the old one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.core.client import ClientConfig, stacked_client_update
from repro_torch.core.codecs import roundtrip_stacked
from repro_torch.core.sampling import (SamplingSchedule, UniformSampler,
                                       participation_mask)

Tree = Dict[str, torch.Tensor]

__all__ = ["FederatedConfig", "fedavg_aggregate", "cohort_select",
           "make_federated_round", "make_cohort_round"]

_GENERALIZED = ("only the plain round body (uniform sampler, no hetero "
                "fleet, no attack) is ported; the generalized bodies wait for "
                "ROADMAP Queue 1 items 10 and 13")


@dataclasses.dataclass(frozen=True)
class FederatedConfig:
    """Population-level round configuration: registered clients, their
    shared :class:`ClientConfig`, and whether error-feedback residuals
    accumulate (beyond-paper)."""

    num_clients: int
    client: ClientConfig
    error_feedback: bool = False


def fedavg_aggregate(global_params: Tree, uploads: Tree,
                     weights: torch.Tensor, upload_semantics: str,
                     normalize: bool = True) -> Tree:
    """Weighted FedAvg over stacked client uploads (leading client axis).
    ``normalize`` re-normalizes ``weights`` to sum to 1 (Eq. 2)."""
    if normalize:
        weights = weights / torch.clamp(weights.sum(), min=1e-12)
    out = {}
    for k, g in global_params.items():
        contrib = torch.tensordot(weights, uploads[k], dims=1)
        out[k] = (g + contrib if upload_semantics == "delta"
                  else contrib).to(g.dtype)
    return out


def _finite_rows(stacked: Tree) -> torch.Tensor:
    """1.0 for client rows whose every entry is finite, else 0.0."""
    ok = None
    for leaf in stacked.values():
        row_ok = torch.isfinite(leaf.reshape(leaf.shape[0], -1)).all(1)
        ok = row_ok if ok is None else ok & row_ok
    return ok.to(torch.float32)


def _zero_rows(stacked: Tree, keep: torch.Tensor) -> Tree:
    """Zero whole client rows where ``keep == 0`` (0 · NaN would be NaN)."""
    return {k: torch.where(keep.reshape((-1,) + (1,) * (u.dim() - 1)) > 0,
                           u, torch.zeros_like(u))
            for k, u in stacked.items()}


def _commit_rows(old: Tree, new: Tree, commit: torch.Tensor) -> Tree:
    """Per-row state commit: ``new[i]`` where ``commit[i] > 0``, else the
    round-entry ``old[i]``."""
    return {k: torch.where(commit.reshape((-1,) + (1,) * (n.dim() - 1)) > 0,
                           n, old[k]) for k, n in new.items()}


def _wire_feedback(new_res: Tree, uploads: Tree, wired: Tree) -> Tree:
    """EF wire-loss feedback ``r + (u - w)``.  The reference pins ``w``
    through a bitcast so XLA cannot contract a lossy codec's dequantisation
    multiply into the subtraction; eager PyTorch runs the subtraction and
    the addition as two separate kernels and never contracts across them,
    so the two ops below give the reference's bits as they stand."""
    return {k: r + (uploads[k] - wired[k]) for k, r in new_res.items()}


def _residual_update(cfg: FederatedConfig, residuals: Tree, new_res: Tree,
                     uploads: Tree, wired: Tree,
                     commit: torch.Tensor) -> Tree:
    """The rows' residuals after the round: the masked-out remainder plus
    the wire loss of a lossy codec, committed where ``commit`` (valid
    participant whose upload passed the gate); the old rows elsewhere.
    Without error feedback the residuals pass through."""
    if not cfg.error_feedback:
        return residuals
    if wired is not uploads:
        new_res = _wire_feedback(new_res, uploads, wired)
    return _commit_rows(residuals, new_res, commit)


def _check_plain(sampler) -> None:
    if sampler is not None and not isinstance(sampler, UniformSampler):
        raise NotImplementedError(_GENERALIZED)


def cohort_select(scores: torch.Tensor, schedule: SamplingSchedule, t,
                  num_clients: int, cohort_size: int):
    """The round's cohort: ``(cohort_ids, valid)`` with ids sorted ascending
    and ``valid[i] = 1`` iff member i is a true participant (its rank < m_t)
    — the participant set of :func:`participation_mask` for the same
    scores."""
    m = schedule.num_clients(t, num_clients)
    order = torch.argsort(scores, stable=True)
    ranks = torch.argsort(order, stable=True)
    cohort_ids = torch.sort(order[:cohort_size]).values
    return cohort_ids, (ranks[cohort_ids] < m).to(torch.float32)


def _metrics(losses, valid, finite) -> Dict[str, torch.Tensor]:
    return {"mean_loss": (losses * valid).sum()
            / torch.clamp(valid.sum(), min=1.0),
            "num_sampled": valid.sum(),
            "quarantined": (valid * (1.0 - finite)).sum()}


def make_federated_round(loss_fn: Callable, schedule: SamplingSchedule,
                         cfg: FederatedConfig, *, codec=None,
                         aggregator=None, sampler=None):
    """Build the full-population (oracle) round.

    Returns ``round_fn(params, residuals, client_batches, n_samples, t,
    scores, mask_scores=None) -> (params, residuals, metrics)``:
    ``client_batches`` are tensors with leading (num_clients, num_batches,
    B, ...) axes, ``n_samples`` the (num_clients,) dataset sizes,
    ``residuals`` the stacked (num_clients, ...) error-feedback state
    (passed through unchanged unless ``cfg.error_feedback``), ``scores`` the
    round's (num_clients,) uniform draws and ``mask_scores`` the random
    mask's per-entry draws, one (num_clients, *shape) tensor per maskable
    leaf (random masking only).  ``codec`` round-trips every upload;
    ``aggregator`` replaces plain FedAvg.
    """
    _check_plain(sampler)
    agg_fn = aggregator.fn if aggregator is not None else fedavg_aggregate

    def round_fn(params: Tree, residuals: Tree,
                 client_batches: Sequence[torch.Tensor],
                 n_samples: torch.Tensor, t, scores: torch.Tensor,
                 mask_scores: Optional[Tree] = None):
        part = participation_mask(scores, schedule, t, cfg.num_clients)
        part = part.to(n_samples.device)
        uploads, new_res, losses = stacked_client_update(
            loss_fn, params, client_batches, cfg.client, residuals,
            cfg.error_feedback, mask_scores)
        wired = roundtrip_stacked(codec, uploads)
        finite = _finite_rows(wired)
        weights = part * n_samples * finite
        new_params = agg_fn(params, _zero_rows(wired, finite), weights,
                            cfg.client.upload)
        residuals = _residual_update(cfg, residuals, new_res, uploads, wired,
                                     part * finite)
        return new_params, residuals, _metrics(losses, part, finite)

    return round_fn


def make_cohort_round(loss_fn: Callable, schedule: SamplingSchedule,
                      cfg: FederatedConfig, cohort_size: int, *,
                      codec=None, aggregator=None, sampler=None):
    """Cohort form of :func:`make_federated_round`: same signature and math,
    but only ``cohort_size`` clients (an upper bound on m_t) run.  Cohort
    ids are ascending, so the weighted reduction visits participants in the
    oracle's client-id order."""
    if not 0 < cohort_size <= cfg.num_clients:
        raise ValueError(
            f"cohort_size {cohort_size} not in (0, {cfg.num_clients}]")
    _check_plain(sampler)
    agg_fn = aggregator.fn if aggregator is not None else fedavg_aggregate

    def round_fn(params: Tree, residuals: Tree,
                 client_batches: Sequence[torch.Tensor],
                 n_samples: torch.Tensor, t, scores: torch.Tensor,
                 mask_scores: Optional[Tree] = None):
        cohort_ids, valid = cohort_select(scores, schedule, t,
                                          cfg.num_clients, cohort_size)
        device = n_samples.device
        cohort_ids, valid = cohort_ids.to(device), valid.to(device)
        cohort_batches = [x.index_select(0, cohort_ids)
                          for x in client_batches]
        cohort_res = ({k: r.index_select(0, cohort_ids)
                       for k, r in residuals.items()}
                      if cfg.error_feedback else None)
        cohort_scores = (None if mask_scores is None else
                         {k: s.index_select(0, cohort_ids)
                          for k, s in mask_scores.items()})
        uploads, new_res, losses = stacked_client_update(
            loss_fn, params, cohort_batches, cfg.client, cohort_res,
            cfg.error_feedback, cohort_scores)
        wired = roundtrip_stacked(codec, uploads)
        finite = _finite_rows(wired)
        weights = valid * n_samples.index_select(0, cohort_ids) * finite
        new_params = agg_fn(params, _zero_rows(wired, finite), weights,
                            cfg.client.upload)
        if cfg.error_feedback:
            rows = _residual_update(cfg, cohort_res, new_res, uploads, wired,
                                    valid * finite)
            residuals = {k: r.index_copy(0, cohort_ids, rows[k])
                         for k, r in residuals.items()}
        return new_params, residuals, _metrics(losses, valid, finite)

    return round_fn
