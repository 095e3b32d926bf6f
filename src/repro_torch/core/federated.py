"""The federated round (counterpart of ``repro/core/federated.py``).

One round implements the paper's Alg. 1/3 server loop body with Alg. 2/4
client bodies:

  1. the sampler picks the participants from the round's uniform scores
     (static/dynamic m_t) and their aggregation weights,
  2. the clients run their local update and masking,
  3. every upload crosses the wire codec, and
  4. weighted FedAvg (Eq. 2): Θ_{t+1} = Θ_t + Σ_i w_i · upload_i.

Two execution forms of the same round:

* **oracle** (``make_federated_round``): ALL registered clients run,
  non-participants are zero-weighted;
* **cohort** (``make_cohort_round``): only a bucketed cohort of
  ``cohort_size`` clients runs, ids ascending, zero-weighted where it is
  padding, so the weighted reduction visits participants in the oracle's
  client-id order.

Each form has two bodies, as in the reference.  The *plain* body serves the
paper's round (uniform sampler, no hetero fleet): its cohort holds the m_t
participants padded with the next-ranked non-participants.  The
*generalized* body serves a non-uniform :class:`ClientSampler` (its
Horvitz-Thompson weights, the server's per-client update-norm EMA) and a
:class:`~repro_torch.core.hetero.HeteroModel` fleet (in-round upload
dropout: a lost upload is zero-weighted and commits no state; the
``part_mask``/``arrived_mask`` metrics feed the host-side round clock).
Its cohort gathers the sampler's ``part > 0`` ids padded with the
lowest-id non-participants.  Selection and the dropout draw run on the
CPU from the (M,) draws, so a run on the card picks the clients a run on
the CPU picks.

A round is ``round_fn(params, state, client_batches, n_samples, t, scores,
mask_scores=None, drop_scores=None) -> (params, state, metrics)``.
``state`` holds the per-client server state: ``"residuals"`` (stacked
error-feedback rows), ``"drift"`` (FedDyn's stacked drift rows, when the
objective uses drift) and ``"norms"`` (the (M,) norm EMA, for an adaptive
sampler).  The reference threads a ``jax.random`` key; here a round takes
the draws that key would have made: the (M,) uniform ``scores``, the
per-client random-mask scores (``{leaf: (M, *shape)}``; the cohort body
masks client i with row i of them) and, with a hetero fleet, the (M,)
uniform ``drop_scores``.  Both bodies gate the decoded payload through the
non-finite quarantine (``metrics["quarantined"]``).

With ``FederatedConfig.error_feedback`` both bodies run the reference's
round-level error feedback (DGC-style residuals): each client adds its
residual to its delta before masking, keeps the masked-out remainder, and
— when the codec is lossy — also the wire loss ``u - w``.  Only
participants whose upload arrived and passed the quarantine gate commit
their new residual (and FedDyn drift, and norm); every other row keeps the
old one.  Byzantine attacks wait for ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.core.client import ClientConfig, stacked_client_update
from repro_torch.core.codecs import roundtrip_stacked
from repro_torch.core.sampling import (SamplingSchedule, UniformSampler,
                                       participation_mask)

Tree = Dict[str, torch.Tensor]

__all__ = ["FederatedConfig", "fedavg_aggregate", "cohort_select",
           "make_cohort_compute", "make_federated_round",
           "make_cohort_round"]

_ATTACKS = ("Byzantine attacks (an active AttackModel) are not ported yet: "
            "ROADMAP Queue 1 item 13")


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


def _is_plain(sampler, hetero) -> bool:
    """True when the round reduces to the paper's body: uniform sampler,
    no hetero fleet."""
    return hetero is None and (sampler is None
                               or isinstance(sampler, UniformSampler))


def _check_attack(attack) -> None:
    if attack is not None and getattr(attack, "active", True):
        raise NotImplementedError(_ATTACKS)


def _aggregator(aggregator, normalize: bool) -> Callable:
    """The aggregation call with the sampler's weight semantics bound:
    FedAvg re-normalizes the weights, or takes Horvitz-Thompson weights as
    they are."""
    fn = aggregator.fn if aggregator is not None else fedavg_aggregate
    if normalize:
        return fn

    def agg_fn(g, uploads, weights, semantics):
        return fn(g, uploads, weights, semantics, normalize=False)

    return agg_fn


def _row_l2(stacked: Tree) -> torch.Tensor:
    """Per-client L2 norm over every leaf (sorted leaf order, fp32)."""
    return torch.sqrt(sum(
        torch.sum(torch.square(stacked[k].float()).reshape(
            stacked[k].shape[0], -1), 1) for k in sorted(stacked)))


def _round_extras(sampler, hetero, cfg: FederatedConfig):
    """The generalized bodies' setup: the resolved sampler and the static
    (M,) fp32 drop-rate vector on the CPU (or None)."""
    smp = sampler if sampler is not None else UniformSampler()
    drop = None
    if hetero is not None:
        drop = torch.as_tensor(hetero.drop_rates(cfg.num_clients),
                               dtype=torch.float32)
    return smp, drop


def _apply_dropout(part, weights, drop, drop_scores, normalize: bool):
    """Fold the round's upload losses (``drop_scores < drop``) into the
    participation weights: ``(arrived, weights)``.  Self-normalized weights
    just zero the lost rows; Horvitz-Thompson weights also divide by the
    survival probability, ``E[arrived_i / (1 - q_i)] = part_i``."""
    if drop is None:
        return part, weights
    lost = (drop_scores.to(drop.device) < drop).to(torch.float32)
    arrived = part * (1.0 - lost)
    if normalize:
        return arrived, weights * arrived
    return arrived, weights * arrived / torch.clamp(1.0 - drop, min=1e-6)


def _select(smp, schedule, t, cfg, scores, n_samples, norms, drop,
            drop_scores):
    """Selection and dropout on the CPU: ``(part, weights, arrived)`` on the
    CPU, weights after dropout."""
    part, weights = smp.select(
        scores.cpu(), schedule, t, cfg.num_clients, n_samples.cpu(),
        None if norms is None else norms.cpu())
    arrived, weights = _apply_dropout(part, weights, drop, drop_scores,
                                      smp.normalize)
    return part, weights, arrived


def _norm_ema(smp, old: torch.Tensor, obs: torch.Tensor,
              commit: torch.Tensor) -> torch.Tensor:
    """The tracker observes the decoded payload's norm where the upload
    applied; other rows keep their value."""
    return torch.where(commit > 0, (1.0 - smp.ema) * old + smp.ema * obs,
                       old)


def _general_metrics(losses, valid, part, arrived, quarantined,
                     dropout: bool) -> Dict[str, torch.Tensor]:
    """An empty round (the threshold sampler's count can be 0) reports a
    NaN loss, not 0.0."""
    n_part = part.sum()
    mean = (losses * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    metrics = {"mean_loss": mean if float(n_part) > 0
               else torch.full_like(mean, float("nan")),
               "num_sampled": n_part,
               "quarantined": quarantined}
    if dropout:
        metrics.update(part_mask=part, arrived_mask=arrived,
                       num_arrived=arrived.sum())
    return metrics


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
                         aggregator=None, sampler=None, hetero=None,
                         attack=None):
    """Build the full-population (oracle) round (the signature is in the
    module docstring).

    ``client_batches`` are tensors with leading (num_clients, num_batches,
    B, ...) axes, ``n_samples`` the (num_clients,) dataset sizes.
    ``codec`` round-trips every upload; ``aggregator`` replaces plain
    FedAvg; ``sampler`` picks the participants and their weights;
    ``hetero`` adds in-round upload dropout.
    """
    _check_attack(attack)
    uses_drift = cfg.client.objective.uses_drift
    if _is_plain(sampler, hetero):
        agg_fn = _aggregator(aggregator, True)

        def plain_fn(params: Tree, state: Dict[str, Any],
                     client_batches: Sequence[torch.Tensor],
                     n_samples: torch.Tensor, t, scores: torch.Tensor,
                     mask_scores: Optional[Tree] = None, drop_scores=None):
            residuals, drift = state["residuals"], state.get("drift")
            part = participation_mask(scores, schedule, t, cfg.num_clients)
            part = part.to(n_samples.device)
            uploads, new_res, new_drift, losses = stacked_client_update(
                loss_fn, params, client_batches, cfg.client, residuals,
                cfg.error_feedback, mask_scores, drift)
            wired = roundtrip_stacked(codec, uploads)
            finite = _finite_rows(wired)
            weights = part * n_samples * finite
            new_params = agg_fn(params, _zero_rows(wired, finite), weights,
                                cfg.client.upload)
            out = {"residuals": _residual_update(
                cfg, residuals, new_res, uploads, wired, part * finite)}
            if uses_drift:
                out["drift"] = _commit_rows(drift, new_drift, part * finite)
            return new_params, out, _metrics(losses, part, finite)

        return plain_fn

    smp, drop = _round_extras(sampler, hetero, cfg)
    agg_fn = _aggregator(aggregator, smp.normalize)

    def round_fn(params: Tree, state: Dict[str, Any],
                 client_batches: Sequence[torch.Tensor],
                 n_samples: torch.Tensor, t, scores: torch.Tensor,
                 mask_scores: Optional[Tree] = None,
                 drop_scores: Optional[torch.Tensor] = None):
        residuals, drift = state["residuals"], state.get("drift")
        norms = state.get("norms")
        device = n_samples.device
        part, weights, arrived = _select(smp, schedule, t, cfg, scores,
                                         n_samples, norms, drop, drop_scores)
        part_d, arrived_d = part.to(device), arrived.to(device)
        uploads, new_res, new_drift, losses = stacked_client_update(
            loss_fn, params, client_batches, cfg.client, residuals,
            cfg.error_feedback, mask_scores, drift)
        wired = roundtrip_stacked(codec, uploads)
        finite = _finite_rows(wired)
        weights = weights.to(device) * finite
        new_params = agg_fn(params, _zero_rows(wired, finite), weights,
                            cfg.client.upload)
        commit = arrived_d * finite
        out = {"residuals": _residual_update(cfg, residuals, new_res,
                                             uploads, wired, commit)}
        if uses_drift:
            out["drift"] = _commit_rows(drift, new_drift, commit)
        if smp.adaptive:
            out["norms"] = _norm_ema(smp, norms, _row_l2(wired), commit)
        return new_params, out, _general_metrics(
            losses, part_d, part, arrived, (arrived_d * (1.0 - finite)).sum(),
            drop is not None)

    return round_fn


def make_cohort_compute(loss_fn: Callable, schedule: SamplingSchedule,
                        cfg: FederatedConfig, cohort_size: int, *,
                        codec=None, sampler=None, hetero=None, attack=None):
    """The generalized cohort round's client-side sweep: selection and the
    dropout draw → cohort gather → local updates → wire round-trip, and
    nothing after it.

    Returns ``compute(params, state, client_batches, n_samples, t, scores,
    mask_scores=None, drop_scores=None) -> dict`` with ``part``,
    ``weights`` and ``arrived`` (full (M,) selection, post-dropout weights
    and arrivals, on the CPU), ``cohort_ids`` (the ``part > 0`` ids
    ascending, padded with the lowest-id non-participants, on the
    device), ``cohort_res`` / ``cohort_drift`` (the round-entry residual
    rows under error feedback and drift rows under FedDyn, else None),
    ``uploads`` / ``wired`` (pre-/post-wire stacked uploads), ``new_res``
    / ``new_drift`` (post-round state candidates) and ``losses``.
    """
    if not 0 < cohort_size <= cfg.num_clients:
        raise ValueError(
            f"cohort_size {cohort_size} not in (0, {cfg.num_clients}]")
    _check_attack(attack)
    smp, drop = _round_extras(sampler, hetero, cfg)
    M = cfg.num_clients

    def compute(params, state, client_batches, n_samples, t, scores,
                mask_scores=None, drop_scores=None):
        part, weights, arrived = _select(smp, schedule, t, cfg, scores,
                                         n_samples, state.get("norms"), drop,
                                         drop_scores)
        ids = torch.arange(M)
        order = torch.argsort(torch.where(part > 0, ids, ids + M),
                              stable=True)
        cohort_ids = torch.sort(order[:cohort_size]).values.to(
            n_samples.device)

        def gather(tree):
            return None if tree is None else {
                k: v.index_select(0, cohort_ids) for k, v in tree.items()}

        cohort_res = (gather(state["residuals"]) if cfg.error_feedback
                      else None)
        cohort_drift = gather(state.get("drift"))
        uploads, new_res, new_drift, losses = stacked_client_update(
            loss_fn, params, [x.index_select(0, cohort_ids)
                              for x in client_batches],
            cfg.client, cohort_res, cfg.error_feedback, gather(mask_scores),
            cohort_drift)
        return {"part": part, "weights": weights, "arrived": arrived,
                "cohort_ids": cohort_ids, "cohort_res": cohort_res,
                "cohort_drift": cohort_drift,
                "uploads": uploads, "wired": roundtrip_stacked(codec, uploads),
                "new_res": new_res, "new_drift": new_drift,
                "losses": losses}

    return compute


def make_cohort_round(loss_fn: Callable, schedule: SamplingSchedule,
                      cfg: FederatedConfig, cohort_size: int, *,
                      codec=None, aggregator=None, sampler=None, hetero=None,
                      attack=None):
    """Cohort form of :func:`make_federated_round`: same signature and math,
    but only ``cohort_size`` clients (an upper bound on the participant
    count, ``ClientSampler.cohort_bucket``) run.  Cohort ids are
    ascending, so the weighted reduction visits participants in the
    oracle's client-id order."""
    if not 0 < cohort_size <= cfg.num_clients:
        raise ValueError(
            f"cohort_size {cohort_size} not in (0, {cfg.num_clients}]")
    _check_attack(attack)
    uses_drift = cfg.client.objective.uses_drift

    def scatter(full: Tree, cohort_ids, rows: Tree) -> Tree:
        return {k: v.index_copy(0, cohort_ids, rows[k])
                for k, v in full.items()}

    if _is_plain(sampler, hetero):
        agg_fn = _aggregator(aggregator, True)

        def plain_fn(params: Tree, state: Dict[str, Any],
                     client_batches: Sequence[torch.Tensor],
                     n_samples: torch.Tensor, t, scores: torch.Tensor,
                     mask_scores: Optional[Tree] = None, drop_scores=None):
            residuals, drift = state["residuals"], state.get("drift")
            cohort_ids, valid = cohort_select(scores, schedule, t,
                                              cfg.num_clients, cohort_size)
            device = n_samples.device
            cohort_ids, valid = cohort_ids.to(device), valid.to(device)
            cohort_batches = [x.index_select(0, cohort_ids)
                              for x in client_batches]
            cohort_res = ({k: r.index_select(0, cohort_ids)
                           for k, r in residuals.items()}
                          if cfg.error_feedback else None)
            cohort_drift = ({k: d.index_select(0, cohort_ids)
                             for k, d in drift.items()}
                            if uses_drift else None)
            cohort_scores = (None if mask_scores is None else
                             {k: s.index_select(0, cohort_ids)
                              for k, s in mask_scores.items()})
            uploads, new_res, new_drift, losses = stacked_client_update(
                loss_fn, params, cohort_batches, cfg.client, cohort_res,
                cfg.error_feedback, cohort_scores, cohort_drift)
            wired = roundtrip_stacked(codec, uploads)
            finite = _finite_rows(wired)
            weights = valid * n_samples.index_select(0, cohort_ids) * finite
            new_params = agg_fn(params, _zero_rows(wired, finite), weights,
                                cfg.client.upload)
            out = {"residuals": residuals}
            if cfg.error_feedback:
                rows = _residual_update(cfg, cohort_res, new_res, uploads,
                                        wired, valid * finite)
                out["residuals"] = scatter(residuals, cohort_ids, rows)
            if uses_drift:
                out["drift"] = scatter(drift, cohort_ids, _commit_rows(
                    cohort_drift, new_drift, valid * finite))
            return new_params, out, _metrics(losses, valid, finite)

        return plain_fn

    smp, _ = _round_extras(sampler, hetero, cfg)
    agg_fn = _aggregator(aggregator, smp.normalize)
    compute = make_cohort_compute(loss_fn, schedule, cfg, cohort_size,
                                  codec=codec, sampler=sampler, hetero=hetero)

    def round_fn(params: Tree, state: Dict[str, Any],
                 client_batches: Sequence[torch.Tensor],
                 n_samples: torch.Tensor, t, scores: torch.Tensor,
                 mask_scores: Optional[Tree] = None,
                 drop_scores: Optional[torch.Tensor] = None):
        c = compute(params, state, client_batches, n_samples, t, scores,
                    mask_scores, drop_scores)
        cohort_ids, uploads, wired = c["cohort_ids"], c["uploads"], c["wired"]
        device = n_samples.device
        finite = _finite_rows(wired)
        valid = c["part"].to(device).index_select(0, cohort_ids)
        arr_c = c["arrived"].to(device).index_select(0, cohort_ids)
        w_c = c["weights"].to(device).index_select(0, cohort_ids) * finite
        new_params = agg_fn(params, _zero_rows(wired, finite), w_c,
                            cfg.client.upload)
        commit = arr_c * finite
        out = {"residuals": state["residuals"]}
        if cfg.error_feedback:
            out["residuals"] = scatter(state["residuals"], cohort_ids,
                                       _residual_update(
                                           cfg, c["cohort_res"],
                                           c["new_res"], uploads, wired,
                                           commit))
        if uses_drift:
            out["drift"] = scatter(state["drift"], cohort_ids, _commit_rows(
                c["cohort_drift"], c["new_drift"], commit))
        if smp.adaptive:
            norms = state["norms"]
            out["norms"] = norms.index_copy(0, cohort_ids, _norm_ema(
                smp, norms.index_select(0, cohort_ids), _row_l2(wired),
                commit))
        return new_params, out, _general_metrics(
            c["losses"], valid, c["part"], c["arrived"],
            (arr_c * (1.0 - finite)).sum(), hetero is not None)

    return round_fn
