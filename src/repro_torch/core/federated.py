"""The federated round (counterpart of ``repro/core/federated.py``).

One round implements the paper's Alg. 1/3 server loop body with Alg. 2/4
client bodies:

  1. the sampler picks the participants from the round's uniform scores
     (static/dynamic m_t) and their aggregation weights,
  2. the clients run their local update and masking,
  3. every upload crosses the wire codec, and
  4. weighted FedAvg (Eq. 2): Θ_{t+1} = Θ_t + Σ_i w_i · upload_i.

Three execution forms of the same round, and a fourth over rounds:

* **oracle** (``make_federated_round``): ALL registered clients run,
  non-participants are zero-weighted;
* **cohort** (``make_cohort_round``): only a bucketed cohort of
  ``cohort_size`` clients runs, ids ascending, zero-weighted where it is
  padding, so the weighted reduction visits participants in the oracle's
  client-id order;
* **store** (``make_store_round``): the cohort round split at the
  client-state boundary, its state rows gathered and scattered by a
  :class:`~repro_torch.core.client_store.ClientStateStore` outside it (the
  layout is in the comment above :func:`make_store_selection`).

The **scan** form (``make_cohort_scan``) runs a segment of rounds of one
bucket in one call, the oracle or the cohort body; on a card it replays a
CUDA graph of the bucket's round (the comment above :class:`RoundParts`).

Every form aggregates over the participants' rows only, so the same
participants give the same parameters bit for bit whichever clients pad
the buffer.

The oracle and cohort forms have two bodies each, as in the reference.
The *plain* body serves the paper's round (uniform sampler, no hetero
fleet): its cohort holds the m_t participants padded with the next-ranked
non-participants.  The *generalized* body serves a non-uniform
:class:`ClientSampler` (its Horvitz-Thompson weights, the server's
per-client update-norm EMA) and a
:class:`~repro_torch.core.hetero.HeteroModel` fleet (in-round upload
dropout: a lost upload is zero-weighted and commits no state; the
``part_mask``/``arrived_mask`` metrics feed the host-side round clock).
Its cohort gathers the sampler's ``part > 0`` ids padded with the
lowest-id non-participants; the generalized cohort body is the store form
with its rows gathered from and scattered into the dense state.
Selection and the dropout draw run on the CPU from the (M,) draws, so a
run on the card picks the clients a run on the CPU picks.

A round is ``round_fn(params, state, client_batches, n_samples, t, scores,
mask_scores=None, drop_scores=None, attack_noise=None) -> (params, state,
metrics)``.
``state`` holds the per-client server state: ``"residuals"`` (stacked
error-feedback rows), ``"drift"`` (FedDyn's stacked drift rows, when the
objective uses drift) and ``"norms"`` (the (M,) norm EMA, for an adaptive
sampler).  The reference threads a ``jax.random`` key; here a round takes
the draws that key would have made: the (M,) uniform ``scores``, the
per-client random-mask scores (``{leaf: (M, *shape)}``; the cohort body
masks client i with row i of them) and, with a hetero fleet, the (M,)
uniform ``drop_scores`` and, under a ``gauss`` attack, the clients'
standard-normal ``attack_noise`` rows (``{leaf: (M, *shape)}``, gathered as
the mask scores are).  Both bodies gate the decoded payload through the
non-finite quarantine (``metrics["quarantined"]``).

With ``FederatedConfig.error_feedback`` both bodies run the reference's
round-level error feedback (DGC-style residuals): each client adds its
residual to its delta before masking, keeps the masked-out remainder, and
— when the codec is lossy — also the wire loss ``u - w``.  Only
participants whose upload arrived and passed the quarantine gate commit
their new residual (and FedDyn drift, and norm); every other row keeps the
old one.

An active :class:`~repro_torch.core.attacks.AttackModel` routes every
form to the generalized body.  The server decodes the attacked payload:
the adversary rows (a fixed (M,) assignment, gathered onto the buffer's
rows) are transformed after the wire round trip and before the gate, and
the gate, the norm tracker and the aggregator read that payload, while
error feedback commits the honest round trip (a client's residual is what
it failed to ship, not what an attacker forged in its name).
``metrics["num_adversarial"]`` counts the adversarial participants.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.core.client import ClientConfig, stacked_client_update
from repro_torch.core.codecs import roundtrip_stacked
from repro_torch.core.sampling import (SamplingSchedule, UniformSampler,
                                       participation_mask)
from repro_torch.kernels.packing import device_constant

Tree = Dict[str, torch.Tensor]

__all__ = ["FederatedConfig", "fedavg_aggregate", "cohort_select",
           "make_federated_round", "make_cohort_round",
           "make_store_selection", "make_store_compute", "StoreRound",
           "Dispatch", "store_dispatch", "make_store_round",
           "RoundParts", "make_cohort_scan", "CohortScan"]

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


def _is_plain(sampler, hetero, attack=None) -> bool:
    """True when the round reduces to the paper's body: uniform sampler,
    no hetero fleet, no attack."""
    return hetero is None and attack is None and (
        sampler is None or isinstance(sampler, UniformSampler))


def _active_attack(attack):
    """The attack model, or None for none or a zero-fraction one."""
    return attack if attack is not None and attack.active else None


def _adversaries(attack, num_clients: int) -> Optional[torch.Tensor]:
    """The (M,) fp32 CPU adversary assignment (None without an attack)."""
    if attack is None:
        return None
    return torch.from_numpy(attack.adversary_mask(num_clients))


def _adversaries_on(attack, num_clients: int, device) -> torch.Tensor:
    """:func:`_adversaries` on ``device``, a
    :func:`~repro_torch.kernels.packing.device_constant`."""
    return device_constant(("adversaries", attack, num_clients),
                           lambda: _adversaries(attack, num_clients), device)


def _aggregator(aggregator, normalize: bool) -> Callable:
    """The aggregation call with the sampler's weight semantics bound:
    FedAvg re-normalizes the weights, or takes Horvitz-Thompson weights as
    they are.  A rule that declares ``ht_compatible=False`` raises under
    an HT sampler."""
    if not normalize and aggregator is not None and not getattr(
            aggregator, "ht_compatible", True):
        raise TypeError(
            f"aggregator {aggregator.name!r} is not Horvitz-Thompson "
            "compatible but the sampler emits HT weights (normalize="
            "False); use a weighted-rank aggregator (coordinate_median / "
            "trimmed_mean) or a self-normalizing sampler")
    fn = aggregator.fn if aggregator is not None else fedavg_aggregate
    if normalize:
        return fn

    def agg_fn(g, uploads, weights, semantics):
        return fn(g, uploads, weights, semantics, normalize=False)

    return agg_fn


def _row_sumsq(leaf: torch.Tensor) -> torch.Tensor:
    """Each row's fp32 sum of squares, reduced in an order its width alone
    fixes: the squared row, zero-padded to a power of two p, is halved by
    adding its two halves until one column is left.  Only elementwise IEEE
    products and sums, so the card gives the CPU's bits (``torch.sum``
    orders its partial sums by device).  No more than a (rows, p) buffer
    is held: the lower half's squares, and the upper half's while they
    are added in."""
    flat = leaf.reshape(leaf.shape[0], math.prod(leaf.shape[1:])).float()
    width = flat.shape[1]
    if width <= 1:
        return (flat * flat).sum(1) if width else flat.new_zeros(
            flat.shape[0])
    half = 1 << (width - 1).bit_length() - 1
    acc = flat[:, :half] * flat[:, :half]
    hi = flat[:, half:]
    acc[:, :width - half] += hi * hi
    while half > 1:
        half //= 2
        acc[:, :half] += acc[:, half:2 * half]
        acc = acc[:, :half]
    return acc[:, 0]


def _row_l2(stacked: Tree) -> torch.Tensor:
    """Per-client L2 norm over every leaf, fp32, the same bits on every
    device and for any batching of the rows: each leaf's row sum of
    squares by :func:`_row_sumsq`, the leaves added in sorted-key order,
    then the root in float64 rounded once to fp32, which is the correctly
    rounded fp32 root (53 >= 2 * 24 + 2 bits) on both devices; torch's
    vectorized fp32 ``sqrt`` on the CPU is not correctly rounded.
    Selection reads these norms on the CPU, and at fleet scale one ulp of
    a norm can move an importance draw to another client."""
    total = None
    for k in sorted(stacked):
        s = _row_sumsq(stacked[k])
        total = s if total is None else total + s
    return torch.sqrt(total.double()).float()


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


def _participant_rows(valid: torch.Tensor, device) -> torch.Tensor:
    """Positions of a buffer's true participants (``valid > 0``, a CPU
    mask), ascending, on ``device``."""
    return torch.nonzero(valid > 0).reshape(-1).to(device)


def _aggregate(agg_fn, params: Tree, wired: Tree, finite: torch.Tensor,
               weights: torch.Tensor, rows: torch.Tensor,
               upload: str) -> Tree:
    """The aggregation over the participants' rows only, in client-id
    order.  Every buffer that holds a round's participants (the oracle's
    M rows, either cohort buffer) gives the aggregator the same matrix, so
    the sum comes out the same bits whichever clients pad the buffer: a
    BLAS product's rounding depends on where zero-weight rows sit."""
    def take(x):
        return x.index_select(0, rows)

    return agg_fn(params, _zero_rows({k: take(u) for k, u in wired.items()},
                                     take(finite)),
                  take(weights), upload)


def _mean_loss(losses: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Mean loss over the participants' rows (0.0 without any)."""
    return losses.index_select(0, rows).sum() / max(rows.numel(), 1)


def _general_metrics(losses, rows, part, arrived, quarantined,
                     dropout: bool) -> Dict[str, torch.Tensor]:
    """An empty round (the threshold sampler's count can be 0) reports a
    NaN loss, not 0.0."""
    n_part = part.sum()
    mean = _mean_loss(losses, rows)
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


def _metrics(losses, rows, valid, finite) -> Dict[str, torch.Tensor]:
    return {"mean_loss": _mean_loss(losses, rows),
            "num_sampled": valid.sum(),
            "quarantined": (valid * (1.0 - finite)).sum()}


# Every oracle and cohort body is three parts, so that the scan form
# (``make_cohort_scan``) can capture the middle one into a CUDA graph and
# replay it:
#
#     prepare(state, n_samples, t, scores, drop_scores)  [CPU]
#         -> inputs (bucket-shaped device tensors), host (the rest)
#     compute(params, carried, client_batches, n_samples, inputs,
#             mask_scores, attack_noise)                  [device, bucket]
#         -> new carried state, outs (payload, finite, weights, losses)
#     finish(params, outs, host)                          [device, m_t rows]
#         -> new_params, metrics
#
# ``prepare`` is the selection, which stays on the CPU.  ``compute`` is
# the work whose shapes the bucket fixes: the gathers, local SGD, masking,
# the wire round trip, the attack, the finite flags and the commit of the
# per-client state it carries (``RoundParts.carried``).  ``finish`` is the
# aggregation and the mean loss over the m_t participant rows, whose count
# changes from round to round inside a bucket.  The eager round runs the
# three in a row; the scan form runs the same ``prepare`` and ``finish``
# around a replay of ``compute``, so both give the same bits.


@dataclasses.dataclass(frozen=True)
class RoundParts:
    """One oracle or cohort body split where a CUDA graph can hold it (see
    the comment above); ``carried`` names the state trees ``compute`` reads
    and returns: ``residuals`` with error feedback, ``drift`` under FedDyn
    and ``norms`` for an adaptive sampler."""

    prepare: Callable
    compute: Callable
    finish: Callable
    carried: tuple


def _carried(cfg: FederatedConfig, adaptive: bool) -> tuple:
    return tuple(name for name, on in (
        ("residuals", cfg.error_feedback),
        ("drift", cfg.client.objective.uses_drift),
        ("norms", adaptive)) if on)


def _eager(parts: RoundParts, name: str) -> Callable:
    """The round (signature in the module docstring): the three parts in a
    row."""
    def round_fn(params: Tree, state: Dict[str, Any],
                 client_batches: Sequence[torch.Tensor],
                 n_samples: torch.Tensor, t, scores: torch.Tensor,
                 mask_scores: Optional[Tree] = None,
                 drop_scores: Optional[torch.Tensor] = None,
                 attack_noise: Optional[Tree] = None):
        inputs, host = parts.prepare(state, n_samples, t, scores,
                                     drop_scores)
        carried, outs = parts.compute(
            params, {k: state[k] for k in parts.carried}, client_batches,
            n_samples, inputs, mask_scores, attack_noise)
        new_params, metrics = parts.finish(params, outs, host)
        return new_params, {**state, **carried}, metrics

    round_fn.__name__ = round_fn.__qualname__ = name
    return round_fn


def _gather(tree: Optional[Tree], ids) -> Optional[Tree]:
    return None if tree is None else {
        k: v.index_select(0, ids) for k, v in tree.items()}


def _scatter(full: Tree, ids, rows: Tree) -> Tree:
    return {k: v.index_copy(0, ids, rows[k]) for k, v in full.items()}


def _plain_finish(agg_fn, upload: str) -> Callable:
    def finish(params, outs, host):
        rows = host["rows"]
        new_params = _aggregate(agg_fn, params, outs["payload"],
                                outs["finite"], outs["weights"], rows, upload)
        return new_params, _metrics(outs["losses"], rows, host["valid"],
                                    outs["finite"])

    return finish


def _general_finish(agg_fn, upload: str, dropout: bool, adv) -> Callable:
    def finish(params, outs, host):
        rows, part = host["rows"], host["part"]
        new_params = _aggregate(agg_fn, params, outs["payload"],
                                outs["finite"], outs["weights"], rows, upload)
        metrics = _general_metrics(
            outs["losses"], rows, part, host["arrived"],
            (host["arrived_d"] * (1.0 - outs["finite"])).sum(), dropout)
        if adv is not None:
            metrics["num_adversarial"] = (part * adv).sum()
        return new_params, metrics

    return finish


def _federated_parts(loss_fn: Callable, schedule: SamplingSchedule,
                     cfg: FederatedConfig, *, codec=None, aggregator=None,
                     sampler=None, hetero=None, attack=None) -> RoundParts:
    """The oracle body's parts (every registered client runs)."""
    attack = _active_attack(attack)
    uses_drift = cfg.client.objective.uses_drift
    upload = cfg.client.upload
    if _is_plain(sampler, hetero, attack):
        def prepare(state, n_samples, t, scores, drop_scores):
            part = participation_mask(scores.cpu(), schedule, t,
                                      cfg.num_clients)
            device = n_samples.device
            valid = part.to(device)
            return {"valid": valid}, {
                "rows": _participant_rows(part, device), "valid": valid}

        def compute(params, carried, client_batches, n_samples, inputs,
                    mask_scores, attack_noise):
            residuals, drift = carried.get("residuals"), carried.get("drift")
            part = inputs["valid"]
            uploads, new_res, new_drift, losses = stacked_client_update(
                loss_fn, params, client_batches, cfg.client, residuals,
                cfg.error_feedback, mask_scores, drift)
            wired = roundtrip_stacked(codec, uploads)
            finite = _finite_rows(wired)
            out = {}
            if cfg.error_feedback:
                out["residuals"] = _residual_update(
                    cfg, residuals, new_res, uploads, wired, part * finite)
            if uses_drift:
                out["drift"] = _commit_rows(drift, new_drift, part * finite)
            return out, {"payload": wired, "finite": finite,
                         "weights": part * n_samples * finite,
                         "losses": losses}

        return RoundParts(prepare, compute,
                          _plain_finish(_aggregator(aggregator, True), upload),
                          _carried(cfg, False))

    smp, drop = _round_extras(sampler, hetero, cfg)
    adv = _adversaries(attack, cfg.num_clients)

    def prepare(state, n_samples, t, scores, drop_scores):
        device = n_samples.device
        part, weights, arrived = _select(smp, schedule, t, cfg, scores,
                                         n_samples, state.get("norms"), drop,
                                         drop_scores)
        arrived_d = arrived.to(device)
        return ({"arrived": arrived_d, "weights": weights.to(device)},
                {"rows": _participant_rows(part, device), "part": part,
                 "arrived": arrived, "arrived_d": arrived_d})

    def compute(params, carried, client_batches, n_samples, inputs,
                mask_scores, attack_noise):
        residuals, drift = carried.get("residuals"), carried.get("drift")
        uploads, new_res, new_drift, losses = stacked_client_update(
            loss_fn, params, client_batches, cfg.client, residuals,
            cfg.error_feedback, mask_scores, drift)
        wired = roundtrip_stacked(codec, uploads)
        # What the server decodes: the adversary rows transformed.
        payload = (wired if attack is None else attack.apply_stacked(
            wired, _adversaries_on(attack, cfg.num_clients,
                                   n_samples.device), attack_noise))
        finite = _finite_rows(payload)
        commit = inputs["arrived"] * finite
        out = {}
        if cfg.error_feedback:
            out["residuals"] = _residual_update(cfg, residuals, new_res,
                                                uploads, wired, commit)
        if uses_drift:
            out["drift"] = _commit_rows(drift, new_drift, commit)
        if smp.adaptive:
            out["norms"] = _norm_ema(smp, carried["norms"],
                                     _row_l2(payload), commit)
        return out, {"payload": payload, "finite": finite,
                     "weights": inputs["weights"] * finite, "losses": losses}

    return RoundParts(prepare, compute,
                      _general_finish(_aggregator(aggregator, smp.normalize),
                                      upload, drop is not None, adv),
                      _carried(cfg, smp.adaptive))


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
    ``hetero`` adds in-round upload dropout; ``attack`` perturbs the
    adversary rows of the decoded payload.
    """
    parts = _federated_parts(loss_fn, schedule, cfg, codec=codec,
                             aggregator=aggregator, sampler=sampler,
                             hetero=hetero, attack=attack)
    plain = _is_plain(sampler, hetero, _active_attack(attack))
    return _eager(parts, "plain_fn" if plain else "round_fn")


# The store form splits the round at the client-state boundary, so a
# ``ClientStateStore`` (dense or sharded) owns the per-client rows and the
# round only ever sees cohort-shaped ones:
#
#     select(norms, n_samples, t, scores)            [CPU, (M,) tensors]
#         -> part, weights, cohort_ids
#     store.gather(cohort_ids)                        [residual, drift rows]
#     body(params, cohort_res, cohort_drift, cohort_batches, cohort_ids,
#          part, weights, norms, mask_scores, drop_scores)
#         -> new_params, new_rows, drift_rows, commit, norm_upd, metrics
#     store.scatter(cohort_ids, new_rows, commit, t)
#     store.update_norms(cohort_ids, norm_upd)
#
# The cohort buffer holds the ``part > 0`` ids padded with the lowest-id
# non-participants, ascending.  Padding rows never commit and are left out
# of every cross-row sum, so a sharded gather that reads zeros for a client
# the window forgot changes only rows nothing reads.  The generalized
# cohort round below is this form with the gather and scatter done on the
# dense state.


def make_store_selection(schedule: SamplingSchedule, cfg: FederatedConfig,
                         cohort_size: int, *, sampler=None):
    """The round's selection head: ``select(norms, n_samples, t, scores) ->
    (part, weights, cohort_ids)``, all on the CPU — the sampler's draw on
    the full (M,) vectors, before any upload loss, and the sorted cohort
    buffer ``sort(argsort(where(part > 0, ids, ids + M))[:cohort_size])``.
    Pass ``norms=None`` for a non-adaptive sampler."""
    if not 0 < cohort_size <= cfg.num_clients:
        raise ValueError(
            f"cohort_size {cohort_size} not in (0, {cfg.num_clients}]")
    smp = sampler if sampler is not None else UniformSampler()
    M = cfg.num_clients

    def select(norms, n_samples, t, scores):
        part, weights = smp.select(
            scores.cpu(), schedule, t, M, n_samples.cpu(),
            None if norms is None else norms.cpu())
        ids = torch.arange(M)
        order = torch.argsort(torch.where(part > 0, ids, ids + M),
                              stable=True)
        return part, weights, torch.sort(order[:cohort_size]).values

    return select


def make_store_compute(loss_fn: Callable, cfg: FederatedConfig, *,
                       codec=None, attack=None):
    """The cohort's client sweep over pre-gathered state rows: local updates
    → wire round trip → adversary injection.  Returns ``compute(params,
    cohort_res, cohort_batches, mask_scores=None, cohort_drift=None,
    cohort_ids=None, attack_noise=None) -> dict`` with ``uploads`` /
    ``wired`` (pre- and post-wire stacked uploads), ``attacked`` (the
    payload the server decodes: ``wired`` with the adversary rows
    perturbed, ``wired`` itself without an attack), ``new_res`` /
    ``new_drift`` (post-round state candidates) and ``losses``.
    ``mask_scores`` and ``attack_noise`` are the cohort's rows of the
    round's random-mask scores and attack noise, so client i draws what
    any other form gives it; ``cohort_ids`` place the adversaries and are
    needed under an attack (the rows are picked on the ids' device, so
    ids on the card copy nothing to or from the host)."""
    attack = _active_attack(attack)

    def compute(params, cohort_res, cohort_batches, mask_scores=None,
                cohort_drift=None, cohort_ids=None, attack_noise=None):
        uploads, new_res, new_drift, losses = stacked_client_update(
            loss_fn, params, cohort_batches, cfg.client, cohort_res,
            cfg.error_feedback, mask_scores, cohort_drift)
        wired = roundtrip_stacked(codec, uploads)
        attacked = wired if attack is None else attack.apply_stacked(
            wired, _adversaries_on(attack, cfg.num_clients,
                                   cohort_ids.device).index_select(
                                       0, cohort_ids), attack_noise)
        return {"uploads": uploads, "wired": wired, "attacked": attacked,
                "new_res": new_res, "new_drift": new_drift, "losses": losses}

    return compute


@dataclasses.dataclass(frozen=True)
class StoreRound:
    """The store-form round, split at the store boundary; the flags tell
    the server loop which optional state the pieces read and write."""

    select: Callable      # (norms, n_samples, t, scores) -> (part, w, ids)
    body: Callable        # see make_store_round
    compute: Callable     # the cohort sweep body runs (make_store_compute)
    adaptive: bool        # body reads the norm EMA and returns its rows
    error_feedback: bool  # residual rows need scattering back
    uses_drift: bool = False  # body reads and returns FedDyn drift rows


def _store_body_parts(loss_fn: Callable, cfg: FederatedConfig, smp, drop,
                      agg_fn, *, codec=None, attack=None):
    """The generalized cohort body on gathered rows, in three parts:
    ``head(part, weights, cohort_ids, drop_scores, device) -> (inputs,
    host)`` on the CPU (the upload losses folded in, the cohort's rows of
    the weights and of the arrived mask sent to the device), ``sweep(params,
    cohort_res, cohort_drift, cohort_batches, inputs, norms, mask_scores,
    attack_noise) -> (new_rows, drift_rows, commit, norm_upd, outs)`` on the
    cohort's rows, and ``tail`` (:func:`_general_finish`)."""
    compute = make_store_compute(loss_fn, cfg, codec=codec, attack=attack)
    adv = _adversaries(attack, cfg.num_clients)

    def head(part, weights, cohort_ids, drop_scores, device):
        arrived, weights = _apply_dropout(part, weights, drop, drop_scores,
                                          smp.normalize)
        arrived_d = arrived.index_select(0, cohort_ids).to(device)
        inputs = {"ids": cohort_ids.to(device), "arrived": arrived_d,
                  "weights": weights.index_select(0, cohort_ids).to(device)}
        return inputs, {
            "rows": _participant_rows(part.index_select(0, cohort_ids),
                                      device),
            "part": part, "arrived": arrived, "arrived_d": arrived_d}

    def sweep(params, cohort_res, cohort_drift, cohort_batches, inputs,
              norms, mask_scores=None, attack_noise=None):
        ids = inputs["ids"]
        c = compute(params, cohort_res, cohort_batches, mask_scores,
                    cohort_drift, ids, attack_noise)
        uploads, wired, payload = c["uploads"], c["wired"], c["attacked"]
        finite = _finite_rows(payload)
        commit = inputs["arrived"] * finite
        new_rows = c["new_res"]
        if cfg.error_feedback and wired is not uploads:
            new_rows = _wire_feedback(new_rows, uploads, wired)
        norm_upd = None
        if smp.adaptive:
            norm_upd = _norm_ema(smp, norms.index_select(0, ids),
                                 _row_l2(payload), commit)
        outs = {"payload": payload, "finite": finite,
                "weights": inputs["weights"] * finite,
                "losses": c["losses"]}
        return new_rows, c["new_drift"], commit, norm_upd, outs

    tail = _general_finish(agg_fn, cfg.client.upload, drop is not None, adv)
    return compute, head, sweep, tail


def make_store_round(loss_fn: Callable, schedule: SamplingSchedule,
                     cfg: FederatedConfig, cohort_size: int, *,
                     codec=None, aggregator=None, sampler=None, hetero=None,
                     attack=None) -> StoreRound:
    """The store form of the generalized cohort round.

    ``body(params, cohort_res, cohort_drift, cohort_batches, cohort_ids,
    part, weights, norms, mask_scores=None, drop_scores=None,
    attack_noise=None) -> (new_params, new_rows, drift_rows, commit,
    norm_upd, metrics)``:
    ``part`` / ``weights`` are the selection's (M,) CPU vectors (the body
    folds the round's upload losses in), ``norms`` the full (M,) EMA or
    None; ``new_rows`` are the post-round residual candidates with the
    wire feedback of a lossy codec folded in, ``drift_rows`` the FedDyn
    drift candidates (None without drift), ``commit`` (on the device) the
    per-row "this upload applied" mask, ``arrived × finite``, and
    ``norm_upd`` the cohort's norm-EMA rows (None for a non-adaptive
    sampler).  The server scatters the rows gated on ``commit``.  A plain
    strategy runs this body too: the uniform sampler's selection is
    :func:`participation_mask`'s.
    """
    if not 0 < cohort_size <= cfg.num_clients:
        raise ValueError(
            f"cohort_size {cohort_size} not in (0, {cfg.num_clients}]")
    attack = _active_attack(attack)
    smp, drop = _round_extras(sampler, hetero, cfg)
    compute, head, sweep, tail = _store_body_parts(
        loss_fn, cfg, smp, drop, _aggregator(aggregator, smp.normalize),
        codec=codec, attack=attack)
    select = make_store_selection(schedule, cfg, cohort_size, sampler=smp)

    def body(params, cohort_res, cohort_drift, cohort_batches, cohort_ids,
             part, weights, norms, mask_scores=None, drop_scores=None,
             attack_noise=None):
        # Everything the host sends the device goes before the sweep is
        # queued, so no copy waits for it.
        device = next(iter(params.values())).device
        inputs, host = head(part, weights, cohort_ids, drop_scores, device)
        new_rows, drift_rows, commit, norm_upd, outs = sweep(
            params, cohort_res, cohort_drift, cohort_batches, inputs, norms,
            mask_scores, attack_noise)
        new_params, metrics = tail(params, outs, host)
        return new_params, new_rows, drift_rows, commit, norm_upd, metrics

    return StoreRound(select=select, body=body, compute=compute,
                      adaptive=smp.adaptive,
                      error_feedback=cfg.error_feedback,
                      uses_drift=cfg.client.objective.uses_drift)


@dataclasses.dataclass(frozen=True)
class Dispatch:
    """One round's dispatch on the store form (:func:`store_dispatch`)."""

    part: torch.Tensor     # (M,) CPU participation of the selection
    weights: torch.Tensor  # (M,) CPU aggregation weights
    ids: torch.Tensor      # (B,) CPU cohort buffer, ascending
    norms: Optional[torch.Tensor]   # the store's norm EMA (adaptive only)
    res: Optional[Tree]    # the cohort's residual rows (error feedback)
    drift: Optional[Tree]  # the cohort's FedDyn drift rows
    batches: list          # the cohort's batches on the device


def store_dispatch(prog: StoreRound, store, n_samples: torch.Tensor, t,
                   scores: torch.Tensor, client_batches, device) -> Dispatch:
    """The store form's dispatch, which the sync store loop and the async
    engine share: ``prog.select`` on the CPU, the cohort's residual (and
    drift) rows from ``store``, and the cohort's batches on ``device``.
    ``client_batches`` is the stacked (M, ...) tensors or, on a sharded
    store, a provider ``client_batches(ids) -> (xs, ys)``."""
    norms = store.norms if prog.adaptive else None
    part, weights, cohort_ids = prog.select(norms, n_samples, t, scores)
    ids_np = cohort_ids.numpy()
    res = store.gather(ids_np) if prog.error_feedback else None
    drift = store.gather(ids_np, tree="drift") if prog.uses_drift else None
    if callable(client_batches):
        batches = [torch.as_tensor(x).to(device)
                   for x in client_batches(ids_np)]
    else:
        ids = cohort_ids.to(device)
        batches = [x.index_select(0, ids) for x in client_batches]
    return Dispatch(part=part, weights=weights, ids=cohort_ids, norms=norms,
                    res=res, drift=drift, batches=batches)


def _cohort_parts(loss_fn: Callable, schedule: SamplingSchedule,
                  cfg: FederatedConfig, cohort_size: int, *, codec=None,
                  aggregator=None, sampler=None, hetero=None,
                  attack=None) -> RoundParts:
    """The cohort body's parts: the plain body's, or the generalized body's
    (the store form's body with its gather and scatter done on the dense
    state)."""
    if not 0 < cohort_size <= cfg.num_clients:
        raise ValueError(
            f"cohort_size {cohort_size} not in (0, {cfg.num_clients}]")
    attack = _active_attack(attack)
    uses_drift = cfg.client.objective.uses_drift
    if _is_plain(sampler, hetero, attack):
        def prepare(state, n_samples, t, scores, drop_scores):
            cohort_ids, valid = cohort_select(
                scores.cpu(), schedule, t, cfg.num_clients, cohort_size)
            device = n_samples.device
            valid_d = valid.to(device)
            return {"ids": cohort_ids.to(device), "valid": valid_d}, {
                "rows": _participant_rows(valid, device), "valid": valid_d}

        def compute(params, carried, client_batches, n_samples, inputs,
                    mask_scores, attack_noise):
            residuals, drift = carried.get("residuals"), carried.get("drift")
            ids, valid = inputs["ids"], inputs["valid"]
            cohort_res = _gather(residuals, ids)
            cohort_drift = _gather(drift, ids)
            uploads, new_res, new_drift, losses = stacked_client_update(
                loss_fn, params, [x.index_select(0, ids)
                                  for x in client_batches],
                cfg.client, cohort_res, cfg.error_feedback,
                _gather(mask_scores, ids), cohort_drift)
            wired = roundtrip_stacked(codec, uploads)
            finite = _finite_rows(wired)
            out = {}
            if cfg.error_feedback:
                out["residuals"] = _scatter(residuals, ids, _residual_update(
                    cfg, cohort_res, new_res, uploads, wired, valid * finite))
            if uses_drift:
                out["drift"] = _scatter(drift, ids, _commit_rows(
                    cohort_drift, new_drift, valid * finite))
            weights = valid * n_samples.index_select(0, ids) * finite
            return out, {"payload": wired, "finite": finite,
                         "weights": weights, "losses": losses}

        return RoundParts(prepare, compute,
                          _plain_finish(_aggregator(aggregator, True),
                                        cfg.client.upload),
                          _carried(cfg, False))

    smp, drop = _round_extras(sampler, hetero, cfg)
    _, head, sweep, tail = _store_body_parts(
        loss_fn, cfg, smp, drop, _aggregator(aggregator, smp.normalize),
        codec=codec, attack=attack)
    select = make_store_selection(schedule, cfg, cohort_size, sampler=smp)

    def prepare(state, n_samples, t, scores, drop_scores):
        part, weights, cohort_ids = select(state.get("norms"), n_samples, t,
                                           scores)
        return head(part, weights, cohort_ids, drop_scores, n_samples.device)

    def compute(params, carried, client_batches, n_samples, inputs,
                mask_scores, attack_noise):
        residuals, drift = carried.get("residuals"), carried.get("drift")
        norms = carried.get("norms")
        ids = inputs["ids"]
        cohort_res = _gather(residuals, ids)
        cohort_drift = _gather(drift, ids)
        new_rows, drift_rows, commit, norm_upd, outs = sweep(
            params, cohort_res, cohort_drift,
            [x.index_select(0, ids) for x in client_batches], inputs, norms,
            _gather(mask_scores, ids), _gather(attack_noise, ids))
        out = {}
        if cfg.error_feedback:
            out["residuals"] = _scatter(residuals, ids, _commit_rows(
                cohort_res, new_rows, commit))
        if uses_drift:
            out["drift"] = _scatter(drift, ids, _commit_rows(
                cohort_drift, drift_rows, commit))
        if smp.adaptive:
            out["norms"] = norms.index_copy(0, ids, norm_upd)
        return out, outs

    return RoundParts(prepare, compute, tail, _carried(cfg, smp.adaptive))


def make_cohort_round(loss_fn: Callable, schedule: SamplingSchedule,
                      cfg: FederatedConfig, cohort_size: int, *,
                      codec=None, aggregator=None, sampler=None, hetero=None,
                      attack=None):
    """Cohort form of :func:`make_federated_round`: same signature and math,
    but only ``cohort_size`` clients (an upper bound on the participant
    count, ``ClientSampler.cohort_bucket``) run.  Cohort ids are
    ascending, so the weighted reduction visits participants in the
    oracle's client-id order.  The generalized body is the store form
    (:func:`make_store_round`) with its gather and scatter done on the
    dense state."""
    parts = _cohort_parts(loss_fn, schedule, cfg, cohort_size, codec=codec,
                          aggregator=aggregator, sampler=sampler,
                          hetero=hetero, attack=attack)
    plain = _is_plain(sampler, hetero, _active_attack(attack))
    return _eager(parts, "plain_fn" if plain else "round_fn")


def make_cohort_scan(loss_fn: Callable, schedule: SamplingSchedule,
                     cfg: FederatedConfig, cohort_size: int, *,
                     codec=None, aggregator=None, sampler=None, hetero=None,
                     attack=None) -> "CohortScan":
    """The scan form: a segment of rounds that share a cohort bucket in one
    call, the oracle body when ``cohort_size == num_clients`` and the
    cohort body otherwise (as the reference's ``lax.scan`` fast path).

    Returns ``scan_fn(params, state, client_batches, n_samples, ts, scores,
    mask_scores=None, drop_scores=None, attack_noise=None) -> (params,
    state, metrics)``: the round's signature with a leading segment axis
    on ``ts`` and on each round's draws (``scores`` and ``drop_scores``
    (S, M), ``mask_scores`` and ``attack_noise`` ``{leaf: (S, M,
    *shape)}``), and every metric stacked per round.  On the CPU it runs
    the eager round in a loop.  On a card it captures the bucket's
    ``compute`` part into a CUDA graph once and replays it for every round,
    with selection on the CPU and the aggregation over the m_t participant
    rows eager between replays (:class:`CohortScan`), so its results equal
    the eager loop's bit for bit."""
    kw = dict(codec=codec, aggregator=aggregator, sampler=sampler,
              hetero=hetero, attack=attack)
    if cohort_size == cfg.num_clients:
        parts = _federated_parts(loss_fn, schedule, cfg, **kw)
    else:
        parts = _cohort_parts(loss_fn, schedule, cfg, cohort_size, **kw)
    return CohortScan(parts)


def _draw(tree, i: int):
    """Round i's rows of a segment's stacked draws (a tensor, a tree or
    None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: v[i] for k, v in tree.items()}
    return tree[i]


def _stack_metrics(metrics: list) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


class CohortScan:
    """The scan form of one bucket's round (:func:`make_cohort_scan`).

    On a card the first call captures the round's ``compute`` part into a
    :class:`~repro_torch.core.graphs.CapturedRound` (warm-up on copies,
    then capture, in the graph memory pool ``pool`` when the caller sets
    one) and every round of every later call replays it; arguments of
    other shapes (another run's batches) capture a graph of their own, as
    the reference compiles again for other input shapes.  The round's
    selection and draws are copied into the graph's input buffers, the
    graph runs, and the aggregation and mean loss over the round's m_t
    participant rows run eagerly on its outputs.  The server's state is
    copied into the graph's buffers when a call starts and out when it
    ends.  A failed capture raises; nothing falls back to the eager round.

    ``last_capture_s`` is the seconds the last call spent on warm-up and
    capture (0.0 when the graph was already built), ``capture_s`` their
    sum over calls; ``graphs`` and ``replays`` count captures and
    replays."""

    def __init__(self, parts: RoundParts):
        self.parts = parts
        self.round_fn = _eager(parts, "round_fn")
        self.pool = None
        self._captured: Dict[Any, Any] = {}
        self.graphs = self.replays = 0
        self.last_capture_s = self.capture_s = 0.0

    def __call__(self, params: Tree, state: Dict[str, Any],
                 client_batches: Sequence[torch.Tensor],
                 n_samples: torch.Tensor, ts, scores: torch.Tensor,
                 mask_scores: Optional[Tree] = None,
                 drop_scores: Optional[torch.Tensor] = None,
                 attack_noise: Optional[Tree] = None):
        self.last_capture_s = 0.0
        if n_samples.device.type != "cuda":
            metrics = []
            for i, t in enumerate(ts):
                params, state, m = self.round_fn(
                    params, state, client_batches, n_samples, t, scores[i],
                    _draw(mask_scores, i), _draw(drop_scores, i),
                    _draw(attack_noise, i))
                metrics.append(m)
            return params, state, _stack_metrics(metrics)
        from repro_torch.core.graphs import CapturedRound, signature
        parts = self.parts
        carried = {k: state[k] for k in parts.carried}
        batches = list(client_batches)
        metrics = []
        for i, t in enumerate(ts):
            inputs, host = parts.prepare({**state, **carried}, n_samples, t,
                                         scores[i], _draw(drop_scores, i))
            draws = (_draw(mask_scores, i), _draw(attack_noise, i))
            if i == 0:
                args = (params, carried, batches, n_samples, inputs) + draws
                key = signature(args)
                graph = self._captured.get(key)
                if graph is None:
                    t0 = time.perf_counter()
                    graph = CapturedRound(parts.compute, args, self.pool)
                    self._captured[key] = graph
                    self.graphs += 1
                    self.last_capture_s = time.perf_counter() - t0
                    self.capture_s += self.last_capture_s
                graph.load(params, carried, batches, n_samples)
                carried = graph.carried
            else:
                graph.set_params(params)
            outs = graph.replay(inputs, *draws)
            self.replays += 1
            params, m = parts.finish(params, outs, host)
            metrics.append(m)
        out = {k: (v.clone() if isinstance(v, torch.Tensor) else
                   {n: x.clone() for n, x in v.items()})
               for k, v in carried.items()}
        return params, {**state, **out}, _stack_metrics(metrics)
