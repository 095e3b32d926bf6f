"""Asynchronous buffered aggregation with a failure model (counterpart of
``repro/core/async_engine.py``).

The sync round ends with a barrier: aggregate once, after everyone.  On a
simulated :class:`~repro_torch.core.hetero.HeteroModel` fleet that barrier
waits for the straggler.  This engine consumes the round's upload arrival
stream (``hetero.arrival_stream``) as a time-ordered event queue on the
host and applies a buffer of K uploads whenever it fills; uploads that
arrive after a flush land in the next one, discounted by how stale their
base model has become.

One round (:meth:`AsyncRoundRunner.run_round`):

1. **dispatch** — the store form's split of the round
   (``federated.store_dispatch``, shared with the sync store loop): the
   sampler's selection on the CPU, the cohort's residual (and FedDyn
   drift) rows from the
   :class:`~repro_torch.core.client_store.ClientStateStore`, then the
   cohort's local updates and wire round trip (the store round's
   ``compute``) on the device.  The sync cohort engine runs this same
   split, so the bits are the same.  The participants' model versions go
   to the store.
2. **the gate** — injected corruption (``corrupt_rate``) sets whole rows
   to NaN; a row is finite iff every element of its decoded upload is.
   The flags come back to the host once a round.
3. **the event loop** (host) — arrivals pop off a heap of ``(time,
   client, attempt, carried_idx)`` in ``(time, client)`` order.  Each
   transmission is lost with the client's ``drop_rate`` and retried after
   ``backoff_s * 2^attempt`` plus its re-upload time, up to
   ``max_retries`` times.  At the deadline (``deadline_s``, or a quantile
   of the cohort's fault-free arrival times) pending uploads time out, or,
   in cross-round mode, are carried into later rounds.  Quarantined
   uploads never enter a flush.  All events of one timestamp drain before
   the buffer is checked; leftovers flush once at round close.
4. **flushes** — the buffered rows aggregate with weights ``w_i / (1 +
   s)^beta``: s is the flush count in the classic mode, and in cross-round
   mode the round distance from the store's version vector.
   Horvitz-Thompson weights are divided by the retry policy's survival
   probability ``1 - q^(R+1)``.  Rows outside the gate are zeroed with a
   select before any arithmetic (0 · NaN is NaN), and only the flush's
   member rows reach the aggregator, as in every sync form.
5. **round close** — residuals, drift and the norm EMA commit through the
   store for the rows whose upload was applied; timeouts, permanent drops
   and quarantined rows keep their round-entry state.  Carried uploads
   commit when they apply.

The host's random stream (corrupt draws, arrival jitter, drop draws) is a
numpy ``Generator`` seeded with the round's words, consumed in the
reference's order.  With instant arrivals (the ideal fleet), K = m_t and
no faults, a round is the dispatch plus one flush of everyone at
staleness 0, and bit-identical to the sync cohort round.  Under an active
:class:`~repro_torch.core.attacks.AttackModel` the dispatch sweep hands
over the attacked payload: it enters the gate (a ``nan`` attack is
quarantined event by event, as an injected corruption is), the flushes
and the norm tracker, while the error-feedback commit reads the honest
wire round trip; ``stats["adversarial"]`` counts the adversarial
participants.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.client_store import DenseStore
from repro_torch.core.federated import (_active_attack, _aggregate,
                                        _aggregator, _finite_rows,
                                        _norm_ema, _row_l2, _wire_feedback,
                                        _zero_rows, store_dispatch)
from repro_torch.core.hetero import HeteroModel, arrival_stream

Tree = Dict[str, torch.Tensor]

__all__ = ["AsyncConfig", "AsyncRoundRunner"]


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """The async engine's knobs: buffering, staleness and the failure model.

    ``buffer_size`` fixes the flush threshold K; ``buffer_frac`` sizes it as
    a fraction of the round's m_t (at most one; neither means K = m_t).
    ``staleness_beta`` is the exponent of the ``1/(1+s)^beta`` discount.
    Deadlines: ``deadline_s`` (absolute seconds) or ``deadline_quantile``
    (of the cohort's fault-free arrival times; at most one).
    ``max_retries`` / ``backoff_s`` bound the retransmissions;
    ``jitter_sigma`` adds per-round lognormal arrival jitter;
    ``corrupt_rate`` injects NaN payloads and ``quarantine`` turns the
    decode gate on or off.  ``max_round_stale`` > 0 switches staleness to
    cross-round distance: deadline-cut uploads are carried into later
    rounds, discounted by the rounds since their client pulled Θ, and
    expire past that many rounds."""

    buffer_size: int | None = None
    buffer_frac: float | None = None
    staleness_beta: float = 0.5
    deadline_s: float | None = None
    deadline_quantile: float | None = None
    max_retries: int = 2
    backoff_s: float = 0.5
    jitter_sigma: float = 0.0
    corrupt_rate: float = 0.0
    quarantine: bool = True
    max_round_stale: int = 0

    def __post_init__(self):
        """Reject contradictory or out-of-range knob combinations."""
        if self.buffer_size is not None and self.buffer_frac is not None:
            raise ValueError("set at most one of buffer_size / buffer_frac")
        if self.buffer_size is not None and self.buffer_size < 1:
            raise ValueError(
                f"buffer_size must be >= 1, got {self.buffer_size}")
        if self.buffer_frac is not None and not 0.0 < self.buffer_frac <= 1.0:
            raise ValueError(
                f"buffer_frac must be in (0, 1], got {self.buffer_frac}")
        if self.staleness_beta < 0.0:
            raise ValueError(
                f"staleness_beta must be >= 0, got {self.staleness_beta}")
        if self.deadline_s is not None and self.deadline_quantile is not None:
            raise ValueError(
                "set at most one of deadline_s / deadline_quantile")
        if self.deadline_s is not None and self.deadline_s <= 0.0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")
        if (self.deadline_quantile is not None
                and not 0.0 < self.deadline_quantile <= 1.0):
            raise ValueError(
                f"deadline_quantile must be in (0, 1], got "
                f"{self.deadline_quantile}")
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_s < 0.0:
            raise ValueError(f"backoff_s must be >= 0, got {self.backoff_s}")
        if self.jitter_sigma < 0.0:
            raise ValueError(
                f"jitter_sigma must be >= 0, got {self.jitter_sigma}")
        if not 0.0 <= self.corrupt_rate <= 1.0:
            raise ValueError(
                f"corrupt_rate must be in [0, 1], got {self.corrupt_rate}")
        if self.max_round_stale < 0:
            raise ValueError(
                f"max_round_stale must be >= 0, got {self.max_round_stale}")

    def buffer_for(self, m: int) -> int:
        """Flush threshold K for a round expecting ``m`` participants."""
        if self.buffer_size is not None:
            return self.buffer_size
        if self.buffer_frac is not None:
            return max(1, int(np.ceil(self.buffer_frac * m)))
        return max(1, m)


def _rows(tree: Tree, row: int) -> Tree:
    """One client's row of a stacked tree, copied (so a carried upload
    keeps nothing else of its round alive)."""
    return {k: v[row].clone() for k, v in tree.items()}


class AsyncRoundRunner:
    """One strategy's async rounds on a client-state store: the fleet's
    traits, the flush weights' survival terms and the uploads carried
    across rounds.  :meth:`run_round` runs one buffered round on the
    caller's store-form round."""

    def __init__(self, strategy, num_clients: int,
                 async_cfg: AsyncConfig | None = None, store=None):
        """``async_cfg`` defaults to ``strategy.async_cfg``, then to
        ``AsyncConfig()``.  ``store`` holds the per-client state; without
        one the first round builds a :class:`DenseStore`, except that
        cross-round staleness and FedDyn drift need the caller's."""
        self.strategy = strategy
        self.num_clients = num_clients
        acfg = async_cfg
        if acfg is None:
            acfg = getattr(strategy, "async_cfg", None)
        self.acfg = acfg if acfg is not None else AsyncConfig()
        # Byzantine adversaries: the dispatch sweep hands over the attacked
        # payload, whose non-finite rows land in the same gate as injected
        # corruption.
        self.attack = _active_attack(getattr(strategy, "attack", None))
        self._adv = (self.attack.adversary_mask(num_clients)
                     if self.attack is not None else None)
        self.store = store
        self._crossround = self.acfg.max_round_stale > 0
        if self._crossround and store is None:
            raise ValueError(
                "max_round_stale > 0 (cross-round staleness) requires a "
                "ClientStateStore — the per-client model-version state "
                "lives there")
        # Uploads carried across round boundaries (cross-round mode): one
        # dict each with its payload, residual and drift rows, base weight,
        # finite flag, dispatch round and remaining lateness.
        self._pending: list = []
        self.schedule = strategy.sampling
        self.smp = strategy.sampler
        self.cfg = strategy.federated_config(num_clients)
        self._uses_drift = self.cfg.client.objective.uses_drift
        if self._uses_drift:
            if store is None:
                raise ValueError(
                    f"strategy {strategy.name!r} carries FedDyn drift "
                    "state; the async engine needs a ClientStateStore "
                    "built with extra_trees={'drift': ...}")
            if "drift" not in store.trees:
                raise ValueError(
                    "async engine with a FedDyn objective requires the "
                    "store to hold a 'drift' tree (extra_trees=)")
        hetero = strategy.hetero if strategy.hetero is not None \
            else HeteroModel(profile="ideal")
        self.traits = hetero.client_traits(num_clients)
        self._agg_fn = _aggregator(strategy.aggregator, self.smp.normalize)
        self._inject = self.acfg.corrupt_rate > 0.0
        # Probability that all max_retries + 1 transmissions drop;
        # Horvitz-Thompson weights divide by its complement (exactly 1.0 on
        # a fleet without drops).
        q = np.asarray(self.traits.drop_rate, np.float64)
        self._survival = (1.0 - q ** (self.acfg.max_retries + 1)).astype(
            np.float32)

    def _gate(self, wired: Tree, corrupt_c: np.ndarray, device) -> tuple:
        """Chaos injection and the quarantine gate's check: ``(payload,
        finite)``, row i finite iff every element of its upload is."""
        if self._inject:
            cm = torch.from_numpy(corrupt_c).to(device)
            wired = {k: torch.where(
                cm.reshape((-1,) + (1,) * (u.dim() - 1)) > 0,
                torch.full_like(u, float("nan")), u)
                for k, u in wired.items()}
        return wired, _finite_rows(wired)

    def run_round(self, params: Tree, prog, client_batches,
                  n_samples: torch.Tensor, t: int, scores: torch.Tensor,
                  event_words: Sequence[int], *, flops: float,
                  wire_bytes: int, mask_scores: Optional[Callable] = None,
                  attack_noise: Optional[Callable] = None):
        """Run one async buffered round: ``(params, stats)``.

        ``prog``: the store form's round for the cohort bucket
        (``build_round(..., form="store")``), whose selection and cohort
        sweep the dispatch runs; ``client_batches``: tensors with leading
        (M, num_batches, B, ...) axes on the device, or (on a sharded
        store) a provider ``client_batches(ids) -> (xs, ys)``;
        ``n_samples``: the (M,) CPU dataset sizes; ``scores``: round t's
        (M,) CPU participant uniforms; ``event_words``: the words that seed
        the host's random stream; ``mask_scores(ids)`` and
        ``attack_noise(ids)`` give the cohort's random-mask scores and
        gauss-attack noise.  ``stats`` is the host-side ledger the server
        turns into a ``RoundRecord``."""
        acfg = self.acfg
        M = self.num_clients
        device = next(iter(params.values())).device
        if self.store is None:
            self.store = DenseStore(M, params, track_norms=self.smp.adaptive)
        store = self.store

        # 1. dispatch: the store form's, as the sync store loop runs it.
        d = store_dispatch(prog, store, n_samples, t, scores, client_batches,
                           device)
        part, weights, ids_np = d.part, d.weights, d.ids.numpy()
        ids = d.ids.to(device)
        out = prog.compute(params, d.res, d.batches,
                           mask_scores(ids) if mask_scores is not None
                           else None, d.drift, d.ids,
                           attack_noise(ids) if attack_noise is not None
                           else None)
        part_np = part.numpy()
        losses = out["losses"].detach().cpu().numpy().astype(np.float64)
        B = int(ids_np.shape[0])
        row_of = {int(cid): i for i, cid in enumerate(ids_np)}
        # Θ_t went out to the participants: the versions staleness reads.
        store.mark_dispatched(np.flatnonzero(part_np > 0), t)
        rng = np.random.default_rng([int(w) for w in event_words])

        # 2. the adversaries' payload, chaos injection and the gate.
        # ``payload`` is what the server decodes; ``wired`` stays the honest
        # round trip the EF commit reads.
        wired = out["wired"]
        payload = out["attacked"]
        corrupt = np.zeros((M,), np.float32)
        if self._inject:
            corrupt = (rng.random(M) < acfg.corrupt_rate).astype(np.float32)
        if self._inject or acfg.quarantine:
            payload, finite = self._gate(payload, corrupt[ids_np], device)
            finite_c = finite.cpu().numpy()
        else:
            finite_c = np.ones((B,), np.float32)

        # 3. the fault-free arrival stream and the deadline.
        first = list(arrival_stream(self.traits, part_np, flops, wire_bytes,
                                    rng=rng, jitter_sigma=acfg.jitter_sigma))
        deadline = np.inf
        if acfg.deadline_s is not None:
            deadline = float(acfg.deadline_s)
        elif acfg.deadline_quantile is not None and first:
            deadline = float(np.quantile(
                np.asarray([ts for ts, _ in first], np.float64),
                acfg.deadline_quantile))
        heap: list = [(ts, cid, 0, -1) for ts, cid in first]
        heapq.heapify(heap)

        q = np.asarray(self.traits.drop_rate, np.float64)
        resend = np.asarray(self.traits.upload_time_s(wire_bytes), np.float64)
        K = acfg.buffer_for(int(self.schedule.num_clients_host(t, M)))
        base_w = weights.numpy().astype(np.float32)[ids_np]
        if not self.smp.normalize:
            base_w = base_w / self._survival[ids_np]
        keep_np = finite_c if acfg.quarantine else np.ones((B,), np.float32)
        keep_dev = torch.from_numpy(np.ascontiguousarray(
            keep_np, np.float32)).to(device)

        applied_rows = np.zeros((B,), np.float32)
        buffer_rows: list = []       # ("cur", cohort row) | ("carried", idx)
        carried_applied: list = []
        arrivals = timeouts = retries = quarantined = dropped = sends = 0
        flushes = 0
        staleness_sum = 0.0
        applied_times: list = []
        close_time = 0.0

        # Cross-round carry-in: earlier rounds' deadline-cut uploads re-enter
        # at their remaining lateness, unless superseded by a fresh dispatch
        # of the same client or expired past max_round_stale (timeouts).
        carried_in: list = []
        superseded = expired = 0
        if self._crossround and self._pending:
            participants = set(np.flatnonzero(part_np > 0).tolist())
            for e in self._pending:
                s = int(store.staleness(np.asarray([e["cid"]]), t)[0])
                if e["cid"] in participants:
                    superseded += 1
                elif s > acfg.max_round_stale:
                    expired += 1
                else:
                    heapq.heappush(
                        heap, (e["lateness"], e["cid"], 0, len(carried_in)))
                    carried_in.append(e)
                    continue
                timeouts += 1
            self._pending = []

        def carry_entry(row: int, cid: int, lateness: float) -> dict:
            """Snapshot one cohort row as an upload still in flight: its
            decoded payload, the residual candidate with the wire feedback
            folded in, its drift row, base weight, finite flag and round."""
            res = None
            if self.cfg.error_feedback:
                res = _rows(out["new_res"], row)
                if wired is not out["uploads"]:
                    res = {k: r + (out["uploads"][k][row] - wired[k][row])
                           for k, r in res.items()}
            return {"cid": int(cid), "w": float(base_w[row]),
                    "finite": float(finite_c[row]), "round": int(t),
                    "lateness": float(lateness),
                    "payload": _rows(payload, row), "res": res,
                    "drift": (_rows(out["new_drift"], row)
                              if self._uses_drift else None)}

        def do_flush():
            """Aggregate the buffer: the flush-count discount in the classic
            mode; in cross-round mode the round distance of each carried
            row (this round's rows are at s = 0), the carried rows after
            this round's."""
            nonlocal params, flushes, staleness_sum
            if not buffer_rows:
                return
            cur = sorted(i for kind, i in buffer_rows if kind == "cur")
            car = [i for kind, i in buffer_rows if kind == "carried"]
            member = np.zeros((B,), np.float32)
            member[cur] = 1.0
            if self._crossround:
                w_flush = base_w * member
            else:
                s = flushes
                discount = np.float32(1.0 / (1.0 + s) ** acfg.staleness_beta)
                w_flush = base_w * member * discount
                staleness_sum += float(s) * len(buffer_rows)
            rows = torch.tensor(cur, dtype=torch.int64, device=device)
            w_dev = torch.from_numpy(w_flush).to(device)
            upload = self.cfg.client.upload
            if not car:
                params = _aggregate(self._agg_fn, params, payload, keep_dev,
                                    w_dev, rows, upload)
            else:
                cids = np.asarray([carried_in[i]["cid"] for i in car])
                s_car = store.staleness(cids, t).astype(np.float64)
                w_car = (np.asarray([carried_in[i]["w"] for i in car],
                                    np.float64)
                         / (1.0 + s_car) ** acfg.staleness_beta)
                staleness_sum += float(s_car.sum())
                stacked = {k: torch.cat([
                    u.index_select(0, rows),
                    torch.stack([carried_in[i]["payload"][k] for i in car])])
                    for k, u in payload.items()}
                # Carried rows passed the gate on arrival: all finite.
                keep = torch.cat([keep_dev.index_select(0, rows),
                                  torch.ones(len(car), device=device)])
                w_all = torch.cat([w_dev.index_select(0, rows),
                                   torch.from_numpy(w_car.astype(
                                       np.float32)).to(device)])
                params = self._agg_fn(params, _zero_rows(stacked, keep),
                                      w_all, upload)
            applied_rows[cur] = 1.0
            carried_applied.extend(carried_in[i] for i in car)
            flushes += 1
            buffer_rows.clear()

        # 4. the event loop.
        while heap:
            t_now = heap[0][0]
            if t_now > deadline:
                # The clients did transmit (the bytes were spent); the
                # server stops listening.  The classic mode times out what
                # is pending, cross-round mode carries it.
                while heap:
                    ev_t, cid, _, ci = heapq.heappop(heap)
                    if ci >= 0:
                        self._pending.append(
                            dict(carried_in[ci], lateness=ev_t - deadline))
                        continue
                    sends += 1
                    if self._crossround:
                        self._pending.append(carry_entry(
                            row_of[int(cid)], cid, ev_t - deadline))
                    else:
                        timeouts += 1
                close_time = max(close_time, deadline)
                break
            # Every event of this timestamp drains before the flush check,
            # so simultaneous arrivals join one flush.
            while heap and heap[0][0] == t_now:
                _, cid, attempt, ci = heapq.heappop(heap)
                if ci >= 0:
                    # A carried upload lands: no drop draw (its transport
                    # happened in its own round), the same gate.
                    e = carried_in[ci]
                    close_time = max(close_time, t_now)
                    if acfg.quarantine and e["finite"] == 0.0:
                        quarantined += 1
                        continue
                    arrivals += 1
                    applied_times.append(t_now)
                    buffer_rows.append(("carried", ci))
                    continue
                sends += 1
                if q[cid] > 0.0 and rng.random() < q[cid]:
                    if attempt < acfg.max_retries:
                        delay = (acfg.backoff_s * (2.0 ** attempt)
                                 + float(resend[cid]))
                        heapq.heappush(
                            heap, (t_now + delay, cid, attempt + 1, -1))
                        retries += 1
                    else:
                        dropped += 1
                    continue
                row = row_of[int(cid)]
                close_time = max(close_time, t_now)
                if acfg.quarantine and finite_c[row] == 0.0:
                    quarantined += 1
                    continue
                arrivals += 1
                applied_times.append(t_now)
                buffer_rows.append(("cur", row))
            if len(buffer_rows) >= K:
                do_flush()
        do_flush()  # leftovers flush once at round close

        # 5. the round-close commit, through the store, for applied rows.
        applied = torch.from_numpy(applied_rows).to(device)
        if self.cfg.error_feedback:
            new_rows = out["new_res"]
            if wired is not out["uploads"]:
                new_rows = _wire_feedback(new_rows, out["uploads"], wired)
            store.scatter(ids_np, new_rows, applied_rows, t)
        if self._uses_drift:
            store.scatter(ids_np, out["new_drift"], applied_rows, t,
                          tree="drift")
        if self.smp.adaptive:
            store.update_norms(ids_np, _norm_ema(
                self.smp, store.norms.index_select(0, ids), _row_l2(payload),
                applied))
        # Carried uploads commit when they apply; their owners were not
        # dispatched this round (supersession dropped those), so these rows
        # are not the round close's.
        one = np.ones((1,), np.float32)
        for e in carried_applied:
            cid = np.asarray([e["cid"]])
            if e["res"] is not None:
                store.scatter(cid, {k: v[None] for k, v in e["res"].items()},
                              one, t)
            if e["drift"] is not None:
                store.scatter(cid, {k: v[None]
                                    for k, v in e["drift"].items()},
                              one, t, tree="drift")
            if self.smp.adaptive:
                obs = _row_l2({k: v[None] for k, v in e["payload"].items()})
                old = store.norms.index_select(
                    0, torch.from_numpy(cid).to(device))
                store.update_norms(cid, (1.0 - self.smp.ema) * old
                                   + self.smp.ema * obs)

        valid = part_np[ids_np].astype(np.float64)
        n_part = float(part_np.sum())
        n_applied = float(applied_rows.sum()) + len(carried_applied)
        mean_loss = (float((losses * valid).sum() / max(valid.sum(), 1.0))
                     if n_part > 0 else float("nan"))
        median_applied = (float(np.median(np.asarray(applied_times)))
                          if applied_times else 0.0)
        stats = {
            "mean_loss": mean_loss,
            "num_sampled": int(n_part),
            "adversarial": (int((part_np * self._adv).sum())
                            if self._adv is not None else 0),
            "arrivals": arrivals,
            "timeouts": timeouts,
            "retries": retries,
            "quarantined": quarantined,
            "dropped": dropped,
            "sends": sends,
            "flushes": flushes,
            "buffer_size": K,
            "carried": len(carried_applied),
            "pending": len(self._pending),
            "superseded": superseded,      # carried-in timeouts: redispatched
            "expired": expired,            # carried-in timeouts: too stale
            "mean_staleness": (staleness_sum / n_applied
                               if n_applied > 0 else 0.0),
            "sim_round_s": close_time,
            "straggler_s": close_time - median_applied,
            "deadline_s": deadline if np.isfinite(deadline) else None,
        }
        return params, stats
