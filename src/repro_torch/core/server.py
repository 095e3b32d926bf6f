"""Central-server training loop (paper Alg. 1 / Alg. 3 outer procedure;
counterpart of ``repro/core/server.py``).

``FederatedServer`` owns the global model, runs R communication rounds,
meters transport bytes and evaluates on held-out data.  Its scenario is one
:class:`repro_torch.core.strategy.FedStrategy`.

Every round picks its cohort bucket on the host and runs the matching round
(``engine="cohort"``: the bucketed cohort body, or the oracle body when the
bucket is the whole population; ``engine="full"``: always the oracle;
``engine="async"``: one buffered round of
:class:`~repro_torch.core.async_engine.AsyncRoundRunner` on the store,
configured by ``strategy.async_cfg``, whose fault ledger fills the async
fields of :class:`RoundRecord`).

With ``scan_rounds=True`` (the default, as in the reference) the dense store
on the ``cohort`` and ``full`` engines runs segment by segment, as the
reference does (:meth:`FederatedServer._segments`): consecutive rounds that
share a bucket, broken after an eval round, go through one call of the
scan form (``build_round(form="scan")``, a
:class:`~repro_torch.core.federated.CohortScan`).  On a card its rounds
replay a CUDA graph of the bucket's round; on the CPU it runs the eager
round in a loop.  Either way the results equal the per-round loop's bit
for bit.  A segment's records carry ``wall_s`` = the segment's wall time
over its length, ``compile_s`` on its first round, and the eval metric
on its last round only.  ``scan_rounds=False`` runs the per-round loop.
The store and async engines always run round by round, as in the
reference.

What is a build here is timed apart as ``RoundRecord.compile_s`` on the
round that first needs it, outside ``wall_s``: a bucket's round
construction, for a round that launches kernels the kernel library's
``nvcc`` build or load, and on the scan form the CUDA graph's warm-up and
capture.  The port keys a built round by (form, bucket); the reference
keys its compiled programs by (bucket, segment length), so it compiles
again where an eval round splits a bucket into segments of another length
and the port does not.  A server's graphs share one memory pool.

Per-client server state lives in a
:class:`~repro_torch.core.client_store.ClientStateStore`: the error-feedback
residuals, FedDyn's drift tree when the objective uses drift, the adaptive
samplers' norm EMA (ones at start) and the model versions.  The default
:class:`DenseStore` holds all M rows and the rounds read and write it
whole; a :class:`ShardedStore` (``store=``) holds rows only inside its
retention window, and the server then runs the store form of the round
(``FederatedServer._store_round``): selection on the CPU, a gather of
the cohort's rows, the cohort-shaped body, ``mark_dispatched`` for the
participants, the commit-gated scatter and the norm update, so no ``(M,
…)`` stack is ever built.  On a sharded store ``run`` also takes a batch
provider, ``client_batches(ids) -> (xs, ys)``, in place of the stacked
batches.  A strategy with a
:class:`~repro_torch.core.hetero.HeteroModel` fleet adds in-round upload
dropout and the host-side round clock: ``RoundRecord.sim_round_s``
(straggler wall-clock on the simulated fleet), ``straggler_s`` and
``dropped``.

Randomness: each round's (M,) uniform participant scores come from the
server's own CPU ``torch.Generator`` seeded with ``seed`` — the same draws
on every device — or from a caller's ``scores(t, M)`` callable, which is how
the parity tests hand in the reference's ``jax.random`` draws.  With a
hetero fleet each sync round also draws (M,) uniform dropout scores from a
second CPU generator seeded with ``seed + 2``, or takes them from a
caller's ``drop_scores(t, M)``; the participant stream does not move.  Under
random masking a client's per-entry mask scores come from
:func:`~repro_torch.core.masking.client_mask_scores` keyed by the mask
seed ``seed + 1``, the round, the client and the leaf, drawn on the
server's device for just the clients a round runs (the same bits on every
device, whatever M), or from a caller's ``mask_scores(t, M)`` callable.
An async round seeds its host event stream with two uint32 words from a
CPU generator seeded with ``seed + 3``, or with a caller's
``event_seed(t)``.  Under a ``gauss`` attack the adversaries' noise comes
from :func:`~repro_torch.core.attacks.client_attack_noise` keyed by the
attack seed ``seed``, the round, the client and the leaf, for just the
clients a round runs, or from a caller's ``attack_noise(t, ids)``.
With an active attack ``RoundRecord.adversarial`` counts the adversarial
participants and ``summary()`` names the attack.

Transport is metered by the strategy's codec: ``RoundRecord.transport_bytes``
counts the EXACT wire bytes of every upload.

``save_state`` / ``restore_state`` round-trip the whole training state
(parameters, the store's state, the generators' states and the mask
seed) through
``repro_torch.checkpoint`` with the round counter in the manifest, and a
restored server's ``run`` resumes bit-identically to the run that wrote
it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.attacks import client_attack_noise
from repro_torch.core.client import local_update_flops
from repro_torch.core.client_store import ClientStateStore, DenseStore
from repro_torch.core.compression import pytree_num_params
from repro_torch.core.federated import _active_attack, store_dispatch
from repro_torch.core.hetero import simulate_round
from repro_torch.core.masking import client_mask_scores
from repro_torch.device import resolve_device

Tree = Dict[str, torch.Tensor]

__all__ = ["RoundRecord", "FederatedServer"]


@dataclasses.dataclass
class RoundRecord:
    """Per-round ledger entry: who participated, what it cost and, with a
    hetero fleet, what the round would have cost on the simulated fleet."""

    round: int
    num_sampled: int
    mean_loss: float
    transport_units: float      # full-model-upload units this round (Eq. 6)
    transport_bytes: int        # EXACT wire bytes (codec-encoded uploads)
    eval_metric: Optional[float] = None
    wall_s: float = 0.0         # round time, device synchronized (build excluded)
    compile_s: float = 0.0      # program build time; nonzero on bucket-change rounds
    cohort_size: int = 0        # padded cohort buffer actually executed
    flop_proxy: float = 0.0     # 6·params·examples·epochs·cohort_size
    quarantined: int = 0        # uploads rejected at the decode gate
    sim_round_s: float = 0.0    # simulated fleet wall-clock (hetero, async)
    straggler_s: float = 0.0    # sim straggler tail: max - median arrival
    dropped: int = 0            # uploads lost on the simulated fleet
    # --- the async engine's ledger (engine="async" only) ---
    arrivals: int = 0           # uploads accepted into a buffer flush
    timeouts: int = 0           # uploads cut by the deadline
    retries: int = 0            # retransmissions scheduled after drops
    flushes: int = 0            # buffer flushes applied this round
    mean_staleness: float = 0.0  # mean staleness of the applied uploads
    carried: int = 0            # earlier rounds' uploads applied (cross-round)
    pending: int = 0            # uploads still in flight for a later round
    # --- Byzantine accounting (strategy.attack set) ---
    adversarial: int = 0        # adversary-controlled participants this round


class FederatedServer:
    """Owns Θ_t; runs rounds; meters communication."""

    def __init__(self, strategy, loss_fn: Callable, init_params: Tree,
                 num_clients: int, *, eval_fn: Optional[Callable] = None,
                 seed: int = 0, engine: str = "cohort",
                 scan_rounds: bool = True, device=None,
                 scores: Optional[Callable[[int, int], Any]] = None,
                 mask_scores: Optional[Callable[[int, int], Any]] = None,
                 drop_scores: Optional[Callable[[int, int], Any]] = None,
                 store: Optional[ClientStateStore] = None,
                 event_seed: Optional[Callable[[int], Any]] = None,
                 attack_noise: Optional[Callable[[int, Any], Any]] = None):
        """See :meth:`from_strategy`."""
        if engine not in ("cohort", "full", "async"):
            raise ValueError(f"unknown engine {engine!r}")
        self.device = resolve_device(device)
        self.strategy = strategy
        self.cfg = strategy.federated_config(num_clients)
        self.schedule = strategy.sampling
        self.engine = engine
        self.scan_rounds = scan_rounds
        self.eval_fn = eval_fn
        self.params = {k: v.to(self.device) for k, v in init_params.items()}
        self._adaptive = strategy.sampler.adaptive
        self._uses_drift = self.cfg.client.objective.uses_drift
        if store is None:
            store = DenseStore(
                num_clients, self.params, track_norms=self._adaptive,
                extra_trees=({"drift": self.params} if self._uses_drift
                             else None))
        self._check_store(store, num_clients)
        self.store = store
        self._traits = (strategy.hetero.client_traits(num_clients)
                        if strategy.hetero is not None else None)
        self._loss_fn = loss_fn
        self._scores = scores
        self._mask_scores = mask_scores
        self._drop_scores = drop_scores
        self._event_seed = event_seed
        self._attack_noise = attack_noise
        attack = _active_attack(strategy.attack)
        self._noise_leaves = (
            {k: tuple(v.shape) for k, v in self.params.items()}
            if attack is not None and attack.needs_keys else {})
        self._attack_seed = seed
        self._generator = torch.Generator().manual_seed(seed)
        self._drop_generator = torch.Generator().manual_seed(seed + 2)
        masking = self.cfg.client.masking
        self._mask_leaves = (
            {k: tuple(v.shape) for k, v in self.params.items()
             if v.numel() >= masking.min_leaf_size}
            if masking.mode == "random" and masking.gamma < 1.0 else {})
        self._mask_seed = seed + 1
        self._async = None
        if engine == "async":
            from repro_torch.core.async_engine import AsyncRoundRunner
            self._async = AsyncRoundRunner(strategy, num_clients,
                                           store=self.store)
            self._event_generator = torch.Generator().manual_seed(seed + 3)
        self._rounds: Dict[tuple, Any] = {}
        self._graph_pool = None
        self._round = 0
        self.history: List[RoundRecord] = []
        self._num_params = pytree_num_params(self.params)
        self.client_upload_bytes = strategy.codec.wire_bytes(self.params)

    def _check_store(self, store: ClientStateStore, num_clients: int) -> None:
        """A caller's store must fit the population, the strategy's state
        and the engine, and live on the server's device."""
        name = self.strategy.name
        if store.num_clients != num_clients:
            raise ValueError(
                f"store was built for {store.num_clients} clients but the "
                f"server registers {num_clients}")
        if self._adaptive and store.norms is None:
            raise ValueError(
                f"strategy {name!r} uses an adaptive sampler; build the "
                "store with track_norms=True")
        if self._uses_drift and "drift" not in store.trees:
            raise ValueError(
                f"strategy {name!r} carries FedDyn drift state; build the "
                "store with extra_trees={'drift': init_params}")
        if self.engine == "full" and store.kind != "dense":
            raise ValueError(
                "engine='full' materializes every client's state per round "
                f"— incompatible with a {store.kind!r} store; use "
                "engine='cohort'")
        here, there = self.device, store.device
        if here.type != there.type or None not in (here.index, there.index) \
                and here.index != there.index:
            raise ValueError(f"the store lives on {there}, the server on "
                             f"{here}")

    @classmethod
    def from_strategy(cls, strategy, loss_fn: Callable, init_params: Tree,
                      num_clients: int, eval_fn: Optional[Callable] = None,
                      seed: int = 0, engine: str = "cohort",
                      scan_rounds: bool = True, *, device=None,
                      scores: Optional[Callable[[int, int], Any]] = None,
                      mask_scores: Optional[Callable[[int, int], Any]] = None,
                      drop_scores: Optional[Callable[[int, int], Any]] = None,
                      store: Optional[ClientStateStore] = None,
                      event_seed: Optional[Callable[[int], Any]] = None,
                      attack_noise: Optional[Callable[[int, Any], Any]]
                      = None) -> "FederatedServer":
        """Build a server from one strategy record.  ``scan_rounds`` runs
        the dense store's rounds segment by segment through the scan form
        (the module docstring).  ``device``: ``cuda``
        unless named (raises without a card).  ``scores(t, M)``, when given,
        supplies round t's (M,) uniform participant scores instead of the
        server's generator; ``mask_scores(t, M)`` supplies round t's random
        mask scores, ``{leaf: (M, *shape)}`` for every maskable leaf, instead
        of the server's own draw (random masking only); ``drop_scores(t,
        M)`` supplies round t's (M,) uniform upload-loss draws (hetero
        fleets, sync engines); ``event_seed(t)`` supplies the uint32 words
        that seed round t's host event stream (``engine="async"``);
        ``attack_noise(t, ids)`` supplies the standard-normal gauss-attack
        rows ``{leaf: (len(ids), *shape)}`` of the clients ``ids``.
        ``store`` is the client-state backend
        (``repro_torch.core.client_store``), on the server's device; None
        builds a :class:`DenseStore`."""
        return cls(strategy, loss_fn, init_params, num_clients,
                   eval_fn=eval_fn, seed=seed, engine=engine,
                   scan_rounds=scan_rounds, device=device,
                   scores=scores, mask_scores=mask_scores,
                   drop_scores=drop_scores, store=store,
                   event_seed=event_seed, attack_noise=attack_noise)

    def _round_fn(self, bucket: int, form: str = "dense") -> tuple:
        """The (cached) round of one form for one cohort bucket and the
        seconds spent building it: on the first use, the round's
        construction and, on a CUDA device when the round launches kernels,
        the kernel library's ``nvcc`` build or load (cached for the process
        after its first use); 0.0 for a round already built.  ``form`` is
        ``"dense"`` (the oracle when the bucket is the whole population,
        else the cohort round), ``"scan"`` (the scan form of either, its
        graph captured at its first call, in the server's graph memory
        pool) or ``"store"``.  The counterpart of the reference's
        ``_get_compiled``.  A build failure raises."""
        fn = self._rounds.get((form, bucket))
        if fn is not None:
            return fn, 0.0
        from repro_torch.core.strategy import build_round, launches_kernels
        t0 = time.perf_counter()
        M = self.cfg.num_clients
        if form in ("store", "scan"):
            fn = build_round(self.strategy, self._loss_fn, M, form=form,
                             cohort_size=bucket)
            if form == "scan" and self.device.type == "cuda":
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                fn.pool = self._graph_pool
        elif bucket >= M:
            fn = build_round(self.strategy, self._loss_fn, M, form="full")
        else:
            fn = build_round(self.strategy, self._loss_fn, M,
                             form="cohort", cohort_size=bucket)
        if self.device.type == "cuda" and launches_kernels(self.strategy):
            from repro_torch.kernels.build import library
            library()
        self._rounds[(form, bucket)] = fn
        return fn, time.perf_counter() - t0

    def _uniforms(self, t: int, given, generator, what: str
                  ) -> torch.Tensor:
        """Round t's (M,) CPU uniforms: ``given(t, M)`` or the next draw of
        ``generator``."""
        M = self.cfg.num_clients
        if given is not None:
            scores = torch.from_numpy(np.array(given(t, M), dtype=np.float32))
        else:
            scores = torch.rand((M,), generator=generator)
        if tuple(scores.shape) != (M,):
            raise ValueError(f"round {t} {what} must have shape ({M},), got "
                             f"{tuple(scores.shape)}")
        return scores

    def _state(self) -> Dict[str, Any]:
        """The per-client state a dense round reads: every stacked tree of
        the store, and the norm EMA for an adaptive sampler."""
        state: Dict[str, Any] = {name: self.store.dense_view(name)
                                 for name in self.store.trees}
        if self._adaptive:
            state["norms"] = self.store.norms
        return state

    def _commit_state(self, state: Dict[str, Any]) -> None:
        for name in self.store.trees:
            self.store.set_dense(state[name], tree=name)
        if self._adaptive:
            self.store.set_norms(state["norms"])

    def round_mask_scores(self, t: int) -> Optional[Tree]:
        """Round t's random-mask scores, ``{leaf: (M, *shape)}`` fp32 on the
        server's device, or None unless the policy masks at random: every
        client's rows of :func:`client_mask_scores` (the dense rounds), or
        the ``mask_scores`` callable's."""
        if not self._mask_leaves:
            return None
        M = self.cfg.num_clients
        if self._mask_scores is None:
            return client_mask_scores(self._mask_seed, t, np.arange(M),
                                      self._mask_leaves, self.device)
        given = self._mask_scores(t, M)
        out = {}
        for k, shape in self._mask_leaves.items():
            v = given[k]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.asarray(v, dtype=np.float32))
            out[k] = v.to(self.device, torch.float32)
            if out[k].numel() != M * int(np.prod(shape)):
                raise ValueError(f"round {t} mask scores of {k!r} must hold "
                                 f"{M} x {shape} values, got "
                                 f"{tuple(out[k].shape)}")
            out[k] = out[k].reshape((M,) + shape)
        return out

    def _cohort_mask_scores(self, t: int, ids: torch.Tensor
                            ) -> Optional[Tree]:
        """The cohort's rows of round t's random-mask scores: the draw of
        just those clients, which equals their rows of
        :meth:`round_mask_scores`, or the rows of the callable's tensors."""
        if not self._mask_leaves:
            return None
        if self._mask_scores is None:
            return client_mask_scores(self._mask_seed, t, ids.cpu().numpy(),
                                      self._mask_leaves, self.device)
        return {k: v.index_select(0, ids)
                for k, v in self.round_mask_scores(t).items()}

    def _cohort_attack_noise(self, t: int, ids) -> Optional[Tree]:
        """Round t's gauss-attack noise rows of the clients ``ids`` on the
        server's device (None unless the attack draws noise): the
        ``attack_noise`` callable's, or :func:`client_attack_noise`."""
        if not self._noise_leaves:
            return None
        ids_np = (ids.cpu().numpy() if isinstance(ids, torch.Tensor)
                  else np.asarray(ids))
        if self._attack_noise is None:
            return client_attack_noise(self._attack_seed, t, ids_np,
                                       self._noise_leaves, self.device)
        given = self._attack_noise(t, ids_np)
        out = {}
        for k, shape in self._noise_leaves.items():
            v = given[k]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.asarray(v, dtype=np.float32))
            out[k] = v.to(self.device, torch.float32).reshape(
                (len(ids_np),) + shape)
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, batches: Sequence[Any]) -> List[torch.Tensor]:
        return [torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(self.device) for x in batches]

    def run(self, client_batches, n_samples, rounds: int,
            eval_every: int = 0, eval_data: Any = None) -> List[RoundRecord]:
        """Run ``rounds`` communication rounds, appending to ``history``.

        ``client_batches``: arrays with leading (num_clients, num_batches,
        B, ...) axes (e.g. ``(xs, ys)``), or, on a sharded store only, a
        provider ``client_batches(ids) -> (xs, ys)`` with leading
        ``(len(ids), num_batches, B, ...)`` axes, so the (M, …) batch stack
        never has to exist either; ``n_samples``: (num_clients,) dataset
        sizes; ``eval_every``: evaluate ``eval_fn(params, eval_data)``
        every that many rounds and on the last.  Rounds are numbered from
        the server's round counter, so a restored server continues where
        its checkpoint left off.
        """
        masking = self.cfg.client.masking
        gamma = masking.gamma if masking.mode != "none" else 1.0
        provider = client_batches if callable(client_batches) else None
        if provider is not None:
            if self.store.kind == "dense":
                raise ValueError(
                    "a client_batches provider callable requires a sharded "
                    "store (the dense rounds take the full batch stack)")
            batches = None
            probe = self._to_device(provider(np.zeros((1,), np.int64)))
        else:
            batches = probe = self._to_device(client_batches)
        flops = float(local_update_flops(probe, self._num_params,
                                         self.cfg.client))
        n_samples = torch.as_tensor(np.asarray(n_samples),
                                    dtype=torch.float32)
        M = self.cfg.num_clients
        if self._async is not None:
            step = self._async_round
        elif self.store.kind == "dense":
            step, n_samples = self._dense_round, n_samples.to(self.device)
            if self.scan_rounds:
                return self._run_segments(batches, n_samples, rounds,
                                          self._eval_rounds(rounds,
                                                            eval_every),
                                          eval_data, gamma, flops)
        else:
            step = self._store_round
        eval_rounds = self._eval_rounds(rounds, eval_every)
        for t in range(self._round + 1, self._round + rounds + 1):
            scores = self._uniforms(t, self._scores, self._generator,
                                    "scores")
            m = self.schedule.num_clients_host(t, M)
            bucket = self.strategy.sampler.cohort_bucket(self.schedule, m, M)
            bucket = bucket if self.engine != "full" else M
            rec = step(t, bucket, batches, provider, n_samples, scores, gamma,
                       flops)
            if t in eval_rounds:
                rec.eval_metric = float(self.eval_fn(self.params, eval_data))
            self.history.append(rec)
            self._round = t
        return self.history

    def _eval_rounds(self, rounds: int, eval_every: int) -> set:
        """The rounds of the next ``rounds`` that evaluate: every
        ``eval_every``-th and the last (none without an ``eval_fn``)."""
        start = self._round
        if not (eval_every and self.eval_fn is not None):
            return set()
        return {t for t in range(start + 1, start + rounds + 1)
                if t % eval_every == 0 or t == start + rounds}

    def _segments(self, rounds: int, eval_rounds, start: int = 0
                  ) -> List[tuple]:
        """Split start+1..start+rounds into ``(bucket, [t, ...])`` segments,
        as the reference does: consecutive rounds that share a cohort
        bucket, broken after each eval round (the host needs Θ_t there).
        ``engine="full"`` pins every bucket to the whole population; the
        sampler sizes the buckets (``ClientSampler.cohort_bucket``).
        Without ``scan_rounds`` every round is a segment of its own."""
        M = self.cfg.num_clients
        sampler = self.strategy.sampler
        plan = self.schedule.round_buckets(rounds, M, start=start)
        segments: List[tuple] = []
        for t, (m, _bucket) in zip(range(start + 1, start + rounds + 1),
                                   plan):
            bucket = sampler.cohort_bucket(self.schedule, m, M)
            b_eff = bucket if self.engine == "cohort" else M
            if (segments and self.scan_rounds
                    and segments[-1][0] == b_eff
                    and (t - 1) not in eval_rounds):
                segments[-1][1].append(t)
            else:
                segments.append((b_eff, [t]))
        return segments

    def _stacked(self, draw: Callable, ts) -> Any:
        """A segment's draws stacked per round: ``draw(t)`` is None, a
        tensor or a ``{leaf: tensor}`` tree."""
        rounds = [draw(t) for t in ts]
        if rounds[0] is None:
            return None
        if isinstance(rounds[0], dict):
            return {k: torch.stack([r[k] for r in rounds])
                    for k in rounds[0]}
        return torch.stack(rounds)

    def _run_segments(self, batches, n_samples, rounds: int, eval_rounds,
                      eval_data, gamma, flops) -> List[RoundRecord]:
        """The dense store's rounds segment by segment through the scan
        form (the module docstring): one call per segment, its records
        from the stacked metrics as the reference writes them."""
        M = self.cfg.num_clients
        everyone = np.arange(M)
        for bucket, ts in self._segments(rounds, eval_rounds, self._round):
            scores = self._stacked(
                lambda t: self._uniforms(t, self._scores, self._generator,
                                         "scores"), ts)
            drop_scores = self._stacked(self._drop_uniforms, ts)
            scan_fn, compile_s = self._round_fn(bucket, "scan")
            self._sync()
            t0 = time.perf_counter()
            mask = self._stacked(self.round_mask_scores, ts)
            noise = self._stacked(
                lambda t: self._cohort_attack_noise(t, everyone), ts)
            self.params, state, metrics = scan_fn(
                self.params, self._state(), batches, n_samples, ts, scores,
                mask, drop_scores, noise)
            self._commit_state(state)
            self._sync()
            wall = time.perf_counter() - t0 - scan_fn.last_capture_s
            compile_s += scan_fn.last_capture_s
            for i, t in enumerate(ts):
                rec = self._sync_record(
                    t, bucket, {k: v[i] for k, v in metrics.items()},
                    wall / len(ts), compile_s if i == 0 else 0.0, gamma,
                    flops)
                if t in eval_rounds and t == ts[-1]:
                    rec.eval_metric = float(self.eval_fn(self.params,
                                                         eval_data))
                self.history.append(rec)
            self._round = ts[-1]
        return self.history

    def release_graphs(self) -> None:
        """Drop the scan form's CUDA graphs and their memory pool, whose
        blocks stay reserved for the graphs while they live; the next
        ``run`` captures again (and times it in ``compile_s``).  Follow
        with ``gc.collect()`` and ``torch.cuda.empty_cache()`` to hand the
        memory back to the card."""
        for key in [k for k in self._rounds if k[0] == "scan"]:
            del self._rounds[key]
        self._graph_pool = None

    def graph_stats(self) -> Dict[str, Any]:
        """The scan form's CUDA graphs: ``graphs`` captured, ``replays``
        run and ``capture_s`` (warm-up and capture seconds), in all and
        per bucket as ``[graphs, replays, capture_s]``."""
        scans = {b: fn for (form, b), fn in self._rounds.items()
                 if form == "scan"}
        return {"graphs": sum(fn.graphs for fn in scans.values()),
                "replays": sum(fn.replays for fn in scans.values()),
                "capture_s": sum(fn.capture_s for fn in scans.values()),
                "per_bucket": {b: [fn.graphs, fn.replays, fn.capture_s]
                               for b, fn in sorted(scans.items())}}

    def _sync_record(self, t, bucket, metrics, wall, compile_s, gamma,
                     flops) -> RoundRecord:
        """A sync round's ledger entry, with the fleet clock on a hetero
        fleet."""
        num_sampled = int(metrics["num_sampled"])
        rec = RoundRecord(
            round=t, num_sampled=num_sampled,
            mean_loss=float(metrics["mean_loss"]),
            transport_units=num_sampled * gamma,
            transport_bytes=num_sampled * self.client_upload_bytes,
            wall_s=wall, compile_s=compile_s, cohort_size=bucket,
            flop_proxy=flops * bucket,
            quarantined=int(metrics["quarantined"]),
            adversarial=int(metrics.get("num_adversarial", 0)))
        if self._traits is not None:
            sim = simulate_round(
                self._traits, metrics["part_mask"].cpu().numpy(),
                metrics["arrived_mask"].cpu().numpy(), flops,
                self.client_upload_bytes)
            rec.sim_round_s = sim["sim_round_s"]
            rec.straggler_s = sim["straggler_s"]
            rec.dropped = sim["dropped"]
        return rec

    def _drop_uniforms(self, t: int) -> Optional[torch.Tensor]:
        """Round t's dropout draws on a hetero fleet (sync engines)."""
        if self._traits is None:
            return None
        return self._uniforms(t, self._drop_scores, self._drop_generator,
                              "drop scores")

    def _event_words(self, t: int) -> List[int]:
        """The uint32 words that seed round t's host event stream: the
        ``event_seed(t)`` callable's, or two from the event generator."""
        if self._event_seed is not None:
            return [int(w) for w in
                    np.asarray(self._event_seed(t), np.uint32).ravel()]
        return torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                             generator=self._event_generator).tolist()

    def _async_round(self, t, bucket, batches, provider, n_samples, scores,
                     gamma, flops) -> RoundRecord:
        """One buffered round of the async engine.  Transport counts every
        transmission the fleet attempted, retries and deadline-cut sends
        included: those bytes crossed the uplink either way."""
        mask_scores = attack_noise = None
        if self._mask_leaves:
            def mask_scores(ids):
                return self._cohort_mask_scores(t, ids)
        if self._noise_leaves:
            def attack_noise(ids):
                return self._cohort_attack_noise(t, ids)
        words = self._event_words(t)
        prog, compile_s = self._round_fn(bucket, "store")
        self._sync()
        t0 = time.perf_counter()
        self.params, stats = self._async.run_round(
            self.params, prog, provider if provider is not None else batches,
            n_samples, t, scores, words, flops=flops,
            wire_bytes=self.client_upload_bytes, mask_scores=mask_scores,
            attack_noise=attack_noise)
        self._sync()
        return RoundRecord(
            round=t, num_sampled=stats["num_sampled"],
            mean_loss=stats["mean_loss"],
            transport_units=stats["sends"] * gamma,
            transport_bytes=stats["sends"] * self.client_upload_bytes,
            wall_s=time.perf_counter() - t0, compile_s=compile_s,
            cohort_size=bucket,
            flop_proxy=flops * bucket, quarantined=stats["quarantined"],
            sim_round_s=stats["sim_round_s"],
            straggler_s=stats["straggler_s"], dropped=stats["dropped"],
            arrivals=stats["arrivals"], timeouts=stats["timeouts"],
            retries=stats["retries"], flushes=stats["flushes"],
            mean_staleness=stats["mean_staleness"],
            carried=stats["carried"], pending=stats["pending"],
            adversarial=stats["adversarial"])

    def _dense_round(self, t, bucket, batches, provider, n_samples, scores,
                     gamma, flops) -> RoundRecord:
        """One round on the dense store."""
        drop_scores = self._drop_uniforms(t)
        round_fn, compile_s = self._round_fn(bucket)
        self._sync()
        t0 = time.perf_counter()
        noise = self._cohort_attack_noise(t, np.arange(self.cfg.num_clients))
        self.params, state, metrics = round_fn(
            self.params, self._state(), batches, n_samples, t, scores,
            self.round_mask_scores(t), drop_scores, noise)
        self._commit_state(state)
        self._sync()
        return self._sync_record(t, bucket, metrics,
                                 time.perf_counter() - t0, compile_s, gamma,
                                 flops)

    def _store_round(self, t, bucket, batches, provider, n_samples, scores,
                     gamma, flops) -> RoundRecord:
        """One round of the store form (a sharded store): selection on the
        CPU, the cohort's state rows from the store, the body, the versions
        of the participants, the commit-gated scatter and the norm
        update."""
        drop_scores = self._drop_uniforms(t)
        prog, compile_s = self._round_fn(bucket, "store")
        store = self.store
        self._sync()
        t0 = time.perf_counter()
        d = store_dispatch(prog, store, n_samples, t, scores,
                           provider if provider is not None else batches,
                           self.device)
        self.params, new_rows, drift_rows, commit, norm_upd, metrics = \
            prog.body(self.params, d.res, d.drift, d.batches, d.ids, d.part,
                      d.weights, d.norms,
                      self._cohort_mask_scores(t, d.ids.to(self.device)),
                      drop_scores, self._cohort_attack_noise(t, d.ids))
        ids_np = d.ids.numpy()
        # Θ_t went out to the participants: the versions staleness reads.
        store.mark_dispatched(ids_np[d.part.numpy()[ids_np] > 0], t)
        commit_np = commit.cpu().numpy()
        if prog.error_feedback:
            store.scatter(ids_np, new_rows, commit_np, t)
        if prog.uses_drift:
            store.scatter(ids_np, drift_rows, commit_np, t, tree="drift")
        if prog.adaptive:
            store.update_norms(ids_np, norm_upd)
        self._sync()
        return self._sync_record(t, bucket, metrics,
                                 time.perf_counter() - t0, compile_s, gamma,
                                 flops)

    # ---- checkpoint / resume ------------------------------------------------
    def state(self) -> Dict[str, Any]:
        """The whole resumable training state as one tree: under ``rng``
        the states of the server's generators (``participants``, seed;
        ``drop``, seed + 2; ``events``, seed + 3, on the async engine) and,
        under random masking, the ``mask`` seed (seed + 1), under a
        ``gauss`` attack the ``attack`` seed (seed); the global
        ``params``; and the store's state under the reference's keys.  The
        round counter goes in the checkpoint's manifest.  Like the
        reference's, it holds no upload still in flight across rounds
        (cross-round mode)."""
        rng = {"participants": self._generator.get_state(),
               "drop": self._drop_generator.get_state()}
        if self._mask_leaves:
            rng["mask"] = torch.tensor(self._mask_seed, dtype=torch.int64)
        if self._async is not None:
            rng["events"] = self._event_generator.get_state()
        if self._noise_leaves:
            rng["attack"] = torch.tensor(self._attack_seed, dtype=torch.int64)
        return {"rng": rng, "params": self.params, **self.store.state()}

    def save_state(self, ckpt_dir: str) -> str:
        """Checkpoint :meth:`state` at the current round (atomically); the
        manifest's ``extra`` holds ``round``, ``num_clients`` and ``store``
        (the backend's kind).  Returns the step's directory."""
        from repro_torch.checkpoint import save_checkpoint
        return save_checkpoint(ckpt_dir, self._round, self.state(),
                               extra={"round": self._round,
                                      "num_clients": self.cfg.num_clients,
                                      "store": self.store.kind})

    def restore_state(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        """Restore :meth:`state` from ``ckpt_dir`` (the latest step unless
        given) and continue the round numbering from it; the next ``run``
        resumes bit-identically to the run that wrote it.  A checkpoint of
        another population size or store kind, or of another structure or
        shape, raises before anything is assigned.  Returns the step."""
        from repro_torch.checkpoint import read_manifest, restore_checkpoint
        extra = read_manifest(ckpt_dir, step).get("extra", {})
        ckpt_m = extra.get("num_clients")
        if ckpt_m is not None and int(ckpt_m) != self.cfg.num_clients:
            raise ValueError(
                f"checkpoint was written for num_clients={int(ckpt_m)} but "
                f"this server registers num_clients={self.cfg.num_clients}")
        ckpt_store = extra.get("store")
        if ckpt_store is not None and ckpt_store != self.store.kind:
            raise ValueError(
                f"checkpoint holds a {ckpt_store!r} store but this server "
                f"owns a {self.store.kind!r} store")
        restored, step, extra = restore_checkpoint(ckpt_dir, self.state(),
                                                   step)
        rng = restored.pop("rng")
        params = restored.pop("params")
        self.store.load_state(restored)
        self._generator.set_state(rng["participants"])
        self._drop_generator.set_state(rng["drop"])
        if self._mask_leaves:
            self._mask_seed = int(rng["mask"])
        if self._async is not None:
            self._event_generator.set_state(rng["events"])
        if self._noise_leaves:
            self._attack_seed = int(rng["attack"])
        self.params = params
        self._round = int(extra.get("round", step))
        return step

    def total_transport_units(self) -> float:
        """Cumulative client uploads in full-model units (Eq. 6 basis)."""
        return float(sum(r.transport_units for r in self.history))

    def total_transport_bytes(self) -> int:
        """Cumulative EXACT wire bytes across all recorded rounds."""
        return int(sum(r.transport_bytes for r in self.history))

    def summary(self) -> Dict[str, Any]:
        """Run-level roll-up of the history (with a hetero fleet also the
        simulated clock and the lost uploads; on the async engine also its
        fault ledger, staleness averaged over the applied uploads)."""
        evals = [r.eval_metric for r in self.history
                 if r.eval_metric is not None]
        out = {
            "rounds": len(self.history),
            "final_loss": (self.history[-1].mean_loss if self.history
                           else float("nan")),
            "final_eval": evals[-1] if evals else float("nan"),
            "transport_units": self.total_transport_units(),
            "transport_bytes": self.total_transport_bytes(),
            "transport_GB": self.total_transport_bytes() / 1e9,
            "num_params": self._num_params,
            "engine": self.engine,
            "strategy": self.strategy.name,
            "sampler": self.strategy.sampler.name,
            "codec": self.strategy.codec.name,
            "client_upload_bytes": self.client_upload_bytes,
            "compile_s": float(sum(r.compile_s for r in self.history)),
            "steady_wall_s": float(sum(r.wall_s for r in self.history)),
            "quarantined": int(sum(r.quarantined for r in self.history)),
            "device": str(self.device),
        }
        if self._traits is not None:
            out["hetero"] = self.strategy.hetero.profile
        if self._traits is not None or self.engine == "async":
            out["sim_total_s"] = float(
                sum(r.sim_round_s for r in self.history))
            out["dropped_uploads"] = int(sum(r.dropped for r in self.history))
        if self.engine == "async":
            arrivals = int(sum(r.arrivals for r in self.history))
            out["arrivals"] = arrivals
            out["timeouts"] = int(sum(r.timeouts for r in self.history))
            out["retries"] = int(sum(r.retries for r in self.history))
            out["flushes"] = int(sum(r.flushes for r in self.history))
            out["mean_staleness"] = float(
                sum(r.mean_staleness * r.arrivals for r in self.history)
                / arrivals) if arrivals else 0.0
            out["carried"] = int(sum(r.carried for r in self.history))
        attack = _active_attack(self.strategy.attack)
        if attack is not None:
            out["attack"] = f"{attack.kind}(f={attack.fraction})"
            out["adversarial_uploads"] = int(
                sum(r.adversarial for r in self.history))
        return out
