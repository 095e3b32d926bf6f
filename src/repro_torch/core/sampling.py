"""Client sampling: how MANY clients per round, and WHICH ones (counterpart
of ``repro/core/sampling.py``).

* :class:`SamplingSchedule` — the participation fraction ``c(t)``; dynamic
  sampling anneals ``c(t) = C * exp(-beta * t)`` (Eq. 3) in float32, floored
  at ``min_clients``.  The rate is always evaluated on the CPU, so a run on
  the card picks the same m_t as one on the CPU.
* :class:`ClientSampler` — WHICH m_t clients, with the aggregation weights
  that keep the weighted FedAvg unbiased: :class:`UniformSampler` (the
  paper's rule), and the norm-adaptive :class:`ImportanceSampler` and
  :class:`ThresholdSampler`, which read the server's per-client EMA of each
  client's observed update norm and emit Horvitz-Thompson weights.

Every selection function takes the round's uniform ``scores`` (one per
registered client) instead of drawing them, so a caller can hand in the
reference's draws; the server draws them from its own CPU generator.  All
three samplers consume exactly that one (M,) vector.  Selection runs on
the tensors' device; the server runs it on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "SamplingSchedule",
    "StaticSampling",
    "DynamicSampling",
    "sample_clients",
    "participation_mask",
    "transport_cost",
    "cumulative_transport",
    "rounds_for_budget",
    "ClientSampler",
    "UniformSampler",
    "ImportanceSampler",
    "ThresholdSampler",
    "transmit_probabilities",
    "get_sampler",
]


_SCAN_BLOCK = 16


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive fp32 prefix sum along dim 0 (each column of a 2-D tensor
    alone), associated as XLA:CPU evaluates the reference's
    ``jnp.cumsum``: sequential within blocks of 16, the block totals
    scanned the same way, and each block offset by the total of the blocks
    before it.  ``torch.cumsum`` accumulates in float64 on the CPU; near a
    CDF edge that moves a draw to the next client."""
    n, rest = x.shape[0], tuple(x.shape[1:])
    nb = -(-n // _SCAN_BLOCK)
    blocks = torch.cat([x, x.new_zeros((nb * _SCAN_BLOCK - n,) + rest)]
                       ).reshape((nb, _SCAN_BLOCK) + rest)
    cols = [blocks[:, 0]]
    for j in range(1, _SCAN_BLOCK):
        cols.append(cols[-1] + blocks[:, j])
    inner = torch.stack(cols, 1)
    if nb > 1:
        totals = _cumsum(inner[:, -1])
        inner = inner + torch.cat([x.new_zeros((1,) + rest),
                                   totals[:-1]])[:, None]
    return inner.reshape((-1,) + rest)[:n]


def _ranks(scores: torch.Tensor) -> torch.Tensor:
    """Rank of every client by ascending score (stable: index tie-break)."""
    order = torch.argsort(scores, stable=True)
    return torch.argsort(order, stable=True)


@dataclasses.dataclass(frozen=True)
class SamplingSchedule:
    """Base schedule: fraction of the M registered clients used at round t."""

    initial_rate: float = 1.0
    min_clients: int = 2

    def rate(self, t) -> torch.Tensor:
        """Participation fraction c(t) at round ``t`` (float32, CPU)."""
        raise NotImplementedError

    def num_clients(self, t, num_registered: int) -> int:
        """m_t = max(round(c_t * M), min_clients), capped at M (Alg. 3 line
        9), with the product and the half-to-even rounding in float32."""
        m = int(torch.round(self.rate(t) * num_registered))
        floor = min(self.min_clients, num_registered)
        return max(min(m, num_registered), floor)

    def num_clients_host(self, t: int, num_registered: int) -> int:
        """m_t as the host computes it for bucket selection: the float32
        rate times M in float64, rounded half-to-even."""
        m = int(round(float(self.rate(t)) * num_registered))
        floor = min(self.min_clients, num_registered)
        return max(min(m, num_registered), floor)

    def bucket_ladder(self, num_registered: int) -> tuple:
        """Static set of cohort buffer sizes: powers of two >= min_clients,
        capped at (and always including) M = num_registered."""
        floor = max(1, min(self.min_clients, num_registered))
        b = 1
        while b < floor:
            b *= 2
        ladder = []
        while b < num_registered:
            ladder.append(b)
            b *= 2
        ladder.append(num_registered)
        return tuple(ladder)

    def bucket_for(self, m: int, num_registered: int) -> int:
        """Smallest ladder bucket that fits an m-client cohort."""
        for b in self.bucket_ladder(num_registered):
            if b >= m:
                return b
        return num_registered

    def round_buckets(self, rounds: int, num_registered: int,
                      start: int = 0) -> list:
        """Per-round (m_t, bucket) for t = start+1..start+rounds."""
        out = []
        for t in range(start + 1, start + rounds + 1):
            m = self.num_clients_host(t, num_registered)
            out.append((m, self.bucket_for(m, num_registered)))
        return out


@dataclasses.dataclass(frozen=True)
class StaticSampling(SamplingSchedule):
    """Alg. 1: constant sampling fraction C."""

    def rate(self, t) -> torch.Tensor:
        """Constant participation fraction C, independent of t."""
        return torch.tensor(self.initial_rate, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class DynamicSampling(SamplingSchedule):
    """Alg. 3: c(t) = C * exp(-beta * t)  (Eq. 3)."""

    beta: float = 0.1

    def rate(self, t) -> torch.Tensor:
        """Exponentially annealed participation fraction (Eq. 3)."""
        t = torch.as_tensor(t, dtype=torch.float32).cpu()
        return self.initial_rate * torch.exp(-self.beta * t)


def sample_clients(scores: torch.Tensor, schedule: SamplingSchedule, t,
                   num_registered: int) -> torch.Tensor:
    """The int64 ids of round ``t``'s m_t participants: the clients with
    the m_t lowest ``scores``, lowest first (a uniform random subset when
    the scores are i.i.d.; the reference takes the head of a random
    permutation, which is this for ``scores = argsort(permutation)``)."""
    m = schedule.num_clients(t, num_registered)
    return torch.argsort(scores, stable=True)[:m]


def participation_mask(scores: torch.Tensor, schedule: SamplingSchedule, t,
                       num_registered: int) -> torch.Tensor:
    """0/1 float mask of shape (num_registered,) with exactly m_t ones: the
    clients whose uniform ``scores`` rank below m_t."""
    m = schedule.num_clients(t, num_registered)
    return (_ranks(scores) < m).to(torch.float32)


def transport_cost(schedule: SamplingSchedule, gamma: float,
                   rounds: int) -> float:
    """Paper Eq. 6: f(beta, gamma) = (gamma / R) * sum_t C*exp(-beta*t), in
    units of one full-model single-client transfer per round."""
    rates = torch.stack([schedule.rate(t) for t in range(1, rounds + 1)])
    return float(gamma * np.float64(rates.double().sum()) / rounds)


def cumulative_transport(schedule: SamplingSchedule, gamma: float,
                         rounds: int, num_registered: int) -> float:
    """Total client uploads over ``rounds`` in full-model units: the integer
    m_t of every round times the kept fraction gamma."""
    return float(sum(gamma * schedule.num_clients(t, num_registered)
                     for t in range(1, rounds + 1)))


def rounds_for_budget(schedule: SamplingSchedule, gamma: float,
                      num_registered: int, budget: float) -> int:
    """How many rounds fit in ``budget`` full-model transfers (paper §5.2)."""
    total, t = 0.0, 0
    while True:
        t += 1
        total += gamma * schedule.num_clients(t, num_registered)
        if total > budget:
            return t - 1
        if t > 1_000_000:  # pragma: no cover - safety
            return t


@dataclasses.dataclass(frozen=True)
class ClientSampler:
    """Base client-selection policy.  :meth:`select` returns ``(part,
    weights)``: the float 0/1 participation mask over the M clients and the
    aggregation coefficients.  With ``normalize`` FedAvg re-normalizes the
    weights to sum to 1 (Eq. 2); without it they are Horvitz-Thompson
    weights, ``E[sum_i weights_i u_i] = sum_i (n_i / n) u_i``.  An
    ``adaptive`` sampler reads ``norms``, the server's per-client EMA (rate
    ``ema``) of the L2 norm of each client's decoded upload."""

    name = "uniform"
    adaptive = False
    normalize = True
    ema = 0.5

    def cohort_bucket(self, schedule: SamplingSchedule, m: int,
                      num_registered: int) -> int:
        """Static cohort-buffer size for a round with nominal m
        participants: an upper bound on the ``part > 0`` count
        :meth:`select` can emit for that m."""
        return schedule.bucket_for(m, num_registered)

    def select(self, scores: torch.Tensor, schedule: SamplingSchedule, t,
               num_registered: int, n_samples: torch.Tensor,
               norms: torch.Tensor | None = None):
        """Pick round ``t``'s participants from the uniform ``scores``."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class UniformSampler(ClientSampler):
    """The paper's selection rule: m_t clients uniformly at random; weights
    are the masked dataset sizes (self-normalized, Eq. 2)."""

    def select(self, scores, schedule, t, num_registered, n_samples,
               norms=None):
        """``part`` from :func:`participation_mask`, weights
        ``part * n_samples``."""
        part = participation_mask(scores, schedule, t, num_registered)
        part = part.to(n_samples.device)
        return part, part * n_samples


@dataclasses.dataclass(frozen=True)
class ImportanceSampler(ClientSampler):
    """Importance sampling by tracked update norm, unbiased through
    with-replacement draws.

    Round t draws m_t client slots i.i.d. from ``p_i ∝ (1 - exploration)
    norm_i / Σ norm + exploration / M`` by inverse CDF (one uniform a slot,
    the first m_t of the round's M scores); a client drawn ``c_i`` times
    uploads once with weight ``c_i n_i / (n m_t p_i)``, and ``E[c_i] = m_t
    p_i`` makes the estimate unbiased for any p.  Distinct participants are
    at most m_t, so the schedule's bucket fits."""

    name = "importance"
    adaptive = True
    normalize = False
    exploration: float = 0.1
    ema: float = 0.5

    def __post_init__(self):
        """Validate the exploration mixing coefficient."""
        if not 0.0 < self.exploration <= 1.0:
            raise ValueError(
                f"exploration must be in (0, 1], got {self.exploration}")

    def probabilities(self, norms: torch.Tensor) -> torch.Tensor:
        """The selection distribution: normalized norms mixed with a
        uniform floor (every entry >= exploration / M)."""
        norms = torch.clamp(norms.to(torch.float32), min=0.0)
        p = norms / torch.clamp(norms.sum(), min=1e-12)
        return (1.0 - self.exploration) * p + self.exploration / norms.numel()

    def select(self, scores, schedule, t, num_registered, n_samples,
               norms=None):
        """Multinomial(m_t, p) slot draws -> (distinct-participant mask,
        Horvitz-Thompson count weights)."""
        m = schedule.num_clients(t, num_registered)
        p = self.probabilities(norms)
        cdf = _cumsum(p)
        draws = torch.clamp(
            torch.searchsorted(cdf, scores.to(p.device) * cdf[-1],
                               right=True), 0, num_registered - 1)
        active = (torch.arange(num_registered, device=p.device)
                  < m).to(torch.float32)
        counts = torch.zeros(num_registered, device=p.device).index_add_(
            0, draws, active)
        part = (counts > 0).to(torch.float32)
        n_total = torch.clamp(n_samples.sum(), min=1e-12)
        weights = counts * n_samples / (n_total * max(float(m), 1.0) * p)
        return part, weights


@dataclasses.dataclass(frozen=True)
class ThresholdSampler(ClientSampler):
    """Norm-threshold transmission, debiased.

    Each client transmits independently with probability ``p_i = min(1,
    norm_i / tau)``, ``tau`` water-filled so that ``Σ p_i = m_t``
    (:func:`transmit_probabilities`), with Horvitz-Thompson weights
    ``n_i / (n p_i)``.  The count is random (mean m_t), so the cohort
    buffer holds ``slack * m_t`` (its bucket) and both forms cap the
    transmitters at that bucket, keeping those with the smallest uniform
    draw."""

    name = "threshold"
    adaptive = True
    normalize = False
    slack: float = 2.0
    ema: float = 0.5

    def __post_init__(self):
        """Validate the cohort-buffer slack factor."""
        if self.slack < 1.0:
            raise ValueError(f"slack must be >= 1, got {self.slack}")

    def cohort_bucket(self, schedule, m, num_registered):
        """Bucket for ``slack * m`` participants (random count, mean m)."""
        target = min(num_registered, int(np.ceil(self.slack * m)))
        return schedule.bucket_for(target, num_registered)

    def _cap(self, schedule, m: int, num_registered: int) -> int:
        """The participant cap, the bucket of ``ceil(slack * m)`` with the
        product in float32 as the reference traces it."""
        target = min(int(np.ceil(np.float32(self.slack) * np.float32(m))),
                     num_registered)
        return schedule.bucket_for(target, num_registered)

    def select(self, scores, schedule, t, num_registered, n_samples,
               norms=None):
        """Independent transmit draws at the water-filled probabilities,
        capped at the cohort bucket; Horvitz-Thompson ``1/p`` weights."""
        m = schedule.num_clients(t, num_registered)
        p = transmit_probabilities(norms, m)
        u = scores.to(p.device)
        sel = u < p
        ranks = _ranks(torch.where(sel, u, torch.full_like(u, 2.0)))
        part = (sel & (ranks < self._cap(schedule, m, num_registered))
                ).to(torch.float32)
        n_total = torch.clamp(n_samples.sum(), min=1e-12)
        weights = part * n_samples / (n_total * torch.clamp(p, min=1e-12))
        return part, weights


def transmit_probabilities(norms: torch.Tensor, m) -> torch.Tensor:
    """Water-filling transmit probabilities ``p_i = min(1, norms_i / tau)``
    with ``Σ p_i = m``: for every count K of saturated clients (the K
    largest norms at p = 1) the threshold is ``tau_K = (sum of the other
    norms) / (m - K)``, and the solution is the first K whose tau clears
    the (K + 1)-th largest norm.  ``m >= M`` gives all ones."""
    a = torch.clamp(norms.to(torch.float32), min=1e-12)
    num = a.numel()
    desc = torch.sort(a, descending=True).values
    csum = _cumsum(desc)
    tails = csum[-1] - torch.cat([csum.new_zeros(1), csum[:-1]])
    denom = float(m) - torch.arange(num, dtype=torch.float32, device=a.device)
    tau_k = torch.where(denom > 0, tails / torch.clamp(denom, min=1e-12),
                        torch.full_like(tails, float("inf")))
    feasible = (denom > 0) & (tau_k >= desc)
    k_star = torch.argmax(feasible.to(torch.int32))   # the first feasible K
    p = torch.clamp(a / tau_k[k_star], max=1.0)
    return torch.ones_like(p) if m >= num else p


_SAMPLERS = {
    "uniform": UniformSampler,
    "importance": ImportanceSampler,
    "threshold": ThresholdSampler,
}


def get_sampler(name: str, **kwargs) -> ClientSampler:
    """Build a sampler by name: ``uniform`` | ``importance`` |
    ``threshold`` (kwargs go to its constructor)."""
    try:
        cls = _SAMPLERS[name]
    except KeyError:
        raise ValueError(
            f"unknown sampler {name!r}; known: {', '.join(sorted(_SAMPLERS))}"
        ) from None
    return cls(**kwargs)
