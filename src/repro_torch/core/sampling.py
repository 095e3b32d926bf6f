"""Client sampling: how MANY clients per round, and WHICH ones (counterpart
of ``repro/core/sampling.py``).

* :class:`SamplingSchedule` — the participation fraction ``c(t)``; dynamic
  sampling anneals ``c(t) = C * exp(-beta * t)`` (Eq. 3) in float32, floored
  at ``min_clients``.  The rate is always evaluated on the CPU, so a run on
  the card picks the same m_t as one on the CPU.
* :class:`UniformSampler` — the paper's rule: m_t clients uniformly at
  random.  Selection functions take the round's uniform ``scores`` (one per
  registered client) instead of drawing them, so a caller can hand in the
  reference's draws; the server draws them from its own generator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "SamplingSchedule",
    "StaticSampling",
    "DynamicSampling",
    "participation_mask",
    "transport_cost",
    "ClientSampler",
    "UniformSampler",
]


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


@dataclasses.dataclass(frozen=True)
class ClientSampler:
    """Base client-selection policy: :meth:`select` returns ``(part,
    weights)`` — the float 0/1 participation mask over the M clients and
    the aggregation coefficients (self-normalized by FedAvg)."""

    name = "uniform"

    def cohort_bucket(self, schedule: SamplingSchedule, m: int,
                      num_registered: int) -> int:
        """Static cohort-buffer size for a round with nominal m
        participants."""
        return schedule.bucket_for(m, num_registered)

    def select(self, scores: torch.Tensor, schedule: SamplingSchedule, t,
               num_registered: int, n_samples: torch.Tensor):
        """Pick round ``t``'s participants from the uniform ``scores``."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class UniformSampler(ClientSampler):
    """The paper's selection rule: m_t clients uniformly at random; weights
    are the masked dataset sizes (self-normalized, Eq. 2)."""

    def select(self, scores, schedule, t, num_registered, n_samples):
        """``part`` from :func:`participation_mask`, weights
        ``part * n_samples``."""
        part = participation_mask(scores, schedule, t, num_registered)
        part = part.to(n_samples.device)
        return part, part * n_samples
