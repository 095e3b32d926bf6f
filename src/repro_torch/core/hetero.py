"""Heterogeneous-client round simulator (counterpart of
``repro/core/hetero.py``; numpy only, the same trait draws for the same
``(profile, seed, num_clients)``).

The paper's simulation treats every client as identical hardware on an
ideal network.  This module models a real fleet:

* :class:`HeteroModel` — a named profile (``ideal`` / ``mobile`` /
  ``flaky-mobile``) plus a seed; draws static per-client traits.
* :class:`ClientTraits` — the drawn per-client hardware/network vectors
  (compute FLOP/s, round-trip latency, uplink bits/s, upload drop rate).
* :func:`simulate_round` — given who participated / whose upload arrived
  and the per-client compute + wire-byte cost, the simulated round
  wall-clock (the straggler max), its straggler tail, and the dropped count.
* :func:`arrival_stream` — the same completion-time model as a
  time-ordered event sequence ``(arrival_s, client_id)``, the input of an
  asynchronous buffered-aggregation engine.

The *drop draws* run inside the round (they change the aggregation and the
state commits, so both execution forms must see the same draws; the round
builders of ``repro_torch.core.federated`` close over
``HeteroModel.drop_rates``), while the *clock* is host-side metering here,
fed by the participation masks the round returns (``FederatedServer``
records ``sim_round_s`` / ``straggler_s`` / ``dropped`` per round next to
the measured ``wall_s``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["ClientTraits", "HeteroModel", "simulate_round", "profile_names",
           "arrival_stream", "MAX_DROP_RATE"]

# Upload-loss probabilities are clamped here.  Horvitz-Thompson weights
# divide by the survival probability ``1 - q`` (``_apply_dropout`` in
# ``repro_torch.core.federated``), so an unclamped q -> 1 would inflate a single
# client's weight without bound; at q <= 0.5 the inflation factor is <= 2.
# A fleet losing more than half its uploads is an outage, not a profile.
MAX_DROP_RATE = 0.5


@dataclasses.dataclass(frozen=True)
class ClientTraits:
    """Static per-client hardware/network draws (host-side numpy).

    ``flops_per_s`` — sustained client compute throughput; ``latency_s`` —
    fixed per-round overhead (connection + scheduling RTTs); ``uplink_bps``
    — upload bandwidth in bits/s; ``drop_rate`` — probability a finished
    upload is lost before the server sees it.
    """

    flops_per_s: np.ndarray
    latency_s: np.ndarray
    uplink_bps: np.ndarray
    drop_rate: np.ndarray

    def client_time_s(self, flops: float, upload_bytes: int) -> np.ndarray:
        """Per-client completion time for one round of ``flops`` local work
        followed by an ``upload_bytes`` upload."""
        return (self.latency_s + flops / self.flops_per_s
                + 8.0 * upload_bytes / self.uplink_bps)

    def upload_time_s(self, upload_bytes: int) -> np.ndarray:
        """Per-client wire time to (re)send an ``upload_bytes`` payload —
        the marginal cost of a retry, which resends cached bytes without
        recomputing the local update."""
        return 8.0 * upload_bytes / self.uplink_bps

    def arrival_times_s(self, flops: float, upload_bytes: int,
                        rng: np.random.Generator | None = None,
                        jitter_sigma: float = 0.0) -> np.ndarray:
        """Per-client first-attempt arrival times for one round.

        The static :meth:`client_time_s` base, optionally multiplied by a
        per-round lognormal jitter draw (``jitter_sigma > 0`` needs
        ``rng``) so repeated rounds do not always see the same straggler.
        """
        base = np.asarray(self.client_time_s(flops, upload_bytes),
                          np.float64)
        if jitter_sigma > 0.0:
            if rng is None:
                raise ValueError("jitter_sigma > 0 requires an rng")
            base = base * np.exp(rng.normal(0.0, jitter_sigma, base.shape))
        return base


# Named profiles: (median, lognormal sigma) per trait + drop rate.  Medians
# are deliberately round "systems" numbers, not measurements — the point is
# realistic *spread* (stragglers, slow uplinks), not calibration.
_PROFILES: Dict[str, Dict[str, tuple]] = {
    # every client identical, infinite-speed network, nothing dropped
    "ideal": {"flops": (1e10, 0.0), "latency": (0.0, 0.0),
              "uplink": (1e12, 0.0), "drop": 0.0},
    # phones: ~2 GFLOP/s median spread over ~an order of magnitude,
    # 100 ms overheads, ~8 Mbit/s uplinks, 5% of uploads lost
    "mobile": {"flops": (2e9, 0.6), "latency": (0.1, 0.5),
               "uplink": (8e6, 0.8), "drop": 0.05},
    # same fleet on a bad day: every fifth upload lost
    "flaky-mobile": {"flops": (2e9, 0.6), "latency": (0.1, 0.5),
                     "uplink": (8e6, 0.8), "drop": 0.2},
}


def profile_names() -> tuple:
    """Names accepted by :class:`HeteroModel` (sorted)."""
    return tuple(sorted(_PROFILES))


@dataclasses.dataclass(frozen=True)
class HeteroModel:
    """A named heterogeneity profile: which fleet the simulation runs on.

    ``dropout`` overrides the profile's upload-loss rate when set (the
    ``hetero-dropout`` strategy preset uses the profile default); whatever
    the source, the effective per-client rate is clamped at
    :data:`MAX_DROP_RATE` so debiasing weights stay bounded.  Draws are
    deterministic in ``(profile, seed, num_clients)`` so both execution
    engines and repeated runs see the same fleet.
    """

    profile: str = "mobile"
    seed: int = 0
    dropout: float | None = None

    def __post_init__(self):
        """Validate the profile name and dropout override."""
        if self.profile not in _PROFILES:
            raise ValueError(
                f"unknown hetero profile {self.profile!r}; known: "
                f"{', '.join(profile_names())}")
        if self.dropout is not None and not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {self.dropout}")

    def client_traits(self, num_clients: int) -> ClientTraits:
        """Draw the static per-client trait vectors for this fleet."""
        spec = _PROFILES[self.profile]
        rng = np.random.default_rng((self.seed, num_clients, 0xFED))

        def lognormal(median, sigma):
            if sigma == 0.0:
                return np.full((num_clients,), median, np.float64)
            return median * np.exp(rng.normal(0.0, sigma, (num_clients,)))

        drop = self.dropout if self.dropout is not None else spec["drop"]
        # Clamp at MAX_DROP_RATE so the Horvitz-Thompson 1/(1-q) dropout
        # correction stays bounded (<= 2x) however lossy the override.
        drop = min(float(drop), MAX_DROP_RATE)
        return ClientTraits(
            flops_per_s=lognormal(*spec["flops"]),
            latency_s=lognormal(*spec["latency"]),
            uplink_bps=lognormal(*spec["uplink"]),
            drop_rate=np.full((num_clients,), drop, np.float64),
        )

    def drop_rates(self, num_clients: int) -> np.ndarray:
        """Per-client upload-loss probabilities — the only trait the round
        program itself consumes (the drop draw changes aggregation)."""
        return self.client_traits(num_clients).drop_rate


def simulate_round(traits: ClientTraits, part: np.ndarray,
                   arrived: np.ndarray, flops: float,
                   upload_bytes: int) -> Dict[str, float]:
    """Meter one round on the simulated fleet.

    ``part`` / ``arrived`` are the round's 0/1 masks over all registered
    clients (who computed+uploaded, whose upload the server received).  The
    server waits for every upload it receives, so the simulated round
    wall-clock is the max completion time over *arrived* clients — the
    straggler — and ``straggler_s`` is how far that max sits above the
    median arrival (the tail the cohort engine cannot hide).  Dropped
    uploads cost their clients the work but the server nothing extra under
    this model (loss is detected asynchronously).
    """
    part = np.asarray(part, bool)
    arrived = np.asarray(arrived, bool)
    times = np.asarray(traits.client_time_s(flops, upload_bytes))
    at = times[arrived]
    round_s = float(at.max()) if at.size else 0.0
    median_s = float(np.median(at)) if at.size else 0.0
    return {
        "sim_round_s": round_s,
        "straggler_s": round_s - median_s,
        "dropped": int(part.sum() - arrived.sum()),
    }


def arrival_stream(traits: ClientTraits, part: np.ndarray, flops: float,
                   upload_bytes: int, rng: np.random.Generator | None = None,
                   jitter_sigma: float = 0.0):
    """Yield this round's upload arrivals as time-ordered events.

    ``part`` is the 0/1 participation mask over all registered clients;
    each participant's first transmission completes at its
    :meth:`ClientTraits.arrival_times_s` draw.  Yields ``(arrival_s,
    client_id)`` sorted by ``(time, client id)`` — the deterministic tie
    break matters on the ``ideal`` fleet, where every arrival lands on the
    same instant.  Retries, drops and deadlines are the *consumer's* story
    (an asynchronous engine); this is only the fault-free first-attempt
    stream the failure model perturbs.
    """
    times = traits.arrival_times_s(flops, upload_bytes, rng, jitter_sigma)
    ids = np.flatnonzero(np.asarray(part) > 0)
    for t_s, cid in sorted(zip(times[ids].tolist(), ids.tolist())):
        yield float(t_s), int(cid)
