"""Composable federated strategies: sampling × masking × codec ×
aggregation (counterpart of ``repro/core/strategy.py``).

A :class:`FedStrategy` is one frozen record composing the sampling
schedule, the :class:`MaskPolicy`, the wire codec and the
:class:`Aggregator`, plus the client hyperparameters.  ``build_round``
turns it into the oracle (``form="full"``) or cohort (``form="cohort"``)
round; ``FederatedServer.from_strategy`` runs it end to end.  The registry
holds the paper presets of this slice: ``dense-baseline``, ``fig3``,
``fig4`` and ``fig5``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from repro_torch.core.client import ClientConfig
from repro_torch.core.codecs import IdentityCodec, SparseCodec, UploadCodec
from repro_torch.core.federated import (FederatedConfig, fedavg_aggregate,
                                        make_cohort_round,
                                        make_federated_round)
from repro_torch.core.masking import MaskingConfig
from repro_torch.core.objectives import LocalObjective
from repro_torch.core.sampling import (ClientSampler, DynamicSampling,
                                       SamplingSchedule, StaticSampling,
                                       UniformSampler)

__all__ = ["MaskPolicy", "Aggregator", "FEDAVG", "FedStrategy",
           "default_codec", "build_round", "register", "get", "names"]


@dataclasses.dataclass(frozen=True)
class MaskPolicy:
    """Which entries of the client delta survive the upload.  ``backend``
    selects the selective-top-k implementation: ``"jnp"`` (the name the
    reference gives it) is the fp32 threshold bisection, ``"kernel"`` the
    segmented CUDA kernels."""

    mode: str = "none"          # none | random | selective
    gamma: float = 1.0          # fraction KEPT (paper's masking rate)
    backend: str = "jnp"        # jnp | kernel
    min_leaf_size: int = 256
    bisect_iters: int = 24

    def __post_init__(self):
        """Validate mode, backend and gamma."""
        if self.mode not in ("none", "random", "selective"):
            raise ValueError(f"unknown masking mode {self.mode!r}")
        if self.backend not in ("jnp", "kernel"):
            raise ValueError(f"unknown masking backend {self.backend!r}")
        if not 0.0 < self.gamma <= 1.0:
            raise ValueError(f"gamma must be in (0, 1], got {self.gamma}")

    @classmethod
    def none(cls) -> "MaskPolicy":
        """Dense uploads: every delta entry survives."""
        return cls()

    @classmethod
    def random(cls, gamma: float, **kw) -> "MaskPolicy":
        """Keep a random ``gamma`` fraction of each maskable leaf."""
        return cls(mode="random", gamma=gamma, **kw)

    @classmethod
    def selective(cls, gamma: float, backend: str = "jnp",
                  **kw) -> "MaskPolicy":
        """Keep the top-``gamma`` fraction by magnitude (paper Alg. 4)."""
        return cls(mode="selective", gamma=gamma, backend=backend, **kw)

    def masking_config(self) -> MaskingConfig:
        """Lower the policy to the client-side :class:`MaskingConfig`."""
        return MaskingConfig(gamma=self.gamma, mode=self.mode,
                             min_leaf_size=self.min_leaf_size,
                             bisect_iters=self.bisect_iters,
                             use_kernel=self.backend == "kernel")


@dataclasses.dataclass(frozen=True)
class Aggregator:
    """Server-side combination rule ``fn(global_params, uploads, weights,
    upload_semantics, normalize=True) -> params`` over stacked uploads."""

    name: str
    fn: Callable


FEDAVG = Aggregator("fedavg", fedavg_aggregate)


def default_codec(masking: MaskPolicy) -> UploadCodec:
    """The wire a mask policy implies: identity for dense uploads, COO
    sized to gamma for masked ones (the reference's jnp/coo branch; its
    int8, bitmap and fused wires wait for ROADMAP Queue 1 items 6 and 9)."""
    if masking.mode == "none" or masking.gamma >= 1.0:
        return IdentityCodec()
    return SparseCodec(gamma=masking.gamma,
                       min_leaf_size=masking.min_leaf_size)


@dataclasses.dataclass(frozen=True)
class FedStrategy:
    """One federated-learning scenario as data (see module docstring)."""

    name: str
    sampling: SamplingSchedule
    masking: MaskPolicy = MaskPolicy()
    codec: UploadCodec = IdentityCodec()
    aggregator: Aggregator = FEDAVG
    sampler: ClientSampler = UniformSampler()
    local_epochs: int = 1
    learning_rate: float = 0.05
    momentum: float = 0.0
    upload: str = "delta"       # delta | zero (Alg. 4 literal)
    objective: LocalObjective = LocalObjective()

    def client_config(self) -> ClientConfig:
        """The per-client hyperparameter record this strategy implies."""
        return ClientConfig(local_epochs=self.local_epochs,
                            learning_rate=self.learning_rate,
                            momentum=self.momentum,
                            masking=self.masking.masking_config(),
                            upload=self.upload, objective=self.objective)

    def federated_config(self, num_clients: int) -> FederatedConfig:
        """The population-level round config for ``num_clients`` clients."""
        return FederatedConfig(num_clients=num_clients,
                               client=self.client_config())

    def with_masking(self, masking: MaskPolicy, **overrides) -> "FedStrategy":
        """Replace the mask policy AND re-derive a consistent codec (COO
        slot counts track gamma).  Pass ``codec=`` explicitly to opt out."""
        overrides.setdefault("codec", default_codec(masking))
        return dataclasses.replace(self, masking=masking, **overrides)

    @classmethod
    def from_components(cls, name: str, sampling: SamplingSchedule,
                        masking: MaskPolicy | None = None,
                        **overrides) -> "FedStrategy":
        """Build a strategy from (schedule, mask policy), deriving the
        matching codec."""
        masking = masking if masking is not None else MaskPolicy.none()
        overrides.setdefault("codec", default_codec(masking))
        return cls(name=name, sampling=sampling, masking=masking, **overrides)


def build_round(strategy: FedStrategy, loss_fn: Callable, num_clients: int,
                form: str = "full", cohort_size: int | None = None):
    """Build the round a strategy describes: ``form="full"`` (every client
    runs) or ``form="cohort"`` (a bucketed cohort of ``cohort_size``).  The
    reference's ``scan`` and ``store`` forms are XLA dispatch and
    store-boundary machinery the eager port does not need yet."""
    if form not in ("full", "cohort"):
        raise ValueError(f"unknown round form {form!r} (the port builds "
                         "'full' and 'cohort')")
    cfg = strategy.federated_config(num_clients)
    kw = dict(codec=strategy.codec, aggregator=strategy.aggregator,
              sampler=strategy.sampler)
    if form == "full":
        return make_federated_round(loss_fn, strategy.sampling, cfg, **kw)
    if cohort_size is None:
        raise ValueError("form='cohort' requires cohort_size")
    return make_cohort_round(loss_fn, strategy.sampling, cfg, cohort_size,
                             **kw)


_REGISTRY: Dict[str, FedStrategy] = {}


def register(strategy: FedStrategy, overwrite: bool = False) -> FedStrategy:
    """Add a strategy to the registry under its ``name``."""
    if not overwrite and strategy.name in _REGISTRY:
        raise ValueError(f"strategy {strategy.name!r} already registered")
    _REGISTRY[strategy.name] = strategy
    return strategy


def names() -> Tuple[str, ...]:
    """Sorted names of every registered preset."""
    return tuple(sorted(_REGISTRY))


def get(name: str, **overrides) -> FedStrategy:
    """Fetch a registered strategy, optionally with field overrides.
    Overriding ``masking`` without ``codec`` re-derives the codec."""
    try:
        base = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown strategy {name!r}; registered: "
                       f"{', '.join(names())}") from None
    if "masking" in overrides and "codec" not in overrides:
        return base.with_masking(overrides.pop("masking"), **overrides)
    return dataclasses.replace(base, **overrides) if overrides else base


# ---- paper presets --------------------------------------------------------
# "dense-baseline": Alg. 1 — full participation, dense uploads.
register(FedStrategy(
    name="dense-baseline",
    sampling=StaticSampling(initial_rate=1.0, min_clients=2)))

# "fig3": dynamic sampling alone (Alg. 3, beta = 0.1), dense uploads.
register(FedStrategy(
    name="fig3",
    sampling=DynamicSampling(initial_rate=1.0, beta=0.1, min_clients=2)))

# "fig4": selective masking alone (Alg. 4) at gamma = 0.1, COO wire.
register(FedStrategy.from_components(
    "fig4", StaticSampling(initial_rate=1.0, min_clients=2),
    MaskPolicy.selective(0.1)))

# "fig5": both levers (beta = 0.1, gamma = 0.5), COO wire.
register(FedStrategy.from_components(
    "fig5", DynamicSampling(initial_rate=1.0, beta=0.1, min_clients=2),
    MaskPolicy.selective(0.5)))
