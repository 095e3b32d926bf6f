"""Composable federated strategies: sampling × masking × codec ×
aggregation (counterpart of ``repro/core/strategy.py``).

A :class:`FedStrategy` is one frozen record composing the sampling
schedule, the :class:`MaskPolicy`, the wire codec, the :class:`Aggregator`,
the client sampler (uniform / importance / threshold), an optional
:class:`~repro_torch.core.hetero.HeteroModel` fleet, the local objective
and the async engine's :class:`~repro_torch.core.async_engine.AsyncConfig`
(``engine="async"``), plus the client hyperparameters.  ``build_round``
turns it into the oracle (``form="full"``), cohort (``form="cohort"``) or
store (``form="store"``) round; ``FederatedServer.from_strategy`` runs it
end to end.  The registry holds
the paper presets ``dense-baseline``, ``fig3``, ``fig4`` and ``fig5``, the
wire presets ``fig5-int8``, ``fig5-fused``, ``fig5-fused-int8`` and
``fig5-bitmap``, the adaptive-sampler and fleet presets
``fig3-importance`` and ``hetero-dropout``, the async presets
``async-mobile``, ``async-crossround`` and ``async-flaky``, the
objective presets ``fig5-prox``, ``fig5-dyn`` and ``noniid-dyn``, and the
Byzantine presets ``byzantine-signflip``, ``robust-median`` and
``robust-krum`` (an :class:`~repro_torch.core.attacks.AttackModel` on the
``attack`` axis, a rule of ``get_aggregator`` on the ``aggregator``
axis).  The codec has three axes (``default_codec``): int8 or not, the ``jnp`` codecs
or the ``fused`` kernel path, the ``coo`` or the ``bitmap`` wire;
replacing the mask policy re-derives the codec on the same axes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.async_engine import AsyncConfig
from repro_torch.core.attacks import AttackModel
from repro_torch.core.client import ClientConfig
from repro_torch.core.codecs import (BitmapCodec, ChainCodec,
                                     FusedSparseCodec, IdentityCodec,
                                     Int8Codec, SparseCodec, UploadCodec)
from repro_torch.core.federated import (FederatedConfig, _row_l2,
                                        fedavg_aggregate, make_cohort_round,
                                        make_cohort_scan,
                                        make_federated_round,
                                        make_store_round)
from repro_torch.core.hetero import HeteroModel
from repro_torch.core.masking import MaskingConfig
from repro_torch.core.objectives import LocalObjective
from repro_torch.core.sampling import (ClientSampler, DynamicSampling,
                                       ImportanceSampler, SamplingSchedule,
                                       StaticSampling, UniformSampler)

__all__ = ["MaskPolicy", "Aggregator", "FEDAVG", "clipped_fedavg",
           "get_aggregator", "aggregator_names", "FedStrategy",
           "default_codec", "build_round", "launches_kernels", "register",
           "get", "names"]


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

    @classmethod
    def from_masking_config(cls, cfg: MaskingConfig) -> "MaskPolicy":
        """Lift a client-side :class:`MaskingConfig` into a policy."""
        return cls(mode=cfg.mode, gamma=cfg.gamma,
                   backend="kernel" if cfg.use_kernel else "jnp",
                   min_leaf_size=cfg.min_leaf_size,
                   bisect_iters=cfg.bisect_iters)

    def masking_config(self) -> MaskingConfig:
        """Lower the policy to the client-side :class:`MaskingConfig`."""
        return MaskingConfig(gamma=self.gamma, mode=self.mode,
                             min_leaf_size=self.min_leaf_size,
                             bisect_iters=self.bisect_iters,
                             use_kernel=self.backend == "kernel")


@dataclasses.dataclass(frozen=True)
class Aggregator:
    """Server-side combination rule ``fn(global_params, uploads, weights,
    upload_semantics, normalize=True) -> params`` over stacked uploads;
    ``normalize=False`` means Horvitz-Thompson weights, used as they are.
    Zero-weight rows must be absent from the result.  ``ht_compatible=
    False`` (the Krum family: selection ignores weight magnitudes) makes a
    round that pairs the rule with an HT sampler raise a ``TypeError``
    when it is built."""

    name: str
    fn: Callable
    ht_compatible: bool = True


FEDAVG = Aggregator("fedavg", fedavg_aggregate)


def clipped_fedavg(max_norm: float) -> Aggregator:
    """FedAvg over per-client norm-clipped uploads: each row scaled by
    ``min(1, max_norm / ||u||)`` (the norm is ``federated._row_l2``'s).
    A zero upload stays zero."""
    if max_norm <= 0.0:
        raise ValueError(
            f"clipped_fedavg: max_norm must be > 0, got {max_norm}")

    def agg(global_params, uploads, weights, upload_semantics,
            normalize=True):
        factor = torch.clamp(
            max_norm / torch.clamp(_row_l2(uploads), min=1e-12), max=1.0)
        clipped = {k: u * factor.reshape((-1,) + (1,) * (u.dim() - 1))
                   for k, u in uploads.items()}
        return fedavg_aggregate(global_params, clipped, weights,
                                upload_semantics, normalize=normalize)

    return Aggregator(f"clipped_fedavg({max_norm})", agg)


# Imported after Aggregator is defined: robust.py builds its records from
# this module.
from repro_torch.core import robust as _robust  # noqa: E402

_AGGREGATORS: Dict[str, Callable[..., Aggregator]] = {
    "fedavg": lambda: FEDAVG,
    "clipped_fedavg": clipped_fedavg,
    "coordinate_median": _robust.coordinate_median,
    "trimmed_mean": _robust.trimmed_mean,
    "krum": _robust.krum,
    "multi_krum": _robust.multi_krum,
    "norm_filter": _robust.norm_filter,
}


def get_aggregator(name: str, *args, **kwargs) -> Aggregator:
    """Build a registered aggregator by factory name, knobs as arguments
    (``get_aggregator("trimmed_mean", 0.2)``)."""
    try:
        factory = _AGGREGATORS[name]
    except KeyError:
        raise KeyError(
            f"unknown aggregator {name!r}; registered: "
            f"{', '.join(aggregator_names())}") from None
    return factory(*args, **kwargs)


def aggregator_names() -> Tuple[str, ...]:
    """Sorted factory names accepted by :func:`get_aggregator`."""
    return tuple(sorted(_AGGREGATORS))


def default_codec(masking: MaskPolicy, quantized: bool = False,
                  backend: str = "jnp", wire: str = "coo") -> UploadCodec:
    """The wire a mask policy implies: identity for dense uploads, a sparse
    wire sized to gamma for masked ones; ``quantized`` chains int8 on the
    value payload.  ``backend="jnp"`` (the name the reference gives the
    plain codecs) picks ``SparseCodec`` (``wire="coo"``) or ``BitmapCodec``
    (``wire="bitmap"``); ``backend="fused"`` picks the kernel-backed
    :class:`FusedSparseCodec`, which emits the same wire."""
    if backend not in ("jnp", "fused"):
        raise ValueError(f"unknown codec backend {backend!r}")
    if wire not in ("coo", "bitmap"):
        raise ValueError(f"unknown wire format {wire!r}")
    if masking.mode == "none" or masking.gamma >= 1.0:
        base: UploadCodec = IdentityCodec()
        return ChainCodec((base, Int8Codec())) if quantized else base
    if backend == "fused":
        return FusedSparseCodec(gamma=masking.gamma,
                                min_leaf_size=masking.min_leaf_size,
                                quantized=quantized, wire=wire)
    base = (BitmapCodec if wire == "bitmap" else SparseCodec)(
        gamma=masking.gamma, min_leaf_size=masking.min_leaf_size)
    return ChainCodec((base, Int8Codec())) if quantized else base


def _quantizes(codec: UploadCodec) -> bool:
    if isinstance(codec, Int8Codec):
        return True
    if isinstance(codec, FusedSparseCodec):
        return codec.quantized
    if isinstance(codec, ChainCodec):
        return any(_quantizes(s) for s in codec.stages)
    return False


def _codec_backend(codec: UploadCodec) -> str:
    """The ``default_codec`` backend axis a codec sits on."""
    if isinstance(codec, FusedSparseCodec):
        return "fused"
    if isinstance(codec, ChainCodec) and any(
            _codec_backend(s) == "fused" for s in codec.stages):
        return "fused"
    return "jnp"


def _codec_wire(codec: UploadCodec) -> str:
    """The ``default_codec`` wire axis a codec sits on (coo | bitmap)."""
    if isinstance(codec, BitmapCodec):
        return "bitmap"
    if isinstance(codec, FusedSparseCodec):
        return codec.wire
    if isinstance(codec, ChainCodec) and any(
            _codec_wire(s) == "bitmap" for s in codec.stages):
        return "bitmap"
    return "coo"


@dataclasses.dataclass(frozen=True)
class FedStrategy:
    """One federated-learning scenario as data (see module docstring)."""

    name: str
    sampling: SamplingSchedule
    masking: MaskPolicy = MaskPolicy()
    codec: UploadCodec = IdentityCodec()
    aggregator: Aggregator = FEDAVG
    sampler: ClientSampler = UniformSampler()
    hetero: HeteroModel | None = None
    local_epochs: int = 1
    learning_rate: float = 0.05
    momentum: float = 0.0
    upload: str = "delta"       # delta | zero (Alg. 4 literal)
    error_feedback: bool = False
    objective: LocalObjective = LocalObjective()
    async_cfg: AsyncConfig | None = None
    attack: AttackModel | None = None

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
                               client=self.client_config(),
                               error_feedback=self.error_feedback)

    def replace(self, **overrides) -> "FedStrategy":
        """Functional field update (frozen-record ``dataclasses.replace``)."""
        return dataclasses.replace(self, **overrides)

    def with_masking(self, masking: MaskPolicy, **overrides) -> "FedStrategy":
        """Replace the mask policy AND re-derive a consistent codec (slot
        counts track gamma), keeping the current codec's int8, backend and
        wire axes.  Pass ``codec=`` explicitly to opt out."""
        if "codec" not in overrides:
            overrides["codec"] = default_codec(
                masking, quantized=_quantizes(self.codec),
                backend=_codec_backend(self.codec),
                wire=_codec_wire(self.codec))
        return dataclasses.replace(self, masking=masking, **overrides)

    @classmethod
    def from_components(cls, name: str, sampling: SamplingSchedule,
                        masking: MaskingConfig | MaskPolicy | None = None,
                        **overrides) -> "FedStrategy":
        """Build a strategy from (schedule, mask policy or client-side
        :class:`MaskingConfig`), deriving the matching codec."""
        if masking is None:
            masking = MaskPolicy.none()
        elif isinstance(masking, MaskingConfig):
            masking = MaskPolicy.from_masking_config(masking)
        overrides.setdefault("codec", default_codec(masking))
        return cls(name=name, sampling=sampling, masking=masking, **overrides)


def build_round(strategy: FedStrategy, loss_fn: Callable, num_clients: int,
                form: str = "full", cohort_size: int | None = None):
    """Build the round a strategy describes: ``form="full"`` (every client
    runs), ``form="cohort"`` (a bucketed cohort of ``cohort_size``),
    ``form="scan"`` (a segment of rounds of one bucket in one call, the
    oracle when ``cohort_size == num_clients``: a
    :class:`~repro_torch.core.federated.CohortScan`, whose rounds replay a
    CUDA graph on a card) or ``form="store"`` (the cohort round split at
    the client-state store boundary: a
    :class:`~repro_torch.core.federated.StoreRound`)."""
    if form not in ("full", "cohort", "scan", "store"):
        raise ValueError(f"unknown round form {form!r} (the port builds "
                         "'full', 'cohort', 'scan' and 'store')")
    cfg = strategy.federated_config(num_clients)
    kw = dict(codec=strategy.codec, aggregator=strategy.aggregator,
              sampler=strategy.sampler, hetero=strategy.hetero,
              attack=strategy.attack)
    if form == "full":
        return make_federated_round(loss_fn, strategy.sampling, cfg, **kw)
    if cohort_size is None:
        raise ValueError(f"form={form!r} requires cohort_size")
    make = {"cohort": make_cohort_round, "scan": make_cohort_scan,
            "store": make_store_round}[form]
    return make(loss_fn, strategy.sampling, cfg, cohort_size, **kw)


def launches_kernels(strategy: FedStrategy) -> bool:
    """Whether the round ``strategy`` builds launches the CUDA kernels:
    selective masking on the ``kernel`` backend that keeps less than the
    whole delta, or a codec on the ``fused`` backend."""
    m = strategy.masking
    masks = m.mode == "selective" and m.backend == "kernel" and m.gamma < 1.0
    return masks or _codec_backend(strategy.codec) == "fused"


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

# "fig5-int8": fig5 with the COO value payload int8-quantised (4 -> 1 bytes
# per kept value; lossy, error <= scale / 2 per entry).
register(get("fig5").with_masking(
    MaskPolicy.selective(0.5),
    codec=ChainCodec((SparseCodec(gamma=0.5), Int8Codec())),
    name="fig5-int8"))

# "fig5-fused": fig5's operating point on the kernel-backed wire path: the
# COO payload comes out of one segmented_encode sweep; wire bytes and
# decoded values are fig5's.
register(get("fig5").replace(
    name="fig5-fused",
    codec=default_codec(MaskPolicy.selective(0.5), backend="fused")))

# "fig5-fused-int8": the fused wire with int8 values quantised in the same
# sweep (the scales come from one segmented_stats sweep); byte-identical to
# fig5-int8's wire.
register(get("fig5").replace(
    name="fig5-fused-int8",
    codec=default_codec(MaskPolicy.selective(0.5), quantized=True,
                        backend="fused")))

# "fig5-bitmap": fig5 over the 1-bit/coordinate membership bitmap wire (the
# plain BitmapCodec); at gamma = 0.5 it costs n/8 bytes of membership where
# COO indices cost 4k = 2n.  The fused bitmap wire is
# default_codec(..., backend="fused", wire="bitmap").
register(get("fig5").replace(
    name="fig5-bitmap",
    codec=default_codec(MaskPolicy.selective(0.5), wire="bitmap")))

# "fig3-importance": fig3's dynamic c(t), but the m_t clients are chosen by
# tracked update-norm importance with Horvitz-Thompson weights.
register(FedStrategy(
    name="fig3-importance",
    sampling=DynamicSampling(initial_rate=1.0, beta=0.1, min_clients=2),
    sampler=ImportanceSampler()))

# "hetero-dropout": full-participation dense rounds on the flaky-mobile
# fleet (lognormal compute/latency/uplink spread, 20% of uploads lost),
# metered as sim_round_s / dropped in the server's records.
register(FedStrategy(
    name="hetero-dropout",
    sampling=StaticSampling(initial_rate=1.0, min_clients=2),
    hetero=HeteroModel(profile="flaky-mobile")))

# "async-mobile": fig3's dynamic c(t) on the mobile fleet, aggregated
# asynchronously: flush every K = m_t / 2 arrivals with the staleness
# discount, cut the round at the 90th arrival percentile, retry lost uploads
# twice with backoff.
register(FedStrategy(
    name="async-mobile",
    sampling=DynamicSampling(initial_rate=1.0, beta=0.1, min_clients=2),
    hetero=HeteroModel(profile="mobile"),
    async_cfg=AsyncConfig(buffer_frac=0.5, staleness_beta=0.5,
                          deadline_quantile=0.9, max_retries=2,
                          backoff_s=0.5, jitter_sigma=0.25)))

# "async-crossround": async-mobile with the median arrival as deadline and
# cross-round staleness: uploads cut at the deadline land in a later round,
# discounted by the rounds since their client pulled Θ, and expire past 3.
# It needs the store's version vector (any backend).
register(FedStrategy(
    name="async-crossround",
    sampling=DynamicSampling(initial_rate=1.0, beta=0.1, min_clients=2),
    hetero=HeteroModel(profile="mobile"),
    async_cfg=AsyncConfig(buffer_frac=0.5, staleness_beta=0.5,
                          deadline_quantile=0.5, max_retries=2,
                          backoff_s=0.5, jitter_sigma=0.25,
                          max_round_stale=3)))

# "async-flaky": the async engine on the flaky-mobile fleet, deadline at the
# 75th percentile, three retries: the chaos scenario.
register(FedStrategy(
    name="async-flaky",
    sampling=DynamicSampling(initial_rate=1.0, beta=0.1, min_clients=2),
    hetero=HeteroModel(profile="flaky-mobile"),
    async_cfg=AsyncConfig(buffer_frac=0.5, staleness_beta=0.5,
                          deadline_quantile=0.75, max_retries=3,
                          backoff_s=0.5, jitter_sigma=0.25)))

# "fig5-prox": fig5 with the FedProx proximal term (mu = 0.1).
register(get("fig5").replace(
    name="fig5-prox",
    objective=LocalObjective.prox(0.1)))

# "fig5-dyn": fig5 under FedDyn (alpha = 0.1), the per-client drift in the
# client-state store, updated on the honest pre-mask delta.
register(get("fig5").replace(
    name="fig5-dyn",
    objective=LocalObjective.dyn(0.1)))

# "noniid-dyn": the non-IID flagship, fig5-dyn with importance-sampled
# client selection.
register(get("fig5-dyn").replace(
    name="noniid-dyn",
    sampler=ImportanceSampler()))

# ---- Byzantine-robustness presets ------------------------------------------
# All three run fig5's sparse operating point (beta = 0.1, gamma = 0.5, COO
# wire) with a sampling floor of 5, which keeps every cohort an honest
# majority at f = 0.3 and gives Krum the n >= f + 3 candidates it needs.
_ROBUST_SAMPLING = DynamicSampling(initial_rate=1.0, beta=0.1, min_clients=5)
# Amplified sign flip: at strength 4 and f = 0.3 the FedAvg mean is
# 0.7 u - 1.2 u = -0.5 u, an ascent direction.
_SIGNFLIP = AttackModel(kind="sign_flip", fraction=0.3, strength=4.0)

# "byzantine-signflip": the attacked baseline, plain FedAvg.
register(get("fig5").replace(
    name="byzantine-signflip",
    sampling=_ROBUST_SAMPLING,
    attack=_SIGNFLIP))

# "robust-median": the same attacked fleet under the coordinate-wise
# weighted median (breakdown point 1/2).
register(get("byzantine-signflip").replace(
    name="robust-median",
    aggregator=_robust.coordinate_median()))

# "robust-krum": the same attacked fleet under multi-Krum (f = 2 suspected
# rows, the m = 2 most central candidates averaged).
register(get("byzantine-signflip").replace(
    name="robust-krum",
    aggregator=_robust.multi_krum(f=2, m=2)))
