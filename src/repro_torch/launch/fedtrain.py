"""The paper's federated round applied to the model zoo (counterpart of
``repro/launch/fedtrain.py``): each client runs local SGD on
``transformer.lm_loss``, its whole-model delta is selectively masked, the
masked delta crosses the strategy codec's wire, and the server adds the
weighted bf16 uploads, accumulated in fp32.

* ``FedPodConfig`` / ``FedPodConfig.from_strategy`` -- the mask policy,
  ``use_kernel = backend == "kernel"``, the codec re-budgeted per
  first-axis slice (``codecs.with_axis0_slices``) and the sampler's weight
  semantics from one ``FedStrategy``.
* ``mask_deltas`` -- per client, every leaf of at least ``min_leaf_size``
  elements is masked per first-axis slice when ndim >= 2 (Alg. 4's
  per-layer loop over the stacked layers) and whole otherwise.  The kernel
  route makes one ``ops.topk_mask_pytree(..., axis0_slices=True)`` call a
  client (segmented histogram, ``_refine_sweeps_for(bisect_iters)`` count
  sweeps, apply); the other route is ``_threshold_mask``'s bisection (plain
  torch; the reference's is jnp, no Pallas kernel) or ``_random_mask``.
* ``make_fed_round`` -- every registered client runs, as in the reference;
  a non-participant has weight 0 but is computed.
* ``make_cohort_fed_round`` -- the cohort form on ``torch.distributed``:
  each rank runs its contiguous share of the cohort end to end, then one
  fp32 ``all_reduce`` each of the aggregate, the loss sum and the valid
  count (NCCL on the card, gloo on the CPU).

The port runs one client at a time where the reference vmaps over them:
its local update, mask, wire round trip and weighted add, then the next
client.  So memory holds one client's delta and masked buffer, not C of
each (at full-width qwen2-1.5b one client's packed buffer is 6.49 GB).

Random masking draws a client's scores from ``masking.client_mask_scores``
keyed by the round's ``key = (seed, t)``, the client's registered id and
the leaf, or takes them from the caller (``mask_scores``), so the full
form and the cohort form give a client the same mask on any world size.
The reference's "masking caveat" (its cohort form draws per shard, so its
random masks vary with the device count) does not carry over.

Not ported: ``fed_layout`` and ``lower_fed_round`` are the reference's XLA
mesh layout and ahead-of-time lowering for the dry-run; one card has no
mesh to lay clients out on and nothing to lower ahead of time, so they
have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.codecs import roundtrip_stacked, with_axis0_slices
from repro_torch.core.masking import (_kept_count, _refine_sweeps_for,
                                      client_mask_scores, random_keep,
                                      threshold_for_topk)
from repro_torch.models import transformer as tr

Tree = Dict[str, torch.Tensor]

__all__ = ["FedPodConfig", "mask_deltas", "make_fed_round",
           "make_cohort_fed_round"]


@dataclasses.dataclass(frozen=True)
class FedPodConfig:
    """Pod-round configuration.  Prefer :meth:`from_strategy`; the loose
    fields remain for scripts that predate the strategy API."""

    num_clients: int
    local_steps: int = 2          # local SGD steps per round (E)
    learning_rate: float = 0.01
    gamma: float = 0.1            # fraction of params kept
    masking: str = "selective"    # selective | random | none
    bisect_iters: int = 16
    min_leaf_size: int = 256
    # Selective masking on the segmented CUDA kernels (one sweep set per
    # client for the whole model) instead of the bisection.
    use_kernel: bool = False
    # Wire codec: every client's masked delta crosses encode -> wire ->
    # decode before the weighted sum.  None = dense upload.
    codec: Any = None
    # True: participation is a 0/1 mask, weighted by n_samples and
    # re-normalised to sum 1.  False: participation already holds the
    # final aggregation weights (a sampler's Horvitz-Thompson weights).
    normalize: bool = True

    @classmethod
    def from_strategy(cls, strategy, num_clients: int,
                      local_steps: int = 2) -> "FedPodConfig":
        """The pod round of a ``FedStrategy``: its mask policy, learning
        rate and sampler weight semantics, and its codec with every sparse
        stage budgeted per first-axis slice, so the wire never truncates a
        within-budget upload."""
        mp = strategy.masking
        return cls(num_clients=num_clients, local_steps=local_steps,
                   learning_rate=strategy.learning_rate, gamma=mp.gamma,
                   masking=mp.mode, bisect_iters=mp.bisect_iters,
                   min_leaf_size=mp.min_leaf_size,
                   use_kernel=mp.backend == "kernel",
                   codec=with_axis0_slices(strategy.codec),
                   normalize=strategy.sampler.normalize)


def _lead(delta: torch.Tensor) -> Tuple[int, ...]:
    """The per-mask leading dims of a client-stacked leaf: (C, G) for an
    ndim >= 2 leaf (per first-axis slice), (C,) for a vector."""
    return tuple(delta.shape[:2] if delta.dim() > 2 else delta.shape[:1])


def _threshold_mask(delta: torch.Tensor, gamma: float,
                    iters: int) -> torch.Tensor:
    """Threshold-bisection top-|delta| mask over the last dims of a (C,
    ...) or (C, G, ...) stack: per block, ``iters`` fp32 halvings of [0,
    max + 1e-12] to the conservative end ``hi``, then keep ``|x| >=
    hi``.  Dropped entries become +0.0 (a select, where the reference
    multiplies by the 0/1 mask)."""
    lead = _lead(delta)
    flat = delta.reshape(lead + (-1,))
    mag = flat.float().abs()
    tau = threshold_for_topk(mag, _kept_count(flat.shape[-1], gamma), iters)
    keep = mag >= tau[..., None]
    return torch.where(keep, flat, torch.zeros_like(flat)).reshape(
        delta.shape)


def _random_mask(delta: torch.Tensor, gamma: float,
                 scores: torch.Tensor) -> torch.Tensor:
    """Exact-count random mask per block of ``_threshold_mask``'s
    granularity: the k = max(1, round(gamma * n)) entries of lowest
    ``scores`` (uniforms, one per entry), ties to the lower index, as
    ``lax.top_k(-scores, k)`` takes them."""
    lead = _lead(delta)
    flat = delta.reshape(lead + (-1,))
    n = flat.shape[-1]
    keep = random_keep(scores.reshape(-1, n).to(flat.device), gamma)
    return torch.where(keep.reshape(flat.shape), flat,
                       torch.zeros_like(flat)).reshape(delta.shape)


def mask_deltas(deltas: Tree, cfg: FedPodConfig,
                scores: Optional[Tree] = None) -> Tree:
    """Mask a client-stacked delta tree (leading C axis on every leaf).

    Leaves under ``cfg.min_leaf_size`` elements a client pass dense.
    Random masking needs ``scores``: one (C, *shape) uniform tensor per
    maskable leaf.  The kernel route masks one client at a time."""
    if cfg.masking == "none" or cfg.gamma >= 1.0:
        return deltas
    if cfg.masking == "selective" and cfg.use_kernel:
        from repro_torch.kernels import ops
        num_clients = next(iter(deltas.values())).shape[0]
        per_client = [ops.topk_mask_pytree(
            {n: leaf[c] for n, leaf in deltas.items()}, cfg.gamma,
            min_leaf_size=cfg.min_leaf_size,
            refine_sweeps=_refine_sweeps_for(cfg.bisect_iters),
            axis0_slices=True) for c in range(num_clients)]
        if num_clients == 1:
            return {n: leaf[None] for n, leaf in per_client[0].items()}
        return {n: torch.stack([m[n] for m in per_client])
                for n in deltas}
    if cfg.masking not in ("random", "selective"):
        raise ValueError(f"unknown masking mode {cfg.masking!r}")
    if cfg.masking == "random" and scores is None:
        raise ValueError("random masking needs per-entry scores")
    out = {}
    for name, leaf in deltas.items():
        if leaf[0].numel() < cfg.min_leaf_size:
            out[name] = leaf
        elif cfg.masking == "random":
            out[name] = _random_mask(leaf, cfg.gamma, scores[name])
        else:
            out[name] = _threshold_mask(leaf, cfg.gamma, cfg.bisect_iters)
    return out


def _make_local_update(arch: ArchConfig, cfg: FedPodConfig) -> Callable:
    """``local_update(params, batches) -> (delta, mean loss)``: E SGD
    steps on ``lm_loss`` over ``batches`` ({"tokens", "labels"}, each (E,
    b, T), or (E, b, K, T) for audio; a vision config's also
    ``"prefix_embeds"`` (E, b, P, d)), each ``x - lr * g`` in x's dtype.
    One definition for both round forms.  ``params`` is not modified."""
    if cfg.local_steps < 1:
        raise ValueError(f"local_steps must be at least 1, got "
                         f"{cfg.local_steps}")
    lr = cfg.learning_rate

    def local_update(params: Tree, batches: Tree):
        local = params
        losses = []
        for e in range(cfg.local_steps):
            leaves = {k: t.detach().requires_grad_() for k, t in local.items()}
            batch = {k: v[e] for k, v in batches.items()}
            with torch.enable_grad():
                loss = tr.lm_loss(leaves, arch, batch)
                grads = torch.autograd.grad(loss, list(leaves.values()))
            losses.append(loss.detach().float())
            with torch.no_grad():
                if local is params:         # the first step: a new copy
                    local = {k: x.detach() - lr * g
                             for (k, x), g in zip(leaves.items(), grads)}
                else:                       # x - lr * g, in place
                    for x, g in zip(local.values(), grads):
                        x.sub_(lr * g)
            del grads, leaves, loss
        with torch.no_grad():               # local - params, in place
            delta = {k: local[k].sub_(params[k]) for k in params}
        return delta, torch.stack(losses).mean()

    return local_update


def _weights(values: torch.Tensor, n_samples: torch.Tensor,
             normalize: bool) -> torch.Tensor:
    """fp32 aggregation weights on the CPU: ``values * n_samples``
    normalised to sum 1, or ``values`` as given (pre-weighted)."""
    values = torch.as_tensor(values, dtype=torch.float32).cpu()
    if not normalize:
        return values
    w = values * torch.as_tensor(n_samples, dtype=torch.float32).cpu()
    return w / torch.clamp(w.sum(), min=1e-12)


def _accumulate(acc: torch.Tensor, delta: torch.Tensor,
                weight: float) -> None:
    """``acc += bf16(weight) * bf16(delta)`` in fp32: the product of two
    bf16 values is exact in fp32, so only the order of the sum differs
    from the reference's ``preferred_element_type=f32`` contraction."""
    wb = float(torch.tensor(weight).to(torch.bfloat16))
    acc += delta.to(torch.bfloat16).float() * wb


def _weighted_upload(w: torch.Tensor, masked: Tree) -> Tree:
    """Client-axis weighted sum of stacked masked deltas, in fp32: the
    sum over c of ``bf16(w[c]) * bf16(masked[c])``, client by client."""
    out = {}
    for name, leaf in masked.items():
        acc = torch.zeros(leaf.shape[1:], dtype=torch.float32,
                          device=leaf.device)
        for c in range(leaf.shape[0]):
            _accumulate(acc, leaf[c], float(w[c]))
        out[name] = acc
    return out


class _Upload:
    """One fp32 buffer holding the round's aggregate, leaf by leaf (so one
    ``all_reduce`` covers it), and the wire round trip and weighted add of
    one client's masked delta."""

    def __init__(self, params: Tree, codec):
        dev = next(iter(params.values())).device
        total = sum(p.numel() for p in params.values())
        self.flat = torch.zeros((total,), dtype=torch.float32, device=dev)
        self.leaves, at = {}, 0
        for name, p in params.items():
            self.leaves[name] = self.flat[at:at + p.numel()].view(p.shape)
            at += p.numel()
        self.codec = codec

    def add(self, masked: Tree, weight: float) -> None:
        """Round-trip one client's (1, ...)-stacked masked delta through
        the codec, leaf by leaf, and add ``bf16(weight) * bf16(wire)``."""
        for name in list(masked):
            wired = roundtrip_stacked(self.codec, {name: masked.pop(name)})
            _accumulate(self.leaves[name], wired[name][0], weight)

    def apply(self, params: Tree) -> Tree:
        """``p + aggregate`` in each parameter's dtype."""
        return {k: p + self.leaves[k].to(p.dtype) for k, p in params.items()}


def _client_scores(cfg: FedPodConfig, key, mask_scores, client: int,
                   params: Tree) -> Optional[Tree]:
    """Random-mask scores of one client, (1, *shape) per maskable leaf."""
    if cfg.masking != "random" or cfg.gamma >= 1.0:
        return None
    if mask_scores is not None:
        return mask_scores([client])
    seed, t = key
    shapes = {k: tuple(p.shape) for k, p in params.items()
              if p.numel() >= cfg.min_leaf_size}
    dev = next(iter(params.values())).device
    return client_mask_scores(seed, t, [client], shapes, device=dev)


def _run_client(local_update, cfg: FedPodConfig, params: Tree,
                batches: Tree, client: int, key, mask_scores, upload: _Upload,
                weight: float, observe) -> torch.Tensor:
    """One client end to end: local SGD, mask, wire, weighted add.
    Returns its mean loss."""
    dev = next(iter(params.values())).device
    mine = {k: v[client].to(dev) for k, v in batches.items()}
    delta, loss = local_update(params, mine)
    stacked = {k: d[None] for k, d in delta.items()}
    del delta
    scores = _client_scores(cfg, key, mask_scores, client, params)
    with torch.no_grad():
        masked = mask_deltas(stacked, cfg, scores)
        if observe is not None:
            observe(client, stacked, dict(masked))
        del stacked
        upload.add(masked, weight)
    return loss


def make_fed_round(arch: ArchConfig, cfg: FedPodConfig,
                   observe: Optional[Callable] = None) -> Callable:
    """Returns ``round(params, batches, n_samples, participation, key=(0,
    0), mask_scores=None) -> (new params, metrics)``.

    batches: {"tokens", "labels"}, each (C, local_steps, b, T) int, or
    (C, local_steps, b, K, T) for audio, and for a vision config
    ``"prefix_embeds"`` (C, local_steps, b, P, d), the reference's
    ``lower_fed_round`` layout; n_samples, participation: (C,).  Every
    client runs; participation (or, with ``normalize=False``, the given
    weights) weights its upload.
    ``key = (seed, t)`` keys random masking's scores; ``mask_scores(ids)
    -> {leaf: (len(ids), *shape)}`` replaces them.  ``observe(client,
    delta, masked)``, when given, sees each client's (1, ...)-stacked
    delta and mask.  metrics: ``mean_loss`` over the participants and
    ``num_sampled``, 0-d fp32 tensors."""
    local_update = _make_local_update(arch, cfg)

    def fed_round(params: Tree, batches: Tree, n_samples, participation,
                  key: Tuple[int, int] = (0, 0), mask_scores=None):
        part = torch.as_tensor(participation, dtype=torch.float32).cpu()
        w = _weights(part, n_samples, cfg.normalize)
        upload = _Upload(params, cfg.codec)
        losses = [_run_client(local_update, cfg, params, batches, c, key,
                              mask_scores, upload, float(w[c]), observe)
                  for c in range(cfg.num_clients)]
        with torch.no_grad():
            new_params = upload.apply(params)
            active = (part > 0).to(torch.float32).to(losses[0].device)
            num = active.sum()
            mean = (torch.stack(losses) * active).sum() / torch.clamp(
                num, min=1.0)
        return new_params, {"mean_loss": mean, "num_sampled": num}

    return fed_round


def make_cohort_fed_round(arch: ArchConfig, cfg: FedPodConfig,
                          cohort_size: int, group=None,
                          observe: Optional[Callable] = None) -> Callable:
    """Cohort form of :func:`make_fed_round` on ``torch.distributed``:
    only the sampled cohort runs (host-chosen ids, padded to the static
    ``cohort_size``), split into contiguous shares over the ranks of
    ``group`` (the default group unless given), each rank running
    ``cohort_size // world_size`` clients.

    Returns ``round(params, batches, n_samples, cohort_ids, valid, key=(0,
    0), mask_scores=None)``: ``batches`` holds every registered client's
    (C, local_steps, ...) rows, ``cohort_ids`` (cohort_size,) ints and
    ``valid`` the 0/1 participation over the cohort (padding slots 0), or
    with ``normalize=False`` the sampler's weights (nonzero =
    participant).  Every rank returns the same new parameters and
    metrics."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if cohort_size % world != 0:
        raise ValueError(f"cohort_size {cohort_size} not divisible by the "
                         f"world size ({world})")
    share = cohort_size // world
    local_update = _make_local_update(arch, cfg)

    def fed_round(params: Tree, batches: Tree, n_samples,
                  cohort_ids: Sequence[int], valid,
                  key: Tuple[int, int] = (0, 0), mask_scores=None):
        ids = [int(i) for i in cohort_ids]
        valid = torch.as_tensor(valid, dtype=torch.float32).cpu()
        n_cohort = torch.as_tensor(n_samples, dtype=torch.float32).cpu()[ids]
        w = _weights(valid, n_cohort, cfg.normalize)
        valid01 = (valid > 0).to(torch.float32)
        dev = next(iter(params.values())).device
        upload = _Upload(params, cfg.codec)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for j in range(rank * share, (rank + 1) * share):
            loss = _run_client(local_update, cfg, params, batches, ids[j],
                               key, mask_scores, upload, float(w[j]), observe)
            loss_sum = loss_sum + loss * float(valid01[j])
        valid_sum = valid01[rank * share:(rank + 1) * share].sum().to(dev)
        dist.all_reduce(upload.flat, group=group)
        dist.all_reduce(loss_sum, group=group)
        dist.all_reduce(valid_sum, group=group)
        with torch.no_grad():
            new_params = upload.apply(params)
        return new_params, {
            "mean_loss": loss_sum / torch.clamp(valid_sum, min=1.0),
            "num_sampled": valid_sum}

    return fed_round
