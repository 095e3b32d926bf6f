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

The silo-sharded pod round (``fed_layout``, ``silo_mesh``,
``silo_param_dtype``, ``make_silo_fed_round``) is the counterpart of
``make_cohort_fed_round`` under ``lower_fed_round``'s layout, and is that
cohort round over the client axis: the clients sit on "data" (on "pod"
for the multi-pod mesh), one client a silo, and each client's model is a
DTensor over its silo ("model", and "data" with FSDP on the multi-pod
mesh), laid out by ``launch/shardings``.  The same client code runs with
the silo's hints: local SGD on the shards, kernel masking over them
(``ops.topk_mask_pytree(..., group=silo)``: the same masks as one device,
bit for bit), the wire round trip and byte count on the whole client,
and ``_Upload``'s fp32 buffer of the silo's shards summed over the client
axis in one all-reduce.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.codecs import roundtrip_stacked, with_axis0_slices
from repro_torch.core.masking import (_kept_count, _refine_sweeps_for,
                                      client_mask_scores, random_keep,
                                      threshold_for_topk)
from repro_torch.launch.shardings import whole
from repro_torch.models import transformer as tr

Tree = Dict[str, torch.Tensor]

__all__ = ["FedPodConfig", "mask_deltas", "make_fed_round",
           "make_cohort_fed_round", "fed_layout", "silo_mesh",
           "silo_param_dtype", "silo_shardings", "make_silo_fed_round"]


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
                scores: Optional[Tree] = None, group=None) -> Tree:
    """Mask a client-stacked delta tree (leading C axis on every leaf).

    Leaves under ``cfg.min_leaf_size`` elements a client pass dense.
    Random masking needs ``scores``: one (C, *shape) uniform tensor per
    maskable leaf.  The kernel route masks one client at a time.

    ``group``: a ``DeviceMesh`` over which the leaves are DTensors (a
    silo's shards).  The kernel route then masks over the shards
    (``ops.topk_mask_pytree(..., group=group)``); the other routes mask
    each leaf whole and keep the local shard."""
    if cfg.masking == "none" or cfg.gamma >= 1.0:
        return deltas
    if group is not None and not (cfg.masking == "selective"
                                  and cfg.use_kernel):
        full = mask_deltas({n: whole(t) for n, t in deltas.items()}, cfg,
                           scores)
        return {n: _local_part(full[n], deltas[n]) for n in deltas}
    if cfg.masking == "selective" and cfg.use_kernel:
        from repro_torch.kernels import ops
        num_clients = next(iter(deltas.values())).shape[0]
        per_client = [ops.topk_mask_pytree(
            {n: leaf[c] for n, leaf in deltas.items()}, cfg.gamma,
            min_leaf_size=cfg.min_leaf_size,
            refine_sweeps=_refine_sweeps_for(cfg.bisect_iters),
            axis0_slices=True, group=group) for c in range(num_clients)]
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


def _local_part(whole: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``whole`` laid out as the DTensor ``like`` (this rank's part of it,
    cut without communication: replicated to sharded is a local slice);
    ``whole`` itself for a plain ``like``."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(like, DTensor):
        return whole
    mesh = like.device_mesh
    return DTensor.from_local(whole, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(
        mesh, like.placements)


def _make_local_update(arch: ArchConfig, cfg: FedPodConfig,
                       hints=None) -> Callable:
    """``local_update(params, batches) -> (delta, mean loss)``: E SGD
    steps on ``lm_loss`` over ``batches`` ({"tokens", "labels"}, each (E,
    b, T), or (E, b, K, T) for audio; a vision config's also
    ``"prefix_embeds"`` (E, b, P, d)), each ``x - lr * g`` in x's dtype.
    One definition for every round form.  ``params`` is not modified.
    Under ``hints`` the leaves are DTensors; each gradient takes its
    leaf's layout before the step."""
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
                loss = tr.lm_loss(leaves, arch, batch, hints=hints)
                grads = torch.autograd.grad(loss, list(leaves.values()))
            if hints is not None:
                grads = [_same_layout(g, x) for g, x in
                         zip(grads, leaves.values())]
                loss = whole(loss)
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


def _same_layout(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``g`` redistributed to the DTensor ``x``'s placements."""
    if tuple(g.placements) != tuple(x.placements):
        return g.redistribute(x.device_mesh, x.placements)
    return g


def _host(values) -> np.ndarray:
    """An fp32 numpy copy of host values: a list, an array or a tensor."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    return np.asarray(values, dtype=np.float32)


def _weights(values, n_samples, normalize: bool) -> np.ndarray:
    """fp32 aggregation weights on the host: ``values * n_samples``
    normalised to sum 1, or ``values`` as given (pre-weighted).  In numpy,
    so that no host value is read back from a tensor (the dry run traces
    the silo round on fake ones)."""
    values = _host(values)
    if not normalize:
        return values
    w = values * _host(n_samples)
    return w / np.maximum(w.sum(dtype=np.float32), np.float32(1e-12))


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


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; a plain tensor itself."""
    return x.to_local() if hasattr(x, "to_local") else x


class _Upload:
    """One fp32 buffer holding the round's aggregate, leaf by leaf (so one
    ``all_reduce`` covers it), and the wire round trip and weighted add of
    one client's masked delta.  A DTensor leaf holds this rank's shard."""

    def __init__(self, params: Tree, codec):
        local = [_local(p) for p in params.values()]
        total = sum(p.numel() for p in local)
        self.flat = torch.zeros((total,), dtype=torch.float32,
                                device=local[0].device)
        self.leaves, at = {}, 0
        for name, p in zip(params, local):
            self.leaves[name] = self.flat[at:at + p.numel()].view(p.shape)
            at += p.numel()
        self.codec = codec

    def add(self, masked: Tree, weight: float) -> None:
        """Round-trip one client's (1, ...)-stacked masked delta through
        the codec, leaf by leaf, and add ``bf16(weight) * bf16(wire)``.
        The wire carries a DTensor's whole leaf; its shard is added."""
        for name in list(masked):
            m = masked.pop(name)
            if self.codec is not None:
                wired = roundtrip_stacked(self.codec, {name: whole(m)})
                m = _local_part(wired[name], m)
            _accumulate(self.leaves[name], _local(m)[0], weight)

    def apply(self, params: Tree) -> Tree:
        """``p + aggregate`` in each parameter's dtype and layout."""
        from torch.distributed.tensor import DTensor
        out = {}
        for k, p in params.items():
            new = _local(p) + self.leaves[k].to(p.dtype)
            out[k] = DTensor.from_local(
                new, p.device_mesh, p.placements, shape=p.shape,
                stride=p.stride(), run_check=False) \
                if isinstance(p, DTensor) else new
        return out


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
                weight: float, observe, hints=None) -> torch.Tensor:
    """One client end to end: local SGD, mask, wire, weighted add.
    Returns its mean loss.  Under ``hints`` the client's model is DTensors
    on ``hints.mesh``, its batch whole on every rank of that mesh, and its
    delta is masked over the mesh's shards."""
    dev = next(iter(params.values())).device
    mine = {k: v[client].to(dev) for k, v in batches.items()}
    if hints is None:
        delta, loss = local_update(params, mine)
    else:
        from torch.distributed.tensor.experimental import \
            implicit_replication

        from repro_torch.models.hints import replicated
        with implicit_replication():
            delta, loss = local_update(
                params, {k: replicated(hints, v) for k, v in mine.items()})
    stacked = {k: d[None] for k, d in delta.items()}
    del delta
    scores = _client_scores(cfg, key, mask_scores, client, params)
    with torch.no_grad():
        masked = mask_deltas(stacked, cfg, scores,
                             group=None if hints is None else hints.mesh)
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
                          observe: Optional[Callable] = None,
                          hints=None) -> Callable:
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
    metrics.

    ``hints`` (``models/hints.Hints``): each client's model is DTensors on
    ``hints.mesh`` (a silo of ranks, ``group`` one rank of each silo):
    local SGD with the hints, masking over the silo's shards, the wire on
    whole leaves, each rank's aggregate its shards'
    (:func:`make_silo_fed_round`)."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if cohort_size % world != 0:
        raise ValueError(f"cohort_size {cohort_size} not divisible by the "
                         f"world size ({world})")
    share = cohort_size // world
    local_update = _make_local_update(arch, cfg, hints=hints)

    def fed_round(params: Tree, batches: Tree, n_samples,
                  cohort_ids: Sequence[int], valid,
                  key: Tuple[int, int] = (0, 0), mask_scores=None):
        ids = [int(i) for i in cohort_ids]
        valid = _host(valid)
        w = _weights(valid, _host(n_samples)[ids], cfg.normalize)
        valid01 = (valid > 0).astype(np.float32)
        dev = next(iter(params.values())).device
        upload = _Upload(params, cfg.codec)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for j in range(rank * share, (rank + 1) * share):
            loss = _run_client(local_update, cfg, params, batches, ids[j],
                               key, mask_scores, upload, float(w[j]), observe,
                               hints)
            loss_sum = loss_sum + loss * float(valid01[j])
        valid_sum = torch.tensor(
            float(valid01[rank * share:(rank + 1) * share].sum()),
            dtype=torch.float32, device=dev)
        dist.all_reduce(upload.flat, group=group)
        dist.all_reduce(loss_sum, group=group)
        dist.all_reduce(valid_sum, group=group)
        with torch.no_grad():
            new_params = upload.apply(params)
        return new_params, {
            "mean_loss": loss_sum / torch.clamp(valid_sum, min=1.0),
            "num_sampled": valid_sum}

    return fed_round


# ---------------------------------------------------------------------------
# the silo-sharded pod round
# ---------------------------------------------------------------------------
def fed_layout(mesh) -> Tuple[str, tuple]:
    """(client axis, FSDP axes of a client's model): single pod -> clients
    on "data", the model over "model"; multi-pod -> clients on "pod", the
    model over ("data", "model")."""
    if "pod" in mesh.mesh_dim_names:
        return "pod", ("data",)
    return "data", ()


def silo_mesh(mesh):
    """This rank's silo: the submesh of every axis but the client axis."""
    client_axis, _ = fed_layout(mesh)
    axes = tuple(a for a in mesh.mesh_dim_names if a != client_axis)
    return mesh[axes]


def silo_param_dtype(arch: ArchConfig, mesh) -> str:
    """The reference's rule: fp32 parameters while a client's fp32 model
    over its silo's chips is under 6e9 bytes a chip, else bf16."""
    from repro_torch.launch.steps import params_specs
    client_axis, _ = fed_layout(mesh)
    clients = mesh.shape[mesh.mesh_dim_names.index(client_axis)]
    silo_chips = mesh.size() // clients
    n = tr.param_count(params_specs(arch, "float32"))
    return "float32" if 4 * n / silo_chips < 6e9 else "bfloat16"


def silo_shardings(params: Tree, mesh) -> Dict[str, Any]:
    """Each parameter's layout over its silo, as ``lower_fed_round`` lays
    it out: tensor parallel over "model", FSDP over the layout's FSDP axes
    (none on a single pod)."""
    from repro_torch.launch import shardings as sh
    _, fsdp_axes = fed_layout(mesh)
    return sh.params_shardings(params, silo_mesh(mesh), fsdp=bool(fsdp_axes),
                               fsdp_axes=fsdp_axes or None)


def make_silo_fed_round(arch: ArchConfig, cfg: FedPodConfig, mesh,
                        observe: Optional[Callable] = None) -> Callable:
    """The pod round over ``mesh``, the clients laid out on silos
    (``fed_layout``): :func:`make_cohort_fed_round` over the client axis,
    every client in the cohort, with the silo's hints (no batch axis: a
    client's batch is whole on its silo, as the reference's
    ``Hints(dp=())``).  ``cfg.num_clients`` must be a multiple of the
    client axis's size, each silo running its contiguous share in turn
    (one client a silo in the reference's layout).

    Returns ``round(params, batches, n_samples, participation, key=(0, 0),
    mask_scores=None) -> (new params, metrics)`` with ``make_fed_round``'s
    arguments, but ``params`` DTensors on this rank's silo mesh
    (``silo_shardings``; every silo holds the same values).  ``metrics``
    adds ``upload_bytes``: a client's exact wire bytes, metered on the
    whole client's shapes.  ``observe(client, delta, masked)`` sees each
    of this silo's clients' (1, ...)-stacked DTensors."""
    from repro_torch.models.hints import Hints
    client_axis, _ = fed_layout(mesh)
    silo = silo_mesh(mesh)
    hints = Hints(mesh=silo, dp=(), model="model",
                  model_size=silo.shape[silo.mesh_dim_names.index("model")])
    cohort = make_cohort_fed_round(arch, cfg, cfg.num_clients,
                                   group=mesh.get_group(client_axis),
                                   observe=observe, hints=hints)
    everyone = list(range(cfg.num_clients))

    def fed_round(params: Tree, batches: Tree, n_samples, participation,
                  key: Tuple[int, int] = (0, 0), mask_scores=None):
        new_params, metrics = cohort(params, batches, n_samples, everyone,
                                     participation, key=key,
                                     mask_scores=mask_scores)
        upload = (cfg.codec.wire_bytes(params) if cfg.codec is not None else
                  sum(p.numel() * p.element_size() for p in params.values()))
        return new_params, {**metrics, "upload_bytes": int(upload)}

    return fed_round
