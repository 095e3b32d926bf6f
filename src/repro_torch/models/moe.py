"""Mixture-of-Experts FFN (counterpart of ``repro/models/moe.py``): top-k
routing with grouped, capacity-bounded dispatch.

The reference writes this in jnp and leaves it to XLA, outside any Pallas
kernel, so the port's counterpart is plain PyTorch: index ops and batched
``torch.matmul``.  It keeps the reference's semantics, not its one-hot
einsums:

* Tokens go in groups of ``g = min(group_size, n)``; the last group is
  padded with zero rows, which are routed and count in the aux loss's
  means, as in the reference.
* Routing is fp32: ``softmax(x @ router)``, the padded experts' logits at
  -1e30 when ``real_experts`` is given (so they are never chosen), the
  top k with the lower expert id first on ties (``lax.top_k``'s order),
  the gates renormalised with a floor of 1e-9.
* Each expert holds ``cap = max(1, int(g * k / (real_experts or E) *
  capacity_factor))`` slots a group.  A (token, slot)'s place in its
  expert's buffer is its rank in token-major, slot-minor order among the
  group's picks of that expert; picks past ``cap`` are dropped.
* Dispatch gathers each expert's (cap, d) rows, the experts run as
  batched products over (E, G * cap, d) with empty slots at zero, and
  combine gathers each kept pick's row back, weighted by its gate.
* Shared experts (fused as one wide FFN) run on every real token.
* The aux loss is Switch's: ``E * sum_e mean(probs)_e * mean(top-1
  one-hot)_e``, fp32.

Autograd reaches the gates through the softmax and the experts through the
products; the keep mask and the one-hot term carry no gradient, as in the
reference.

Under ``hints`` (``models/hints.py``; DTensor parameters on a mesh) the
routing, dispatch and combine are plain tensor code (their index ops have
no DTensor rules).  Where the data axes split the batch and each rank's
rows hold whole groups, each data rank routes its own rows' groups
through ``local_map`` (``_local_moe``); else (a group spans data ranks, as
decode's one group of the batch does) the whole batch is routed, the
same on every rank.  The expert and shared products run on DTensors:
experts over "model" where E divides it (expert parallel), else the ff
dim, as ``launch/shardings.param_spec`` lays the weights out.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.models import hints as hints_lib
from repro_torch.models.common import dense_init

__all__ = ["init_moe_params", "Routing", "route", "moe_ffn"]


def init_moe_params(generator: torch.Generator, d_model: int,
                    num_experts: int, d_ff: int, shared_d_ff: int,
                    gated: bool, dtype, *, stack: Tuple[int, ...] = (),
                    device=None) -> dict:
    """The router (fp32 whatever ``dtype``), the experts' ``wi`` / ``wg``
    (E, d, f) and ``wo`` (E, f, d), and the fused shared experts, each
    leaf with the leading ``stack`` axes; the reference's leaf names."""
    def dense(shape, dt=dtype):
        return dense_init(generator, stack + shape, dt, device=device)

    p = {"router": dense((d_model, num_experts), torch.float32),
         "wi": dense((num_experts, d_model, d_ff)),
         "wo": dense((num_experts, d_ff, d_model))}
    if gated:
        p["wg"] = dense((num_experts, d_model, d_ff))
    if shared_d_ff:
        p["shared_wi"] = dense((d_model, shared_d_ff))
        p["shared_wo"] = dense((shared_d_ff, d_model))
        if gated:
            p["shared_wg"] = dense((d_model, shared_d_ff))
    return p


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    return (torch.nn.functional.silu(x) if name == "silu"
            else torch.nn.functional.gelu(x, approximate="tanh"))


class Routing(NamedTuple):
    """One call's routing, per group (G groups of g rows, the last padded
    with zero rows)."""
    xg: torch.Tensor            # (G, g, d) the grouped input
    expert_ids: torch.Tensor    # (G, g, k) int64, best first
    gates: torch.Tensor         # (G, g, k) fp32, renormalised, 0 if dropped
    positions: torch.Tensor     # (G, g, k) int64, place in the expert's buffer
    keep: torch.Tensor          # (G, g, k) bool, positions < capacity
    aux: torch.Tensor           # () fp32 load-balance loss
    capacity: int               # slots an expert holds a group
    mean_probs: torch.Tensor    # (E,) fp32 the aux loss's mean router probs
    mean_top1: torch.Tensor     # (E,) fp32 its mean top-1 one-hot


def _top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, best first, the lower index first
    among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, x: torch.Tensor, *, topk: int,
          capacity_factor: float = 1.25, group_size: int = 512,
          real_experts: int = 0, logits=None) -> Routing:
    """Group ``x`` (..., d) into rows of ``min(group_size, n)`` tokens and
    route them through ``router`` (d, E) as the module docstring says.
    ``logits`` (..., E) fp32, where given, are ``x @ router`` made by the
    caller (each rank's rows under hints)."""
    d = x.shape[-1]
    E = router.shape[-1]
    xf = x.reshape(-1, d)
    n_tok = xf.shape[0]
    g = min(group_size, n_tok)
    n_groups = -(-n_tok // g)
    pad = n_groups * g - n_tok
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad, d)])
    xg = xf.reshape(n_groups, g, d)

    if logits is None:
        logits = xg.float() @ router.float()                 # (G, g, E)
    else:
        logits = logits.reshape(n_tok, E)
        if pad:
            logits = torch.cat([logits, logits.new_zeros(pad, E)])
        logits = logits.reshape(n_groups, g, E)
    if real_experts and real_experts < E:
        routable = torch.arange(E, device=x.device) < real_experts
        logits = torch.where(routable, logits,
                             torch.full((), -1e30, device=x.device))
    probs = torch.softmax(logits, dim=-1)
    gates, ids = _top_k(probs, topk)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean(dim=(0, 1))
    top1 = torch.nn.functional.one_hot(ids[..., 0], E).float().mean(
        dim=(0, 1))
    aux = E * torch.sum(me * top1)

    cap = max(1, int(g * topk / (real_experts or E) * capacity_factor))
    picks = torch.nn.functional.one_hot(ids.reshape(n_groups, g * topk), E)
    pos = ((picks.cumsum(1) * picks).sum(-1) - 1).reshape(ids.shape)
    keep = pos < cap
    return Routing(xg, ids, gates * keep, pos, keep, aux.float(), cap, me,
                   top1)


def _dispatch(r: Routing, num_experts: int) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """(xe (E, G * cap, d): each expert's slots, empty ones zero; slot (G,
    g, k): where each pick's row sits in ``ye``'s (G, E, cap) order, the
    zero row G * E * cap for a dropped pick)."""
    G, g, d = r.xg.shape
    E, cap = num_experts, r.capacity
    rows = G * g
    dev = r.xg.device
    slot = (torch.arange(G, device=dev)[:, None, None] * (E * cap)
            + r.expert_ids * cap + r.positions)
    empty = G * E * cap
    slot = torch.where(r.keep, slot, empty)
    token = torch.arange(rows, device=dev).view(G, g, 1).expand_as(slot)
    src = torch.full((empty + 1,), rows, dtype=torch.long, device=dev)
    src[slot.reshape(-1)] = token.reshape(-1)
    src = src[:empty]
    xz = torch.cat([r.xg.reshape(rows, d), r.xg.new_zeros(1, d)])
    xe = xz[src].view(G, E, cap, d).transpose(0, 1).reshape(E, G * cap, d)
    return xe, slot


def _combine(ye: torch.Tensor, slot: torch.Tensor,
             gates: torch.Tensor) -> torch.Tensor:
    """Each kept pick's expert row back at its token, weighted by its gate
    (in ye's dtype, summed in fp32): (G * g, d)."""
    E, _, d = ye.shape
    G, g, _ = slot.shape
    dt = ye.dtype
    ye = ye.view(E, G, -1, d).transpose(0, 1).reshape(-1, d)
    yz = torch.cat([ye, ye.new_zeros(1, d)])
    picked = yz[slot]                                        # (G, g, k, d)
    y = (gates.to(dt).float()[..., None] * picked.float()).sum(-2)
    return y.to(dt).reshape(G * g, d)


def _experts(params: dict, xe: torch.Tensor, act: str,
             gated: bool) -> torch.Tensor:
    """The batched expert FFNs on (E, N, d) slots, in xe's dtype."""
    dt = xe.dtype
    h = torch.matmul(xe, params["wi"].to(dt))
    if gated:
        h = _act(h, act) * torch.matmul(xe, params["wg"].to(dt))
    else:
        h = _act(h, act)
    return torch.matmul(h, params["wo"].to(dt))              # (E, N, d)


def _local_moe(params: dict, x: torch.Tensor, hints, *, topk: int,
               act: str, gated: bool, capacity_factor: float, g: int,
               real_experts: int):
    """The routed experts under hints with each data rank routing its own
    rows' groups (``local_map``): the slots of every rank's groups, in
    rank order, are the whole batch's slots in group order, so the expert
    products see the unsharded (E, G * cap, d) layout.  Returns (y, aux),
    the aux loss from the ranks' mean probs and top-1 shares (averaged
    over the data ranks, where the whole batch takes one mean)."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = hints.mesh
    E = params["router"].shape[-1]
    rows, whole = hints.layout(Shard(0)), hints.layout()
    slots, mean = hints.layout(Shard(1)), hints.layout(Partial("avg"))

    def route_local(xl, router):
        r = route(router, xl, topk=topk, capacity_factor=capacity_factor,
                  group_size=g, real_experts=real_experts)
        xe, slot = _dispatch(r, E)
        return xe, slot, r.gates, r.mean_probs, r.mean_top1

    xe, slot, gates, me, top1 = local_map(
        route_local,
        out_placements=(slots, rows, rows, mean, mean),
        in_placements=(rows, whole),
        in_grad_placements=(rows, hints.layout(Partial())),
        device_mesh=mesh, redistribute_inputs=True)(x, params["router"])
    ye = _experts(params, xe, act, gated)
    B, T, d = x.shape
    y = local_map(lambda a, b, c: _combine(a, b, c).reshape(-1, T, d),
                  out_placements=rows,
                  in_placements=(slots, rows, rows),
                  in_grad_placements=(slots, rows, rows),
                  device_mesh=mesh, redistribute_inputs=True)(ye, slot, gates)
    return y, (E * torch.sum(me * top1)).float()


def _slots_over_data(hints, xe: torch.Tensor) -> torch.Tensor:
    """Under hints, the (E, slots, d) buffer that every rank holds whole,
    as a DTensor whose slots are split over the data axes (each rank
    takes its chunk; nothing moves), so that the expert products run on
    one rank's share of the slots.  Else ``xe``."""
    if hints is None:
        return xe
    from torch.distributed.tensor import Shard
    return hints_lib.replicated(hints, xe).redistribute(
        hints.mesh, hints.layout(Shard(1)))


def moe_ffn(params: dict, x: torch.Tensor, *, topk: int, act: str = "silu",
            gated: bool = True, capacity_factor: float = 1.25,
            group_size: int = 512, real_experts: int = 0,
            hints=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out (B, T, d) in x's dtype, aux loss () fp32).

    Routing in fp32; the experts and the shared FFN in x's dtype."""
    B, T, d = x.shape
    dt = x.dtype
    E = params["router"].shape[-1]
    g = min(group_size, B * T)
    if hints is not None and hints.splits_batch(B) and \
            (B // hints._dp_size() * T) % g == 0:
        y, aux = _local_moe(params, x, hints, topk=topk, act=act,
                            gated=gated, capacity_factor=capacity_factor,
                            g=g, real_experts=real_experts)
        y = y.reshape(B * T, d)
    else:       # one device, or rows whose groups straddle data ranks
        xin = hints_lib.whole(hints, x)
        logits = None if hints is None else hints_lib.whole(
            hints, x.float() @ params["router"].float())
        r = route(hints_lib.whole(hints, params["router"]), xin, topk=topk,
                  capacity_factor=capacity_factor, group_size=group_size,
                  real_experts=real_experts, logits=logits)
        xe, slot = _dispatch(r, E)
        ye = hints_lib.whole(hints, _experts(
            params, _slots_over_data(hints, xe), act, gated))
        y = hints_lib.replicated(hints, _combine(ye, slot, r.gates)[:B * T])
        aux = hints_lib.replicated(hints, r.aux)

    if "shared_wi" in params:
        xs = x.reshape(B * T, d)
        hs = xs @ params["shared_wi"].to(dt)
        if gated:
            hs = _act(hs, act) * (xs @ params["shared_wg"].to(dt))
        else:
            hs = _act(hs, act)
        y = y + hs @ params["shared_wo"].to(dt)
    return y.reshape(B, T, d).to(dt), aux
