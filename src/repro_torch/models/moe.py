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
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

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


def _top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, best first, the lower index first
    among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, x: torch.Tensor, *, topk: int,
          capacity_factor: float = 1.25, group_size: int = 512,
          real_experts: int = 0) -> Routing:
    """Group ``x`` (..., d) into rows of ``min(group_size, n)`` tokens and
    route them through ``router`` (d, E) as the module docstring says."""
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

    logits = xg.float() @ router.float()                     # (G, g, E)
    if real_experts and real_experts < E:
        routable = torch.arange(E, device=x.device) < real_experts
        logits = torch.where(routable, logits,
                             torch.full((), -1e30, device=x.device))
    probs = torch.softmax(logits, dim=-1)
    gates, ids = _top_k(probs, topk)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean(dim=(0, 1))
    top1 = torch.nn.functional.one_hot(ids[..., 0], E).float()
    aux = E * torch.sum(me * top1.mean(dim=(0, 1)))

    cap = max(1, int(g * topk / (real_experts or E) * capacity_factor))
    picks = torch.nn.functional.one_hot(ids.reshape(n_groups, g * topk), E)
    pos = ((picks.cumsum(1) * picks).sum(-1) - 1).reshape(ids.shape)
    keep = pos < cap
    return Routing(xg, ids, gates * keep, pos, keep, aux.float(), cap)


def moe_ffn(params: dict, x: torch.Tensor, *, topk: int, act: str = "silu",
            gated: bool = True, capacity_factor: float = 1.25,
            group_size: int = 512,
            real_experts: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out (B, T, d) in x's dtype, aux loss () fp32).

    Routing in fp32; the experts and the shared FFN in x's dtype."""
    B, T, d = x.shape
    dt = x.dtype
    r = route(params["router"], x, topk=topk,
              capacity_factor=capacity_factor, group_size=group_size,
              real_experts=real_experts)
    G, g, _ = r.xg.shape
    E = params["router"].shape[-1]
    cap = r.capacity
    rows = G * g

    # slot (group, expert, place) of every kept pick; the rest read the
    # zero row at the end
    slot = (torch.arange(G, device=x.device)[:, None, None] * (E * cap)
            + r.expert_ids * cap + r.positions)
    empty = G * E * cap
    slot = torch.where(r.keep, slot, empty)
    token = torch.arange(rows, device=x.device).view(G, g, 1).expand_as(slot)
    src = torch.full((empty + 1,), rows, dtype=torch.long, device=x.device)
    src[slot.reshape(-1)] = token.reshape(-1)
    src = src[:empty]

    xz = torch.cat([r.xg.reshape(rows, d), x.new_zeros(1, d)])
    xe = xz[src].view(G, E, cap, d).transpose(0, 1).reshape(E, G * cap, d)
    h = torch.matmul(xe, params["wi"].to(dt))
    if gated:
        h = _act(h, act) * torch.matmul(xe, params["wg"].to(dt))
    else:
        h = _act(h, act)
    ye = torch.matmul(h, params["wo"].to(dt))                # (E, G*cap, d)
    ye = ye.view(E, G, cap, d).transpose(0, 1).reshape(empty, d)
    yz = torch.cat([ye, ye.new_zeros(1, d)])
    picked = yz[slot]                                        # (G, g, k, d)
    y = (r.gates.to(dt).float()[..., None] * picked.float()).sum(-2)
    y = y.to(dt).reshape(rows, d)[:B * T]

    if "shared_wi" in params:
        xs = x.reshape(B * T, d)
        hs = xs @ params["shared_wi"].to(dt)
        if gated:
            hs = _act(hs, act) * (xs @ params["shared_wg"].to(dt))
        else:
            hs = _act(hs, act)
        y = y + hs @ params["shared_wo"].to(dt)
    return y.reshape(B, T, d).to(dt), r.aux
