"""Attention (counterpart of ``repro/models/attention.py``): GQA with RoPE,
a blocked train and prefill path and a single-token decode path over full
or sliding (ring-buffer) KV caches.

The reference computes attention in jnp, not in Pallas, so the port's is
plain PyTorch too:

* ``flash_attention`` (train and prefill) is ``models/flash_vjp.py``'s
  blocked exact softmax; where a gradient is needed it runs as
  ``flash_vjp.FlashAttention``, whose backward recomputes the
  probabilities from the saved output and log-sum-exp.
* ``decode_attention`` writes the new key and value into the cache *in
  place* (the reference returns a new cache; the port updates the tensor
  and returns the cache with its index advanced) and attends one token.

Under ``hints`` (``models/hints.py``; DTensor inputs on a mesh) both run
on each rank's shard through ``local_map``, in the reference's layouts:
training and prefill attention head-sharded over "model" where the heads
divide it (each rank attends its heads against the KV heads they read),
else sequence-sharded (each rank's query rows against every key, from
their offset); decode against a cache whose slots are sharded over
"model", the ranks' partial softmax sums combined by all-reduce.  With
one rank on "model" both call the plain function on the whole tensors.

Products whose reference output is fp32 from bf16 inputs
(``preferred_element_type``) upcast both inputs to fp32 first: the product
of two bf16 values is exact in fp32, so only the summation order differs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.models.common import apply_rope, dense_init, init_device

__all__ = ["NEG_INF", "visibility", "flash_attention", "KVCache",
           "init_kv_cache", "cache_positions", "decode_attention",
           "init_attn_params", "project_qkv", "out_proj"]

NEG_INF = -1e30


def visibility(q_pos: torch.Tensor, k_pos: torch.Tensor, attn: str,
               window: int) -> torch.Tensor:
    """(Tq, Tk) bool.  k_pos < 0 marks an invalid (empty) slot."""
    q = q_pos[:, None]
    k = k_pos[None, :]
    vis = (k <= q) & (k >= 0)
    if attn == "sliding" and window > 0:
        vis &= k > q - window
    elif attn == "chunked" and window > 0:
        vis &= (k // window) == (q // window)
    return vis


def _scaled(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale with the scale rounded to q's dtype first, as the
    reference's ``q * jnp.asarray(scale, q.dtype)``."""
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, attn: str = "full", window: int = 0,
                    softcap_val: float = 0.0, scale: Optional[float] = None,
                    q_offset: int = 0, block_q: int = 512,
                    hints=None) -> torch.Tensor:
    """q: (B, T, H, D); k, v: (B, S, KV, D) with H a multiple of KV (GQA).
    Returns (B, T, H, D) in q's dtype.  Causal; query positions are
    ``q_offset + [0..T)`` and key positions ``[0..S)``.

    Where a gradient is needed (grad mode on and q, k or v requiring one)
    this is ``flash_vjp.FlashAttention``, whose backward recomputes the
    probabilities; otherwise the same forward without saving anything."""
    from repro_torch.models import flash_vjp
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if hints is not None:
        return _sharded_flash(q, k, v, hints, attn=attn, window=window,
                              softcap_val=softcap_val, scale=scale,
                              q_offset=q_offset, block_q=block_q)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_vjp.FlashAttention.apply(q, k, v, attn, window,
                                              softcap_val, scale, q_offset,
                                              block_q)
    return flash_vjp.flash_forward(q, k, v, attn=attn, window=window,
                                   softcap_val=softcap_val, scale=scale,
                                   q_offset=q_offset, block_q=block_q)[0]


def _model_layout(hints, mesh):
    """(index of the "model" mesh dim, its size, this rank's coordinate
    on it)."""
    mi = mesh.mesh_dim_names.index(hints.model)
    return mi, mesh.shape[mi], mesh.get_local_rank(hints.model)


def _sharded_flash(q, k, v, hints, *, attn, window, softcap_val, scale,
                   q_offset, block_q):
    """:func:`flash_attention` on DTensors, through ``local_map``: heads
    over "model" where they divide it, else query rows, else whole."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = hints.mesh
    B, T, H, D = q.shape
    KV = k.shape[2]
    groups = H // KV
    mi, m, r = _model_layout(hints, mesh)
    if m > 1 and H % m == 0:
        mode, q_dim = "heads", 2
    elif m > 1 and T % m == 0:
        mode, q_dim = "rows", 1
    else:
        mode, q_dim = "whole", None
    batch = Shard(0) if hints.splits_batch(B) else None
    q_pl = hints.layout(batch, None if q_dim is None else Shard(q_dim))
    kv_pl = hints.layout(batch)
    kv_grad = hints.layout(batch, None if mode == "whole" else Partial())

    def local(ql, kl, vl):
        off = q_offset
        if mode == "heads":
            hl = H // m
            if hl % groups == 0:          # whole KV groups: slice them
                lo = r * hl // groups
                kl = kl[:, :, lo:lo + hl // groups]
                vl = vl[:, :, lo:lo + hl // groups]
            else:                         # each local head's KV head
                idx = (r * hl + torch.arange(hl, device=kl.device)) // groups
                kl, vl = kl[:, :, idx], vl[:, :, idx]
        elif mode == "rows":
            off = q_offset + r * ql.shape[1]
        return flash_attention(ql, kl, vl, attn=attn, window=window,
                               softcap_val=softcap_val, scale=scale,
                               q_offset=off, block_q=block_q)

    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


class KVCache(NamedTuple):
    """k, v: (..., B, S_cache, KV, D) (leading axes: the layer groups);
    ``index``: logical position of the next token, shared by the stack.

    Full layers: S_cache = max_seq (append at index).  Sliding and chunked
    layers: S_cache = window slots (a ring buffer)."""
    k: torch.Tensor
    v: torch.Tensor
    index: int


def init_kv_cache(batch: int, max_seq: int, kv_heads: int, head_dim: int,
                  dtype, *, attn: str = "full", window: int = 0,
                  stack: Tuple[int, ...] = (), device=None) -> KVCache:
    """Zero caches of ``max_seq`` slots, or ``window`` slots for sliding
    and chunked layers, with the leading ``stack`` axes."""
    slots = window if (attn in ("sliding", "chunked") and window) else max_seq
    slots = min(slots, max_seq)
    shape = stack + (batch, slots, kv_heads, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def cache_positions(cache: KVCache, attn: str, window: int, *,
                    slots: Optional[int] = None,
                    offset: int = 0) -> torch.Tensor:
    """Logical position held by each cache slot *after* the current token
    (at position ``cache.index``) has been written; empty slots -> -1.
    ``slots`` / ``offset``: ``cache`` holds the slots from ``offset`` on
    of a cache of ``slots`` slots (all of them by default)."""
    local = cache.k.shape[-3]
    slots = local if slots is None else slots
    pos = cache.index
    slot_ids = torch.arange(offset, offset + local, device=cache.k.device)
    if attn in ("sliding", "chunked") and window:
        logical = pos - ((pos - slot_ids) % slots)
        return torch.where(logical >= 0, logical, -1)
    return torch.where(slot_ids <= pos, slot_ids, -1)


def decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, cache: KVCache, *,
                     attn: str = "full", window: int = 0,
                     softcap_val: float = 0.0,
                     scale: Optional[float] = None, hints=None,
                     slots: Optional[int] = None, offset: int = 0,
                     reduce=None) -> Tuple[torch.Tensor, KVCache]:
    """One-token attention.  q: (B, 1, H, D); k_new, v_new: (B, 1, KV, D);
    cache k, v: (B, S, KV, D), written in place at slot ``index % S``.

    A shard of the slots: ``cache`` holds the ``offset``-th on of
    ``slots`` slots, the new row is written only where its slot is held,
    and ``reduce(t, op)`` ("max" or "sum" over the shards) combines the
    softmax max, sum and products (the probabilities rounded to the cache
    dtype as one rank rounds them)."""
    if hints is not None:
        return _sharded_decode(q, k_new, v_new, cache, hints, attn=attn,
                               window=window, softcap_val=softcap_val,
                               scale=scale)
    B, _, H, D = q.shape
    KV = k_new.shape[2]
    groups = H // KV
    scale = scale if scale is not None else D ** -0.5
    local = cache.k.shape[1]
    slots = local if slots is None else slots
    pos = cache.index
    slot = pos % slots - offset      # full cache: pos < slots
    if 0 <= slot < local:
        cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)

    k_pos = cache_positions(cache, attn, window, slots=slots, offset=offset)
    vis = visibility(torch.tensor([pos], device=q.device), k_pos, attn,
                     window)[0]                              # (S,)
    qf = _scaled(q, scale).reshape(B, KV, groups, D).to(cache.k.dtype)
    logits = qf.float() @ cache.k.permute(0, 2, 3, 1).float()  # (B,KV,g,S)
    if softcap_val > 0.0:
        logits = softcap_val * torch.tanh(logits / softcap_val)
    logits = torch.where(vis, logits, NEG_INF)
    vf = cache.v.permute(0, 2, 1, 3).float()
    if reduce is None:
        p = torch.softmax(logits, dim=-1)
        out = p.to(cache.v.dtype).float() @ vf
    else:
        e = torch.exp(logits - reduce(logits.amax(-1, keepdim=True), "max"))
        p = e / reduce(e.sum(-1, keepdim=True), "sum")
        out = reduce(p.to(cache.v.dtype).float() @ vf, "sum")
    out = out.reshape(B, 1, H, D).to(q.dtype)
    return out, KVCache(cache.k, cache.v, pos + 1)


def _sharded_decode(q, k_new, v_new, cache: KVCache, hints, *, attn, window,
                    softcap_val, scale):
    """:func:`decode_attention` on DTensors: the plain function on each
    rank's shard of the cache, with q and the new rows whole over
    "model".  With the slots over "model" each rank attends its slots
    (writing the new row where its slot is held) and the ranks' softmax
    max, sum and products are all-reduced over "model"."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = hints.mesh
    ck, cv = cache.k, cache.v
    mi, m, r = _model_layout(hints, mesh)
    split = isinstance(ck.placements[mi], Shard) and m > 1
    # q and the new rows: the cache's batch layout, whole over "model"
    rows = tuple(Replicate() if i == mi else p
                 for i, p in enumerate(ck.placements))
    ql, kl_new, vl_new = (x.redistribute(mesh, rows).to_local()
                          for x in (q, k_new, v_new))
    local = KVCache(ck.to_local(), cv.to_local(), cache.index)
    shard = {}
    if split:
        shard = {"slots": ck.shape[1], "offset": r * local.k.shape[1],
                 "reduce": lambda t, op: funcol.all_reduce(t, op,
                                                           (mesh, mi))}
    out, _ = decode_attention(ql, kl_new, vl_new, local, attn=attn,
                              window=window, softcap_val=softcap_val,
                              scale=scale, **shard)
    return (DTensor.from_local(out, mesh, rows, run_check=False),
            KVCache(ck, cv, cache.index + 1))


def init_attn_params(generator: torch.Generator, d_model: int,
                     num_heads: int, num_kv: int, head_dim: int,
                     qkv_bias: bool, dtype, *, stack: Tuple[int, ...] = (),
                     device=None) -> dict:
    """q, k, v and output projections (and zero biases with
    ``qkv_bias``), each leaf with the leading ``stack`` axes."""
    def dense(shape):
        return dense_init(generator, stack + shape, dtype, device=device)

    p = {
        "wq": dense((d_model, num_heads * head_dim)),
        "wk": dense((d_model, num_kv * head_dim)),
        "wv": dense((d_model, num_kv * head_dim)),
        "wo": dense((num_heads * head_dim, d_model)),
    }
    if qkv_bias:
        dev = init_device(generator, device)
        for name, width in (("bq", num_heads), ("bk", num_kv),
                            ("bv", num_kv)):
            p[name] = torch.zeros(stack + (width * head_dim,), dtype=dtype,
                                  device=dev)
    return p


def project_qkv(params: dict, x: torch.Tensor, num_heads: int, num_kv: int,
                head_dim: int, positions: torch.Tensor, rope_theta: float,
                compute_dtype, hints=None):
    """x: (B, T, d) -> q (B, T, H, D), k and v (B, T, KV, D), RoPE applied
    at ``positions`` (T,).  Under hints a projection whose heads "model"
    does not divide is gathered over it before it is split into heads (its
    column shards would cut heads apart)."""
    B, T, _ = x.shape
    xc = x.to(compute_dtype)
    q = xc @ params["wq"].to(compute_dtype)
    k = xc @ params["wk"].to(compute_dtype)
    v = xc @ params["wv"].to(compute_dtype)
    if "bq" in params:
        q = q + params["bq"].to(compute_dtype)
        k = k + params["bk"].to(compute_dtype)
        v = v + params["bv"].to(compute_dtype)
    if hints is not None:
        from repro_torch.models.hints import apply_batch
        q, k, v = (t if hints._ok(n) else apply_batch(hints, t) for t, n in
                   ((q, num_heads), (k, num_kv), (v, num_kv)))
    q = q.reshape(B, T, num_heads, head_dim)
    k = k.reshape(B, T, num_kv, head_dim)
    v = v.reshape(B, T, num_kv, head_dim)
    if rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def out_proj(params: dict, attn_out: torch.Tensor,
             compute_dtype, hints=None) -> torch.Tensor:
    """(B, T, H, D) -> (B, T, d) through ``wo``.  Under hints a
    sequence-sharded output (heads that "model" does not divide) is
    gathered over "model" first; a head-sharded one feeds the
    row-parallel product as it is."""
    B, T, H, D = attn_out.shape
    gather = hints is not None and not hints._ok(H)
    if gather:
        from repro_torch.models.hints import apply_batch
        attn_out = apply_batch(hints, attn_out)
    flat = attn_out.reshape(B, T, H * D)
    if gather:      # the backward gathers the gradient before the split
        from repro_torch.models.hints import batch_grad
        flat = batch_grad(hints, flat)
    return flat.to(compute_dtype) @ params["wo"].to(compute_dtype)
