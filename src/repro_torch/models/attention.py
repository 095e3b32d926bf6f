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
                    q_offset: int = 0, block_q: int = 512) -> torch.Tensor:
    """q: (B, T, H, D); k, v: (B, S, KV, D) with H a multiple of KV (GQA).
    Returns (B, T, H, D) in q's dtype.  Causal; query positions are
    ``q_offset + [0..T)`` and key positions ``[0..S)``.

    Where a gradient is needed (grad mode on and q, k or v requiring one)
    this is ``flash_vjp.FlashAttention``, whose backward recomputes the
    probabilities; otherwise the same forward without saving anything."""
    from repro_torch.models import flash_vjp
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_vjp.FlashAttention.apply(q, k, v, attn, window,
                                              softcap_val, scale, q_offset,
                                              block_q)
    return flash_vjp.flash_forward(q, k, v, attn=attn, window=window,
                                   softcap_val=softcap_val, scale=scale,
                                   q_offset=q_offset, block_q=block_q)[0]


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


def cache_positions(cache: KVCache, attn: str, window: int) -> torch.Tensor:
    """Logical position held by each cache slot *after* the current token
    (at position ``cache.index``) has been written; empty slots -> -1."""
    slots = cache.k.shape[-3]
    pos = cache.index
    slot_ids = torch.arange(slots, device=cache.k.device)
    if attn in ("sliding", "chunked") and window:
        logical = pos - ((pos - slot_ids) % slots)
        return torch.where(logical >= 0, logical, -1)
    return torch.where(slot_ids <= pos, slot_ids, -1)


def decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, cache: KVCache, *,
                     attn: str = "full", window: int = 0,
                     softcap_val: float = 0.0,
                     scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One-token attention.  q: (B, 1, H, D); k_new, v_new: (B, 1, KV, D);
    cache k, v: (B, S, KV, D), written in place at slot ``index % S``."""
    B, _, H, D = q.shape
    KV = k_new.shape[2]
    groups = H // KV
    scale = scale if scale is not None else D ** -0.5
    slots = cache.k.shape[1]
    pos = cache.index
    slot = pos % slots               # full cache: pos < slots
    cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)

    k_pos = cache_positions(cache, attn, window)
    vis = visibility(torch.tensor([pos], device=q.device), k_pos, attn,
                     window)[0]                              # (S,)
    qf = _scaled(q, scale).reshape(B, KV, groups, D).to(cache.k.dtype)
    logits = qf.float() @ cache.k.permute(0, 2, 3, 1).float()  # (B,KV,g,S)
    if softcap_val > 0.0:
        logits = softcap_val * torch.tanh(logits / softcap_val)
    logits = torch.where(vis, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = p.to(cache.v.dtype).float() @ cache.v.permute(0, 2, 1, 3).float()
    out = out.reshape(B, 1, H, D).to(q.dtype)
    return out, KVCache(cache.k, cache.v, pos + 1)


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
                compute_dtype):
    """x: (B, T, d) -> q (B, T, H, D), k and v (B, T, KV, D), RoPE applied
    at ``positions`` (T,)."""
    B, T, _ = x.shape
    xc = x.to(compute_dtype)
    q = xc @ params["wq"].to(compute_dtype)
    k = xc @ params["wk"].to(compute_dtype)
    v = xc @ params["wv"].to(compute_dtype)
    if "bq" in params:
        q = q + params["bq"].to(compute_dtype)
        k = k + params["bk"].to(compute_dtype)
        v = v + params["bv"].to(compute_dtype)
    q = q.reshape(B, T, num_heads, head_dim)
    k = k.reshape(B, T, num_kv, head_dim)
    v = v.reshape(B, T, num_kv, head_dim)
    if rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def out_proj(params: dict, attn_out: torch.Tensor,
             compute_dtype) -> torch.Tensor:
    """(B, T, H, D) -> (B, T, d) through ``wo``."""
    B, T, H, D = attn_out.shape
    return (attn_out.reshape(B, T, H * D).to(compute_dtype)
            @ params["wo"].to(compute_dtype))
