"""Blocked attention with a recomputing backward (counterpart of
``repro/models/flash_vjp.py``: ``flash_core``, its ``_flash_fwd`` and
``_flash_bwd``).

The reference writes this in jnp and leaves it to XLA, not in Pallas, so the
port's counterpart is plain PyTorch: the products are ``torch.matmul``.

* :func:`flash_forward` walks query blocks.  Each block takes the keys it
  can see (causal from ``q_offset``, and the window for sliding or chunked
  layers), computes fp32 logits, masks them with
  ``attention.visibility`` and applies an exact softmax: unnormalised
  ``exp(l - max)`` cast to the value dtype, multiplied with V in fp32,
  divided by the fp32 row sum.  It also returns each row's log-sum-exp.
  That is the reference's online softmax when the keys fit in one of its
  2048-wide blocks, and equal to it up to rounding beyond.
* :class:`FlashAttention` is the ``torch.autograd.Function`` behind
  training: it saves the inputs, the output and the (B, H, T) fp32
  log-sum-exp, never a probability block, and its backward recomputes each
  block's probabilities from them (the FlashAttention-2 backward, as the
  reference's custom VJP).  So what attention keeps for the backward is
  O(T) per head, and the backward's temporaries are one query block's.

Casts follow the reference's backward: ``dp`` and ``dv`` in fp32, ``ds``
rounded to the key dtype for ``dq`` and to the query dtype for ``dk``,
``dq`` scaled by the unrounded ``scale``, and the GQA head groups summed
back onto their KV heads.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.attention import NEG_INF, _scaled, visibility

__all__ = ["flash_forward", "FlashAttention"]


def _key_range(q_lo: int, q_hi: int, num_keys: int, attn: str,
              window: int) -> Tuple[int, int]:
    """The keys ``[lo, hi)`` that queries at positions ``[q_lo, q_hi)`` can
    see (a superset; ``attention.visibility`` masks the rest).  The
    whole key range when none is visible, as the reference's fully masked
    rows attend over their block."""
    hi = min(num_keys, q_hi)
    lo = 0
    if attn == "sliding" and window > 0:
        lo = max(0, q_lo - window + 1)
    elif attn == "chunked" and window > 0:
        lo = q_lo // window * window
    if lo >= hi:
        return 0, num_keys
    return lo, hi


def _heads(q, k, v, scale):
    """(B, T, H, D) and (B, S, KV, D) -> (B, H, T, D) scaled queries and
    (B, H, S, D) keys and values with the KV heads repeated per group."""
    groups = q.shape[2] // k.shape[2]
    qh = _scaled(q, scale).transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(groups, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(groups, dim=1)
    return qh, kh, vh


def _block_logits(qh, kh, qs, qe, ks, ke, q_offset, attn, window,
                  softcap_val):
    """One block's masked fp32 logits, the visibility mask and, with a
    softcap, ``tanh(raw / cap)``."""
    raw = qh[:, :, qs:qe].float() @ kh[:, :, ks:ke].float().transpose(2, 3)
    th = None
    if softcap_val > 0.0:
        th = torch.tanh(raw / softcap_val)
        raw = softcap_val * th
    dev = qh.device
    vis = visibility(torch.arange(q_offset + qs, q_offset + qe, device=dev),
                     torch.arange(ks, ke, device=dev), attn, window)
    return torch.where(vis, raw, NEG_INF), vis, th


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  attn: str = "full", window: int = 0,
                  softcap_val: float = 0.0, scale: float = 1.0,
                  q_offset: int = 0, block_q: int = 512
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, T, H, D); k, v: (B, S, KV, D) with H a multiple of KV.
    Query positions are ``q_offset + [0..T)``, key positions ``[0..S)``.
    Returns (out (B, T, H, D) in q's dtype, lse (B, H, T) fp32)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    qh, kh, vh = _heads(q, k, v, scale)
    out = torch.empty((B, H, T, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    for qs in range(0, T, block_q):
        qe = min(T, qs + block_q)
        ks, ke = _key_range(q_offset + qs, q_offset + qe, S, attn, window)
        logits, _, _ = _block_logits(qh, kh, qs, qe, ks, ke, q_offset, attn,
                                     window, softcap_val)
        m = logits.amax(-1, keepdim=True)
        p = torch.exp(logits - m)
        lsum = p.sum(-1, keepdim=True).clamp_min(1e-30)
        acc = p.to(v.dtype).float() @ vh[:, :, ks:ke].float()
        out[:, :, qs:qe] = (acc / lsum).to(q.dtype)
        lse[:, :, qs:qe] = (m + torch.log(lsum))[..., 0]
    return out.transpose(1, 2), lse


class FlashAttention(torch.autograd.Function):
    """Attention whose backward recomputes the probabilities: saves q, k,
    v, the output and the per-row log-sum-exp only."""

    @staticmethod
    def forward(ctx, q, k, v, attn: str, window: int, softcap_val: float,
                scale: float, q_offset: int, block_q: int):
        """:func:`flash_forward`'s output; the log-sum-exp is kept."""
        out, lse = flash_forward(q, k, v, attn=attn, window=window,
                                 softcap_val=softcap_val, scale=scale,
                                 q_offset=q_offset, block_q=block_q)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (attn, window, softcap_val, scale, q_offset, block_q)
        return out

    @staticmethod
    def backward(ctx, g):
        """(dq, dk, dv) block by block, the reference's ``_flash_bwd``."""
        q, k, v, out, lse = ctx.saved_tensors
        attn, window, softcap_val, scale, q_offset, block_q = ctx.args
        B, T, H, D = q.shape
        S, KV = k.shape[1], k.shape[2]
        qh, kh, vh = _heads(q, k, v, scale)
        do = g.transpose(1, 2).float()                       # (B, H, T, D)
        delta = (do * out.transpose(1, 2).float()).sum(-1)   # (B, H, T)
        f32 = torch.float32
        dq = torch.empty((B, H, T, D), dtype=f32, device=q.device)
        dk = torch.zeros((B, H, S, D), dtype=f32, device=q.device)
        dv = torch.zeros((B, H, S, D), dtype=f32, device=q.device)
        for qs in range(0, T, block_q):
            qe = min(T, qs + block_q)
            ks, ke = _key_range(q_offset + qs, q_offset + qe, S, attn, window)
            logits, vis, th = _block_logits(qh, kh, qs, qe, ks, ke, q_offset,
                                            attn, window, softcap_val)
            p = torch.exp(logits - lse[:, :, qs:qe, None])
            p = torch.where(vis, p, 0.0)
            do_b = do[:, :, qs:qe]
            dp = do_b @ vh[:, :, ks:ke].float().transpose(2, 3)
            ds = p * (dp - delta[:, :, qs:qe, None])
            if th is not None:
                ds = ds * (1.0 - th * th)
            ds = torch.where(vis, ds, 0.0)
            dq[:, :, qs:qe] = ds.to(k.dtype).float() @ kh[:, :, ks:ke].float()
            dv[:, :, ks:ke] += p.transpose(2, 3) @ do_b
            dk[:, :, ks:ke] += (ds.to(q.dtype).float().transpose(2, 3)
                                @ qh[:, :, qs:qe].float())
        groups = H // KV
        dq = (dq * scale).transpose(1, 2).to(q.dtype)
        dk = dk.reshape(B, KV, groups, S, D).sum(2).transpose(1, 2).to(k.dtype)
        dv = dv.reshape(B, KV, groups, S, D).sum(2).transpose(1, 2).to(v.dtype)
        return dq, dk, dv, None, None, None, None, None, None
