"""The port's attention backward (``models/flash_vjp.py``) against ``jax.vjp``
of the reference's ``flash_attention`` (its ``flash_core`` custom VJP) on
the CPU, fp32.

Cases: full, sliding and chunked attention (window 16), with and without
a softcap of 20, 4 query heads over 2 KV heads (GQA), queries at offset 0
and 8 (keys cover the offset), T = 48 in query blocks of 16 on the port's
side and key blocks of 16 on the reference's (so both walk several
blocks).  Tolerance: rtol 1e-4 / atol 1e-5 on the output and on (dq, dk,
dv); the two sum in other orders and the reference's online softmax
rescales across key blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro_torch.models import attention as attn
from repro_torch.models import flash_vjp

B, T, H, KV, D = 2, 48, 4, 2, 16
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: with several test workers on one machine, torch's
    intra-op threads only contend (the tier-1 run's six workers made
    these files about ten times slower).  Restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inputs(q_offset: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    S = T + q_offset
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    g = rng.standard_normal((B, T, H, D)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("q_offset", [0, 8])
@pytest.mark.parametrize("softcap", [0.0, 20.0])
@pytest.mark.parametrize("kind", ["full", "sliding", "chunked"])
def test_forward_and_vjp_match_reference(kind, softcap, q_offset):
    window = 0 if kind == "full" else 16
    q, k, v, g = _inputs(q_offset)
    kw = dict(attn=kind, window=window, softcap_val=softcap,
              q_offset=q_offset)

    def ref_fn(q, k, v):
        return ref_attn.flash_attention(q, k, v, block_kv=16, **kw)

    ref_out, vjp = jax.vjp(ref_fn, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v))
    ref_grads = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.from_numpy(x.copy()).requires_grad_()
                  for x in (q, k, v))
    out = attn.flash_attention(tq, tk, tv, block_q=16, **kw)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               **TOL)
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad),
                               ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"d{name}", **TOL)


def test_backward_keeps_only_inputs_output_and_lse():
    """Saved for the backward: q, k, v, the output and a (B, H, T) fp32
    log-sum-exp; no (T, S) probability block."""
    q, k, v, _ = _inputs(0)
    tq, tk, tv = (torch.from_numpy(x.copy()).requires_grad_()
                  for x in (q, k, v))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        out = attn.flash_attention(tq, tk, tv, block_q=16)
    assert sorted(saved) == sorted([(B, T, H, D), (B, T, KV, D),
                                    (B, T, KV, D), (B, T, H, D), (B, H, T)])
    out.sum().backward()
    assert tq.grad is not None and tk.grad.shape == (B, T, KV, D)


def test_no_grad_forward_is_the_function_forward():
    """The serving path (no gradient) and the autograd function give the
    same bits."""
    q, k, v, _ = _inputs(0, seed=3)
    args = [torch.from_numpy(x.copy()) for x in (q, k, v)]
    with torch.no_grad():
        plain = attn.flash_attention(*args, attn="sliding", window=16,
                                     block_q=16)
    fn = flash_vjp.FlashAttention.apply(
        *[a.clone().requires_grad_() for a in args], "sliding", 16, 0.0,
        D ** -0.5, 0, 16)
    assert torch.equal(plain, fn.detach())


def test_bf16_backward_follows_the_reference_casts():
    """bf16 inputs: the output and gradients stay within two bf16 ulps of
    the reference's (they round the same fp32 values after sums in other
    orders)."""
    q, k, v, g = _inputs(0, seed=5)
    bf = jnp.bfloat16
    ref_out, vjp = jax.vjp(
        lambda q, k, v: ref_attn.flash_attention(q, k, v, block_kv=16),
        *(jnp.asarray(x, bf) for x in (q, k, v)))
    ref_grads = vjp(jnp.asarray(g, bf))
    tq, tk, tv = (torch.from_numpy(x.copy()).to(torch.bfloat16)
                  .requires_grad_() for x in (q, k, v))
    out = attn.flash_attention(tq, tk, tv, block_q=16)
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    for got, want in zip((out, tq.grad, tk.grad, tv.grad),
                         (ref_out, *ref_grads)):
        want = np.asarray(want, np.float32)
        got = got.detach().float().numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 2 * 2.0 ** -8 * scale
