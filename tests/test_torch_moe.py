"""The port's mixture of experts (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` on the CPU, on the same numpy inputs.

Cases (d 16, expert width 24; parameters and tokens drawn with numpy from
seed 0, at the reference's ``init_moe_params`` leaf names and scales):
- ``base``: 8 experts, top 2, gated, a 32-wide shared FFN, 2 x 8 tokens
  in one group;
- ``ungated`` and ``no-shared``: the same without the gate or without the
  shared experts;
- ``padded-group``: 2 x 37 tokens in groups of 16, so the last group
  holds 10 tokens and 6 zero rows;
- ``drops``: 256 tokens in groups of 16 at top 3 over 8 experts, so the
  6-slot capacity binds and picks are dropped;
- ``real-experts``: 16 experts of which 5 are real (``real_experts``),
  2 x 40 tokens in groups of 32.

Tolerances.  fp32: y rtol 1e-5 / atol 1e-6 and aux rtol 1e-5 (sums in
other orders; a different routing or drop would be an O(1) error);
gradients rtol 1e-4 / atol 1e-5 of ``jax.grad``'s.  bf16 (the experts in
bf16, routing still fp32): y within 2^-6 of its largest magnitude (a few
bf16 ulps: XLA rounds its fused products once, torch after each op).  The
routing (ids, positions, keep mask, dropped count) is exact against a plain
numpy loop.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tr
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import moe
from repro_torch.models import transformer as tr

D, F = 16, 24
# name -> (experts, real experts, top k, gated, shared width, (B, T), group)
CASES = {
    "base": (8, 0, 2, True, 32, (2, 8), 512),
    "ungated": (8, 0, 2, False, 32, (2, 8), 512),
    "no-shared": (8, 0, 2, True, 0, (2, 8), 512),
    "padded-group": (8, 0, 2, True, 32, (2, 37), 16),
    "drops": (8, 0, 3, True, 32, (4, 64), 16),
    "real-experts": (16, 5, 2, True, 32, (2, 40), 32),
}
FP32_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: with several test workers on one machine, torch's
    intra-op threads only contend.  Restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _inputs(name: str, dtype: str = "float32"):
    """(the reference's parameter dict of numpy arrays, x (B, T, D) fp32,
    the call's keywords).  The router stays fp32 in a bf16 tree."""
    E, real, k, gated, shared, (B, T), group = CASES[name]
    rng = np.random.default_rng(0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def dense(*shape, dt=jdt):
        w = rng.standard_normal(shape).astype(np.float32) / np.sqrt(
            shape[-2])
        return np.array(jnp.asarray(w, dt))

    ref_params = {"router": dense(D, E, dt=jnp.float32),
                  "wi": dense(E, D, F), "wo": dense(E, F, D)}
    if gated:
        ref_params["wg"] = dense(E, D, F)
    if shared:
        ref_params.update(shared_wi=dense(D, shared),
                          shared_wo=dense(shared, D))
        if gated:
            ref_params["shared_wg"] = dense(D, shared)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    kw = dict(topk=k, gated=gated, group_size=group, real_experts=real)
    return ref_params, x, kw


def _ref_moe(ref_params, x, kw):
    """The reference's ``moe_ffn`` under one jit (its eager form compiles
    every primitive on first use)."""
    return jax.jit(lambda p, xx: ref_moe.moe_ffn(p, xx, **kw))(ref_params, x)


def _port(ref_params):
    return bridge.params_from_numpy(ref_params, device="cpu")


def _x(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_matches_reference(name, dtype):
    ref_params, x, kw = _inputs(name, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref_y, ref_aux = _ref_moe(ref_params, jnp.asarray(x, jdt), kw)
    params = _port(ref_params)
    assert params["router"].dtype == torch.float32
    y, aux = moe.moe_ffn(params, _x(x, dtype), **kw)
    assert y.shape == x.shape and y.dtype == getattr(torch, dtype)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
    ref_y = np.asarray(ref_y, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(y.numpy(), ref_y, **FP32_TOL)
    else:
        err = np.abs(y.float().numpy() - ref_y).max()
        assert err <= 2.0 ** -6 * np.abs(ref_y).max(), err


def _numpy_routing(router, x, k, group, real, capacity_factor=1.25):
    """The reference's routing, written as a plain loop over groups,
    tokens and slots."""
    E = router.shape[1]
    xf = x.reshape(-1, x.shape[-1]).astype(np.float32)
    n = xf.shape[0]
    g = min(group, n)
    G = -(-n // g)
    xf = np.concatenate([xf, np.zeros((G * g - n, xf.shape[1]),
                                      np.float32)])
    logits = (xf @ router).reshape(G, g, E)
    if real and real < E:
        logits[..., real:] = -1e30
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    cap = max(1, int(g * k / (real or E) * capacity_factor))
    ids = np.zeros((G, g, k), np.int64)
    pos = np.zeros((G, g, k), np.int64)
    for gi in range(G):
        filled = [0] * E
        for t in range(g):
            # best first; equal values: the lower id first
            order = sorted(range(E), key=lambda e: (-probs[gi, t, e], e))
            for s in range(k):
                e = order[s]
                ids[gi, t, s] = e
                pos[gi, t, s] = filled[e]
                filled[e] += 1
    return ids, pos, pos < cap, cap


@pytest.mark.parametrize("name", list(CASES))
def test_routing_equals_a_plain_loop(name):
    ref_params, x, kw = _inputs(name)
    router = ref_params["router"]
    r = moe.route(torch.from_numpy(router), torch.from_numpy(x),
                  topk=kw["topk"], group_size=kw["group_size"],
                  real_experts=kw["real_experts"])
    ids, pos, keep, cap = _numpy_routing(
        router, x, kw["topk"], kw["group_size"], kw["real_experts"])
    assert r.capacity == cap
    assert np.array_equal(r.expert_ids.numpy(), ids)
    assert np.array_equal(r.positions.numpy(), pos)
    assert np.array_equal(r.keep.numpy(), keep)
    assert int((~r.keep).sum()) == int((~keep).sum())
    assert bool((r.gates[~r.keep] == 0).all())
    if name == "drops":
        assert int((~keep).sum()) > 0      # the capacity binds
    if kw["real_experts"]:
        assert int(r.expert_ids.max()) < kw["real_experts"]


@pytest.mark.parametrize("real", [0, 5])
def test_ties_go_to_the_lower_expert_id(real):
    """A zero router gives every real expert the same probability: the top
    k are then experts 0 .. k-1, as ``lax.top_k`` orders ties."""
    x = torch.randn((3, 7, D), generator=torch.Generator().manual_seed(0))
    r = moe.route(torch.zeros((D, 8)), x, topk=3, real_experts=real)
    assert torch.equal(r.expert_ids,
                       torch.arange(3).expand(r.expert_ids.shape))


@pytest.mark.parametrize("name", ["base", "ungated", "drops",
                                  "real-experts"])
def test_moe_gradients_match_jax_grad(name):
    """d/d(params, x) of sum(y * w) + aux: through the gates, the softmax
    and the experts; the keep mask and the top-1 one-hot carry none."""
    ref_params, x, kw = _inputs(name)
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def ref_f(p, xx):
        y, aux = ref_moe.moe_ffn(p, xx, **kw)
        return jnp.sum(y * w) + aux

    ref_gp, ref_gx = jax.jit(jax.grad(ref_f, argnums=(0, 1)))(
        ref_params, jnp.asarray(x))
    params = {k: v.requires_grad_() for k, v in _port(ref_params).items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_ffn(params, xt, **kw)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux,
                                [xt, *params.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(ref_gx),
                               rtol=1e-4, atol=1e-5)
    for (leaf, g) in zip(params, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_gp[leaf]),
                                   rtol=1e-4, atol=1e-5, err_msg=leaf)
    assert float(grads[1 + list(params).index("router")].abs().max()) > 0


# ------------------------------------------- the reference's padded experts
def _padded_cfgs():
    """One MoE layer, 5 real experts padded to 16, fp32."""
    out = []
    for get in (get_arch, ref_get_arch):
        cfg = dataclasses.replace(get("qwen2-moe-a2.7b").reduced(),
                                  moe_experts=5, moe_pad_experts=True,
                                  compute_dtype="float32")
        out.append(cfg)
    return out


SERVE_TOL = dict(rtol=1e-4, atol=1e-4)    # tests/test_torch_serve.py's


def test_padded_experts_are_never_routed_unlike_the_references_forward(
        monkeypatch):
    """The reference's ``forward`` omits ``real_experts`` (its decode passes
    it), so it routes the padded experts and sizes the capacity by 16
    experts.  The port passes it in both: its forward equals the
    reference's forward with that layer's ``moe_ffn`` given
    ``real_experts=5``, differs from the reference's own forward, and picks
    no padded expert."""
    cfg, rcfg = _padded_cfgs()
    assert cfg.padded_experts == 16
    params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    ref_params = bridge.params_to_numpy(params)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    ref_as_is = np.asarray(jax.jit(lambda p, t: ref_tr.forward(p, rcfg, t)[0])(
        ref_params, toks))

    original = ref_moe.moe_ffn
    monkeypatch.setattr(ref_moe, "moe_ffn", lambda *a, **kw: original(
        *a, **{**kw, "real_experts": rcfg.moe_experts}))
    ref_real = np.asarray(jax.jit(lambda p, t: ref_tr.forward(p, rcfg, t)[0])(
        ref_params, toks))
    monkeypatch.undo()

    picked = []
    port_route = moe.route
    monkeypatch.setattr(moe, "route", lambda *a, **kw: picked.append(
        port_route(*a, **kw)) or picked[-1])
    with torch.no_grad():
        logits, _ = tr.forward(params, cfg, torch.from_numpy(toks))
    assert len(picked) == cfg.num_layers
    assert all(int(r.expert_ids.max()) < 5 for r in picked)
    np.testing.assert_allclose(logits.numpy(), ref_real, **SERVE_TOL)
    assert np.abs(ref_as_is - ref_real).max() > 1e-2
