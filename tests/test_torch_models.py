"""The port's VGG and GRU language model, and its text data, against the
JAX package on the same inputs.

Weights are carried across by the bridge.  Sizes are the reference
benchmarks' (``benchmarks/common.py``): VGG at 16 px with widths
(16, 32, 64); the GRU with a 256-token vocabulary, 64/64 widths, T = 24.
Tolerances: logits and loss rtol 1e-5, gradients rtol 1e-4 (the GRU's
gradients accumulate over 24 steps, summed in a different order by XLA
and PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value

from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.models import paper_models as jpm
from repro_torch import bridge
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.models import paper_models as tpm


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("seed", [0, 3])
def test_markov_text_is_byte_identical(seed):
    want = jsyn.markov_text(num_train=5000, num_test=700, vocab_size=300,
                            seed=seed)
    got = tsyn.markov_text(num_train=5000, num_test=700, vocab_size=300,
                           seed=seed)
    for name in ("train_tokens", "test_tokens"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == np.int32
        assert a.tobytes() == b.tobytes(), name
    assert got.vocab_size == want.vocab_size


@pytest.mark.parametrize("seed", [0, 3])
def test_partition_text_is_byte_identical(seed):
    tokens = tsyn.markov_text(num_train=6000, seed=seed).train_tokens
    want = jpart.partition_text(tokens, 8, 4, 24, seed=seed)
    got = tpart.partition_text(tokens, 8, 4, 24, seed=seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert got[0].shape == (8, 7, 4, 24)
    np.testing.assert_array_equal(got[0][..., 1:], got[1][..., :-1])


def test_partition_text_rejects_a_corpus_too_small():
    with pytest.raises(ValueError):
        tpart.partition_text(np.arange(50, dtype=np.int32), 8, 4, 24)


# ------------------------------------------------------------------ models
def _check_grads(got, want, rtol):
    want = bridge.flatten_tree(jax.device_get(want))
    assert list(got) == list(want)
    for name, g in got.items():
        scale = float(np.abs(want[name]).max()) or 1.0
        np.testing.assert_allclose(g.numpy(), want[name], rtol=rtol,
                                   atol=rtol * scale, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_vgg_logits_loss_and_grads_match(seed):
    p = jpm.init_vgg(jax.random.PRNGKey(seed), 16, 3, widths=(16, 32, 64))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, 6).astype(np.int32)
    tp = bridge.params_from_numpy(jax.device_get(p), device="cpu")
    np.testing.assert_allclose(
        tpm.vgg_forward(tp, _t(x)).numpy(),
        np.asarray(jpm.vgg_forward(p, jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    jl, jg = jax.value_and_grad(jpm.classifier_loss(jpm.vgg_forward))(
        p, (jnp.asarray(x), jnp.asarray(y)))
    g, loss = grad_and_value(tpm.classifier_loss(tpm.vgg_forward))(
        tp, (_t(x), _t(y)))
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    _check_grads(g, jg, 1e-4)
    acc = tpm.classifier_accuracy(tpm.vgg_forward)(tp, (_t(x), _t(y)))
    jacc = jpm.classifier_accuracy(jpm.vgg_forward)(p, (jnp.asarray(x),
                                                        jnp.asarray(y)))
    assert float(acc) == float(jacc)


def test_vgg_pools_only_while_both_spatial_dims_allow():
    """Four stages on an 8 px input: pools after stages 0-2 (8 -> 4 -> 2
    -> 1), none after stage 3, whose activation is 1 x 1."""
    p = jpm.init_vgg(jax.random.PRNGKey(2), 8, 3, widths=(8, 8, 8, 8))
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 3)
                                                 ).astype(np.float32)
    tp = bridge.params_from_numpy(jax.device_get(p), device="cpu")
    np.testing.assert_allclose(
        tpm.vgg_forward(tp, _t(x)).numpy(),
        np.asarray(jpm.vgg_forward(p, jnp.asarray(x))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tied", [True, False])
def test_gru_lm_logits_loss_and_grads_match(tied):
    p = jpm.init_gru_lm(jax.random.PRNGKey(1), 256, 64, 64, tied=tied)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, (4, 25)).astype(np.int32)
    x, y = toks[:, :-1], toks[:, 1:]
    tp = bridge.params_from_numpy(jax.device_get(p), device="cpu")
    logits = tpm.gru_lm_forward(tp, _t(x))
    assert tuple(logits.shape) == (4, 24, 256)
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jpm.gru_lm_forward(p, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)
    jl, jg = jax.value_and_grad(jpm.gru_lm_loss)(p, (jnp.asarray(x),
                                                     jnp.asarray(y)))
    g, loss = grad_and_value(tpm.gru_lm_loss)(tp, (_t(x), _t(y)))
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    _check_grads(g, jg, 1e-4)
    ppl = tpm.perplexity(tp, (_t(x), _t(y)))
    assert float(ppl) == pytest.approx(
        float(jpm.perplexity(p, (jnp.asarray(x), jnp.asarray(y)))), rel=1e-5)


def test_gru_lm_grads_under_vmap_match_one_client_at_a_time():
    """The round differentiates the loss under ``torch.func.vmap`` with
    per-client weights; the embedding lookup and its backward included."""
    p = tpm.init_gru_lm(torch.Generator().manual_seed(0), 64, 16, 16,
                        device="cpu")
    stacked = {k: torch.stack([v, 1.5 * v]) for k, v in p.items()}
    toks = torch.randint(0, 64, (2, 3, 9),
                         generator=torch.Generator().manual_seed(1))
    x, y = toks[..., :-1].int(), toks[..., 1:].int()
    g, loss = torch.func.vmap(grad_and_value(tpm.gru_lm_loss))(stacked,
                                                               (x, y))
    for i in range(2):
        gi, li = grad_and_value(tpm.gru_lm_loss)(
            {k: v[i] for k, v in stacked.items()}, (x[i], y[i]))
        torch.testing.assert_close(loss[i], li)
        for k in gi:
            torch.testing.assert_close(g[k][i], gi[k], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("model", ["vgg", "gru"])
def test_full_width_inits_have_the_reference_leaves(model):
    if model == "vgg":
        want = jpm.init_vgg(jax.random.PRNGKey(0))
        got = tpm.init_vgg(torch.Generator().manual_seed(0), device="cpu")
        total, maskable = 617_770, 11
    else:
        want = jpm.init_gru_lm(jax.random.PRNGKey(0), 512)
        got = tpm.init_gru_lm(torch.Generator().manual_seed(0), 512,
                              device="cpu")
        total, maskable = 180_608, 5
    want = bridge.flatten_tree(jax.device_get(want))
    assert list(got) == list(want)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert sum(v.numel() for v in got.values()) == total
    assert sum(v.numel() >= 256 for v in got.values()) == maskable
    for name, leaf in got.items():
        if name.endswith("b") and leaf.dim() == 1:
            assert not leaf.any(), name
        else:
            assert leaf.std() == pytest.approx(float(np.std(want[name])),
                                               rel=0.15), name


def test_bridge_round_trips_both_trees():
    for p in (jpm.init_vgg(jax.random.PRNGKey(0), 16, 3, widths=(16, 32)),
              jpm.init_gru_lm(jax.random.PRNGKey(0), 64, 8, 8, tied=False)):
        p = jax.device_get(p)
        back = bridge.params_to_numpy(bridge.params_from_numpy(p,
                                                               device="cpu"))
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(p)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(p)):
            assert a.tobytes() == np.asarray(b).tobytes()


def test_modules_wrap_the_functional_forms():
    vp = tpm.init_vgg(torch.Generator().manual_seed(0), 16, 3,
                      widths=(8, 16), device="cpu")
    gp = tpm.init_gru_lm(torch.Generator().manual_seed(0), 32, 8, 8,
                         device="cpu")
    x = torch.randn(2, 16, 16, 3)
    toks = torch.randint(0, 32, (2, 5))
    vgg, gru = tpm.VGG(vp), tpm.GRULM(gp)
    assert list(vgg.params()) == list(vp)
    assert list(gru.params()) == list(gp)
    torch.testing.assert_close(vgg(x), tpm.vgg_forward(vp, x))
    torch.testing.assert_close(gru(toks), tpm.gru_lm_forward(gp, toks))
