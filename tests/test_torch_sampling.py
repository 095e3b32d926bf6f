"""The port's client samplers and schedule functions
(``repro_torch/core/sampling.py``) against the JAX package on the same
draws, on the CPU.

The reference draws its uniforms inside ``select`` from a key; the port
takes them as ``scores``.  Each test draws them once from the reference's
key and hands the same vector to both.  Integer and discrete outputs (m_t,
participant masks, ids, buckets, round counts) must match exactly; float
weights and probabilities within rtol 1e-6 (reductions in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampling as jsamp
from repro_torch.core import sampling as tsamp

SCHEDULES = [
    (jsamp.DynamicSampling(initial_rate=1.0, beta=0.1, min_clients=2),
     tsamp.DynamicSampling(initial_rate=1.0, beta=0.1, min_clients=2)),
    (jsamp.DynamicSampling(initial_rate=0.8, beta=0.3, min_clients=3),
     tsamp.DynamicSampling(initial_rate=0.8, beta=0.3, min_clients=3)),
    (jsamp.StaticSampling(initial_rate=0.5, min_clients=2),
     tsamp.StaticSampling(initial_rate=0.5, min_clients=2)),
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: with several test workers on one machine, torch's
    intra-op threads only contend (six workers with torch's default
    threads made the port's files more than ten times slower).  Restored
    after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _draws(seed: int, M: int):
    """The key the reference's sampler gets, and the (M,) uniforms it draws
    from it."""
    key = jax.random.PRNGKey(seed)
    return key, np.asarray(jax.random.uniform(key, (M,)))


def _norms(seed: int, M: int, kind: str) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "spread":
        return rng.lognormal(0.0, 1.0, M).astype(np.float32)
    if kind == "ties":
        return rng.choice(np.float32([0.5, 1.0, 2.0]), M).astype(np.float32)
    return np.ones(M, np.float32)


# ------------------------------------------------------ schedule functions
@pytest.mark.parametrize("M", [8, 32, 100])
def test_sample_clients_takes_the_reference_permutation(M):
    """The reference's ids are the head of ``permutation(key, M)``; handed
    ``argsort(perm)`` as scores the port returns exactly those ids."""
    js, ts = SCHEDULES[0]
    for t in (1, 5, 12, 40):
        key = jax.random.PRNGKey(1000 * M + t)
        want = np.asarray(jsamp.sample_clients(key, js, t, M))
        perm = np.asarray(jax.random.permutation(key, M))
        got = tsamp.sample_clients(_t(np.argsort(perm).astype(np.float32)),
                                   ts, t, M)
        np.testing.assert_array_equal(got.numpy(), want)
        assert len(want) == ts.num_clients(t, M)


@pytest.mark.parametrize("i", range(len(SCHEDULES)))
@pytest.mark.parametrize("M", [8, 100])
def test_cumulative_transport_and_rounds_for_budget(i, M):
    js, ts = SCHEDULES[i]
    for gamma, rounds in ((1.0, 10), (0.5, 31), (0.1, 80)):
        assert tsamp.cumulative_transport(ts, gamma, rounds, M) == \
            pytest.approx(jsamp.cumulative_transport(js, gamma, rounds, M),
                          rel=1e-12)
    for gamma, budget in ((1.0, 100.0), (0.5, 37.5), (0.25, 10.0)):
        assert tsamp.rounds_for_budget(ts, gamma, M, budget) == \
            jsamp.rounds_for_budget(js, gamma, M, budget)


@pytest.mark.parametrize("M", [1, 2, 15, 16, 17, 33, 100, 257, 4097])
def test_cumsum_associates_as_the_reference(M):
    """The samplers' CDF sums bitwise as ``jnp.cumsum`` does on XLA:CPU
    (blocks of 16), where ``torch.cumsum`` does not."""
    x = np.random.default_rng(M).lognormal(0.0, 1.0, M).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x)))
    np.testing.assert_array_equal(tsamp._cumsum(_t(x)).numpy(), want)


# --------------------------------------------------------------- samplers
@pytest.mark.parametrize("M", [5, 16, 100])
@pytest.mark.parametrize("kind", ["spread", "ties", "ones"])
def test_transmit_probabilities_match(M, kind):
    norms = _norms(M, M, kind)
    for m in (1, 2, M // 2, M - 1, M, M + 3):
        if m < 1:
            continue
        want = np.asarray(jsamp.transmit_probabilities(jnp.asarray(norms), m))
        got = tsamp.transmit_probabilities(_t(norms), m).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert got.sum() == pytest.approx(min(m, M), rel=1e-4)


@pytest.mark.parametrize("name", ["importance", "threshold"])
@pytest.mark.parametrize("M", [8, 32, 100])
@pytest.mark.parametrize("kind", ["spread", "ties", "ones"])
def test_adaptive_select_matches(name, M, kind):
    """Same (scores, norms, n_samples): ``part`` exact, weights rtol 1e-6."""
    jsmp, tsmp = jsamp.get_sampler(name), tsamp.get_sampler(name)
    norms = _norms(M + 1, M, kind)
    n = np.random.default_rng(M).uniform(1.0, 5.0, M).astype(np.float32)
    for i, (js, ts) in enumerate(SCHEDULES):
        for t in (1, 4, 9):
            key, u = _draws(100 * M + 10 * i + t, M)
            part, w = jsmp.select(key, js, jnp.float32(t), M, jnp.asarray(n),
                                  jnp.asarray(norms))
            got_part, got_w = tsmp.select(_t(u), ts, t, M, _t(n), _t(norms))
            np.testing.assert_array_equal(got_part.numpy(), np.asarray(part))
            np.testing.assert_allclose(got_w.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=0)
            assert int(got_part.sum()) <= tsmp.cohort_bucket(
                ts, ts.num_clients_host(t, M), M)


def test_importance_probabilities_match():
    norms = np.asarray([0.0, 1.0, 3.0, 0.5, 0.0, 2.0, 0.1, 1.4], np.float32)
    for expl in (0.1, 0.2, 1.0):
        want = jsamp.ImportanceSampler(exploration=expl).probabilities(
            jnp.asarray(norms))
        got = tsamp.ImportanceSampler(exploration=expl).probabilities(
            _t(norms))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        assert float(got.sum()) == pytest.approx(1.0, rel=1e-6)
        assert float(got.min()) >= expl / 8 - 1e-7


@pytest.mark.parametrize("slack", [1.0, 1.5, 2.0, 3.3])
@pytest.mark.parametrize("M", [8, 33, 100])
def test_threshold_cap_is_the_cohort_bucket(slack, M):
    """The port's host cap equals the reference's traced ``_cap`` and its
    host ``cohort_bucket``, for every m."""
    js, ts = SCHEDULES[0]
    jsmp = jsamp.ThresholdSampler(slack=slack)
    tsmp = tsamp.ThresholdSampler(slack=slack)
    for m in range(1, M + 1):
        want = int(jsmp._cap(js, jnp.int32(m), M))
        assert tsmp._cap(ts, m, M) == want
        assert tsmp.cohort_bucket(ts, m, M) == jsmp.cohort_bucket(js, m, M)
        assert tsmp.cohort_bucket(ts, m, M) == want


def test_get_sampler_and_validation():
    for name in ("uniform", "importance", "threshold"):
        smp = tsamp.get_sampler(name)
        ref = jsamp.get_sampler(name)
        assert smp.name == ref.name == name
        assert (smp.adaptive, smp.normalize, smp.ema) == \
            (ref.adaptive, ref.normalize, ref.ema)
    assert tsamp.get_sampler("importance", exploration=0.3).exploration == 0.3
    assert tsamp.get_sampler("threshold", slack=1.5).slack == 1.5
    with pytest.raises(ValueError, match="unknown sampler"):
        tsamp.get_sampler("bogus")
    with pytest.raises(ValueError, match="exploration"):
        tsamp.ImportanceSampler(exploration=0.0)
    with pytest.raises(ValueError, match="slack"):
        tsamp.ThresholdSampler(slack=0.5)


@pytest.mark.parametrize("name", ["importance", "threshold"])
def test_adaptive_sampler_aggregation_unbiased(name):
    """E[sum_i w_i u_i] == sum_i (n_i / n) u_i over selection draws, for
    fixed uploads and arbitrary tracked norms (within 4 standard errors),
    as the reference's ``tests/test_sampling.py`` checks its own."""
    M = 12
    sched = tsamp.StaticSampling(initial_rate=0.5, min_clients=2)
    rng = np.random.default_rng(3)
    norms = _t(rng.uniform(0.05, 2.0, M).astype(np.float32))
    u = rng.normal(size=(M,)).astype(np.float32)
    n = _t(rng.uniform(1.0, 4.0, M).astype(np.float32))
    target = float((n / n.sum()).numpy() @ u)
    smp = tsamp.get_sampler(name)
    assert smp.adaptive and not smp.normalize
    gen = torch.Generator().manual_seed(0)
    ests = []
    for _ in range(3000):
        part, w = smp.select(torch.rand(M, generator=gen), sched, 2, M, n,
                             norms)
        w = w.numpy()
        assert (w[part.numpy() == 0] == 0).all()
        ests.append(float(w @ u))
    stderr = np.std(ests) / np.sqrt(len(ests))
    assert abs(np.mean(ests) - target) < 4 * stderr + 1e-4, \
        (np.mean(ests), target, stderr)
