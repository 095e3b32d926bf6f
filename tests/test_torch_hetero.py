"""The port's hetero fleet (``repro_torch/core/hetero.py``) and the
generalized round bodies — non-uniform samplers with the norm EMA, upload
dropout, the host-side round clock — against the JAX package, on the CPU.

Server runs take the reference's own draws (``reference_draws``: the
sample and the drop uniforms of its three-way key split).  Each run records
the (part, arrived) masks both servers hand to ``simulate_round``, and an
adaptive sampler's participation mask every round.  Exact:
trait draws, simulated clocks, participants, arrived masks, buckets,
``num_sampled``, bytes, ``sim_round_s`` and ``dropped``.  Floats: losses
rtol 1e-3, parameters and norms atol 1e-3 (XLA and PyTorch reduce in other
orders; the measured gaps are about 1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hetero as jhet
from repro.core import sampling as jsamp
from repro.core import server as jserver
from repro.core import strategy as jst
from repro.data.partition import iid_partition_images
from repro.data.synthetic import class_gaussian_images
from repro.models import paper_models as jpm
from repro_torch import bridge
from repro_torch.core import hetero as thet
from repro_torch.core import sampling as tsamp
from repro_torch.core import server as tserver
from repro_torch.core import strategy as tst
from repro_torch.models import paper_models as tpm
from test_torch_slice import recording_sampler, reference_draws

M, ROUNDS, BATCH = 8, 6, 16


# ------------------------------------------------------------- the fleet
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


@pytest.mark.parametrize("profile", ["ideal", "mobile", "flaky-mobile"])
@pytest.mark.parametrize("seed,M_", [(0, 8), (3, 100), (11, 1000)])
def test_traits_and_drop_rates_identical(profile, seed, M_):
    for dropout in (None, 0.3, 0.9):
        want = jhet.HeteroModel(profile, seed, dropout).client_traits(M_)
        got = thet.HeteroModel(profile, seed, dropout).client_traits(M_)
        for field in ("flops_per_s", "latency_s", "uplink_bps", "drop_rate"):
            a, b = getattr(want, field), getattr(got, field)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
        assert jhet.HeteroModel(profile, seed, dropout).drop_rates(M_) \
            .tobytes() == thet.HeteroModel(profile, seed,
                                           dropout).drop_rates(M_).tobytes()
    assert thet.MAX_DROP_RATE == jhet.MAX_DROP_RATE
    assert thet.profile_names() == jhet.profile_names()


def test_simulate_round_and_arrival_stream_identical():
    rng = np.random.default_rng(0)
    for profile in ("ideal", "mobile", "flaky-mobile"):
        want_t = jhet.HeteroModel(profile, 2).client_traits(50)
        got_t = thet.HeteroModel(profile, 2).client_traits(50)
        for _ in range(5):
            part = (rng.uniform(size=50) < 0.6).astype(np.float32)
            arrived = part * (rng.uniform(size=50) < 0.8)
            for flops, nbytes in ((1e9, 123_984), (6.5e10, 431_184)):
                assert thet.simulate_round(got_t, part, arrived, flops,
                                           nbytes) == \
                    jhet.simulate_round(want_t, part, arrived, flops, nbytes)
                want = list(jhet.arrival_stream(
                    want_t, part, flops, nbytes,
                    np.random.default_rng(4), 0.25))
                got = list(thet.arrival_stream(
                    got_t, part, flops, nbytes,
                    np.random.default_rng(4), 0.25))
                assert got == want
    empty = np.zeros(50)
    assert thet.simulate_round(got_t, empty, empty, 1e9, 10) == \
        {"sim_round_s": 0.0, "straggler_s": 0.0, "dropped": 0}
    with pytest.raises(ValueError, match="profile"):
        thet.HeteroModel("bogus")
    with pytest.raises(ValueError, match="dropout"):
        thet.HeteroModel("mobile", dropout=1.0)


# -------------------------------------------------- server runs, both sides
def _threshold(pkg, samp, het):
    """fig3 (dense) under the threshold sampler at slack 1.5 with a faster
    decay, so the cohort body runs from round 3 on, on the flaky fleet."""
    return pkg.get("fig3").replace(
        sampler=samp.ThresholdSampler(slack=1.5),
        sampling=samp.DynamicSampling(initial_rate=1.0, beta=0.3,
                                      min_clients=2),
        hetero=het.HeteroModel("flaky-mobile"))


CASES = {
    "fig3-importance": lambda pkg, samp, het: pkg.get("fig3-importance"),
    "hetero-dropout": lambda pkg, samp, het: pkg.get("hetero-dropout"),
    "threshold-flaky": _threshold,
}


def _recording(module, calls):
    real = module.simulate_round

    def record(traits, part, arrived, flops, upload_bytes):
        calls.append((np.asarray(part, np.float32).copy(),
                      np.asarray(arrived, np.float32).copy()))
        return real(traits, part, arrived, flops, upload_bytes)

    return record


def run_pair(name: str):
    """The reference server and the port's on one strategy, the port fed
    the reference's draws; returns both and each side's recorded masks:
    ``(part, arrived)`` a round with a fleet, and the selections of an
    adaptive sampler."""
    masks = {"ref": [], "port": [], "ref_part": [], "port_part": []}
    js = CASES[name](jst, jsamp, jhet)
    ts = CASES[name](tst, tsamp, thet)
    if js.sampler.adaptive:
        js = js.replace(sampler=recording_sampler(js.sampler,
                                                  masks["ref_part"], True))
        ts = ts.replace(sampler=recording_sampler(ts.sampler,
                                                  masks["port_part"], False))
    ds = class_gaussian_images(num_train=512, image_size=12, seed=0)
    xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, M, BATCH,
                                      seed=0)
    p0 = jpm.init_lenet(jax.random.PRNGKey(0), image_size=12)
    hetero = js.hetero is not None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jserver, "simulate_round",
                   _recording(jserver, masks["ref"]))
        mp.setattr(tserver, "simulate_round",
                   _recording(tserver, masks["port"]))
        ref = jserver.FederatedServer.from_strategy(
            js, jpm.classifier_loss(jpm.lenet_forward), p0, M, seed=0)
        ref.run((jnp.asarray(xs), jnp.asarray(ys)), ns, ROUNDS)
        port = tserver.FederatedServer.from_strategy(
            ts, tpm.classifier_loss(tpm.lenet_forward),
            bridge.params_from_numpy(jax.device_get(p0), device="cpu"), M,
            device="cpu",
            scores=lambda t, m: reference_draws(t, m, 0, hetero)[0],
            drop_scores=(lambda t, m: reference_draws(t, m, 0, True)[1])
            if hetero else None)
        port.run((xs, ys), ns, ROUNDS)
    return ref, port, masks


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    return request.param, run_pair(request.param)


def test_participants_masks_and_clock_exact(pair):
    name, (ref, port, masks) = pair
    assert [r.num_sampled for r in port.history] == \
        [r.num_sampled for r in ref.history]
    assert [r.cohort_size for r in port.history] == \
        [r.cohort_size for r in ref.history]
    assert port.summary()["transport_bytes"] == \
        ref.summary()["transport_bytes"]
    assert all(r.transport_bytes == r.num_sampled * port.client_upload_bytes
               for r in port.history)
    for field in ("sim_round_s", "straggler_s", "dropped"):
        assert [getattr(r, field) for r in port.history] == \
            [getattr(r, field) for r in ref.history], field
    assert len(masks["port"]) == len(masks["ref"])
    for (p_part, p_arr), (r_part, r_arr) in zip(masks["port"], masks["ref"]):
        np.testing.assert_array_equal(p_part, r_part)
        np.testing.assert_array_equal(p_arr, r_arr)
    assert len(masks["port_part"]) == len(masks["ref_part"])
    for got, want in zip(masks["port_part"], masks["ref_part"]):
        np.testing.assert_array_equal(got, want)
    if port.strategy.sampler.adaptive:
        assert len(masks["port_part"]) == ROUNDS
    summ, want = port.summary(), ref.summary()
    for key in ("hetero", "sim_total_s", "dropped_uploads", "sampler"):
        assert summ.get(key) == want.get(key), key
    if name != "fig3-importance":
        assert summ["dropped_uploads"] > 0
    if name == "threshold-flaky":
        assert min(r.cohort_size for r in port.history) < M


def test_losses_parameters_and_norms_match(pair):
    name, (ref, port, _) = pair
    np.testing.assert_allclose([r.mean_loss for r in port.history],
                               [r.mean_loss for r in ref.history], rtol=1e-3)
    want = bridge.flatten_tree(jax.device_get(ref.params))
    for k, leaf in port.params.items():
        np.testing.assert_allclose(leaf.numpy(), want[k], rtol=0, atol=1e-3,
                                   err_msg=k)
    if port.strategy.sampler.adaptive:
        np.testing.assert_allclose(port.store.norms.numpy(),
                                   np.asarray(ref.store.norms), rtol=0,
                                   atol=1e-3)
        assert float((port.store.norms - 1.0).abs().max()) > 0
    else:
        assert port.store.norms is None


# ------------------------------------------------ the port's own guarantees
@pytest.mark.parametrize("sampler_name", ["importance", "threshold"])
def test_cohort_matches_oracle_nonuniform(sampler_name):
    """The generalized cohort body against the oracle body under adaptive
    selection and dropout, with error feedback: participants, drops and
    buckets exact; parameters, residuals and norms within rtol 1e-5 /
    atol 1e-6 (cuDNN/oneDNN batch the clients differently)."""
    Mc = 16
    ds = class_gaussian_images(num_train=Mc * 32, image_size=12, seed=1)
    xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, Mc, 16, seed=1)
    st = tst.get("fig3", sampler=tsamp.get_sampler(sampler_name),
                 sampling=tsamp.DynamicSampling(initial_rate=1.0, beta=0.3,
                                                min_clients=2),
                 hetero=thet.HeteroModel(profile="mobile", seed=1),
                 error_feedback=True, learning_rate=0.1)
    runs = {}
    for engine in ("full", "cohort"):
        params = tpm.init_lenet(torch.Generator().manual_seed(3),
                                image_size=12, device="cpu")
        server = tserver.FederatedServer.from_strategy(
            st, tpm.classifier_loss(tpm.lenet_forward), params, Mc,
            engine=engine, seed=11, device="cpu")
        server.run((xs, ys), ns, 6)
        runs[engine] = server
    full, cohort = runs["full"], runs["cohort"]
    for field in ("num_sampled", "dropped", "sim_round_s"):
        assert [getattr(r, field) for r in full.history] == \
            [getattr(r, field) for r in cohort.history], field
    for k, v in full.params.items():
        np.testing.assert_allclose(cohort.params[k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in full.store.residuals_dense().items():
        np.testing.assert_allclose(
            cohort.store.residuals_dense()[k].numpy(), v.numpy(), rtol=1e-5,
            atol=1e-6, err_msg=k)
    np.testing.assert_allclose(cohort.store.norms.numpy(),
                               full.store.norms.numpy(), rtol=1e-5)
    assert float((cohort.store.norms - 1.0).abs().max()) > 0
    for t, rec in enumerate(cohort.history, start=1):
        m = st.sampling.num_clients_host(t, Mc)
        assert rec.cohort_size == st.sampler.cohort_bucket(st.sampling, m,
                                                           Mc)
        assert rec.num_sampled <= rec.cohort_size
    assert min(r.cohort_size for r in cohort.history) < Mc


@pytest.mark.parametrize("form", ["full", "cohort"])
def test_empty_round_reports_nan_not_zero_loss(form):
    """A threshold round that selects nobody leaves the parameters, the
    state and the norms as they were and reports a NaN loss."""
    st = tst.get("fig3", sampler=tsamp.ThresholdSampler(),
                 sampling=tsamp.StaticSampling(initial_rate=0.5,
                                               min_clients=2))
    ds = class_gaussian_images(num_train=256, image_size=12, seed=0)
    xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, M, BATCH,
                                      seed=0)
    params = tpm.init_lenet(torch.Generator().manual_seed(0), image_size=12,
                            device="cpu")
    round_fn = tst.build_round(st, tpm.classifier_loss(tpm.lenet_forward), M,
                               form=form, cohort_size=M // 2)
    state = {"residuals": {k: torch.zeros((M,) + v.shape)
                           for k, v in params.items()},
             "norms": torch.ones(M)}
    # norms all one at m = 4 of 8: p = 0.5 each; every draw above it
    new, out, metrics = round_fn(params, state, [torch.as_tensor(xs),
                                                 torch.as_tensor(ys)],
                                 torch.as_tensor(ns), 1,
                                 torch.full((M,), 0.75))
    assert float(metrics["num_sampled"]) == 0.0
    assert np.isnan(float(metrics["mean_loss"]))
    for k, v in params.items():
        assert torch.equal(new[k], v), k
    assert torch.equal(out["norms"], state["norms"])
