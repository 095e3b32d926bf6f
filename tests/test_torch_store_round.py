"""The store form of the round (``make_store_round`` and
``FederatedServer`` on a ``ShardedStore``), resumable server state and the
store's server-side contract, on the CPU.

* Port server against reference server on a ``ShardedStore`` whose window
  is smaller than the clients that commit, so it evicts: ``fig5`` (kernel
  masking) and ``noniid-dyn`` (drift, importance sampler, Dirichlet data;
  the preset's bisection masking), both with error feedback, LeNet-12,
  M = 8, 6 rounds, the port fed the reference's draws.  Participants,
  buckets, bytes, the slot directory, evictions and versions exact;
  losses rtol 1e-3, parameters, residual and drift pools and norms atol
  1e-3 (after a few rounds a delta entry lying on a candidate threshold
  can flip its mask, as in the slice tests).
* The store selection against the reference's, exact, for every sampler.
* In the port, on a linear model with 320-wide weights (so masking binds
  and residuals carry mass): dense and sharded stores bit-identical over
  every preset while nothing is evicted, and the reference's documented
  divergence when something is; resume (3 rounds, ``save_state``, a fresh
  server's ``restore_state``, 3 rounds) bit-identical to 6 rounds on both
  stores under random masking, the hetero fleet's dropout and FedDyn with
  the importance sampler; mismatched restores raise before anything is
  assigned; the store's validation, the batch provider, the random-mask
  draw limit, and ``compile_s`` on the store form's bucket changes.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client_store as jcs
from repro.core import federated as jfed
from repro.core import sampling as jsamp
from repro.core import strategy as jst
from repro.core.server import FederatedServer as JaxServer
from repro.data import partition as jpart
from repro.data.synthetic import class_gaussian_images
from repro.models import paper_models as jpm
from repro_torch import bridge
from repro_torch.core import federated as tfed
from repro_torch.core import sampling as tsamp
from repro_torch.core import server as tserver
from repro_torch.core import strategy as tst
from repro_torch.core.client_store import ShardedStore
from repro_torch.core.masking import MaskingConfig
from repro_torch.core.server import FederatedServer
from repro_torch.models import paper_models as tpm
from test_torch_slice import recording_sampler, reference_scores

M, ROUNDS, BATCH = 8, 6, 16
# preset -> (partition, retention): below the clients that commit over the
# run, at or above any one round's commits.
PARITY = {"fig5": ("iid", 7), "noniid-dyn": ("dirichlet", 6)}


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


@pytest.fixture(scope="module", params=sorted(PARITY))
def parity_runs(request):
    """The reference's server and the port's on one preset, both on a
    sharded store that evicts."""
    name = request.param
    partition, retention = PARITY[name]
    ds = class_gaussian_images(num_train=512, image_size=12, seed=0)
    split = (jpart.dirichlet_partition_images if partition == "dirichlet"
             else jpart.iid_partition_images)
    xs, ys, ns = split(ds.train_x, ds.train_y, M, BATCH, seed=0)
    p0 = jpm.init_lenet(jax.random.PRNGKey(0), image_size=12)
    js = jst.get(name, error_feedback=True)
    ts = tst.get(name, error_feedback=True)
    if name == "fig5":
        js = js.with_masking(jst.MaskPolicy.selective(0.5, backend="kernel"))
        ts = ts.with_masking(tst.MaskPolicy.selective(0.5, backend="kernel"))
    selected = {"ref": [], "port": []}
    if js.sampler.adaptive:
        js = js.replace(sampler=recording_sampler(js.sampler,
                                                  selected["ref"], True))
        ts = ts.replace(sampler=recording_sampler(ts.sampler,
                                                  selected["port"], False))
    drift = ts.objective.uses_drift
    ref_store = jcs.ShardedStore(M, p0, retention,
                                 track_norms=js.sampler.adaptive,
                                 extra_trees={"drift": p0} if drift else None)
    ref = JaxServer.from_strategy(js, jpm.classifier_loss(jpm.lenet_forward),
                                  p0, M, seed=0, store=ref_store)
    ref.run((jnp.asarray(xs), jnp.asarray(ys)), ns, ROUNDS)
    params = bridge.params_from_numpy(jax.device_get(p0), device="cpu")
    port_store = ShardedStore(M, params, retention,
                              track_norms=ts.sampler.adaptive,
                              extra_trees={"drift": params} if drift else None)
    port = FederatedServer.from_strategy(
        ts, tpm.classifier_loss(tpm.lenet_forward), params, M, device="cpu",
        scores=reference_scores, store=port_store)
    port.run((xs, ys), ns, ROUNDS)
    return name, ref, port, selected


def test_parity_participants_bytes_and_slot_directory_exact(parity_runs):
    name, ref, port, selected = parity_runs
    for field in ("num_sampled", "cohort_size", "transport_bytes"):
        assert [getattr(r, field) for r in port.history] == \
            [getattr(r, field) for r in ref.history], field
    assert len(selected["port"]) == len(selected["ref"]) == (
        ROUNDS if name == "noniid-dyn" else 0)
    for got, want in zip(selected["port"], selected["ref"]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.store._slot_ids,
                                  ref.store._slot_ids)
    np.testing.assert_array_equal(port.store._slot_round,
                                  ref.store._slot_round)
    np.testing.assert_array_equal(port.store.versions, ref.store.versions)
    assert port.store.evictions == ref.store.evictions > 0
    assert port.store.memory_bytes() == ref.store.memory_bytes()


def test_parity_losses_parameters_pools_and_norms(parity_runs):
    _, ref, port, _ = parity_runs
    np.testing.assert_allclose([r.mean_loss for r in port.history],
                               [r.mean_loss for r in ref.history], rtol=1e-3)
    pairs = [(port.params, ref.params)]
    for tree in port.store.trees:
        pairs.append((port.store._pools[tree], ref.store._pools[tree]))
    for got, want in pairs:
        want = bridge.flatten_tree(jax.device_get(want))
        for k, leaf in got.items():
            np.testing.assert_allclose(leaf.numpy(), want[k], rtol=0,
                                       atol=1e-3, err_msg=k)
    if port.store.norms is not None:
        np.testing.assert_allclose(port.store.norms.numpy(),
                                   np.asarray(ref.store.norms), rtol=0,
                                   atol=1e-3)
    assert float(sum(v.abs().sum() for v in port.store.slots.values())) > 0


@pytest.mark.parametrize("sampler", ["uniform", "importance", "threshold"])
def test_store_selection_matches_the_reference(sampler):
    """Participants, weights and the cohort buffer of the selection head on
    the reference's draws; importance and threshold on uneven norms."""
    Mc, bucket = 64, 32
    sched_t = tsamp.DynamicSampling(initial_rate=0.3, beta=0.1,
                                    min_clients=2)
    sched_j = jsamp.DynamicSampling(initial_rate=0.3, beta=0.1,
                                    min_clients=2)
    cfg_j = jfed.FederatedConfig(num_clients=Mc, client=jst.get(
        "fig5").client_config())
    cfg_t = tst.get("fig5").federated_config(Mc)
    sel_j = jax.jit(jfed.make_store_selection(
        sched_j, cfg_j, bucket, sampler=jsamp.get_sampler(sampler)))
    sel_t = tfed.make_store_selection(sched_t, cfg_t, bucket,
                                      sampler=tsamp.get_sampler(sampler))
    rng = np.random.default_rng(3)
    norms = rng.lognormal(0.0, 1.0, Mc).astype(np.float32)
    n = rng.integers(8, 64, Mc).astype(np.float32)
    for t in (1, 4):
        key = jax.random.PRNGKey(10 + t)
        part, weights, ids = sel_j(jnp.asarray(norms), jnp.asarray(n),
                                   jnp.float32(t), key)
        scores = torch.from_numpy(np.array(jax.random.uniform(key, (Mc,))))
        got = sel_t(torch.from_numpy(norms), torch.from_numpy(n), t, scores)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(part))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(weights),
                                   rtol=1e-6)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ids))
        assert got[2].numel() == bucket


# ---- the port's own store-form guarantees (linear model) -----------------
MS, NB, B, D = 16, 2, 4, 320
SMALL = dict(sampling=tsamp.DynamicSampling(initial_rate=0.25, beta=0.0,
                                            min_clients=2))


def _problem(num_clients=MS):
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((num_clients, NB, B, D)).astype(np.float32)
    ys = xs @ np.linspace(-1.0, 1.0, D).astype(np.float32)
    n = np.full((num_clients,), NB * B, np.float64)
    return (xs, ys), n


def _loss(p, batch):
    x, y = batch
    return torch.mean((x @ p["w"] + p["b"] - y) ** 2)


def _params():
    return {"w": torch.zeros(D), "b": torch.zeros(())}


def _server(strat, kind, retention=MS, num_clients=MS, **kw):
    params = _params()
    store = None
    if kind == "sharded":
        store = ShardedStore(
            num_clients, params, retention,
            track_norms=strat.sampler.adaptive,
            extra_trees=({"drift": params} if strat.objective.uses_drift
                         else None))
    return FederatedServer.from_strategy(strat, _loss, params, num_clients,
                                         device="cpu", seed=0, store=store,
                                         **kw)


def _bit_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _same_runs(a, b) -> None:
    """Two servers' results, bit for bit."""
    _bit_equal(a.params, b.params)
    for tree in a.store.trees:
        _bit_equal(a.store.dense_view(tree), b.store.dense_view(tree))
    if a.store.norms is not None:
        assert torch.equal(a.store.norms, b.store.norms)
    for field in ("num_sampled", "transport_bytes", "cohort_size", "dropped",
                  "quarantined", "sim_round_s"):
        assert [getattr(r, field) for r in a.history] == \
            [getattr(r, field) for r in b.history], field
    np.testing.assert_array_equal([r.mean_loss for r in a.history],
                                  [r.mean_loss for r in b.history])


@pytest.mark.parametrize("preset", [*tst.names(), "fig5-small-cohorts"])
def test_dense_and_sharded_stores_are_bit_identical(preset):
    """No eviction (retention = M): every preset as configured (full
    buckets run the oracle body on the dense store, the store body on the
    sharded one), and fig5 at cohorts of 4 of 16, where the two buffers
    pad with different clients."""
    if preset == "fig5-small-cohorts":
        strat = tst.get("fig5", error_feedback=True, **SMALL)
    else:
        strat = tst.get(preset)
    batches, n = _problem()
    runs = []
    for kind in ("dense", "sharded"):
        server = _server(strat, kind)
        server.run(batches, n, 3)
        runs.append(server)
    dense, sharded = runs
    assert sharded.store.evictions == 0
    _same_runs(dense, sharded)
    assert sharded.store.versions.max() == 3
    if preset == "fig5-small-cohorts":
        assert {r.cohort_size for r in sharded.history} == {4}


def test_eviction_divergence_is_the_documented_one():
    """A window smaller than the clients that commit: an evicted client
    that has not committed since holds zeros in the sharded store, where
    the dense store still holds its residual."""
    strat = tst.get("fig5", error_feedback=True, **SMALL)
    batches, n = _problem()
    dense = _server(strat, "dense")
    dense.run(batches, n, 8)
    sharded = _server(strat, "sharded", retention=4)
    sharded.run(batches, n, 8)
    sh = sharded.store
    assert sh.evictions > 0
    gone = [c for c in range(MS) if c not in sh._slot_of]
    assert gone
    for v in sh.residuals_dense().values():
        assert not v[gone].any()
    dense_gone = torch.cat([v[gone].abs().reshape(-1)
                            for v in dense.store.residuals_dense().values()])
    assert float(dense_gone.max()) > 0.0
    assert [r.num_sampled for r in dense.history] == \
        [r.num_sampled for r in sharded.history]


RESUME = {
    "random-mask": lambda: tst.get(
        "fig5", masking=tst.MaskPolicy.random(0.5), error_feedback=True,
        **SMALL),
    "hetero-dropout": lambda: tst.get(
        "hetero-dropout", error_feedback=True,
        sampling=tsamp.StaticSampling(initial_rate=0.25, min_clients=2)),
    "noniid-dyn": lambda: tst.get("noniid-dyn", **SMALL),
}


@pytest.mark.parametrize("kind", ["dense", "sharded"])
@pytest.mark.parametrize("variant", sorted(RESUME))
def test_resume_is_bit_identical(tmp_path, kind, variant):
    """3 rounds, ``save_state``, a fresh server's ``restore_state`` and 3
    more rounds give the 6-round run's parameters, state, generators and
    records bit for bit; the sharded window (6 of 16) evicts."""
    strat = RESUME[variant]()
    batches, n = _problem()
    whole = _server(strat, kind, retention=6)
    whole.run(batches, n, 6)
    first = _server(strat, kind, retention=6)
    first.run(batches, n, 3)
    first.save_state(str(tmp_path))
    resumed = _server(strat, kind, retention=6)
    assert resumed.restore_state(str(tmp_path)) == 3
    resumed.run(batches, n, 3)
    resumed.history[:0] = first.history
    assert [r.round for r in resumed.history] == list(range(1, 7))
    _same_runs(whole, resumed)
    np.testing.assert_array_equal(whole.store.versions,
                                  resumed.store.versions)
    for name, state in whole.state()["rng"].items():
        assert torch.equal(state, resumed.state()["rng"][name]), name
    if kind == "sharded":
        np.testing.assert_array_equal(whole.store._slot_ids,
                                      resumed.store._slot_ids)
        np.testing.assert_array_equal(whole.store._slot_round,
                                      resumed.store._slot_round)
        for tree in whole.store.trees:
            _bit_equal(whole.store._pools[tree], resumed.store._pools[tree])
        assert whole.store.evictions > 0
    if variant == "hetero-dropout":
        assert sum(r.dropped for r in whole.history[3:]) > 0


@pytest.mark.parametrize("case", ["population", "store-kind", "structure"])
def test_mismatched_restore_raises_before_assigning(tmp_path, case):
    strat = tst.get("fig5", error_feedback=True, **SMALL)
    batches, n = _problem()
    saved = _server(strat, "dense")
    saved.run(batches, n, 2)
    saved.save_state(str(tmp_path))
    if case == "population":
        other = _server(strat, "dense", num_clients=24)
        match = r"num_clients=16.*num_clients=24"
    elif case == "store-kind":
        other = _server(strat, "sharded")
        match = "'dense'.*'sharded'"
    else:
        other = _server(tst.get("fig5", masking=tst.MaskPolicy.random(0.5),
                                **SMALL), "dense")
        match = "structure"
    other.run(*_problem(other.cfg.num_clients), 1)
    before = {k: v.clone() for k, v in other.params.items()}
    versions = other.store.versions.copy()
    with pytest.raises(ValueError, match=match):
        other.restore_state(str(tmp_path))
    _bit_equal(other.params, before)
    np.testing.assert_array_equal(other.store.versions, versions)
    assert other._round == 1


def test_store_validation_on_the_server():
    sh = ShardedStore(MS, _params(), retention=4)
    with pytest.raises(ValueError, match="engine='full'"):
        FederatedServer.from_strategy(tst.get("dense-baseline"), _loss,
                                      _params(), MS, engine="full",
                                      device="cpu", store=sh)
    with pytest.raises(ValueError, match="track_norms"):
        FederatedServer.from_strategy(tst.get("fig3-importance"), _loss,
                                      _params(), MS, device="cpu", store=sh)
    with pytest.raises(ValueError, match="drift"):
        FederatedServer.from_strategy(
            tst.get("fig5-dyn"), _loss, _params(), MS, device="cpu",
            store=ShardedStore(MS, _params(), retention=4))
    with pytest.raises(ValueError, match="registers 8"):
        FederatedServer.from_strategy(tst.get("fig5"), _loss, _params(), 8,
                                      device="cpu", store=sh)


def test_batch_provider_needs_a_sharded_store_and_changes_nothing():
    (xs, ys), n = _problem()

    def provider(ids):
        return xs[np.asarray(ids)], ys[np.asarray(ids)]

    strat = tst.get("fig5", error_feedback=True, **SMALL)
    dense = _server(strat, "dense")
    with pytest.raises(ValueError, match="provider"):
        dense.run(provider, n, 1)
    runs = []
    for batches in ((xs, ys), provider):
        server = _server(strat, "sharded")
        server.run(batches, n, 3)
        runs.append(server)
    _same_runs(*runs)


# ------------------------------------------------- random-mask draws
def _mask_model(model):
    """(loss, params, batches, n) of a small LeNet or GRU-LM over MS
    clients."""
    rng = np.random.default_rng(1)
    gen = torch.Generator().manual_seed(0)
    if model == "lenet":
        xs = rng.standard_normal((MS, 1, 4, 12, 12, 1)).astype(np.float32)
        ys = rng.integers(0, 10, (MS, 1, 4)).astype(np.int64)
        return (tpm.classifier_loss(tpm.lenet_forward),
                tpm.init_lenet(gen, image_size=12, device="cpu"), (xs, ys))
    toks = rng.integers(0, 64, (MS, 1, 4, 9)).astype(np.int64)
    return (tpm.gru_lm_loss, tpm.init_gru_lm(gen, 64, 16, 16, device="cpu"),
            (toks[..., :-1], toks[..., 1:]))


def _random_strategy():
    return tst.get("fig5", masking=tst.MaskPolicy.random(0.5),
                   error_feedback=True, **SMALL)


@pytest.mark.parametrize("model", ["lenet", "gru"])
def test_dense_and_store_forms_mask_each_client_alike(model):
    """Under ``MaskPolicy.random``: the cohort's draw equals the cohort's
    rows of the dense rounds' (M, *shape) draw, and a dense run equals a
    sharded one bit for bit (parameters and residuals)."""
    loss, params, batches = _mask_model(model)
    n = np.full((MS,), 4.0)
    runs = []
    for kind in ("dense", "sharded"):
        store = ShardedStore(MS, params, MS) if kind == "sharded" else None
        server = FederatedServer.from_strategy(
            _random_strategy(), loss, params, MS, device="cpu", seed=5,
            store=store)
        server.run(batches, n, 2)
        runs.append(server)
    dense, sharded = runs
    ids = torch.tensor([1, 6, 7, 15])
    rows = sharded._cohort_mask_scores(3, ids)
    full = dense.round_mask_scores(3)
    assert rows and rows.keys() == full.keys()
    for k, v in rows.items():
        assert torch.equal(v, full[k].index_select(0, ids)), k
    _bit_equal(dense.params, sharded.params)
    _bit_equal(dense.store.residuals_dense(), sharded.store.residuals_dense())


def test_store_round_masks_at_random_among_a_million_clients():
    """A store-form round at M = 10^6 with a maskable leaf of 2^20 entries,
    where an (M, *shape) fp32 draw would be 4.2 TB: the server draws the
    cohort's rows only."""
    big, width = 1_000_000, 1024
    assert 4 * big * width * width > 4e12
    strat = tst.get("fig5", masking=tst.MaskPolicy.random(0.5),
                    error_feedback=True,
                    sampling=tsamp.StaticSampling(initial_rate=2 / big,
                                                  min_clients=2))
    params = {"w": torch.zeros((width, width))}
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((2, 1, 2, width)).astype(np.float32)

    def provider(ids):
        return (torch.from_numpy(xs[np.asarray(ids) % 2]),
                torch.from_numpy(xs[np.asarray(ids) % 2]))

    def loss(p, batch):
        x, y = batch
        return torch.mean((x @ p["w"] - y) ** 2)

    server = FederatedServer.from_strategy(
        strat, loss, params, big, device="cpu", seed=0,
        store=ShardedStore(big, params, 4))

    def refuse(t):
        raise AssertionError("the store form drew the (M, *shape) scores")

    server.round_mask_scores = refuse
    server.run(provider, np.full((big,), 2.0), 2)
    assert [r.num_sampled for r in server.history] == [2, 2]
    kept = server.params["w"] != 0
    assert 0 < int(kept.sum()) <= 2 * max(1, round(0.5 * width * width))


def test_client_draw_is_independent_of_population_and_cohort():
    """Client i's scores are one splitmix64 stream keyed by (seed, round,
    client, leaf): the same bits alone, beside other clients and on servers
    of 10 or 1,000 clients; other rounds, clients, leaves and seeds draw
    otherwise.  The int64 tensor ops equal numpy's uint64 splitmix64."""
    from repro_torch.core import masking as tmask
    leaves = {"w": (5, 7), "v": (300,)}
    alone = tmask.client_mask_scores(3, 2, [5], leaves, "cpu")
    among = tmask.client_mask_scores(3, 2, [0, 5, 999_999], leaves, "cpu")
    for k in leaves:
        assert torch.equal(alone[k][0], among[k][1]), k
        assert 0.0 <= float(among[k].min()) and float(among[k].max()) < 1.0
    assert not torch.equal(among["w"][0], among["w"][1])
    for seed, t in ((3, 3), (4, 2)):
        other = tmask.client_mask_scores(seed, t, [5], leaves, "cpu")
        assert not torch.equal(alone["w"], other["w"]), (seed, t)
    assert not torch.equal(alone["w"].reshape(-1)[:35],
                           alone["v"].reshape(-1)[:35])
    strat = tst.get("fig5", masking=tst.MaskPolicy.random(0.5))
    for num in (10, 1000):
        server = FederatedServer.from_strategy(
            strat, _loss, _params(), num, device="cpu", seed=2)
        got = server._cohort_mask_scores(2, torch.tensor([5]))
        want = tmask.client_mask_scores(3, 2, [5], {"w": (D,)}, "cpu")
        assert torch.equal(got["w"], want["w"])

    def mix(z):
        z = (z ^ (z >> np.uint64(30))) * np.uint64(tmask._MIX[0])
        z = (z ^ (z >> np.uint64(27))) * np.uint64(tmask._MIX[1])
        return z ^ (z >> np.uint64(31))

    ids = np.array([0, 5, 999_999], np.uint64)
    golden = np.uint64(tmask._GOLDEN)
    with np.errstate(over="ignore"):
        for ell, name in enumerate(sorted(leaves)):
            n = int(np.prod(leaves[name]))
            key = np.uint64(tmask._stream_key(3, 2, ell))
            rows = mix(mix(ids + golden) ^ key)
            z = mix(rows[:, None]
                    + np.arange(1, n + 1, dtype=np.uint64) * golden)
            want = (z >> np.uint64(40)).astype(np.float32) * \
                np.float32(2.0 ** -24)
            np.testing.assert_array_equal(
                among[name].reshape(3, n).numpy(), want)


def test_client_draw_runs_on_the_card_unless_told():
    """Like every entry point of the port, the draw lands on ``cuda`` unless
    the caller names a device, and raises where there is no card."""
    from repro_torch.core import masking as tmask
    if torch.cuda.is_available():
        out = tmask.client_mask_scores(3, 2, [5], {"w": (4,)})
        assert out["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmask.client_mask_scores(3, 2, [5], {"w": (4,)})
    assert tmask.client_mask_scores(3, 2, [5], {"w": (4,)},
                                    "cpu")["w"].device.type == "cpu"


def test_default_draw_is_deterministic_and_resumes_bit_identically(tmp_path):
    """Two servers of one seed draw the same scores; the mask seed rides in
    ``state()``, so a server restored with another constructor seed runs
    on as the straight run does."""
    strat = _random_strategy()
    batches, n = _problem()
    a = _server(strat, "sharded", retention=6)
    b = _server(strat, "sharded", retention=6)
    for k, v in a.round_mask_scores(4).items():
        assert torch.equal(v, b.round_mask_scores(4)[k])
    a.run(batches, n, 6)
    b.run(batches, n, 3)
    b.save_state(str(tmp_path))
    assert int(b.state()["rng"]["mask"]) == 1
    other = FederatedServer.from_strategy(
        strat, _loss, _params(), MS, device="cpu", seed=77,
        store=ShardedStore(MS, _params(), 6))
    other.restore_state(str(tmp_path))
    other.run(batches, n, 3)
    _bit_equal(a.params, other.params)
    _bit_equal(a.store.residuals_dense(), other.store.residuals_dense())


def test_injected_mask_scores_still_win():
    """A caller's ``mask_scores(t, M)`` is what every form masks with: its
    rows in the store form, and a run fed the default draw through it is
    the default run."""
    strat = _random_strategy()
    batches, n = _problem()
    plain = _server(strat, "sharded")
    given = {"w": torch.rand((MS, D), generator=torch.Generator()
                             .manual_seed(9))}
    injected = _server(strat, "sharded", mask_scores=lambda t, m: given)
    rows = injected._cohort_mask_scores(1, torch.tensor([2, 3]))
    assert torch.equal(rows["w"], given["w"][2:4])
    echo = _server(strat, "sharded",
                   mask_scores=lambda t, m: plain.round_mask_scores(t))
    for server in (plain, injected, echo):
        server.run(batches, n, 3)
    _bit_equal(plain.params, echo.params)
    assert not torch.equal(plain.params["w"], injected.params["w"])


def test_random_keep_takes_ties_lowest_index_first_as_top_k_does():
    """Equal scores at the k-th place keep the lowest indices, as the
    reference's ``lax.top_k`` of the negated scores does."""
    from repro_torch.core.masking import random_keep
    rng = np.random.default_rng(3)
    scores = (rng.integers(0, 6, (4, 50)) / 8.0).astype(np.float32)
    k = max(1, round(0.3 * 50))
    _, idx = jax.lax.top_k(-jnp.asarray(scores), k)
    want = np.zeros(scores.shape, bool)
    np.put_along_axis(want, np.asarray(idx), True, 1)
    got = random_keep(torch.from_numpy(scores), 0.3).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(1) == k).all()


def test_build_round_forms_and_legacy_shims():
    st = tst.get("fig5")
    prog = tst.build_round(st, _loss, MS, form="store", cohort_size=4)
    assert isinstance(prog, tfed.StoreRound)
    assert not prog.adaptive and not prog.uses_drift
    dyn = tst.build_round(tst.get("noniid-dyn"), _loss, MS, form="store",
                          cohort_size=4)
    assert dyn.adaptive and dyn.uses_drift
    with pytest.raises(ValueError, match="CUDA graph"):
        tst.build_round(st, _loss, MS, form="scan", cohort_size=4)
    with pytest.raises(ValueError, match="requires cohort_size"):
        tst.build_round(st, _loss, MS, form="store")
    cfg = MaskingConfig(gamma=0.3, mode="selective", use_kernel=True,
                        min_leaf_size=64, bisect_iters=12)
    policy = tst.MaskPolicy.from_masking_config(cfg)
    assert policy == tst.MaskPolicy.selective(0.3, backend="kernel",
                                              min_leaf_size=64,
                                              bisect_iters=12)
    assert policy.masking_config() == cfg
    legacy = tst.FedStrategy.from_components("legacy", st.sampling, cfg)
    assert legacy.masking == policy and legacy.codec.gamma == 0.3
    want = jst.FedStrategy.from_components(
        "legacy", jst.get("fig5").sampling, jst.MaskPolicy.selective(
            0.3, backend="kernel", min_leaf_size=64, bisect_iters=12))
    assert legacy.codec.name == want.codec.name


def test_store_form_compile_s_lands_on_bucket_changes(monkeypatch):
    """On a sharded store a bucket's first build (a 0.2 s sleep here) goes
    to ``compile_s`` on the round that first needs it, outside ``wall_s``,
    and a later run finds its buckets built."""
    real = tst.build_round
    builds = []

    def slow_build_round(*args, **kwargs):
        builds.append(kwargs.get("form"))
        time.sleep(0.2)
        return real(*args, **kwargs)

    monkeypatch.setattr(tst, "build_round", slow_build_round)
    strat = tst.get("fig5", error_feedback=True,
                    sampling=tsamp.DynamicSampling(initial_rate=1.0, beta=0.3,
                                                   min_clients=2))
    server = _server(strat, "sharded", retention=MS)
    batches, n = _problem()
    t0 = time.perf_counter()
    server.run(batches, n, 4)
    run_s = time.perf_counter() - t0
    server.run(batches, n, 2)
    buckets = [r.cohort_size for r in server.history]
    changed = [i == 0 or b != buckets[i - 1] for i, b in enumerate(buckets)]
    assert len(set(buckets)) > 1 and builds == ["store"] * len(set(buckets))
    assert [r.compile_s >= 0.2 for r in server.history] == changed
    assert all(r.compile_s == 0.0 for r, c in zip(server.history, changed)
               if not c)
    assert sum(r.wall_s for r in server.history[:4]) <= run_s - 0.2 * sum(
        changed[:4])
