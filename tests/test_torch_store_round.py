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


def test_random_mask_draw_that_does_not_fit_raises():
    """The store form takes the cohort's rows of the whole (M, *shape)
    draw; where the allocator refuses that draw it raises with its size
    rather than draw otherwise.  A leaf of 2^56 entries makes a draw of
    2^62 bytes, past any address space."""
    strat = tst.get("fig5", masking=tst.MaskPolicy.random(0.5), **SMALL)
    server = _server(strat, "sharded")
    server._mask_leaves = {"big": (1 << 56,)}
    with pytest.raises(ValueError,
                       match=f"{MS} clients x {1 << 56} entries = "
                             f"{4 * MS << 56} bytes"):
        server.run(*_problem(), 1)


@pytest.mark.parametrize("error, reported", [
    (torch.OutOfMemoryError("CUDA out of memory"), ValueError),
    (MemoryError(), ValueError),
    (RuntimeError("DefaultCPUAllocator: can't allocate memory"), ValueError),
    (RuntimeError("an unrelated fault"), RuntimeError)])
def test_random_mask_draw_failure_is_reported_by_kind(monkeypatch, error,
                                                      reported):
    """An allocation failure of the draw becomes the ValueError naming its
    size; any other fault passes through unchanged."""
    strat = tst.get("fig5", masking=tst.MaskPolicy.random(0.5), **SMALL)
    server = _server(strat, "sharded")

    def refuse(t):
        raise error

    monkeypatch.setattr(server, "round_mask_scores", refuse)
    with pytest.raises(reported) as info:
        server.run(*_problem(), 1)
    assert (f"{MS} clients x {D} entries" in str(info.value)) == \
        (reported is ValueError)


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
