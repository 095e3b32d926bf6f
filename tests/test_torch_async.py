"""The port's async engine (``repro_torch.core.async_engine``,
``FederatedServer(engine="async")``) on the CPU.

* ``AsyncConfig``'s validation and ``buffer_for``, and the three async
  presets' configurations, against the reference's.
* The keystone, port against port: on the ideal fleet with the default
  ``AsyncConfig()`` the async engine equals the cohort engine bit for bit
  (parameters, residuals, norms, bytes) on ``fig3``, ``fig5``,
  ``fig3-importance`` and ``fig3`` under the threshold sampler.
* Port server against reference server on the reference's tiny regression
  problem (its ``tests/test_async.py``: linear softmax over dim-8 or dim-32
  features), the port fed the reference's participant scores, random-mask
  scores and event seeds (the words of its drop key, or of its round key
  without a fleet): participants, sends, arrivals, timeouts, retries,
  dropped, quarantined, flushes, carried, pending, ``sim_round_s``, the
  deadline, versions and bytes exact; losses, parameters, residual and
  drift state within rtol 1e-3.  Scenarios: ``async-mobile``,
  ``async-flaky`` with injected corruption under random masking,
  ``async-crossround`` on a dense store and on an evicting sharded store
  with a batch provider, FedDyn's drift through the store, the staleness
  discount, the deadline cut and the quarantine gate on and off.
* Resume bit for bit on ``engine="async"``, and the cross-round uploads
  in flight that ``state()`` does not hold, as in the reference.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client_store as jcs
from repro.core import strategy as jst
from repro.core.async_engine import AsyncConfig as JConfig
from repro.core.federated import _split_round_key
from repro.core.hetero import HeteroModel as JHetero
from repro.core.objectives import LocalObjective as JObjective
from repro.core.server import FederatedServer as JaxServer
from repro_torch.core import strategy as tst
from repro_torch.core.async_engine import AsyncConfig, AsyncRoundRunner
from repro_torch.core.client_store import DenseStore, ShardedStore
from repro_torch.core.hetero import HeteroModel
from repro_torch.core.objectives import LocalObjective
from repro_torch.core.sampling import ThresholdSampler
from repro_torch.core.server import FederatedServer
from test_torch_slice import recording_sampler

IDEAL = HeteroModel(profile="ideal")
LEDGER = ("num_sampled", "cohort_size", "transport_bytes", "arrivals",
          "timeouts", "retries", "dropped", "quarantined", "flushes",
          "carried", "pending", "sim_round_s", "straggler_s",
          "mean_staleness")


# ---------------------------------------------------------------- problem
@functools.lru_cache()
def _data(num_clients, dim, classes, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((num_clients, 2, 4, dim)).astype(np.float32)
    y = rng.integers(0, classes, (num_clients, 2, 4)).astype(np.int32)
    w = (0.1 * rng.standard_normal((dim, classes))).astype(np.float32)
    return x, y, w


def _torch_loss(p, batch):
    xb, yb = batch
    logp = torch.log_softmax(xb @ p["w"] + p["b"], -1)
    return -logp.gather(1, yb[:, None].long()).mean()


def _jax_loss(p, batch):
    xb, yb = batch
    logp = jax.nn.log_softmax(xb @ p["w"] + p["b"])
    return -jnp.mean(jnp.take_along_axis(logp, yb[:, None], 1))


def _torch_params(M, dim, classes):
    w = _data(M, dim, classes)[2]
    return {"b": torch.zeros(classes), "w": torch.from_numpy(w.copy())}


def _port(st, M, dim=8, classes=3, seed=3, store=None, **kw):
    p = _torch_params(M, dim, classes)
    if store == "sharded":
        store = ShardedStore(M, p, M, track_norms=st.sampler.adaptive)
    return FederatedServer.from_strategy(st, _torch_loss, p, M, seed=seed,
                                         device="cpu", store=store, **kw)


def _batches(M, dim=8, classes=3):
    x, y, _ = _data(M, dim, classes)
    return (x, y), np.ones((M,), np.float32)


def _bit_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------------------ AsyncConfig
BAD_CONFIGS = [
    (dict(buffer_size=4, buffer_frac=0.5), "buffer_size / buffer_frac"),
    (dict(buffer_size=0), "buffer_size must be >= 1"),
    (dict(buffer_frac=1.5), "buffer_frac must be in"),
    (dict(buffer_frac=0.0), "buffer_frac must be in"),
    (dict(staleness_beta=-0.1), "staleness_beta"),
    (dict(deadline_s=1.0, deadline_quantile=0.9),
     "deadline_s / deadline_quantile"),
    (dict(deadline_s=0.0), "deadline_s must be > 0"),
    (dict(deadline_quantile=0.0), "deadline_quantile must be in"),
    (dict(max_retries=-1), "max_retries"),
    (dict(backoff_s=-0.5), "backoff_s"),
    (dict(jitter_sigma=-1.0), "jitter_sigma"),
    (dict(corrupt_rate=2.0), "corrupt_rate"),
    (dict(max_round_stale=-1), "max_round_stale"),
]


@pytest.mark.parametrize("kw, match", BAD_CONFIGS,
                         ids=[m.split()[0] + str(i)
                              for i, (_, m) in enumerate(BAD_CONFIGS)])
def test_asyncconfig_validation_matches_the_reference(kw, match):
    with pytest.raises(ValueError, match=match) as got:
        AsyncConfig(**kw)
    with pytest.raises(ValueError) as want:
        JConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw, m", [({}, 7), ({"buffer_size": 3}, 7),
                                   ({"buffer_frac": 0.5}, 7),
                                   ({"buffer_frac": 0.01}, 7), ({}, 0)])
def test_buffer_for_matches_the_reference(kw, m):
    assert AsyncConfig(**kw).buffer_for(m) == JConfig(**kw).buffer_for(m)


@pytest.mark.parametrize("name", ["async-mobile", "async-crossround",
                                  "async-flaky"])
def test_async_presets_equal_the_reference(name):
    got, want = tst.get(name), jst.get(name)
    assert dataclasses.asdict(got.async_cfg) == \
        dataclasses.asdict(want.async_cfg)
    assert got.hetero.profile == want.hetero.profile
    assert dataclasses.asdict(got.sampling) == \
        dataclasses.asdict(want.sampling)
    assert got.codec.name == want.codec.name
    assert got.sampler.name == want.sampler.name
    over = tst.get(name, async_cfg=AsyncConfig(buffer_size=2))
    assert over.async_cfg.buffer_size == 2 and over.hetero == got.hetero


def test_unknown_engine_and_active_attack_raise():
    """An unknown engine raises.  Attacks are ported (item 13), so an
    active one now builds the async runner; what still raises with one is
    a Krum-family rule under the Horvitz-Thompson weights of an adaptive
    sampler, as in the sync builders."""
    with pytest.raises(ValueError, match="unknown engine"):
        _port(tst.get("fig3"), 4, engine="buffered")
    st = tst.get("async-mobile", attack=tst.get("robust-krum").attack)
    runner = AsyncRoundRunner(st, 4)
    assert runner.attack is st.attack
    assert runner._adv.tobytes() == st.attack.adversary_mask(4).tobytes()
    with pytest.raises(TypeError, match="Horvitz-Thompson"):
        _port(st.replace(sampler=tst.get("fig3-importance").sampler,
                         aggregator=tst.get("robust-krum").aggregator), 4,
              engine="async")
    # An inactive attack model is no attack, as in the sync builders.
    inactive = AsyncRoundRunner(
        st.replace(attack=dataclasses.replace(st.attack, fraction=0.0)), 4)
    assert inactive.attack is None and inactive._adv is None


def test_crossround_and_drift_need_a_store():
    with pytest.raises(ValueError, match="requires a ClientStateStore"):
        AsyncRoundRunner(tst.get("async-crossround"), 4)
    with pytest.raises(ValueError, match="extra_trees"):
        AsyncRoundRunner(tst.get("fig5-dyn"), 4)
    p = _torch_params(4, 8, 3)
    with pytest.raises(ValueError, match="'drift' tree"):
        AsyncRoundRunner(tst.get("fig5-dyn"), 4, store=DenseStore(4, p))


# --------------------------------------------------------------- keystone
KEYSTONE = {
    "fig3": lambda: tst.get("fig3", hetero=IDEAL, error_feedback=True),
    "fig5": lambda: tst.get("fig5", hetero=IDEAL, error_feedback=True),
    "fig3-importance": lambda: tst.get("fig3-importance", hetero=IDEAL,
                                       error_feedback=True),
    "fig3+threshold": lambda: tst.get("fig3", hetero=IDEAL,
                                      error_feedback=True,
                                      sampler=ThresholdSampler()),
    # The Byzantine presets: both engines aggregate the attacked payload
    # of the shared dispatch sweep.
    "byzantine-signflip": lambda: tst.get("byzantine-signflip", hetero=IDEAL,
                                          error_feedback=True),
    "robust-median": lambda: tst.get("robust-median", hetero=IDEAL,
                                     error_feedback=True),
    "robust-krum": lambda: tst.get("robust-krum", hetero=IDEAL,
                                   error_feedback=True),
}


@pytest.mark.parametrize("case", sorted(KEYSTONE))
def test_async_equals_the_cohort_engine_bit_for_bit(case):
    """Ideal fleet, ``AsyncConfig()`` (K = m_t, no deadline, no faults):
    every round is the dispatch and one flush of everyone at staleness 0,
    and equals the sync cohort round bit for bit: parameters, residuals,
    norms and bytes.  Weights of 320 entries, so masking binds."""
    M = 10
    st = KEYSTONE[case]().replace(async_cfg=AsyncConfig())
    batches, n = _batches(M, 32, 10)
    runs = []
    for engine in ("cohort", "async"):
        server = _port(st, M, 32, 10, engine=engine)
        server.run(batches, n, 6)
        runs.append(server)
    sync, buf = runs
    _bit_equal(sync.params, buf.params)
    _bit_equal(sync.store.residuals_dense(), buf.store.residuals_dense())
    if st.sampler.adaptive:
        assert torch.equal(sync.store.norms, buf.store.norms)
    assert sync.summary()["transport_bytes"] == \
        buf.summary()["transport_bytes"]
    if case == "fig5":
        assert any(bool(v.any()) for v in buf.store.residuals_dense().values())
    for a, b in zip(sync.history, buf.history):
        assert b.num_sampled == a.num_sampled == b.arrivals
        assert b.cohort_size == a.cohort_size
        assert b.flushes <= 1 and b.mean_staleness == 0.0
        assert b.timeouts == b.retries == b.quarantined == 0
        assert b.adversarial == a.adversarial
    if st.attack is not None:
        assert sum(r.adversarial for r in buf.history) > 0
        assert buf.summary()["attack"] == sync.summary()["attack"]
    np.testing.assert_allclose([r.mean_loss for r in sync.history],
                               [r.mean_loss for r in buf.history],
                               rtol=1e-6, equal_nan=True)


# -------------------------------------------------- against the reference
def _round_keys(seed, rounds):
    key = jax.random.PRNGKey(seed)
    subs = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def _reference_draws(seed, rounds, M, fleet, leaves):
    """The reference server's draws from ``PRNGKey(seed)``: per round the
    (M,) participant uniforms, the event words (its drop key, or the round
    key without a fleet) and, for the named leaves, the random-mask
    uniforms (``{leaf: (M, n)}``, leaf keys split over ``leaves``, every
    leaf in sorted order)."""
    out = {}
    for t, sub in enumerate(_round_keys(seed, rounds), 1):
        sample_key, mask_key, drop_key = _split_round_key(sub, fleet)
        masks = {}
        if leaves:
            names = sorted(leaves)
            cks = [jax.random.split(ck, len(names))
                   for ck in jax.random.split(mask_key, M)]
            masks = {name: np.stack([np.asarray(jax.random.uniform(
                cks[i][j], (leaves[name],))) for i in range(M)])
                for j, name in enumerate(names) if leaves[name] >= 256}
        words = drop_key if drop_key is not None else sub
        out[t] = (np.asarray(jax.random.uniform(sample_key, (M,))),
                  np.asarray(words, np.uint32).ravel(), masks)
    return out


def _record_stats(server, log):
    """Append every async round's host stats to ``log``."""
    runner = server._async
    inner = runner.run_round

    def run_round(*args, **kwargs):
        out = inner(*args, **kwargs)
        log.append(out[-1])
        return out

    runner.run_round = run_round


# scenario -> (the two strategies, M, dim, classes, rounds, store, seed)
def _scenario(name):
    sel = dict(masking=tst.MaskPolicy.selective(0.5))
    jsel = dict(masking=jst.MaskPolicy.selective(0.5))
    if name == "mobile":
        return (jst.get("async-mobile", error_feedback=True, **jsel),
                tst.get("async-mobile", error_feedback=True, **sel),
                12, 32, 10, 5, "dense", 0)
    if name == "flaky-corrupt":
        kw = dict(error_feedback=True)
        return (jst.get("async-flaky", masking=jst.MaskPolicy.random(0.5),
                        async_cfg=dataclasses.replace(
                            jst.get("async-flaky").async_cfg,
                            corrupt_rate=0.2), **kw),
                tst.get("async-flaky", masking=tst.MaskPolicy.random(0.5),
                        async_cfg=dataclasses.replace(
                            tst.get("async-flaky").async_cfg,
                            corrupt_rate=0.2), **kw),
                12, 32, 10, 5, "dense", 1)
    if name in ("crossround-dense", "crossround-sharded"):
        kind = name.split("-")[1]
        return (jst.get("async-crossround", error_feedback=True, **jsel),
                tst.get("async-crossround", error_feedback=True, **sel),
                12, 32, 10, 6, kind, 2)
    if name == "dyn":
        return (jst.get("async-mobile", error_feedback=True,
                        objective=JObjective.dyn(0.1), **jsel),
                tst.get("async-mobile", error_feedback=True,
                        objective=LocalObjective.dyn(0.1), **sel),
                12, 32, 10, 4, "dense", 4)
    if name == "staleness":
        acfg = dict(buffer_size=1, staleness_beta=1.0, max_retries=0)
        return (jst.get("fig3-importance", hetero=JHetero(profile="mobile"),
                        async_cfg=JConfig(**acfg)),
                tst.get("fig3-importance",
                        hetero=HeteroModel(profile="mobile"),
                        async_cfg=AsyncConfig(**acfg)),
                10, 8, 3, 3, "dense", 4)
    if name == "deadline":
        acfg = dict(deadline_quantile=0.5, max_retries=0)
        return (jst.get("fig5", hetero=JHetero(profile="mobile"),
                        error_feedback=True, async_cfg=JConfig(**acfg)),
                tst.get("fig5", hetero=HeteroModel(profile="mobile"),
                        error_feedback=True, async_cfg=AsyncConfig(**acfg)),
                12, 32, 10, 1, "dense", 6)
    gate = name == "quarantine-on"
    return (jst.get("fig5", error_feedback=True,
                    async_cfg=JConfig(corrupt_rate=0.5, quarantine=gate)),
            tst.get("fig5", error_feedback=True,
                    async_cfg=AsyncConfig(corrupt_rate=0.5,
                                          quarantine=gate)),
            12, 32, 10, 1, "dense", 42)


SCENARIOS = ("mobile", "flaky-corrupt", "crossround-dense",
             "crossround-sharded", "dyn", "staleness", "deadline",
             "quarantine-on", "quarantine-off")
RETENTION = 8            # the sharded scenario's window: it evicts


@functools.lru_cache()
def _pair(name):
    """The reference's server and the port's on one scenario, the port fed
    the reference's draws; each with its participants and round stats."""
    js, ts, M, dim, classes, rounds, kind, seed = _scenario(name)
    x, y, w = _data(M, dim, classes)
    fleet = js.hetero is not None
    leaves = ({"b": classes, "w": dim * classes}
              if ts.masking.mode == "random" else {})
    draws = _reference_draws(seed, rounds, M, fleet, leaves)
    picks = {"ref": [], "port": []}
    js = js.replace(sampler=recording_sampler(js.sampler, picks["ref"], True))
    ts = ts.replace(sampler=recording_sampler(ts.sampler, picks["port"],
                                              False))
    drift = ts.objective.uses_drift
    jp = {"b": jnp.zeros((classes,)), "w": jnp.asarray(w)}
    tp = _torch_params(M, dim, classes)
    if kind == "sharded":
        jstore = jcs.ShardedStore(M, jp, RETENTION)
        tstore = ShardedStore(M, tp, RETENTION)
    else:
        extra = {"drift": jp} if drift else None
        jstore = jcs.DenseStore(M, jp, track_norms=js.sampler.adaptive,
                                extra_trees=extra)
        tstore = DenseStore(M, tp, track_norms=ts.sampler.adaptive,
                            extra_trees={"drift": tp} if drift else None)
    ref = JaxServer.from_strategy(js, _jax_loss, jp, M, seed=seed,
                                  engine="async", store=jstore)
    port = FederatedServer.from_strategy(
        ts, _torch_loss, tp, M, seed=seed + 100, device="cpu",
        engine="async", store=tstore,
        scores=lambda t, m: draws[t][0],
        event_seed=lambda t: draws[t][1],
        mask_scores=(lambda t, m: draws[t][2]) if leaves else None)
    stats = {"ref": [], "port": []}
    _record_stats(ref, stats["ref"])
    _record_stats(port, stats["port"])
    ref.run((jnp.asarray(x), jnp.asarray(y)), np.ones((M,), np.float32),
            rounds)
    if kind == "sharded":
        def provider(ids):
            ids = np.asarray(ids)
            return x[ids], y[ids]
        port.run(provider, np.ones((M,), np.float32), rounds)
    else:
        port.run((x, y), np.ones((M,), np.float32), rounds)
    return ref, port, picks, stats


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("name", SCENARIOS)
def test_ledger_is_exact_against_the_reference(name):
    ref, port, picks, stats = _pair(name)
    assert len(picks["port"]) == len(picks["ref"]) == len(ref.history)
    for got, want in zip(picks["port"], picks["ref"]):
        np.testing.assert_array_equal(got, want)
    for field in LEDGER:
        got = [getattr(r, field) for r in port.history]
        want = [getattr(r, field) for r in ref.history]
        if field == "mean_staleness":
            np.testing.assert_allclose(got, want, rtol=1e-12)
        else:
            assert got == want, field
    for key in ("sends", "deadline_s", "buffer_size"):
        assert [s[key] for s in stats["port"]] == \
            [s[key] for s in stats["ref"]], key
    for s, r in zip(stats["port"], port.history):
        assert r.transport_bytes == s["sends"] * port.client_upload_bytes
    np.testing.assert_array_equal(port.store.versions, ref.store.versions)
    assert port.summary()["transport_bytes"] == \
        ref.summary()["transport_bytes"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_floats_within_rtol_of_the_reference(name):
    ref, port, _, _ = _pair(name)
    np.testing.assert_allclose([r.mean_loss for r in port.history],
                               [r.mean_loss for r in ref.history],
                               rtol=1e-3, equal_nan=True)
    finite = name != "quarantine-off"
    for k, v in port.params.items():
        want = np.asarray(ref.params[k])
        if finite:
            np.testing.assert_allclose(v.numpy(), want, rtol=1e-3,
                                       atol=1e-5, err_msg=k)
        else:
            assert not np.isfinite(want).all()
            np.testing.assert_array_equal(np.isfinite(v.numpy()),
                                          np.isfinite(want))
    for tree in port.store.trees:
        got = port.store.dense_view(tree)
        want = _np(ref.store.dense_view(tree))
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-3,
                                       atol=1e-5, err_msg=f"{tree}/{k}")
    if port.store.norms is not None:
        np.testing.assert_allclose(port.store.norms.numpy(),
                                   np.asarray(ref.store.norms), rtol=1e-3)


def test_summary_holds_the_reference_keys():
    ref, port, _, _ = _pair("mobile")
    got, want = port.summary(), ref.summary()
    assert set(got) - {"device"} == set(want)
    for key in ("arrivals", "timeouts", "retries", "flushes", "carried",
                "dropped_uploads", "quarantined", "transport_bytes"):
        assert got[key] == want[key], key
    for key in ("sim_total_s", "mean_staleness", "transport_units"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)
    arrivals = sum(r.arrivals for r in port.history)
    assert got["mean_staleness"] == pytest.approx(
        sum(r.mean_staleness * r.arrivals for r in port.history) / arrivals)


def test_scenarios_exercise_what_they_name():
    """Each scenario reaches the behaviour it is there for."""
    hist = {name: _pair(name)[1].history for name in SCENARIOS}
    assert sum(r.retries for r in hist["flaky-corrupt"]) > 0
    assert sum(r.quarantined for r in hist["flaky-corrupt"]) > 0
    for name in ("crossround-dense", "crossround-sharded"):
        assert sum(r.carried for r in hist[name]) > 0
        assert max(r.pending for r in hist[name]) > 0
    assert _pair("crossround-sharded")[1].store.evictions > 0
    assert any(r.flushes > 1 for r in hist["staleness"])
    assert any(r.mean_staleness > 0 for r in hist["staleness"])
    assert hist["deadline"][0].timeouts > 0
    assert hist["quarantine-on"][0].quarantined > 0
    assert hist["quarantine-off"][0].quarantined == 0
    drift = _pair("dyn")[1].store.dense_view("drift")
    assert any(bool(v.any()) for v in drift.values())


def test_retry_accounting_balances():
    """Classic mode: every send is an arrival, a quarantined upload, a
    timeout, a retry or a permanent drop."""
    for name in ("mobile", "flaky-corrupt", "deadline", "quarantine-on"):
        port = _pair(name)[1]
        for r in port.history:
            sends = r.transport_bytes // port.client_upload_bytes
            assert sends == (r.arrivals + r.quarantined + r.timeouts
                             + r.retries + r.dropped), name


def test_staleness_discount_changes_the_math():
    """K = 1 on the mobile fleet with Horvitz-Thompson weights: beta = 0
    and beta = 1 give different parameters (a sum-normalising FedAvg
    would cancel a discount shared by one flush's rows)."""
    st = _scenario("staleness")[1]
    batches, n = _batches(10)
    runs = []
    for beta in (0.0, 1.0):
        server = _port(st.replace(async_cfg=dataclasses.replace(
            st.async_cfg, staleness_beta=beta)), 10, seed=4, engine="async")
        server.run(batches, n, 3)
        runs.append(server)
    assert any(not torch.equal(runs[0].params[k], runs[1].params[k])
               for k in runs[0].params)


def test_deadline_cut_leaves_the_ef_state_untouched():
    """Only applied uploads advance a residual row: every other client's
    row is its round-entry state (zeros)."""
    port = _pair("deadline")[1]
    rec = port.history[0]
    assert rec.arrivals + rec.timeouts + rec.dropped == rec.num_sampled
    nonzero = np.zeros((12,), bool)
    for leaf in port.store.residuals_dense().values():
        nonzero |= (leaf.reshape(12, -1) != 0).any(1).numpy()
    assert int(nonzero.sum()) == rec.arrivals
    times = port._async.traits.client_time_s(
        float(6 * 330 * 8), port.client_upload_bytes)
    assert rec.sim_round_s <= float(np.max(times))


def test_quarantine_keeps_nan_out_of_the_model_and_the_ef_state():
    """Gate on: finite parameters, and every quarantined client's residual
    row is its round-entry state; gate off: the same round poisons the
    parameters (the negative control, above)."""
    port = _pair("quarantine-on")[1]
    assert all(bool(torch.isfinite(v).all()) for v in port.params.values())
    words = _reference_draws(42, 1, 12, False, {})[1][1]
    corrupt = np.random.default_rng([int(x) for x in words]).random(12) < 0.5
    rec = port.history[0]
    assert int(corrupt.sum()) >= rec.quarantined > 0
    res = port.store.residuals_dense()
    nonzero = np.zeros((12,), bool)
    for leaf in res.values():
        assert not leaf[torch.from_numpy(corrupt)].any()
        nonzero |= (leaf.reshape(12, -1) != 0).any(1).numpy()
    assert int(nonzero.sum()) == rec.arrivals


# ------------------------------------------------------------------ resume
def test_async_resume_is_bit_identical(tmp_path):
    """4 rounds, ``save_state``, a server built with another seed restores
    and runs 4 more: the 8-round run's parameters, residuals, norms,
    ledger and generators bit for bit (the event generator included)."""
    st = tst.get("async-flaky", error_feedback=True,
                 masking=tst.MaskPolicy.random(0.5),
                 sampler=tst.ImportanceSampler())
    batches, n = _batches(12, 32, 10)
    whole = _port(st, 12, 32, 10, seed=7, engine="async")
    whole.run(batches, n, 8)
    first = _port(st, 12, 32, 10, seed=7, engine="async")
    first.run(batches, n, 4)
    first.save_state(str(tmp_path))
    resumed = _port(st, 12, 32, 10, seed=999, engine="async")
    assert resumed.restore_state(str(tmp_path)) == 4
    resumed.run(batches, n, 4)
    assert [r.round for r in resumed.history] == [5, 6, 7, 8]
    _bit_equal(whole.params, resumed.params)
    _bit_equal(whole.store.residuals_dense(), resumed.store.residuals_dense())
    assert torch.equal(whole.store.norms, resumed.store.norms)
    for field in LEDGER:
        assert [getattr(r, field) for r in whole.history[4:]] == \
            [getattr(r, field) for r in resumed.history], field
    for name, state in whole.state()["rng"].items():
        assert torch.equal(state, resumed.state()["rng"][name]), name
    assert sum(r.retries for r in whole.history) > 0


def test_crossround_resume_drops_uploads_in_flight(tmp_path):
    """``state()`` holds no cross-round upload still in flight, as the
    reference's does not (its ``state()`` keys are pinned here too): a run
    saved with pending uploads resumes without them, so it is not the
    straight run."""
    st = tst.get("async-crossround", error_feedback=True)
    batches, n = _batches(12, 32, 10)
    whole = _port(st, 12, 32, 10, seed=2, engine="async")
    whole.run(batches, n, 5)
    first = _port(st, 12, 32, 10, seed=2, engine="async")
    first.run(batches, n, 3)
    assert first.history[-1].pending > 0
    first.save_state(str(tmp_path))
    resumed = _port(st, 12, 32, 10, seed=2, engine="async")
    resumed.restore_state(str(tmp_path))
    assert resumed._async._pending == []
    resumed.run(batches, n, 2)
    straight = whole.history[3]
    assert straight.carried + straight.timeouts > \
        resumed.history[0].carried + resumed.history[0].timeouts
    assert any(not torch.equal(whole.params[k], resumed.params[k])
               for k in whole.params)
    jp = {"b": jnp.zeros((3,)), "w": jnp.zeros((8, 3))}
    ref = JaxServer.from_strategy(jst.get("async-crossround"), _jax_loss, jp,
                                  4, engine="async",
                                  store=jcs.DenseStore(4, jp))
    assert set(ref.state()) == {"key", "params", "residuals", "versions"}
