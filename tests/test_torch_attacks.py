"""Byzantine attacks in the port (``repro_torch.core.attacks`` and their
threading through every round engine) against ``repro.core.attacks`` and
the reference's servers, on the CPU.

* ``AttackModel``: the reference's validation messages, ``active``,
  ``needs_keys``, ``num_adversaries``; ``adversary_mask`` byte for byte
  over several (seed, M, fraction).
* ``apply_stacked`` for every kind on numpy-seeded uploads with the
  reference's keyed noise injected for ``gauss``: exact; honest rows pass
  bit for bit; ``gauss`` without noise raises.
* ``client_attack_noise``: a client's rows do not depend on who else is
  drawn, on M or on the device's batching; rounds, seeds and leaves draw
  apart; the stream is not the random-mask stream; the draws are
  standard normal.
* The three Byzantine presets against the reference's, and the presets
  plus a ``nan`` attack on the reference's linear problem (dim 32, 10
  classes, so the 320-wide weight is masked), M = 12, 5 rounds, on the
  ``full``, ``cohort`` and store forms beside the reference's server on
  the same form, the port fed the reference's participant scores:
  participants, ``adversarial``, ``quarantined`` and bytes exact; losses
  rtol 1e-3, parameters and residuals atol 1e-3.  ``gauss`` with the
  reference's noise injected through ``attack_noise(t, ids)``, against
  the reference's oracle on every port form.
* The port's own guarantee: cohort == full == store bit for bit under
  all five kinds; a ``nan`` fleet keeps parameters finite and its
  residuals at their round-entry zeros; ``summary()`` names the attack;
  resume under ``gauss`` is bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attacks as jatk
from repro.core import client_store as jcs
from repro.core import strategy as jst
from repro.core.server import FederatedServer as JaxServer
from repro_torch.core import attacks as tatk
from repro_torch.core import strategy as tst
from repro_torch.core.client_store import ShardedStore
from repro_torch.core.masking import client_mask_scores
from repro_torch.core.server import FederatedServer
from test_torch_async import _data, _jax_loss, _round_keys, _torch_loss
from test_torch_slice import reference_draws

KINDS = ("sign_flip", "scale", "gauss", "zero", "nan")
M, DIM, CLASSES, ROUNDS, SEED = 12, 32, 10, 5, 5


def _np_uploads(rows, seed, sparse=True):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((rows, 6, 5)).astype(np.float32)
    if sparse:
        w[rng.random(w.shape) < 0.5] = 0.0
    return {"b": rng.standard_normal((rows, 3)).astype(np.float32), "w": w}


# ------------------------------------------------------------ the record
BAD = [dict(kind="bitflip"), dict(fraction=1.5), dict(fraction=-0.1),
       dict(strength=0.0), dict(kind="gauss", fraction=0.5, sigma=-1.0)]


@pytest.mark.parametrize("kw", BAD, ids=[next(iter(k)) + str(i)
                                         for i, k in enumerate(BAD)])
def test_validation_messages_match_the_reference(kw):
    with pytest.raises(ValueError) as got:
        tatk.AttackModel(**kw)
    with pytest.raises(ValueError) as want:
        jatk.AttackModel(**kw)
    assert str(got.value) == str(want.value)


def test_flags_counts_and_kinds_match_the_reference():
    assert tatk.attack_kinds() == jatk.attack_kinds() == KINDS
    assert tatk._ATTACK_FOLD == jatk._ATTACK_FOLD
    for kw in (dict(), dict(fraction=0.3), dict(kind="gauss", fraction=0.1),
               dict(kind="nan", fraction=1.0)):
        got, want = tatk.AttackModel(**kw), jatk.AttackModel(**kw)
        assert (got.active, got.needs_keys) == (want.active, want.needs_keys)
        for n in (0, 1, 7, 10, 33, 1000):
            assert got.num_adversaries(n) == want.num_adversaries(n)


@pytest.mark.parametrize("seed, n, fraction", [
    (0, 12, 0.25), (0, 20, 0.3), (11, 20, 0.3), (3, 1, 0.5), (7, 100, 0.1),
    (2, 1000, 0.45), (5, 100_000, 0.3), (1, 9, 0.0)])
def test_adversary_mask_is_byte_identical(seed, n, fraction):
    got = tatk.AttackModel(fraction=fraction, seed=seed).adversary_mask(n)
    want = jatk.AttackModel(fraction=fraction, seed=seed).adversary_mask(n)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


# ------------------------------------------------------------- transforms
def _reference_noise(mask_key, rows, uploads):
    """The reference's gauss draws for ``rows`` (standard normal, before
    sigma): row i's key is ``attack_keys(mask_key, n)[i]`` folded with the
    leaf's position in sorted order."""
    keys = jatk.attack_keys(mask_key, rows)
    out = {}
    for li, name in enumerate(sorted(uploads)):
        shape = uploads[name].shape[1:]
        out[name] = np.asarray(jax.vmap(
            lambda k, _li=li, _s=shape: jax.random.normal(
                jax.random.fold_in(k, _li), _s, jnp.float32))(keys))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_apply_stacked_matches_the_reference_exactly(kind):
    up = _np_uploads(6, seed=KINDS.index(kind))
    up["w"][1, 0, 0] = -0.0
    adv = np.array([1, 0, 1, 0, 0, 1], np.float32)
    key = jax.random.PRNGKey(3)
    jm = jatk.AttackModel(kind=kind, fraction=0.5, strength=3.0, sigma=2.0)
    tm = tatk.AttackModel(kind=kind, fraction=0.5, strength=3.0, sigma=2.0)
    want = jm.apply_stacked({k: jnp.asarray(v) for k, v in up.items()},
                            jnp.asarray(adv),
                            jatk.attack_keys(key, 6) if jm.needs_keys
                            else None)
    noise = None
    if tm.needs_keys:
        noise = {k: torch.from_numpy(v.copy())
                 for k, v in _reference_noise(key, 6, up).items()}
    got = tm.apply_stacked({k: torch.from_numpy(v) for k, v in up.items()},
                           torch.from_numpy(adv), noise)
    for k in up:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.tobytes() == w.tobytes(), k
        assert g[adv == 0].tobytes() == up[k][adv == 0].tobytes(), k
        if kind not in ("zero",):
            assert g[adv == 1].tobytes() != up[k][adv == 1].tobytes(), k


def test_gauss_without_noise_raises():
    with pytest.raises(ValueError, match="noise"):
        tatk.AttackModel(kind="gauss", fraction=0.5).apply_stacked(
            {"w": torch.ones(2, 3)}, torch.tensor([1.0, 0.0]))


# ---------------------------------------------------------- noise stream
LEAVES = {"b": (3,), "w": (6, 5)}


def test_noise_rows_do_not_depend_on_the_others_drawn():
    alone = tatk.client_attack_noise(4, 2, [7], LEAVES, "cpu")
    among = tatk.client_attack_noise(4, 2, [3, 7, 9_999_999], LEAVES, "cpu")
    for k in LEAVES:
        assert alone[k].shape == (1,) + LEAVES[k]
        assert torch.equal(alone[k][0], among[k][1]), k
        assert not torch.equal(among[k][0], among[k][1]), k
    # another round, another seed, another leaf: other draws
    other_t = tatk.client_attack_noise(4, 3, [7], LEAVES, "cpu")
    other_seed = tatk.client_attack_noise(5, 2, [7], LEAVES, "cpu")
    assert not torch.equal(alone["w"], other_t["w"])
    assert not torch.equal(alone["w"], other_seed["w"])
    assert not torch.equal(alone["b"][0], alone["w"][0, 0, :3])


def test_noise_stream_is_not_the_mask_stream():
    noise = tatk.client_attack_noise(0, 1, [0, 1], {"w": (64,)}, "cpu")
    masks = client_mask_scores(0, 1, [0, 1], {"w": (64,)}, "cpu")
    u = torch.special.ndtr(noise["w"])
    assert float((u - masks["w"]).abs().max()) > 0.1


def test_noise_is_standard_normal():
    z = tatk.client_attack_noise(9, 1, np.arange(4), {"w": (50_000,)},
                                 "cpu")["w"].double().reshape(-1)
    assert z.dtype == torch.float64 and bool(torch.isfinite(z).all())
    assert abs(float(z.mean())) < 0.01
    assert abs(float(z.std()) - 1.0) < 0.01
    # the tails of 200,000 draws: P(|z| > 3) = 0.0027, P(|z| > 5.6) ~ 2e-8
    assert 0.002 < float((z.abs() > 3).double().mean()) < 0.0034
    assert float(z.abs().max()) < 5.6


def test_noise_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        tatk.client_attack_noise(0, 1, [0], LEAVES)


# ---------------------------------------------------------------- presets
ROBUST = ("byzantine-signflip", "robust-median", "robust-krum")


@pytest.mark.parametrize("name", ROBUST)
def test_presets_equal_the_reference(name):
    got, want = tst.get(name), jst.get(name)
    assert dataclasses.asdict(got.attack) == dataclasses.asdict(want.attack)
    assert dataclasses.asdict(got.sampling) == \
        dataclasses.asdict(want.sampling)
    assert got.aggregator.name == want.aggregator.name
    assert got.aggregator.ht_compatible == want.aggregator.ht_compatible
    assert got.codec.name == want.codec.name
    assert dataclasses.asdict(got.masking) == dataclasses.asdict(want.masking)
    assert got.sampler.name == want.sampler.name
    assert got.hetero is None and got.async_cfg is None
    assert set(ROBUST) <= set(tst.names())
    assert len(tst.names()) == len(jst.names()) == 19


# ------------------------------------------------- servers beside the reference
def _nan():
    return lambda pkg, atk: pkg.get("fig5").replace(
        attack=atk.AttackModel(kind="nan", fraction=0.25))


CASES = {**{name: (lambda pkg, atk, _n=name: pkg.get(_n)) for name in ROBUST},
         "nan": _nan()}
FORMS = ("full", "cohort", "store")


def _jax_params(w):
    return {"b": jnp.zeros((CLASSES,)), "w": jnp.asarray(w)}


def _torch_params(w):
    return {"b": torch.zeros(CLASSES), "w": torch.from_numpy(w.copy())}


def _reference(js, engine):
    """The reference's server on ``js`` after ROUNDS rounds."""
    x, y, w = _data(M, DIM, CLASSES)
    ref = JaxServer.from_strategy(js, _jax_loss, _jax_params(w), M,
                                  seed=SEED, engine=engine)
    ref.run((jnp.asarray(x), jnp.asarray(y)), np.ones((M,), np.float32),
            ROUNDS)
    return ref


def _port(ts, form, **kw):
    """The port's server on ``ts`` in one form after ROUNDS rounds, fed the
    reference's participant scores."""
    x, y, w = _data(M, DIM, CLASSES)
    tp = _torch_params(w)
    port = FederatedServer.from_strategy(
        ts, _torch_loss, tp, M, seed=SEED + 100, device="cpu",
        engine="full" if form == "full" else "cohort",
        store=ShardedStore(M, tp, M) if form == "store" else None,
        scores=lambda t, m: reference_draws(t, m, SEED)[0], **kw)
    port.run((x, y), np.ones((M,), np.float32), ROUNDS)
    return port


@functools.lru_cache()
def _reference_case(case):
    """One reference run per case, on its cohort engine: its forms agree
    bit for bit under these attacks (its tests/test_attacks.py and
    tests/test_equivalence.py), so each port form is held against it."""
    return _reference(CASES[case](jst, jatk).replace(error_feedback=True),
                      "cohort")


def _assert_parity(ref, port, same_buckets=True):
    fields = ("num_sampled", "transport_bytes", "adversarial", "quarantined")
    for field in fields + (("cohort_size",) if same_buckets else ()):
        assert [getattr(r, field) for r in port.history] == \
            [getattr(r, field) for r in ref.history], field
    np.testing.assert_allclose([r.mean_loss for r in port.history],
                               [r.mean_loss for r in ref.history], rtol=1e-3)
    for k, v in port.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(ref.params[k]),
                                   rtol=0, atol=1e-3, err_msg=k)
    want = ref.store.residuals_dense()
    for k, v in port.store.residuals_dense().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-3, err_msg=k)
    summ, ref_summ = port.summary(), ref.summary()
    for key in ("attack", "adversarial_uploads", "quarantined",
                "transport_bytes"):
        assert summ[key] == ref_summ[key], key


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_server_matches_the_reference(case, form):
    ref = _reference_case(case)
    port = _port(CASES[case](tst, tatk).replace(error_feedback=True), form)
    _assert_parity(ref, port, same_buckets=form != "full")
    assert sum(r.adversarial for r in port.history) > 0
    if case == "nan":
        assert all(r.quarantined == r.adversarial for r in port.history)
    else:
        assert port.summary()["quarantined"] == 0
    if form != "full":
        assert min(r.cohort_size for r in port.history) < M


def _reference_noise_fn(M_, leaves):
    """``attack_noise(t, ids)`` giving the reference server's gauss draws
    for round t (its round key's mask key, no fleet)."""
    shapes = {k: np.zeros((1,) + tuple(s), np.float32)
              for k, s in leaves.items()}

    @functools.lru_cache()
    def round_noise(t):
        _, mask_key = jax.random.split(_round_keys(SEED, t)[-1])
        return _reference_noise(mask_key, M_, shapes)

    def noise(t, ids):
        return {k: v[np.asarray(ids)] for k, v in round_noise(t).items()}

    return noise


@functools.lru_cache()
def _gauss_reference():
    return _reference(jst.get("fig5", error_feedback=True).replace(
        attack=jatk.AttackModel(kind="gauss", fraction=0.25, sigma=0.5)),
        "full")


@pytest.mark.parametrize("form", FORMS)
def test_gauss_with_the_reference_noise_matches_its_oracle(form):
    """The reference's own cohort gauss run does not equal its oracle
    (ROADMAP Queue 3), so every port form is held against the oracle."""
    ts = tst.get("fig5", error_feedback=True).replace(
        attack=tatk.AttackModel(kind="gauss", fraction=0.25, sigma=0.5))
    port = _port(ts, form, attack_noise=_reference_noise_fn(
        M, {"b": (CLASSES,), "w": (DIM, CLASSES)}))
    _assert_parity(_gauss_reference(), port, same_buckets=form == "full")


# ------------------------------------------------- the port's own guarantees
def _port_run(st, form, rounds=ROUNDS, seed=SEED):
    x, y, w = _data(M, DIM, CLASSES)
    tp = _torch_params(w)
    store = ShardedStore(M, tp, M) if form == "store" else None
    server = FederatedServer.from_strategy(
        st, _torch_loss, tp, M, seed=seed, device="cpu",
        engine="full" if form == "full" else "cohort", store=store)
    server.run((x, y), np.ones((M,), np.float32), rounds)
    return server


@pytest.mark.parametrize("kind", KINDS)
def test_cohort_full_and_store_forms_are_bit_identical(kind):
    st = tst.get("fig5", error_feedback=True).replace(
        attack=tatk.AttackModel(kind=kind, fraction=0.25, strength=2.0,
                                sigma=1.5))
    runs = [_port_run(st, form) for form in FORMS]
    full = runs[0]
    assert min(r.cohort_size for r in runs[1].history) < M
    for other in runs[1:]:
        for k, v in full.params.items():
            assert torch.equal(v, other.params[k]), (kind, k)
        ra, rb = full.store.residuals_dense(), other.store.residuals_dense()
        for k in ra:
            assert torch.equal(ra[k], rb[k]), (kind, k)
        assert [(r.num_sampled, r.adversarial, r.quarantined)
                for r in other.history] == \
            [(r.num_sampled, r.adversarial, r.quarantined)
             for r in full.history]
        np.testing.assert_array_equal([r.mean_loss for r in other.history],
                                      [r.mean_loss for r in full.history])


def test_nan_fleet_is_quarantined_and_keeps_its_residuals_at_zero():
    st = tst.get("fig5", error_feedback=True).replace(
        attack=tatk.AttackModel(kind="nan", fraction=0.4))
    server = _port_run(st, "cohort", rounds=4, seed=2)
    for v in server.params.values():
        assert bool(torch.isfinite(v).all())
    assert all(r.quarantined == r.adversarial for r in server.history)
    assert sum(r.adversarial > 0 for r in server.history) > 1
    adv = torch.from_numpy(st.attack.adversary_mask(M).astype(bool))
    res = server.store.residuals_dense()
    for k, v in res.items():
        assert not bool(v[adv].any()), k
    assert bool(res["w"][~adv].any())     # the masked leaf's honest rows
    summ = server.summary()
    assert summ["attack"] == "nan(f=0.4)"
    assert summ["quarantined"] == summ["adversarial_uploads"] > 0


def test_attack_free_runs_say_nothing_of_attacks():
    server = _port_run(tst.get("fig5").replace(
        attack=tatk.AttackModel(fraction=0.0)), "cohort", rounds=2)
    plain = _port_run(tst.get("fig5"), "cohort", rounds=2)
    assert "attack" not in server.summary()
    assert all(r.adversarial == 0 for r in server.history)
    for k, v in plain.params.items():
        assert torch.equal(v, server.params[k]), k


def test_gauss_resume_is_bit_identical(tmp_path):
    st = tst.get("fig5", error_feedback=True).replace(
        attack=tatk.AttackModel(kind="gauss", fraction=0.25, sigma=0.5))
    x, y, w = _data(M, DIM, CLASSES)
    n = np.ones((M,), np.float32)
    whole = _port_run(st, "cohort", rounds=4, seed=8)
    first = FederatedServer.from_strategy(st, _torch_loss, _torch_params(w),
                                          M, seed=8, device="cpu")
    first.run((x, y), n, 2)
    first.save_state(str(tmp_path))
    assert int(first.state()["rng"]["attack"]) == 8
    resumed = FederatedServer.from_strategy(
        st, _torch_loss, _torch_params(w), M, seed=1, device="cpu")
    resumed.restore_state(str(tmp_path))
    resumed.run((x, y), n, 2)
    for k, v in whole.params.items():
        assert torch.equal(v, resumed.params[k]), k
