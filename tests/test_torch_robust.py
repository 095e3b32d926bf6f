"""Robust aggregation in the port (``repro_torch.core.robust``,
``strategy.clipped_fedavg`` / ``get_aggregator``) and the device-independent
norm ``federated._row_l2``, against the reference on the CPU.

* Every aggregator against ``repro.core.robust`` / ``repro.core.strategy``
  on the same numpy-seeded uploads and weights, in six cases: zero-weight
  rows, sparse uploads full of tied (and signed) zeros, Horvitz-Thompson
  weights (``normalize=False``), a single row, an empty round and
  integer-valued uploads with tied rows.  Medians, Krum's choice and the
  rows each rule keeps are exact; the other floats within rtol 1e-5
  (the reference sums a trimmed mean's kept mass and a Krum distance in
  another order).
* Zero-weight rows exactly absent (bit for bit) wherever they sit, the
  reference's hand-checked examples, Krum's ties to the lowest row, the
  pairwise distances in blocks (bit for bit at any block size), the
  breakdown property of the median, trimmed mean and multi-Krum.
* The registry, the construction-time errors and the build-time
  ``TypeError`` of an ``ht_compatible=False`` rule under an HT sampler,
  on every form, with the reference's messages.
* ``_row_l2``: the same bits however the rows are batched or sliced, its
  halving order within rtol 2e-7 of a float64 sum, within atol 1e-3 of the
  reference's norms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import federated as jfed
from repro.core import robust as jrob
from repro.core import strategy as jst
from repro_torch.core import federated as tfed
from repro_torch.core import robust as trob
from repro_torch.core import strategy as tst
from repro_torch.core.async_engine import AsyncRoundRunner
from repro_torch.core.sampling import UniformSampler

RULES = {
    "fedavg": lambda s: s.FEDAVG,
    "clipped_fedavg(2.0)": lambda s: s.get_aggregator("clipped_fedavg", 2.0),
    "coordinate_median": lambda s: s.get_aggregator("coordinate_median"),
    "trimmed_mean(0.2)": lambda s: s.get_aggregator("trimmed_mean", 0.2),
    "trimmed_mean(0.0)": lambda s: s.get_aggregator("trimmed_mean", 0.0),
    "krum(1)": lambda s: s.get_aggregator("krum", 1),
    "multi_krum(1,3)": lambda s: s.get_aggregator("multi_krum", 1, 3),
    "norm_filter(6.0)": lambda s: s.get_aggregator("norm_filter", 6.0),
    "norm_filter(6.0)+median": lambda s: s.get_aggregator(
        "norm_filter", 6.0, inner=s.get_aggregator("coordinate_median")),
}
# rules whose every output entry is one of the inputs' (or g + it)
EXACT = ("coordinate_median", "krum(1)", "norm_filter(6.0)+median")


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


def _case(name):
    """``(global, uploads, weights, normalize)`` as numpy arrays."""
    rng = np.random.default_rng(CASES.index(name))
    g = {"b": rng.standard_normal(3).astype(np.float32),
         "w": rng.standard_normal((6, 5)).astype(np.float32)}
    rows = 1 if name == "single" else 9   # one shape: the reference's
    # eager ops compile once for all cases
    up = {"b": rng.standard_normal((rows, 3)).astype(np.float32),
          "w": rng.standard_normal((rows, 6, 5)).astype(np.float32)}
    w = rng.integers(1, 50, rows).astype(np.float32)
    normalize = True
    if name == "zero-weight":
        w[[0, 4, 5]] = 0.0
        up["w"][4] *= 1e4
    elif name == "sparse":
        for k in up:
            up[k][rng.random(up[k].shape) < 0.6] = 0.0
            neg = rng.random(up[k].shape) < 0.3
            up[k][neg & (up[k] == 0)] = -0.0
        w[2] = 0.0
    elif name == "ht":
        w = (rng.random(rows) * 7.3 + 0.1).astype(np.float32)
        w[3] = 0.0
        normalize = False
    elif name == "empty":
        w[:] = 0.0
    elif name == "integer":
        for k in up:
            up[k] = np.round(up[k] * 2).astype(np.float32)
        up["w"][7] = up["w"][2]
        up["b"][7] = up["b"][2]
    return g, up, w, normalize


CASES = ("zero-weight", "sparse", "ht", "single", "empty", "integer")


def _call(pkg, rule, g, up, w, normalize):
    agg = RULES[rule](pkg)
    if pkg is jst:
        out = agg.fn({k: jnp.asarray(v) for k, v in g.items()},
                     {k: jnp.asarray(v) for k, v in up.items()},
                     jnp.asarray(w), "delta", normalize=normalize)
        return {k: np.asarray(v) for k, v in out.items()}
    out = agg.fn({k: torch.from_numpy(v) for k, v in g.items()},
                 {k: torch.from_numpy(v) for k, v in up.items()},
                 torch.from_numpy(w), "delta", normalize=normalize)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_matches_the_reference(rule, case):
    g, up, w, normalize = _case(case)
    got = _call(tst, rule, g, up, w, normalize)
    want = _call(jst, rule, g, up, w, normalize)
    for k in g:
        if rule in EXACT or case == "empty":
            assert got[k].tobytes() == want[k].tobytes(), k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    if case == "empty":
        for k in g:
            assert got[k].tobytes() == g[k].tobytes(), k


@pytest.mark.parametrize("case", [c for c in CASES if c != "empty"])
@pytest.mark.parametrize("f", [0, 1, 3])
def test_krum_scores_and_choices_are_the_reference(case, f):
    g, up, w, _ = _case(case)
    score, present, n = trob._krum_scores(
        {k: torch.from_numpy(v) for k, v in up.items()},
        torch.from_numpy(w), f)
    want, _, want_n = jrob._krum_scores(
        {k: jnp.asarray(v) for k, v in up.items()}, jnp.asarray(w), f)
    assert float(n) == float(want_n)
    want = np.asarray(want)
    assert int(torch.argmin(score)) == int(np.argmin(want))
    order = torch.argsort(torch.argsort(score, stable=True), stable=True)
    np.testing.assert_array_equal(order.numpy(), np.asarray(
        jnp.argsort(jnp.argsort(jnp.asarray(want)))))
    np.testing.assert_allclose(score.numpy(), want, rtol=1e-5)


# ------------------------------------------------------------- invariants
_G = {"w": np.zeros(4, np.float32)}
_UPS = {"w": np.array([[1.0, 2.0, 3.0, 4.0], [100.0, -5.0, 0.0, 7.0],
                       [0.5, 0.5, 0.5, 0.5]], np.float32)}
_W = np.array([1.0, 0.0, 2.0], np.float32)
ROBUST = ("coordinate_median", "trimmed_mean(0.2)", "krum(1)",
          "multi_krum(1,3)", "norm_filter(6.0)", "norm_filter(6.0)+median")


@pytest.mark.parametrize("rule", ROBUST)
def test_zero_weight_rows_are_exactly_absent(rule):
    g, up, w, _ = _case("integer")
    base = _call(tst, rule, g, up, w, True)
    rng = np.random.default_rng(1)
    junk = {k: (rng.standard_normal((3,) + v.shape[1:]) * 1e6).astype(
        np.float32) for k, v in up.items()}
    at = [0, 5, 9]            # first, among and after the rows
    padded = {k: np.insert(v, at, junk[k], axis=0)
              for k, v in up.items()}
    wp = np.insert(w, at, 0.0)
    got = _call(tst, rule, g, padded, wp, True)
    for k in g:
        assert got[k].tobytes() == base[k].tobytes(), (rule, k)


def test_the_reference_hand_checked_examples():
    def call(rule, w=_W):
        return _call(tst, rule, _G, _UPS, w, True)["w"]
    np.testing.assert_array_equal(call("coordinate_median"),
                                  np.full(4, 0.5, np.float32))
    np.testing.assert_array_equal(call("krum(1)"), _UPS["w"][0])
    nf = trob.norm_filter(5.0).fn({"w": torch.from_numpy(_G["w"])},
                                  {"w": torch.from_numpy(_UPS["w"])},
                                  torch.ones(3), "delta")
    # rows 0 (norm ~5.48) and 1 are rejected; only row 2 survives
    np.testing.assert_array_equal(nf["w"].numpy(), _UPS["w"][2])
    one = {"w": np.array([0.25, -1.5], np.float32)}
    row = {"w": np.array([[0.125, 3.75]], np.float32)}
    med = _call(tst, "coordinate_median", one, row,
                np.array([7.0], np.float32), True)
    avg = _call(tst, "fedavg", one, row, np.array([7.0], np.float32), True)
    assert med["w"].tobytes() == avg["w"].tobytes()
    assert trob.trimmed_mean(0.0).fn is tfed.fedavg_aggregate


def test_krum_ties_go_to_the_lowest_row():
    rows = np.array([[3.0, 0.0], [1.0, 1.0], [1.0, 1.0], [1.0, 1.0],
                     [-2.0, 5.0]], np.float32)
    w = np.ones(5, np.float32)
    got = _call(tst, "krum(1)", {"w": np.zeros(2, np.float32)},
                {"w": rows}, w, True)
    np.testing.assert_array_equal(got["w"], rows[1])
    score, _, _ = trob._krum_scores({"w": torch.from_numpy(rows)},
                                    torch.from_numpy(w), 1)
    rank = torch.argsort(torch.argsort(score, stable=True), stable=True)
    assert rank[1:4].tolist() == [0, 1, 2]


def test_pairwise_distances_in_blocks_are_bit_identical(monkeypatch):
    g, up, w, _ = _case("zero-weight")
    ups = {k: torch.from_numpy(v) for k, v in up.items()}
    present = torch.from_numpy((w > 0).astype(np.float32))
    whole = trob._pairwise_sq_dists(ups, present)
    seen = []
    real = torch.Tensor.mul_

    def spy(self, other):
        seen.append(tuple(self.shape))
        return real(self, other)

    cap = 4 * 9 * 30 * 2
    monkeypatch.setattr(trob, "_PAIRWISE_BYTES", cap)
    monkeypatch.setattr(torch.Tensor, "mul_", spy)
    blocked = trob._pairwise_sq_dists(ups, present)
    monkeypatch.undo()
    assert torch.equal(whole, blocked)
    # "w" (30 entries) in blocks of 2 rows against all 9, "b" (3) whole:
    # no block holds more than the cap, and no (9, 9, 30) tensor exists
    assert (2, 9, 30) in seen and (9, 9, 3) in seen
    assert all(4 * r * n * p <= cap for r, n, p in seen)
    want = np.asarray(jrob._pairwise_sq_dists(
        {k: jnp.asarray(v) for k, v in up.items()},
        jnp.asarray((w > 0).astype(np.float32))))
    np.testing.assert_allclose(whole.numpy(), want, rtol=1e-5)


def test_sign_flip_below_breakdown_cannot_move_the_robust_rules():
    rows = np.concatenate([np.ones((7, 5)), -4.0 * np.ones((3, 5))]).astype(
        np.float32)
    g = {"w": np.zeros(5, np.float32)}
    w = np.ones(10, np.float32)
    med = _call(tst, "coordinate_median", g, {"w": rows}, w, True)
    np.testing.assert_array_equal(med["w"], np.ones(5))
    tm = trob.trimmed_mean(0.3).fn({"w": torch.zeros(5)},
                                   {"w": torch.from_numpy(rows)},
                                   torch.from_numpy(w), "delta")
    np.testing.assert_allclose(tm["w"].numpy(), np.ones(5), rtol=1e-5)
    mk = trob.multi_krum(3, 4).fn({"w": torch.zeros(5)},
                                  {"w": torch.from_numpy(rows)},
                                  torch.from_numpy(w), "delta")
    np.testing.assert_allclose(mk["w"].numpy(), np.ones(5), rtol=1e-5)
    avg = _call(tst, "fedavg", g, {"w": rows}, w, True)
    assert avg["w"][0] < 0.0


def test_rules_take_no_rows_at_all():
    """The port's rounds hand a rule only the participants' rows, so an
    empty round (the threshold sampler's zero) gives it none."""
    g = {"w": torch.ones(4)}
    empty = {"w": torch.zeros((0, 4))}
    for rule in ROBUST + ("clipped_fedavg(2.0)",):
        out = RULES[rule](tst).fn(g, empty, torch.zeros(0), "delta")
        assert torch.equal(out["w"], g["w"]), rule


# ----------------------------------------------------- registry and errors
BAD = [
    (lambda p: p.clipped_fedavg(-1.0), "clipped_fedavg"),
    (lambda p: p.clipped_fedavg(0.0), "clipped_fedavg"),
    (lambda p: p.get_aggregator("trimmed_mean", 0.5), "beta"),
    (lambda p: p.get_aggregator("trimmed_mean", -0.1), "beta"),
    (lambda p: p.get_aggregator("krum", -1), "f"),
    (lambda p: p.get_aggregator("multi_krum", -2, 1), "f"),
    (lambda p: p.get_aggregator("multi_krum", 1, 0), "m"),
    (lambda p: p.get_aggregator("norm_filter", 0.0), "max_norm"),
]


@pytest.mark.parametrize("i", range(len(BAD)))
def test_construction_errors_match_the_reference(i):
    make, _ = BAD[i]
    with pytest.raises(ValueError) as got:
        make(tst)
    with pytest.raises(ValueError) as want:
        make(jst)
    assert str(got.value) == str(want.value)


def test_registry_matches_the_reference():
    assert tst.aggregator_names() == jst.aggregator_names()
    for rule in RULES:
        got, want = RULES[rule](tst), RULES[rule](jst)
        assert (got.name, got.ht_compatible) == (want.name,
                                                 want.ht_compatible)
    with pytest.raises(KeyError) as got:
        tst.get_aggregator("median-of-means")
    with pytest.raises(KeyError) as want:
        jst.get_aggregator("median-of-means")
    assert str(got.value) == str(want.value)
    assert tst.get("robust-krum").aggregator.ht_compatible is False


@pytest.mark.parametrize("form", ["full", "cohort", "store", "async"])
def test_krum_under_an_ht_sampler_raises_at_build_time(form):
    st = tst.get("fig3-importance").replace(
        aggregator=trob.multi_krum(1, 2))
    with pytest.raises(TypeError) as got:
        if form == "async":
            AsyncRoundRunner(st, 8)
        else:
            tst.build_round(st, None, 8, form=form, cohort_size=4)
    with pytest.raises(TypeError) as want:
        jst.build_round(jst.get("fig3-importance").replace(
            aggregator=jrob.multi_krum(1, 2)), None, 8, form="full")
    assert str(got.value) == str(want.value)
    # the weighted-rank rules take HT weights, and Krum a uniform sampler
    tst.build_round(st.replace(aggregator=trob.coordinate_median()), None, 8,
                    form=form if form != "async" else "store", cohort_size=4)
    tst.build_round(st.replace(sampler=UniformSampler()), None, 8,
                    form="full")


# ------------------------------------------------------------------ _row_l2
def _tree(rows, seed):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((rows, 3, 7)) * 10.0).astype(
                np.float32),
            "b": rng.standard_normal((rows, 1)).astype(np.float32),
            "c": (rng.standard_normal((rows, 1025)) * 1e-3).astype(
                np.float32),
            "d": np.zeros((rows, 0), np.float32)}


def test_row_l2_bits_do_not_depend_on_the_batching():
    up = {k: torch.from_numpy(v) for k, v in _tree(13, 0).items()}
    whole = tfed._row_l2(up)
    for lo, hi in ((0, 1), (3, 9), (12, 13), (0, 13)):
        part = tfed._row_l2({k: v[lo:hi] for k, v in up.items()})
        assert torch.equal(part, whole[lo:hi]), (lo, hi)
    perm = torch.from_numpy(np.random.default_rng(2).permutation(13))
    shuffled = tfed._row_l2({k: v.index_select(0, perm)
                             for k, v in up.items()})
    assert torch.equal(shuffled, whole.index_select(0, perm))
    # strided views (a column slice) give the contiguous copy's bits
    wide = torch.from_numpy(_tree(5, 1)["c"])
    view = wide[:, 1:1000]
    assert not view.is_contiguous()
    assert torch.equal(tfed._row_l2({"c": view}),
                       tfed._row_l2({"c": view.contiguous()}))


def test_row_l2_halving_order_against_float64_and_the_reference():
    for seed in range(4):
        tree = _tree(7, seed)
        got = tfed._row_l2({k: torch.from_numpy(v) for k, v in tree.items()})
        f64 = np.sqrt(sum((v.astype(np.float64) ** 2).reshape(7, -1).sum(1)
                          for v in tree.values()))
        np.testing.assert_allclose(got.numpy(), f64, rtol=2e-7)
        want = np.asarray(jfed._row_l2({k: jnp.asarray(v)
                                        for k, v in tree.items()}))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    # each width's halving is the pairwise tree over the zero-padded row
    for width in (1, 2, 3, 5, 8, 9, 1000):
        x = torch.from_numpy(np.random.default_rng(width).random(
            (2, width)).astype(np.float32))
        sq = torch.cat([x * x, torch.zeros(2, (1 << max(width - 1, 0)
                                                .bit_length()) - width)], 1)
        while sq.shape[1] > 1:
            h = sq.shape[1] // 2
            sq = sq[:, :h] + sq[:, h:]
        assert torch.equal(tfed._row_sumsq(x), sq[:, 0]), width
