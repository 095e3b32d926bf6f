"""The port's segmented masking kernels (plain PyTorch versions on the CPU)
against the JAX package's Pallas kernels in interpret mode, on the same
numpy-made inputs.

Tolerances: counts and histograms must be exact; masked values must be
bitwise equal (compared as int32 bit patterns, so the sign of zero counts).
Kernel-level tests feed the JAX side's thresholds to both, because
``candidate_taus`` uses exp/log, which may differ by one ulp between XLA and
PyTorch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import packing as jpk
from repro.kernels import ref as jref
from repro.kernels import segmented as jseg
from repro_torch.bridge import flatten_tree
from repro_torch.kernels import measure
from repro_torch.kernels import ops as tops
from repro_torch.kernels import packing as tpk
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segmented as tseg

LENET_MASKED = [(5, 5, 6, 16), (784, 120), (120, 84), (84, 10)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Broadcast comparisons over (rows, candidates) on the CPU: with
    several test workers on one machine, torch's intra-op threads only
    contend (the tier-1 run's six workers made one such test about a
    hundred times slower).  Restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _special_leaves(seed: int, clients: int = 2):
    """LeNet-shaped delta leaves with zeros, negatives, values below
    2^-96, values above 2^28, infinities and NaN."""
    rng = np.random.default_rng(seed)
    leaves = []
    for shape in LENET_MASKED:
        x = (rng.standard_normal((clients,) + shape)
             * 10.0 ** rng.uniform(-4, -1)).astype(np.float32)
        flat = x.reshape(clients, -1)
        flat[:, ::89] = 0.0
        flat[:, 3::173] = 1e-31
        flat[:, 5::401] = -3e8
        flat[:, 7::997] = 5e8
        flat[0, 11] = np.inf
        flat[-1, 13] = -np.inf
        flat[0, 17] = np.nan
        leaves.append(x)
    return leaves


def _packed(seed: int, clients: int = 2):
    """One cohort-packed buffer through the reference's packing and row
    padding: (x2d (R, 1024), seg_ids (R, 1), S)."""
    leaves = _special_leaves(seed, clients)
    per_client = [jnp.asarray(leaf[c]) for c in range(clients)
                  for leaf in leaves]
    x2d, spec = jpk.pack_leaves(per_client)
    x2d, seg_ids = jseg.pad_rows(x2d, jnp.asarray(spec.seg_ids()),
                                 interpret=True)
    return np.asarray(x2d), np.asarray(seg_ids), spec.num_segments


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmented_histogram_matches_pallas(seed):
    x2d, seg_ids, S = _packed(seed)
    want = jseg.segmented_histogram(jnp.asarray(x2d), jnp.asarray(seg_ids), S,
                                    interpret=True)
    got = tseg.segmented_histogram(_t(x2d), _t(seg_ids), S)
    assert got.dtype == torch.int32 and tuple(got.shape) == (S, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_taus(x2d, seg_ids, S, gamma=0.5):
    hist = jseg.segmented_histogram(jnp.asarray(x2d), jnp.asarray(seg_ids), S,
                                    interpret=True)
    sizes = np.bincount(seg_ids[:, 0], minlength=S)[:S] * 1024
    k = jnp.asarray(np.maximum(1, np.round(gamma * sizes)), jnp.int32)
    lo, hi, cnt_lo, cnt_hi = jseg.select_thresholds(hist, k)
    cand = jseg.candidate_taus(lo, hi, 16, geometric=True)
    return np.asarray(cand), np.asarray(jnp.where(cnt_hi >= 1, hi, lo))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmented_count_matches_pallas(seed):
    x2d, seg_ids, S = _packed(seed)
    cand, _ = _jax_taus(x2d, seg_ids, S)
    want = jseg.segmented_count(jnp.asarray(x2d), jnp.asarray(seg_ids),
                                jnp.asarray(cand), interpret=True)
    got = tseg.segmented_count(_t(x2d), _t(seg_ids), _t(cand))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmented_apply_matches_pallas_bitwise(seed):
    x2d, seg_ids, S = _packed(seed)
    _, tau = _jax_taus(x2d, seg_ids, S)
    want, want_kept = jseg.segmented_apply(
        jnp.asarray(x2d), jnp.asarray(seg_ids), jnp.asarray(tau),
        interpret=True)
    got, kept = tseg.segmented_apply(_t(x2d), _t(seg_ids), _t(tau))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(want_kept))


def test_apply_zeroes_masked_out_entries_as_the_reference_does():
    """XLA turns the reference's x * float(keep) into a select: masked-out
    negatives come back +0.0 and NaN comes back 0.0."""
    x = np.zeros((32, 1024), np.float32)
    x[0, :4] = [-1e-3, 2e-3, np.nan, -5.0]
    seg_ids = np.zeros((32, 1), np.int32)
    tau = np.asarray([1e-2], np.float32)
    want, _ = jseg.segmented_apply(jnp.asarray(x), jnp.asarray(seg_ids),
                                   jnp.asarray(tau), interpret=True)
    got, kept = tseg.segmented_apply(_t(x), _t(seg_ids), _t(tau))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert not np.signbit(got.numpy()[0, 0]) and got.numpy()[0, 2] == 0.0
    assert int(kept[0, 0]) == 1


def test_out_of_range_segment_rows_count_nowhere():
    """A row whose id is outside [0, S) adds to no segment and is masked
    against tau 0, as the reference's one-hot gathers give it."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 1024)).astype(np.float32)
    seg_ids = np.zeros((64, 1), np.int32)
    seg_ids[32:] = 5
    want = jseg.segmented_histogram(jnp.asarray(x), jnp.asarray(seg_ids), 2,
                                    interpret=True)
    got = tseg.segmented_histogram(_t(x), _t(seg_ids), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tau = np.asarray([0.5, 0.5], np.float32)
    want_out, want_kept = jseg.segmented_apply(
        jnp.asarray(x), jnp.asarray(seg_ids), jnp.asarray(tau), interpret=True)
    out, kept = tseg.segmented_apply(_t(x), _t(seg_ids), _t(tau))
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(want_out))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(want_kept))


# The wire edge inputs' row counts (kernels/measure.py): single rows,
# segments changing inside a block's rows, 32-row blocks at the largest.
EDGE_ROWS = [1, 3, 5, 4095, 33 * 1024 + 5]


def _edge_inputs(rows: int):
    """The wire edge inputs as numpy: (x2d, seg_ids (R, 1), S)."""
    x2d, ids, taus, _ = measure.wire_edge_inputs(rows, seed=rows)
    return x2d.numpy(), ids.numpy().reshape(-1, 1), taus.numel()


@pytest.mark.parametrize("rows", EDGE_ROWS)
def test_segmented_histogram_matches_pallas_on_edge_inputs(rows):
    """The plain version against the Pallas kernel in interpret mode on the
    wire edge inputs (NaN, +-inf, -0.0, subnormals, magnitudes at and
    beside 2^-96; segments of 1-7 rows; ids S + 1 and -2), padded by the
    reference's pad_rows.  No magnitude lies between one of the reference's
    inexact bin edges and the exact power of two (ROADMAP Queue 3), so the
    two agree exactly."""
    x2d, seg_ids, S = _edge_inputs(rows)
    ladder = np.asarray(jseg._bin_ladder()).reshape(-1)
    exact = tseg.bin_edges().numpy()
    mag = np.abs(x2d)
    between = [((mag >= min(lo, hi)) & (mag < max(lo, hi))).any()
               for lo, hi in zip(ladder, exact) if lo != hi]
    assert len(between) > 0 and not any(between)
    jx, jids = jseg.pad_rows(jnp.asarray(x2d), jnp.asarray(seg_ids),
                             interpret=True)
    want = jseg.segmented_histogram(jx, jids, S, interpret=True)
    got = tseg.segmented_histogram(_t(x2d), _t(seg_ids), S)
    assert got.dtype == torch.int32 and tuple(got.shape) == (S, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows", EDGE_ROWS)
def test_segmented_histogram_is_the_histogram_of_segmented_stats(rows):
    """The histogram and stats kernels share one sweep on the card; their
    histograms are the same function."""
    x2d, seg_ids, S = _edge_inputs(rows)
    hist = tseg.segmented_histogram(_t(x2d), _t(seg_ids), S)
    stats_hist, _ = tseg.segmented_stats(_t(x2d), _t(seg_ids), S)
    np.testing.assert_array_equal(hist.numpy(), stats_hist.numpy())


# ------------------------------------- segmented_count: any order of taus
def _rank_count(x2d, seg_ids, taus, seed: int = 0) -> np.ndarray:
    """The CUDA count kernel's formulation in numpy: int keys (|x| bits,
    NaN -1; tau bits, tau <= 0 as 0, NaN tau as INT_MAX), each segment's
    keys sorted with their columns (ties in a random order), every rank by
    the kernel's branchless upper bound, and count at sorted position p =
    #{rank > p} from the rank histogram's suffix sums."""
    x = np.asarray(x2d, np.float32)
    seg = np.asarray(seg_ids).reshape(-1)
    t = np.asarray(taus, np.float32)
    S, C = t.shape
    bits = x.view(np.int32) & 0x7fffffff
    akey = np.where(bits > 0x7f800000, -1, bits).astype(np.int64)
    tkey = np.where(np.isnan(t), 0x7fffffff,
                    np.where(t > 0, t.view(np.int32), 0)).astype(np.int64)
    rng = np.random.default_rng(seed)
    out = np.zeros((S, C), np.int64)
    for s in range(S):
        a = akey[seg == s].reshape(-1)
        order = np.lexsort((rng.permutation(C), tkey[s]))
        keys = tkey[s][order]
        base = np.zeros(a.shape, np.int64)
        n = C
        while n > 1:
            half = n >> 1
            base += np.where(keys[base + half] <= a, half, 0)
            n -= half
        rank = base + (keys[base] <= a)
        suffix = np.cumsum(np.bincount(rank, minlength=C + 1)[::-1])[::-1]
        out[s, order] = suffix[1:]
    return out.astype(np.int32)


def _data_taus(x2d, S: int, C: int, seed: int) -> np.ndarray:
    """(S, C) positive finite taus drawn from the data's own magnitudes,
    shuffled, with duplicates."""
    rng = np.random.default_rng(seed)
    mags = np.abs(x2d[np.isfinite(x2d) & (x2d != 0)])
    taus = rng.choice(mags, (S, C)).astype(np.float32)
    if C > 2:
        taus[:, 1] = taus[:, -1]
    return taus


@pytest.mark.parametrize("C", [1, 5, 17, 33, 256])
def test_segmented_count_matches_pallas_for_any_order_of_taus(C):
    """Unsorted and duplicated candidates, exact against the Pallas kernel
    and against the CUDA kernel's rank formulation."""
    x2d, seg_ids, S = _packed(C)
    taus = _data_taus(x2d, S, C, seed=C)
    want = jseg.segmented_count(jnp.asarray(x2d), jnp.asarray(seg_ids),
                                jnp.asarray(taus), interpret=True)
    got = tseg.segmented_count(_t(x2d), _t(seg_ids), _t(taus))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(_rank_count(x2d, seg_ids, taus),
                                  got.numpy())


def test_segmented_count_inf_taus_match_pallas_in_one_segment():
    """An inf tau counts the infinities only.  One segment: the reference's
    one-hot gather multiplies the other segments' taus by 0, and 0 * inf
    is NaN (next test)."""
    x2d, seg_ids, _ = _packed(4, clients=1)
    ones = np.zeros_like(seg_ids)
    taus = np.array([[np.inf, 1e-2, np.inf, 3e8, 1e-2, 2.5e-3, 1e-31]],
                    np.float32)
    want = jseg.segmented_count(jnp.asarray(x2d), jnp.asarray(ones),
                                jnp.asarray(taus), interpret=True)
    got = tseg.segmented_count(_t(x2d), _t(ones), _t(taus))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0, 0]) == int(np.isinf(x2d).sum()) > 0
    np.testing.assert_array_equal(_rank_count(x2d, ones, taus), got.numpy())


def test_reference_count_loses_a_column_to_an_inf_tau_elsewhere():
    """The reference gathers each row's taus with a one-hot matmul
    (``segmented.py:175``), so an inf tau in one segment makes the same
    column NaN (0 * inf) for every other segment's rows: they count 0
    there.  The port counts them."""
    x2d, seg_ids, S = _packed(5)
    taus = np.full((S, 2), 1e-3, np.float32)
    taus[0, 1] = np.inf
    want = np.asarray(jseg.segmented_count(
        jnp.asarray(x2d), jnp.asarray(seg_ids), jnp.asarray(taus),
        interpret=True))
    got = tseg.segmented_count(_t(x2d), _t(seg_ids), _t(taus)).numpy()
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    assert (want[1:, 1] == 0).all() and (got[1:, 1] == got[1:, 0]).all()
    assert (got[1:, 1] > 0).all()


@pytest.mark.parametrize("C", [1, 16, 17, 4096])
def test_segmented_count_nan_and_nonpositive_taus(C):
    """Outside the reference's contract (taus > 0), held against the port's
    plain version and the rank formulation: a NaN tau counts nothing, a tau
    <= 0 (-0.0 included) every non-NaN entry, rows outside [0, S) nowhere."""
    x2d, seg_ids, S = _packed(6)
    seg_ids = seg_ids.copy()
    seg_ids[1] = S + 3
    seg_ids[2] = -1
    taus = _data_taus(x2d, S, C, seed=C)
    special = np.array([np.nan, -0.0, 0.0, -1.0, 1e-45, np.inf, -np.inf,
                        np.nan], np.float32)
    flat = taus.reshape(-1)
    flat[::7] = np.resize(special, flat[::7].size)
    got = tseg.segmented_count(_t(x2d), _t(seg_ids), _t(taus))
    want = tseg.segmented_count_plain(_t(x2d), _t(seg_ids), _t(taus))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(_rank_count(x2d, seg_ids, taus),
                                  got.numpy())
    assert got.numpy().reshape(-1)[np.isnan(flat)].sum() == 0
    per_seg = [int((~np.isnan(x2d[seg_ids[:, 0] == s])).sum())
               for s in range(S)]
    for s, c in zip(*np.nonzero(taus <= 0)):
        assert int(got[s, c]) == per_seg[s]


def test_segmented_count_of_a_view_off_the_16_byte_boundary_on_the_cpu():
    """On the CPU the wrapper takes a buffer that starts 4 bytes into its
    storage (the card's kernel refuses one) and agrees with the reference."""
    x2d, seg_ids, S = _packed(7)
    taus = _data_taus(x2d, S, 16, seed=7)
    storage = torch.zeros(x2d.size + 4)
    view = storage[1:1 + x2d.size].view(x2d.shape)
    view.copy_(_t(x2d))
    assert view.data_ptr() % 16
    want = jseg.segmented_count(jnp.asarray(x2d), jnp.asarray(seg_ids),
                                jnp.asarray(taus), interpret=True)
    got = tseg.segmented_count(view, _t(seg_ids), _t(taus))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_check_their_arguments():
    x = torch.zeros((4, 1024))
    seg_ids = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError):
        tseg.segmented_histogram(torch.zeros((4, 512)), seg_ids, 1)
    with pytest.raises(TypeError):
        tseg.segmented_histogram(x.double(), seg_ids, 1)
    with pytest.raises(TypeError):
        tseg.segmented_histogram(x, seg_ids.long(), 1)
    with pytest.raises(ValueError):
        tseg.segmented_histogram(x, seg_ids[:3], 1)
    with pytest.raises(ValueError):
        tseg.segmented_count(x, seg_ids, torch.ones((16,)))
    with pytest.raises(TypeError):
        tseg.segmented_apply(x, seg_ids, torch.ones((1,), dtype=torch.float64))
    with pytest.raises(ValueError):
        tseg.segmented_histogram(x.t().contiguous().t(), seg_ids, 1)


def test_cpu_wrappers_launch_nothing():
    before = tseg.launch_counts()
    x2d, seg_ids, S = _packed(0)
    tseg.segmented_histogram(_t(x2d), _t(seg_ids), S)
    assert tseg.launch_counts() == before


@pytest.mark.parametrize("clients", [1, 3])
def test_packing_matches_reference(clients):
    leaves = _special_leaves(4, clients)
    per_client = [jnp.asarray(leaf[c]) for c in range(clients)
                  for leaf in leaves]
    want, jspec = jpk.pack_leaves(per_client)
    spec = tpk.build_pack_spec([_t(leaf[0]) for leaf in leaves])
    got = tpk.pack_stacked([_t(leaf) for leaf in leaves], spec)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    want_ids = np.asarray(jspec.seg_ids())[:, 0]
    np.testing.assert_array_equal(spec.seg_ids(clients).numpy(), want_ids)
    back = tpk.unpack_stacked(got, spec)
    for leaf, b in zip(leaves, back):
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(leaf))
    single, _ = tpk.pack_leaves([_t(leaf[0]) for leaf in leaves])
    assert tuple(single.shape) == (106, 1024)


@pytest.mark.parametrize("seed", [0, 1])
def test_threshold_math_matches_reference(seed):
    """select_thresholds / shrink_brackets agree exactly where the
    reference's jnp.exp2 is exact (octaves >= 2^-12); below that XLA's
    exp2 is a few ulp off a power of two and the port keeps the exact
    power (ROADMAP Queue 3)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, 64, 1024)) * np.asarray(
        [1e-3, 1e-2, 1.0, 50.0])[:, None, None]).astype(np.float32)
    x2d = x.reshape(-1, 1024)
    seg_ids = np.repeat(np.arange(4, dtype=np.int32), 64)[:, None]
    k = np.asarray([1000, 20000, 7, 65536], np.int32)
    hist = np.asarray(jseg.segmented_histogram(
        jnp.asarray(x2d), jnp.asarray(seg_ids), 4, interpret=True))
    want = jseg.select_thresholds(jnp.asarray(hist), jnp.asarray(k))
    got = tseg.select_thresholds(_t(hist), _t(k))
    for w, g in zip(want[2:], got[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5)
    cand = np.asarray(jseg.candidate_taus(want[0], want[1], 16,
                                          geometric=True))
    got_cand = tseg.candidate_taus(_t(np.asarray(want[0])),
                                   _t(np.asarray(want[1])), 16,
                                   geometric=True)
    np.testing.assert_allclose(got_cand.numpy(), cand, rtol=1e-6)
    lin = np.asarray(jseg.candidate_taus(want[0], want[1], 16))
    got_lin = tseg.candidate_taus(_t(np.asarray(want[0])),
                                  _t(np.asarray(want[1])), 16)
    np.testing.assert_array_equal(_bits(got_lin.numpy()), _bits(lin))
    counts = np.asarray(jseg.segmented_count(
        jnp.asarray(x2d), jnp.asarray(seg_ids), jnp.asarray(cand),
        interpret=True))
    want_s = jseg.shrink_brackets(*want, jnp.asarray(cand),
                                  jnp.asarray(counts), jnp.asarray(k))
    got_s = tseg.shrink_brackets(*[_t(np.asarray(w)) for w in want],
                                 _t(cand), _t(counts), _t(k))
    for w, g in zip(want_s, got_s):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _delta_tree(seed: int, scale: float = 1e-3):
    rng = np.random.default_rng(seed)
    tree = {"conv1": {"b": 6, "w": (5, 5, 1, 6)},
            "conv2": {"b": 16, "w": (5, 5, 6, 16)},
            "fc1": {"b": 120, "w": (784, 120)},
            "fc2": {"b": 84, "w": (120, 84)},
            "out": {"b": 10, "w": (84, 10)}}
    return {layer: {p: (scale * rng.standard_normal(s)).astype(np.float32)
                    for p, s in leaves.items()}
            for layer, leaves in tree.items()}


@pytest.mark.parametrize("seed,gamma", [(0, 0.5), (1, 0.5), (2, 0.1),
                                        (3, 0.25)])
def test_topk_mask_pytree_matches_pallas(seed, gamma):
    tree = _delta_tree(seed)
    want = flatten_tree(jax.device_get(jops.topk_mask_pytree(
        jax.tree.map(jnp.asarray, tree), gamma, interpret=True)))
    got = tops.topk_mask_pytree(
        {k: _t(v) for k, v in flatten_tree(tree).items()}, gamma)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(_bits(got[name].numpy()),
                                      _bits(want[name]), err_msg=name)


def test_topk_mask_pytree_contract():
    """DESIGN.md §3.4: at most k kept off tie plateaus, the kept entries
    dominate the dropped ones, small leaves pass through, and a constant
    leaf keeps every tied entry instead of splitting the tie."""
    tree = {k: _t(v) for k, v in flatten_tree(_delta_tree(5)).items()}
    out = tops.topk_mask_pytree(tree, 0.3)
    for name, leaf in tree.items():
        if leaf.numel() < 256:
            assert torch.equal(out[name], leaf)
            continue
        kept = out[name] != 0
        k = max(1, round(0.3 * leaf.numel()))
        assert int(kept.sum()) <= k
        assert float(leaf[kept].abs().min()) >= float(leaf[~kept].abs().max())
    flat = np.full((1000,), 0.5, np.float32)
    want = jops.topk_mask_pytree({"w": jnp.asarray(flat)}, 0.3,
                                 interpret=True)["w"]
    got = tops.topk_mask_pytree({"w": _t(flat)}, 0.3)["w"]
    assert int((got != 0).sum()) == 1000
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_stacked_masking_equals_per_client_masking():
    clients = [{k: _t(v) for k, v in flatten_tree(_delta_tree(s)).items()}
               for s in range(3)]
    stacked = {k: torch.stack([c[k] for c in clients]) for k in clients[0]}
    out = tops.topk_mask_stacked(stacked, 0.5)
    for i, c in enumerate(clients):
        one = tops.topk_mask_pytree(c, 0.5)
        for k in c:
            assert torch.equal(out[k][i].view(torch.int32),
                               one[k].view(torch.int32)), k


def test_gamma_one_and_small_trees_pass_through():
    tree = {k: _t(v) for k, v in flatten_tree(_delta_tree(6)).items()}
    for k, v in tops.topk_mask_pytree(tree, 1.0).items():
        assert torch.equal(v, tree[k])
    small = {"b": tree["conv1.b"]}
    assert torch.equal(tops.topk_mask_pytree(small, 0.5)["b"], small["b"])


@pytest.mark.parametrize("segmented,want", [(True, 4), (False, 40)])
def test_sweep_count_matches_reference(segmented, want):
    assert tops.pytree_sweep_count(4, segmented=segmented) == want
    assert jops.pytree_sweep_count(4, segmented=segmented) == want


def test_ref_oracles_match_reference():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(5000) * 10.0 ** rng.uniform(-8, 3, 5000)
         ).astype(np.float32)
    x[::50] = 0.0
    np.testing.assert_array_equal(
        tref.exponent_histogram_ref(_t(x)).numpy(),
        np.asarray(jref.exponent_histogram_ref(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tref.group_histogram_ref(_t(x)).numpy(),
        np.asarray(jref.group_histogram_ref(jnp.asarray(x))))
    assert int(tref.count_ge_ref(_t(x), 0.01)) == int(
        jref.count_ge_ref(jnp.asarray(x), 0.01))
    want = np.asarray(jax.jit(jref.topk_mask_ref, static_argnums=1)(
        jnp.asarray(x), 0.2))
    np.testing.assert_array_equal(
        _bits(tref.topk_mask_ref(_t(x), 0.2).numpy()), _bits(want))
    want = np.asarray(jax.jit(jref.threshold_mask_ref)(jnp.asarray(x), 0.01))
    np.testing.assert_array_equal(
        _bits(tref.threshold_mask_ref(_t(x), 0.01).numpy()), _bits(want))
