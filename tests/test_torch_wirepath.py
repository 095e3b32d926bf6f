"""The fused wire path of the port — kernels 4 and 5, ``topk_encode``, the
fig5-fused-int8 round with error feedback — against the JAX package on the
CPU (Pallas in interpret mode), on the same numpy-made inputs.

Tolerances: histograms, counts, bitmaps, kept counts, int8 codes, wire
arrays, m_t, buckets, bytes and ``quarantined`` exact; masked values and
maxima bitwise.  Trained floats of the port against the reference within
rtol 1e-3 (``tests/test_torch_slice.py`` states why); the port's
fused-vs-codec run pairs bitwise, parameters and residuals.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import strategy as jst
from repro.core.server import FederatedServer as JaxServer
from repro.data.partition import iid_partition_images
from repro.data.synthetic import class_gaussian_images
from repro.kernels import ops as jops
from repro.kernels import packing as jpk
from repro.kernels import segmented as jseg
from repro.models import paper_models as jpm
from repro_torch import bridge
from repro_torch.core import strategy as tst
from repro_torch.core.server import FederatedServer
from repro_torch.kernels import ops as tops
from repro_torch.kernels import segmented as tseg
from repro_torch.models import paper_models as tpm
from test_torch_slice import reference_scores

LENET_MASKED = [(5, 5, 6, 16), (784, 120), (120, 84), (84, 10)]


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


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _packed(seed: int, clients: int = 2, special=None):
    """A cohort-packed LeNet-shaped buffer through the reference's packing
    and row padding, with zeros, negatives, |x| < 2^-96 and |x| > 2^28."""
    rng = np.random.default_rng(seed)
    leaves = []
    for shape in LENET_MASKED:
        x = (rng.standard_normal((clients,) + shape)
             * 10.0 ** rng.uniform(-4, -1)).astype(np.float32)
        flat = x.reshape(clients, -1)
        flat[:, ::89] = 0.0
        flat[:, 3::173] = -1e-31
        flat[:, 5::401] = -3e8
        flat[:, 7::997] = 5e8
        leaves.append(x)
    if special is not None:
        special(leaves)
    per_client = [jnp.asarray(leaf[c]) for c in range(clients)
                  for leaf in leaves]
    x2d, spec = jpk.pack_leaves(per_client)
    x2d, seg_ids = jseg.pad_rows(x2d, jnp.asarray(spec.seg_ids()),
                                 interpret=True)
    return np.asarray(x2d), np.asarray(seg_ids), spec.num_segments


def _stats_both(x2d, seg_ids, S):
    want = jseg.segmented_stats(jnp.asarray(x2d), jnp.asarray(seg_ids), S,
                                interpret=True)
    got = tseg.segmented_stats(_t(x2d), _t(seg_ids), S)
    return got, want


@pytest.mark.parametrize("seed", [0, 1])
def test_segmented_stats_matches_pallas(seed):
    x2d, seg_ids, S = _packed(seed)
    (hist, amax), (want_hist, want_amax) = _stats_both(x2d, seg_ids, S)
    assert hist.dtype == torch.int32 and tuple(amax.shape) == (S, 1)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(want_hist))
    np.testing.assert_array_equal(_bits(amax), _bits(want_amax))


def test_segmented_stats_keeps_nonfinite_in_its_own_segment():
    """A NaN makes its own segment's max NaN, an infinity its own
    segment's inf; no other segment (of the same client or another)
    changes, exactly as the reference's compiled kernel gives."""
    def poison(leaves):
        leaves[1][0].reshape(-1)[17] = np.nan
        leaves[2][1].reshape(-1)[3] = -np.inf
    x2d, seg_ids, S = _packed(3, special=poison)
    (hist, amax), (want_hist, want_amax) = _stats_both(x2d, seg_ids, S)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(want_hist))
    got, want = amax.numpy()[:, 0], np.asarray(want_amax)[:, 0]
    assert np.isnan(want[1]) and np.isinf(want[6])
    assert np.isfinite(np.delete(want, [1, 6])).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


def _encode_inputs(x2d, seg_ids, S, quantize):
    rng = np.random.default_rng(S)
    taus = (10.0 ** rng.uniform(-4, -2, S)).astype(np.float32)
    taus[0] = 2.0 ** -97
    if not quantize:
        return taus, None
    _, amax = _stats_both(x2d, seg_ids, S)[1]
    return taus, np.array(jnp.maximum(
        amax[:, 0] * jnp.float32(1.0 / 127.0), 1e-12))


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("seed", [0, 2])
def test_segmented_encode_matches_pallas(seed, quantize):
    x2d, seg_ids, S = _packed(seed)
    taus, scales = _encode_inputs(x2d, seg_ids, S, quantize)
    want = jseg.segmented_encode(
        jnp.asarray(x2d), jnp.asarray(seg_ids), jnp.asarray(taus),
        None if scales is None else jnp.asarray(scales), interpret=True)
    got = tseg.segmented_encode(_t(x2d), _t(seg_ids), _t(taus),
                                None if scales is None else _t(scales))
    assert got[0].dtype == (torch.int8 if quantize else torch.float32)
    assert got[1].dtype == torch.uint8 and tuple(got[1].shape) == (
        x2d.shape[0], 128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("quantize", [False, True])
def test_segmented_encode_with_nan_matches_pallas(quantize):
    """NaN never passes the threshold (bit 0, value +0.0, code 0).  A NaN
    or infinite scale makes the reference's one-hot gather NaN on every row
    of its buffer, so every code of the buffer is 0: the port reproduces
    that per client through ``client_encode_scales`` (one client here)."""
    def poison(leaves):
        leaves[0][0].reshape(-1)[[4, 9]] = [np.nan, np.inf]
    x2d, seg_ids, S = _packed(4, special=poison)
    taus, scales = _encode_inputs(x2d, seg_ids, S, quantize)
    if quantize:
        scales[1], scales[2] = np.nan, np.inf
    want = jseg.segmented_encode(
        jnp.asarray(x2d), jnp.asarray(seg_ids), jnp.asarray(taus),
        None if scales is None else jnp.asarray(scales), interpret=True)
    got = tseg.segmented_encode(
        _t(x2d), _t(seg_ids), _t(taus),
        None if scales is None else tops.client_encode_scales(_t(scales), 1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    if quantize:
        assert not got[0].any()


# The reference's own odd layouts (tests/test_kernels.py): leaves of odd
# sizes packed and padded by its pad_rows to one slab, to slabs of 128
# rows, and to slabs of 40 rows rounded down to 32.
ODD_SHAPES = [(300, 77), (128, 128), (8, 8, 65), (70000,), (257,)]


def _odd_packed(seed: int, slab):
    rng = np.random.default_rng(seed)
    leaves = []
    for shape in ODD_SHAPES:
        x = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-4, 0)
             ).astype(np.float32)
        flat = x.reshape(-1)
        flat[::53] = 0.0
        flat[1::97] = -2.0 ** -96
        flat[2::131] = 1e-31
        leaves.append(jnp.asarray(x))
    x2d, spec = jpk.pack_leaves(leaves)
    x2d, seg_ids = jseg.pad_rows(x2d, jnp.asarray(spec.seg_ids()),
                                 interpret=True, slab_rows=slab)
    return np.asarray(x2d), np.asarray(seg_ids), spec.num_segments


@pytest.mark.parametrize("slab", [None, 128, 40])
@pytest.mark.parametrize("kind", ["stats", "int8", "fp32"])
def test_wire_plain_versions_match_pallas_on_odd_layouts(kind, slab):
    """``segmented_stats_plain`` and ``segmented_encode_plain`` (int8 and
    fp32) against the Pallas kernels in interpret mode, on the layouts the
    reference's pad_rows makes; exact and bitwise."""
    x2d, seg_ids, S = _odd_packed(len(ODD_SHAPES) + (slab or 0), slab)
    jx, jids = jnp.asarray(x2d), jnp.asarray(seg_ids)
    if kind == "stats":
        want = jseg.segmented_stats(jx, jids, S, interpret=True,
                                    slab_rows=slab)
        got = tseg.segmented_stats_plain(_t(x2d), _t(seg_ids), S)
    else:
        rng = np.random.default_rng(S)
        taus = (10.0 ** rng.uniform(-3, -1, S)).astype(np.float32)
        scales = None
        if kind == "int8":
            amax = jseg.segmented_stats(jx, jids, S, interpret=True,
                                        slab_rows=slab)[1]
            scales = np.array(jnp.maximum(
                amax[:, 0] * jnp.float32(1.0 / 127.0), 1e-12))
        want = jseg.segmented_encode(
            jx, jids, jnp.asarray(taus),
            None if scales is None else jnp.asarray(scales),
            interpret=True, slab_rows=slab)
        got = tseg.segmented_encode_plain(
            _t(x2d), _t(seg_ids), _t(taus),
            None if scales is None else _t(scales))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(np.asarray(w)))


def test_reference_bin_edges_are_a_few_ulps_off_on_the_cpu():
    """A reference fault, pinned side by side: its bin ladder is
    ``jnp.exp2`` of the edge exponents, which XLA's CPU exp2 misses by a
    few ulps at most edges, so a magnitude one ulp below such an edge
    counts in the reference's bin and not in the port's, whose edges are
    exact powers of two (``torch.ldexp``)."""
    ladder = np.asarray(jseg._bin_ladder()).reshape(-1)
    exact = tseg.bin_edges().numpy()
    low = np.flatnonzero(ladder < exact)
    assert low.size > 0
    x2d = np.zeros((1, 1024), np.float32)
    x2d[0, :exact.size] = np.nextafter(exact, np.float32(0))
    x2d, seg_ids = jseg.pad_rows(jnp.asarray(x2d), jnp.zeros((1, 1),
                                                             jnp.int32),
                                 interpret=True)
    (hist, _), (want, _) = _stats_both(np.asarray(x2d), np.asarray(seg_ids),
                                       1)
    below = np.nextafter(exact, np.float32(0))[:, None]
    np.testing.assert_array_equal(hist.numpy()[0], (below >= exact).sum(0))
    np.testing.assert_array_equal(np.asarray(want)[0],
                                  (below >= ladder).sum(0))
    assert (np.asarray(want)[0] > hist.numpy()[0])[low].all()


@pytest.mark.parametrize("kind", ["stats", "int8", "fp32"])
def test_wire_wrappers_take_a_view_off_the_16_byte_boundary_on_the_cpu(kind):
    """On the CPU the stats and encode wrappers take a buffer that starts 4
    bytes into its storage (the card's kernels refuse one) and agree with
    the reference."""
    x2d, seg_ids, S = _packed(6)
    storage = torch.zeros(x2d.size + 4)
    view = storage[1:1 + x2d.size].view(x2d.shape)
    view.copy_(_t(x2d))
    assert view.data_ptr() % 16
    jx, jids = jnp.asarray(x2d), jnp.asarray(seg_ids)
    if kind == "stats":
        want = jseg.segmented_stats(jx, jids, S, interpret=True)
        got = tseg.segmented_stats(view, _t(seg_ids), S)
    else:
        taus, scales = _encode_inputs(x2d, seg_ids, S, kind == "int8")
        want = jseg.segmented_encode(
            jx, jids, jnp.asarray(taus),
            None if scales is None else jnp.asarray(scales), interpret=True)
        got = tseg.segmented_encode(view, _t(seg_ids), _t(taus),
                                    None if scales is None else _t(scales))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(np.asarray(w)))


@pytest.mark.parametrize("candidates", [1, 8, 17, 32])
def test_segmented_count_takes_any_candidate_count(candidates):
    x2d, seg_ids, S = _packed(5)
    rng = np.random.default_rng(candidates)
    taus = np.sort(10.0 ** rng.uniform(-5, -1, (S, candidates)), 1
                   ).astype(np.float32)
    want = jseg.segmented_count(jnp.asarray(x2d), jnp.asarray(seg_ids),
                                jnp.asarray(taus), interpret=True)
    got = tseg.segmented_count(_t(x2d), _t(seg_ids), _t(taus))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------- topk_encode
def _delta(seed: int):
    rng = np.random.default_rng(seed)
    shapes = {"conv1.b": (6,), "conv2.w": (5, 5, 6, 16), "fc1.w": (784, 120),
              "out.w": (84, 10)}
    return {k: (1e-3 * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


def _assert_wire_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            _assert_wire_equal(got[key], want[key])
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert g.dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(_bits(g), _bits(want))


@pytest.mark.parametrize("assume_masked", [True, False])
@pytest.mark.parametrize("wire,quantize", [("coo", True), ("bitmap", True),
                                           ("coo", False)])
def test_topk_encode_pytree_matches_reference(wire, quantize, assume_masked):
    tree = _delta(0)
    if assume_masked:
        tree = jax.device_get(jops.topk_mask_pytree(
            jax.tree.map(jnp.asarray, tree), 0.5, interpret=True))
    kw = dict(min_leaf_size=256, quantize=quantize, wire=wire,
              assume_masked=assume_masked)
    want = jops.topk_encode_pytree(jax.tree.map(jnp.asarray, tree), 0.5,
                                   interpret=True, **kw)
    got = tops.topk_encode_pytree({k: _t(v) for k, v in tree.items()}, 0.5,
                                  **kw)
    _assert_wire_equal(got, want)


def _client(wire, i):
    """Client i's payload of a stacked wire (shape vectors are shared)."""
    if isinstance(wire, dict):
        return {k: v if k == "shape" else _client(v, i)
                for k, v in wire.items()}
    return wire[i]


def test_topk_encode_stacked_equals_per_client():
    """One launch of each kernel for the cohort == each client alone."""
    clients = [{k: _t(v) for k, v in _delta(s).items()} for s in range(3)]
    stacked = {k: torch.stack([c[k] for c in clients]) for k in clients[0]}
    for wire in ("coo", "bitmap"):
        out = tops.topk_encode_stacked(stacked, 0.3, quantize=True,
                                       wire=wire)
        for i, c in enumerate(clients):
            one = tops.topk_encode_pytree(c, 0.3, quantize=True, wire=wire)
            _assert_wire_equal(_client(out, i), one)


def test_wirepath_accounting_matches_reference():
    for kw in (dict(fused=True), dict(fused=False),
               dict(fused=True, assume_masked=True),
               dict(fused=True, assume_masked=True, quantize=False)):
        assert tops.wirepath_sweep_count(**kw) == jops.wirepath_sweep_count(
            **kw)
    for wire in ("coo", "bitmap"):
        for fused in (True, False):
            assert tops.wirepath_bytes_moved(
                107_786, 0.5, fused=fused, wire=wire) == \
                jops.wirepath_bytes_moved(107_786, 0.5, fused=fused,
                                          wire=wire)


# ------------------------------------------------------------ the slice
M, ROUNDS, BATCH = 8, 6, 16


@pytest.fixture(scope="module")
def fused_slice():
    """fig5-fused-int8 with kernel masking, reference and port on the
    LeNet-12 problem of tests/test_torch_slice.py."""
    ds = class_gaussian_images(num_train=512, image_size=12, seed=0)
    xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, M, BATCH,
                                      seed=0)
    p0 = jpm.init_lenet(jax.random.PRNGKey(0), image_size=12)
    ref = JaxServer.from_strategy(
        jst.get("fig5-fused-int8",
                masking=jst.MaskPolicy.selective(0.5, backend="kernel")),
        jpm.classifier_loss(jpm.lenet_forward), p0, M, seed=0)
    ref.run((jnp.asarray(xs), jnp.asarray(ys)), ns, ROUNDS)
    port = FederatedServer.from_strategy(
        tst.get("fig5-fused-int8",
                masking=tst.MaskPolicy.selective(0.5, backend="kernel")),
        tpm.classifier_loss(tpm.lenet_forward),
        bridge.params_from_numpy(jax.device_get(p0), device="cpu"), M,
        device="cpu", scores=reference_scores)
    port.run((xs, ys), ns, ROUNDS)
    return ref, port


def test_fused_slice_counts_and_bytes_exact(fused_slice):
    ref, port = fused_slice
    assert port.summary()["codec"] == ref.summary()["codec"] == \
        "fused-sparse(gamma=0.5)+int8"
    assert [r.num_sampled for r in port.history] == \
        [r.num_sampled for r in ref.history] == [7, 7, 6, 5, 5, 4]
    assert [r.cohort_size for r in port.history] == \
        [r.cohort_size for r in ref.history]
    assert port.client_upload_bytes == ref.client_upload_bytes
    assert port.summary()["transport_bytes"] == \
        ref.summary()["transport_bytes"]


def test_fused_slice_losses_and_parameters_match(fused_slice):
    ref, port = fused_slice
    np.testing.assert_allclose([r.mean_loss for r in port.history],
                               [r.mean_loss for r in ref.history], rtol=1e-3)
    want = bridge.flatten_tree(jax.device_get(ref.params))
    for name, leaf in port.params.items():
        np.testing.assert_allclose(leaf.numpy(), want[name], rtol=1e-3,
                                   atol=1e-3, err_msg=name)


# ------------------------------------------- error feedback, quarantine
@functools.lru_cache()
def _linear_problem(num_clients, dim=32, classes=10, num_batches=2, batch=4):
    """The softmax-regression problem of tests/test_wirepath.py, from
    numpy: its 32 x 10 weight clears min_leaf_size, so the wires engage."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((num_clients, num_batches, batch, dim)
                            ).astype(np.float32)
    y = rng.integers(0, classes, (num_clients, num_batches, batch)
                     ).astype(np.int32)
    w = (0.1 * rng.standard_normal((dim, classes))).astype(np.float32)
    return x, y, {"b": np.zeros((classes,), np.float32), "w": w}


def _jax_loss(params, data):
    xb, yb = data
    logp = jax.nn.log_softmax(xb @ params["w"] + params["b"])
    return -jnp.mean(jnp.take_along_axis(logp, yb[:, None], 1))


def _torch_loss(params, data):
    xb, yb = data
    logp = torch.log_softmax(xb @ params["w"] + params["b"], -1)
    return -logp.gather(1, yb[:, None].long()).mean()


def _port_run(name, x, y, p0, rounds=3, seed=5, **overrides):
    server = FederatedServer.from_strategy(
        tst.get(name, error_feedback=True, **overrides), _torch_loss,
        {k: _t(v) for k, v in p0.items()}, x.shape[0], device="cpu",
        scores=functools.partial(reference_scores, seed=seed))
    server.run((x, y), np.ones((x.shape[0],), np.float32), rounds)
    return server


def _jax_run(name, x, y, p0, rounds=3, seed=5, **overrides):
    server = JaxServer.from_strategy(
        jst.get(name, error_feedback=True, **overrides), _jax_loss,
        jax.tree.map(jnp.asarray, p0), x.shape[0], seed=seed,
        engine="cohort")
    server.run((jnp.asarray(x), jnp.asarray(y)),
               np.ones((x.shape[0],), np.float32), rounds)
    return server


RUN_PAIRS = [("fig5", "fig5-fused"), ("fig5-int8", "fig5-fused-int8"),
             ("fig5", "fig5-bitmap")]


@pytest.mark.parametrize("codec_preset,other_preset", RUN_PAIRS)
def test_error_feedback_run_pairs_are_bitwise_equal(codec_preset,
                                                    other_preset):
    """The port's fused/bitmap runs equal its codec runs bit for bit,
    parameters AND residuals, and the residuals are live."""
    x, y, p0 = _linear_problem(8)
    a, b = (_port_run(n, x, y, p0) for n in (codec_preset, other_preset))
    ra, rb = a.store.residuals_dense(), b.store.residuals_dense()
    for k in p0:
        assert torch.equal(a.params[k].view(torch.int32),
                           b.params[k].view(torch.int32)), k
        assert torch.equal(ra[k].view(torch.int32), rb[k].view(torch.int32))
    assert bool(rb["w"].abs().sum() > 0)


def test_error_feedback_fused_int8_run_matches_reference():
    """fig5-fused-int8 with kernel masking and error feedback: m_t and
    bytes exact, parameters and residuals within the slice tolerance."""
    x, y, p0 = _linear_problem(8)
    kernel = dict(masking=None)
    runs = []
    for mod, run in ((jst, _jax_run), (tst, _port_run)):
        kernel["masking"] = mod.MaskPolicy.selective(0.5, backend="kernel")
        runs.append(run("fig5-fused-int8", x, y, p0, rounds=4, **kernel))
    ref, port = runs
    assert [r.num_sampled for r in port.history] == \
        [r.num_sampled for r in ref.history]
    assert port.summary()["transport_bytes"] == \
        ref.summary()["transport_bytes"]
    res = port.store.residuals_dense()
    for k in p0:
        np.testing.assert_allclose(port.params[k].numpy(),
                                   np.asarray(ref.params[k]), rtol=1e-3,
                                   atol=1e-4, err_msg=k)
        np.testing.assert_allclose(res[k].numpy(),
                                   np.asarray(ref._residuals[k]), rtol=1e-3,
                                   atol=1e-4, err_msg=k)
    assert bool(res["w"].abs().sum() > 0)


def test_nan_client_is_quarantined_as_in_the_reference():
    """One client's NaN data: its upload decodes non-finite, so it is
    quarantined in every round it takes part in, as in the reference;
    its residual row stays as it was and the model stays finite."""
    x, y, p0 = _linear_problem(8)
    x = x.copy()
    x[3] = np.nan
    kw = {}
    runs = []
    for mod, run in ((jst, _jax_run), (tst, _port_run)):
        kw["masking"] = mod.MaskPolicy.selective(0.5, backend="kernel")
        runs.append(run("fig5-fused-int8", x, y, p0, rounds=3, **kw))
    ref, port = runs
    quarantined = [r.quarantined for r in port.history]
    assert quarantined == [r.quarantined for r in ref.history]
    assert sum(quarantined) > 0
    assert all(bool(torch.isfinite(v).all()) for v in port.params.values())
    res = port.store.residuals_dense()
    assert all(bool(torch.isfinite(v).all()) for v in res.values())
    assert bool((res["w"][3] == 0).all())


# --------------------------------------------------------------- repairs
@pytest.mark.parametrize("name", tst.names())
def test_replacing_the_mask_policy_keeps_the_codec_axes(name):
    """get(name, masking=...) names the same codec in both packages: the
    int8, backend and wire axes of the preset's codec survive."""
    got = tst.get(name, masking=tst.MaskPolicy.selective(0.5,
                                                         backend="kernel"))
    want = jst.get(name, masking=jst.MaskPolicy.selective(0.5,
                                                          backend="kernel"))
    assert got.codec.name == want.codec.name
    assert tst.get(name).codec.name == jst.get(name).codec.name
