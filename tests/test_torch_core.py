"""The port's core modules (sampling, masking oracles, LeNet, codecs,
aggregation, data, strategies) against the JAX package on the same
numpy-made inputs, on the CPU.

Integer and discrete outputs (m_t, participants, buckets, keep masks, COO
indices, wire bytes, data arrays) must match exactly.  Float outputs state
their tolerance where they are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from repro.core import codecs as jcodecs
from repro.core import compression as jcomp
from repro.core import federated as jfed
from repro.core import masking as jmask
from repro.core import sampling as jsamp
from repro.core import strategy as jst
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro.models import paper_models as jpm
from repro_torch import bridge
from repro_torch.core import codecs as tcodecs
from repro_torch.core import compression as tcomp
from repro_torch.core import federated as tfed
from repro_torch.core import masking as tmask
from repro_torch.core import sampling as tsamp
from repro_torch.core import strategy as tst
from repro_torch.core.objectives import LocalObjective
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.models import paper_models as tpm


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
    return np.asarray(a, np.float32).view(np.int32)


def _bits_nosign0(a) -> np.ndarray:
    """Bit patterns with -0.0 folded into +0.0.  The reference's eager
    (unjitted) masks compute x * float(keep) and so keep -0.0, while its
    jitted rounds — and the port — give +0.0."""
    return (np.asarray(a, np.float32) + np.float32(0.0)).view(np.int32)


# ---------------------------------------------------------------- sampling
SCHEDULES = {
    "fig3": (jst.get("fig3").sampling, tst.get("fig3").sampling),
    "fig5": (jst.get("fig5").sampling, tst.get("fig5").sampling),
    "fig4": (jst.get("fig4").sampling, tst.get("fig4").sampling),
}


@pytest.mark.parametrize("preset", ["fig3", "fig5", "fig4"])
@pytest.mark.parametrize("M", [8, 32, 100])
def test_m_t_exact(preset, M):
    js, ts = SCHEDULES[preset]
    for t in range(0, 201):
        assert ts.num_clients(t, M) == int(js.num_clients(np.float32(t), M)), t
        assert ts.num_clients_host(t, M) == js.num_clients_host(t, M), t


@pytest.mark.parametrize("M", [8, 32, 100])
def test_bucket_ladder_and_round_buckets(M):
    js, ts = SCHEDULES["fig5"]
    assert ts.bucket_ladder(M) == js.bucket_ladder(M)
    assert ts.round_buckets(40, M) == js.round_buckets(40, M)
    assert ts.round_buckets(5, M, start=17) == js.round_buckets(5, M, start=17)
    for m in range(1, M + 1):
        assert ts.bucket_for(m, M) == js.bucket_for(m, M)


@pytest.mark.parametrize("M", [8, 32, 100])
def test_participants_exact_for_the_same_scores(M):
    js, ts = SCHEDULES["fig5"]
    key = jax.random.PRNGKey(M)
    for t in (1, 3, 7, 15, 30):
        key, sub = jax.random.split(key)
        scores = np.asarray(jax.random.uniform(sub, (M,)))
        want = np.asarray(jsamp.participation_mask(sub, js, t, M))
        got = tsamp.participation_mask(_t(scores), ts, t, M)
        np.testing.assert_array_equal(got.numpy(), want)
        bucket = ts.bucket_for(ts.num_clients_host(t, M), M)
        ids, valid = jfed.cohort_select(sub, js, t, M, bucket)
        got_ids, got_valid = tfed.cohort_select(_t(scores), ts, t, M, bucket)
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ids))
        np.testing.assert_array_equal(got_valid.numpy(), np.asarray(valid))
        part, w = jsamp.UniformSampler().select(sub, js, t, M,
                                                jnp.ones((M,)) * 3.0)
        got_part, got_w = tsamp.UniformSampler().select(
            _t(scores), ts, t, M, torch.full((M,), 3.0))
        np.testing.assert_array_equal(got_part.numpy(), np.asarray(part))
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(w))


def test_transport_cost_matches():
    js, ts = SCHEDULES["fig5"]
    for rounds in (1, 10, 50):
        assert tsamp.transport_cost(ts, 0.5, rounds) == pytest.approx(
            jsamp.transport_cost(js, 0.5, rounds), rel=1e-6)


# ----------------------------------------------------------------- masking
def _masking_input(seed: int, n: int = 3000):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    x[::37] = x[1::37][: x[::37].size]  # exact ties
    x[::101] = 0.0
    return x


@pytest.mark.parametrize("seed,gamma", [(0, 0.1), (1, 0.5), (2, 0.33)])
def test_selective_mask_exact_matches(seed, gamma):
    x = _masking_input(seed)
    want = np.asarray(jmask.selective_mask_exact(jnp.asarray(x), gamma))
    got = tmask.selective_mask_exact(_t(x), gamma)
    np.testing.assert_array_equal(_bits_nosign0(got.numpy()),
                                  _bits_nosign0(want))


@pytest.mark.parametrize("seed,gamma", [(0, 0.1), (1, 0.5), (2, 0.33)])
def test_threshold_bisection_matches(seed, gamma):
    """24 fp32 halvings: the same compares and the same tau, bit for bit."""
    x = _masking_input(seed)
    k = max(1, round(gamma * x.size))
    want = np.asarray(jmask.threshold_for_topk(jnp.abs(jnp.asarray(x)),
                                               jnp.asarray(k)))
    got = tmask.threshold_for_topk(_t(x).abs(), k)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    want = np.asarray(jmask.selective_mask_threshold(jnp.asarray(x), gamma))
    got = tmask.selective_mask_threshold(_t(x), gamma)
    np.testing.assert_array_equal(_bits_nosign0(got.numpy()),
                                  _bits_nosign0(want))


def test_kernel_backed_single_tensor_masking_matches():
    x = _masking_input(3, n=5000).reshape(50, 100)
    want = np.asarray(jmask.selective_mask_threshold(
        jnp.asarray(x), 0.2, use_kernel=True))
    got = tmask.selective_mask_threshold(_t(x), 0.2, use_kernel=True)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("mode", ["selective", "random"])
def test_mask_pytree_matches(mode):
    rng = np.random.default_rng(9)
    tree = {"a": {"w": (rng.standard_normal((40, 30)) * 1e-2
                        ).astype(np.float32)},
            "b": (rng.standard_normal(10)).astype(np.float32)}
    cfg = jmask.MaskingConfig(gamma=0.25, mode=mode)
    key = jax.random.PRNGKey(4)
    want = bridge.flatten_tree(jax.device_get(
        jmask.mask_pytree(key, jax.tree.map(jnp.asarray, tree), cfg)))
    scores = None
    if mode == "random":
        # mask_pytree splits the key per leaf in tree order; random_mask
        # draws one uniform per entry from the leaf's key.
        keys = jax.random.split(key, 2)
        scores = {"a.w": _t(np.asarray(jax.random.uniform(keys[0], (1200,)))),
                  "b": torch.zeros(10)}
    got = tmask.mask_pytree({k: _t(v) for k, v in
                             bridge.flatten_tree(tree).items()},
                            tmask.MaskingConfig(gamma=0.25, mode=mode),
                            scores)
    for name in want:
        np.testing.assert_array_equal(_bits_nosign0(got[name].numpy()),
                                      _bits_nosign0(want[name]), err_msg=name)


def test_random_masking_needs_scores():
    with pytest.raises(ValueError):
        tmask.mask_pytree({"w": torch.ones(300)},
                          tmask.MaskingConfig(gamma=0.5, mode="random"))


# ------------------------------------------------------------------- LeNet
@pytest.mark.parametrize("image_size", [28, 12])
def test_lenet_logits_loss_and_grads_match(image_size):
    """Tolerance rtol 1e-5 / atol 1e-6: the same fp32 math, summed in
    different orders by XLA and PyTorch."""
    p = jpm.init_lenet(jax.random.PRNGKey(1), image_size=image_size)
    params = bridge.params_from_numpy(jax.device_get(p), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, image_size, image_size, 1)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    want = np.asarray(jpm.lenet_forward(p, jnp.asarray(x)))
    got = tpm.lenet_forward(params, _t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tpm.LeNet(params)(_t(x)).detach().numpy(),
                               want, rtol=1e-5, atol=1e-6)
    jloss = jpm.classifier_loss(jpm.lenet_forward)
    tloss = tpm.classifier_loss(tpm.lenet_forward)
    want_l, want_g = jax.value_and_grad(jloss)(p, (jnp.asarray(x),
                                                   jnp.asarray(y)))
    got_l = tloss(params, (_t(x), _t(y)))
    assert float(got_l) == pytest.approx(float(want_l), rel=1e-5)
    got_g = grad(tloss)(params, (_t(x), _t(y)))
    for name, g in bridge.flatten_tree(jax.device_get(want_g)).items():
        np.testing.assert_allclose(got_g[name].numpy(), g, rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    acc = tpm.classifier_accuracy(tpm.lenet_forward)(params, (_t(x), _t(y)))
    want_acc = jpm.classifier_accuracy(jpm.lenet_forward)(
        p, (jnp.asarray(x), jnp.asarray(y)))
    assert float(acc) == pytest.approx(float(want_acc))


def test_lenet_names_shapes_and_order_match():
    p = jpm.init_lenet(jax.random.PRNGKey(0))
    leaves, _ = jax.tree_util.tree_flatten_with_path(p)
    want = [(".".join(k.key for k in path), tuple(v.shape))
            for path, v in leaves]
    got = tpm.init_lenet(torch.Generator().manual_seed(0), device="cpu")
    assert [(k, tuple(v.shape)) for k, v in got.items()] == want
    assert sum(v.numel() for v in got.values()) == 107_786
    assert list(tpm.LeNet(got).params()) == [k for k, _ in want]


def test_bridge_round_trip():
    p = jax.device_get(jpm.init_lenet(jax.random.PRNGKey(2), image_size=12))
    back = bridge.params_to_numpy(bridge.params_from_numpy(p, device="cpu"))
    for name, leaf in bridge.flatten_tree(p).items():
        np.testing.assert_array_equal(bridge.flatten_tree(back)[name], leaf)


# ------------------------------------------------------------------ codecs
def _masked_leaf(seed: int, shape=(120, 84), gamma=0.5):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
    return np.asarray(jax.jit(jmask.selective_mask_exact,
                              static_argnums=1)(jnp.asarray(x), gamma))


@pytest.mark.parametrize("seed", [0, 1])
def test_coo_encode_matches_bitwise(seed):
    m = _masked_leaf(seed)
    k = round(0.5 * m.size)
    want = jcomp.encode_sparse(jnp.asarray(m), k)
    got = tcomp.encode_sparse(_t(m), k)
    assert got["indices"].dtype == torch.int32
    np.testing.assert_array_equal(got["indices"].numpy(),
                                  np.asarray(want["indices"]))
    np.testing.assert_array_equal(_bits(got["values"].numpy()),
                                  _bits(want["values"]))
    np.testing.assert_array_equal(got["shape"].numpy(), want["shape"])
    dense = tcomp.decode_sparse(got)
    np.testing.assert_array_equal(
        _bits_nosign0(dense.numpy()),
        _bits_nosign0(np.asarray(jcomp.decode_sparse(want))))
    np.testing.assert_array_equal(_bits_nosign0(dense.numpy()),
                                  _bits_nosign0(m))


@pytest.mark.parametrize("image_size,want_bytes", [(28, 431_184),
                                                    (12, 123_984)])
def test_fig5_wire_bytes_exact(image_size, want_bytes):
    p = jpm.init_lenet(jax.random.PRNGKey(0), image_size=image_size)
    jcodec = jst.get("fig5").codec
    tcodec = tst.get("fig5").codec
    params = bridge.params_from_numpy(jax.device_get(p), device="cpu")
    assert jcodec.wire_bytes(p) == want_bytes
    assert tcodec.wire_bytes(params) == want_bytes
    assert tcodecs.tree_wire_nbytes(tcodec.encode(params)) == want_bytes
    assert tcodec.name == jcodec.name


def test_sparse_codec_roundtrip_matches_reference():
    rng = np.random.default_rng(5)
    tree = {"big": {"w": _masked_leaf(2, (40, 30), 0.5)},
            "small": (rng.standard_normal(7)).astype(np.float32)}
    jc = jcodecs.SparseCodec(gamma=0.5)
    tc = tcodecs.SparseCodec(gamma=0.5)
    want = bridge.flatten_tree(jax.device_get(
        jc.roundtrip(jax.tree.map(jnp.asarray, tree))))
    flat = {k: _t(v) for k, v in bridge.flatten_tree(tree).items()}
    got = tc.roundtrip(flat)
    stacked = tc.roundtrip_stacked({k: torch.stack([v, v]) for k, v in
                                    flat.items()})
    for name in want:
        np.testing.assert_array_equal(_bits_nosign0(got[name].numpy()),
                                      _bits_nosign0(want[name]))
        for row in stacked[name]:
            np.testing.assert_array_equal(_bits_nosign0(row.numpy()),
                                          _bits_nosign0(want[name]))
    assert tcodecs.tree_wire_nbytes(tc.encode(flat)) == \
        jcodecs.tree_wire_nbytes(jc.encode(jax.tree.map(jnp.asarray, tree)))


@pytest.mark.parametrize("bad", ["missing", "float_idx", "lengths",
                                 "range", "nonfinite", "negative_shape"])
def test_decode_sparse_rejects_malformed_payloads(bad):
    good = tcomp.encode_sparse(_t(_masked_leaf(3, (20, 20))), 200)
    payload = dict(good)
    if bad == "missing":
        del payload["values"]
    elif bad == "float_idx":
        payload["indices"] = payload["indices"].float()
    elif bad == "lengths":
        payload["values"] = payload["values"][:-1]
    elif bad == "range":
        payload["indices"] = payload["indices"].clone()
        payload["indices"][0] = 400
    elif bad == "nonfinite":
        payload["values"] = payload["values"].clone()
        payload["values"][0] = float("nan")
    elif bad == "negative_shape":
        payload["shape"] = torch.tensor([-20, 20], dtype=torch.int32)
    with pytest.raises(ValueError):
        tcomp.decode_sparse(payload)
    jpayload = {k: np.asarray(v) for k, v in payload.items()}
    with pytest.raises(ValueError):
        jcomp.decode_sparse(jpayload)


def test_identity_codec_rejects_nonfinite_on_decode():
    with pytest.raises(ValueError):
        tcodecs.IdentityCodec().decode({"w": torch.tensor([1.0, float("inf")])})


def test_pytree_num_params_matches():
    p = jpm.init_lenet(jax.random.PRNGKey(0))
    assert tcomp.pytree_num_params(bridge.params_from_numpy(
        jax.device_get(p), device="cpu")) == jcomp.pytree_num_params(p)


# ------------------------------------------------------------- aggregation
@pytest.mark.parametrize("semantics", ["delta", "zero"])
def test_fedavg_matches(semantics):
    """rtol 1e-6: a weighted sum over 5 clients, summed in another order."""
    rng = np.random.default_rng(11)
    g = {"w": rng.standard_normal((30, 20)).astype(np.float32)}
    u = {"w": rng.standard_normal((5, 30, 20)).astype(np.float32)}
    w = np.asarray([1.0, 0.0, 2.0, 3.0, 0.0], np.float32)
    want = jfed.fedavg_aggregate(jax.tree.map(jnp.asarray, g),
                                 jax.tree.map(jnp.asarray, u),
                                 jnp.asarray(w), semantics)
    got = tfed.fedavg_aggregate({"w": _t(g["w"])}, {"w": _t(u["w"])}, _t(w),
                                semantics)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-6, atol=1e-7)


def test_quarantine_rows_match():
    u = {"w": torch.tensor([[1.0, 2.0], [float("nan"), 1.0], [3.0, 4.0]])}
    finite = tfed._finite_rows(u)
    assert finite.tolist() == [1.0, 0.0, 1.0]
    zeroed = tfed._zero_rows(u, finite)
    assert bool(torch.isfinite(zeroed["w"]).all())
    want = jfed._finite_rows({"w": jnp.asarray(u["w"].numpy())})
    np.testing.assert_array_equal(finite.numpy(), np.asarray(want))


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("kw", [dict(num_train=512, image_size=12, seed=0),
                                dict(num_train=300, image_size=28, seed=3,
                                     channels=3)])
def test_data_byte_identical(kw):
    want = jsyn.class_gaussian_images(**kw)
    got = tsyn.class_gaussian_images(**kw)
    for field in ("train_x", "train_y", "test_x", "test_y"):
        a, b = getattr(want, field), getattr(got, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    want_p = jpart.iid_partition_images(want.train_x, want.train_y, 4, 16,
                                        seed=2)
    got_p = tpart.iid_partition_images(got.train_x, got.train_y, 4, 16,
                                       seed=2)
    for a, b in zip(want_p, got_p):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind,kw", [
    ("noniid", dict(shards_per_client=2, seed=0)),
    ("noniid", dict(shards_per_client=3, seed=5)),
    ("dirichlet", dict(alpha=0.5, seed=0)),
    ("dirichlet", dict(alpha=0.1, seed=7)),
    ("dirichlet", dict(alpha=100.0, seed=1)),
])
def test_noniid_partitions_byte_identical(kind, kw):
    """The label-shard and Dirichlet partitioners draw what the reference
    draws, in the same order: every array byte for byte."""
    ds = tsyn.class_gaussian_images(num_train=600, image_size=12, seed=2)
    name = f"{kind}_partition_images"
    want = getattr(jpart, name)(ds.train_x, ds.train_y, 6, 16, **kw)
    got = getattr(tpart, name)(ds.train_x, ds.train_y, 6, 16, **kw)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_dirichlet_partition_rejects_bad_alpha_and_sizes():
    ds = tsyn.class_gaussian_images(num_train=64, image_size=12, seed=0)
    with pytest.raises(ValueError, match="alpha"):
        tpart.dirichlet_partition_images(ds.train_x, ds.train_y, 4, 8,
                                         alpha=0.0)
    with pytest.raises(ValueError, match="one batch"):
        tpart.dirichlet_partition_images(ds.train_x, ds.train_y, 16, 8)


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_pytree_round_trip_matches(seed):
    """Codes and scales exact against the reference; the round trip within
    scale / 2 of the input (rounding half to even)."""
    rng = np.random.default_rng(seed)
    tree = {"a.w": rng.standard_normal((7, 5)).astype(np.float32),
            "b.b": (rng.standard_normal(13) * 1e-3).astype(np.float32),
            "c.z": np.zeros(4, np.float32)}
    want = jcomp.quantize_pytree({k: jnp.asarray(v) for k, v in tree.items()})
    got = tcomp.quantize_pytree({k: _t(v) for k, v in tree.items()})
    back = tcomp.dequantize_pytree(got)
    want_back = jcomp.dequantize_pytree(want)
    for k, v in tree.items():
        np.testing.assert_array_equal(got[k]["q"].numpy(),
                                      np.asarray(want[k]["q"]))
        assert _bits(got[k]["scale"]).tolist() == \
            _bits(want[k]["scale"]).tolist()
        np.testing.assert_array_equal(back[k].numpy(),
                                      np.asarray(want_back[k]))
        assert float(np.abs(back[k].numpy() - v).max()) <= \
            float(got[k]["scale"]) / 2 + 1e-12
    with pytest.raises(ValueError, match="missing"):
        tcomp.dequantize_pytree({"a": {"q": got["a.w"]["q"]}})


def test_dense_store_trees_and_norms_match_the_reference():
    """Gather, commit-masked scatter and dense views by tree name, and the
    norm EMA vector, against the reference's ``DenseStore``: exact."""
    from repro.core.client_store import DenseStore as JStore
    from repro_torch.core.client_store import DenseStore as TStore
    rng = np.random.default_rng(0)
    tmpl = {"a.w": np.zeros((3, 2), np.float32), "b": np.zeros(4, np.float32)}
    want = JStore(6, {k: jnp.asarray(v) for k, v in tmpl.items()},
                  track_norms=True, extra_trees={"drift": tmpl})
    got = TStore(6, {k: _t(v) for k, v in tmpl.items()}, track_norms=True,
                 extra_trees={"drift": {k: _t(v) for k, v in tmpl.items()}})
    assert got.trees == want.trees == ("residuals", "drift")
    np.testing.assert_array_equal(got.norms.numpy(), np.asarray(want.norms))
    ids = np.asarray([4, 1, 3])
    commit = np.asarray([1.0, 0.0, 1.0], np.float32)
    for tree in ("residuals", "drift"):
        rows = {k: rng.standard_normal((3,) + v.shape).astype(np.float32)
                for k, v in tmpl.items()}
        want.scatter(ids, {k: jnp.asarray(v) for k, v in rows.items()},
                     commit, 1, tree=tree)
        got.scatter(ids, {k: _t(v) for k, v in rows.items()}, commit, 1,
                    tree=tree)
        for k in tmpl:
            np.testing.assert_array_equal(got.dense_view(tree)[k].numpy(),
                                          np.asarray(want.dense_view(tree)[k]))
            np.testing.assert_array_equal(
                got.gather([3, 0], tree)[k].numpy(),
                np.asarray(want.gather(np.asarray([3, 0]), tree)[k]))
    got.update_norms([2, 5], [0.5, 3.0])
    want.update_norms(np.asarray([2, 5]), np.asarray([0.5, 3.0]))
    np.testing.assert_array_equal(got.norms.numpy(), np.asarray(want.norms))
    got.set_norms(np.arange(6, dtype=np.float32))
    assert got.norms.tolist() == list(range(6))
    assert got.residuals_dense() is got.dense_view("residuals")
    with pytest.raises(KeyError, match="bogus"):
        got.gather([0], "bogus")
    with pytest.raises(ValueError, match="norm tracking"):
        TStore(2, {"b": torch.zeros(1)}).set_norms([1.0, 1.0])
    with pytest.raises(ValueError, match="shadow"):
        TStore(2, {"b": torch.zeros(1)},
               extra_trees={"residuals": {"b": torch.zeros(1)}})


# -------------------------------------------------------------- strategies
def test_registry_and_codec_derivation():
    assert set(tst.names()) == {"dense-baseline", "fig3", "fig4", "fig5",
                                "fig5-int8", "fig5-fused", "fig5-fused-int8",
                                "fig5-bitmap", "fig3-importance",
                                "hetero-dropout", "fig5-prox", "fig5-dyn",
                                "noniid-dyn", "async-mobile",
                                "async-crossround", "async-flaky",
                                "byzantine-signflip", "robust-median",
                                "robust-krum"}
    st = tst.get("fig5", masking=tst.MaskPolicy.selective(0.5,
                                                          backend="kernel"))
    assert isinstance(st.codec, tcodecs.SparseCodec) and st.codec.gamma == 0.5
    assert st.client_config().masking.use_kernel
    assert isinstance(tst.get("fig3").codec, tcodecs.IdentityCodec)
    assert tst.get("fig4").codec.name == jst.get("fig4").codec.name
    dense = tst.get("fig5", masking=tst.MaskPolicy.none())
    assert isinstance(dense.codec, tcodecs.IdentityCodec)
    assert isinstance(tst.default_codec(tst.MaskPolicy.none()),
                      tcodecs.IdentityCodec)
    with pytest.raises(ValueError):
        tst.build_round(st, None, 8, form="scan", cohort_size=4)
    with pytest.raises(ValueError):
        tst.MaskPolicy(mode="bogus")


def test_objectives_wait_for_their_roadmap_item():
    """Active FedProx/FedDyn are ported, and so are attacks (item 13): an
    active attack model builds the generalized round where it used to
    raise, and a zero-fraction one the plain round.  Zero strengths stay
    the plain loss itself."""
    assert LocalObjective.prox(0.1).active
    assert LocalObjective.dyn(0.1).uses_drift
    fn = object()
    assert LocalObjective.prox(0.0).localize(fn) is fn
    assert LocalObjective.dyn(0.0).localize(fn) is fn
    assert not LocalObjective.none().uses_drift
    from repro_torch.core.attacks import AttackModel
    args = (None, tst.get("fig5").sampling,
            tst.get("fig5").federated_config(4))
    attacked = tfed.make_federated_round(
        *args, attack=AttackModel(kind="nan", fraction=0.5))
    plain = tfed.make_federated_round(*args, attack=AttackModel())
    assert attacked.__name__ == "round_fn" and plain.__name__ == "plain_fn"


# ------------------------------------------------------------------ device
def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    from repro_torch.models import common as tcommon
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpm.init_lenet()
    with pytest.raises(RuntimeError, match="CUDA"):
        tcommon.dense_init(gen, (4, 3), torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcommon.truncated_normal(gen, (4, 3))
    assert tcommon.dense_init(gen, (4, 3), torch.float32,
                              device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.params_from_numpy({"w": np.zeros(3, np.float32)})
    params = tpm.init_lenet(device="cpu")
    from repro_torch.core.server import FederatedServer
    with pytest.raises(RuntimeError, match="CUDA"):
        FederatedServer.from_strategy(
            tst.get("fig5"), tpm.classifier_loss(tpm.lenet_forward), params,
            4)


# ------------------------------------------------------------------ client
@pytest.mark.parametrize("momentum,epochs", [(0.0, 1), (0.9, 2)])
def test_local_sgd_matches(momentum, epochs):
    """rtol 1e-5 / atol 1e-6 on parameters and loss: the same SGD steps,
    gradients summed in another order."""
    from repro.core import client as jclient
    from repro_torch.core import client as tclient
    p = jpm.init_lenet(jax.random.PRNGKey(3), image_size=12)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 8, 12, 12, 1)).astype(np.float32)
    y = rng.integers(0, 10, (3, 8)).astype(np.int32)
    jcfg = jclient.ClientConfig(local_epochs=epochs, learning_rate=0.05,
                                momentum=momentum)
    tcfg = tclient.ClientConfig(local_epochs=epochs, learning_rate=0.05,
                                momentum=momentum)
    want_p, want_l = jclient.local_sgd(jpm.classifier_loss(jpm.lenet_forward),
                                       p, (jnp.asarray(x), jnp.asarray(y)),
                                       jcfg)
    got_p, got_l = tclient.local_sgd(
        tpm.classifier_loss(tpm.lenet_forward),
        bridge.params_from_numpy(jax.device_get(p), device="cpu"),
        (_t(x), _t(y)), tcfg)
    assert float(got_l) == pytest.approx(float(want_l), rel=1e-5)
    for name, leaf in bridge.flatten_tree(jax.device_get(want_p)).items():
        np.testing.assert_allclose(got_p[name].numpy(), leaf, rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("upload", ["delta", "zero"])
def test_client_update_error_feedback_and_uploads(upload):
    """EF conservation holds exactly (delta + residual == upload part +
    new residual); the zero upload ships masked weights with +0.0 where the
    mask dropped.  Against the reference's ``client_update`` on the same
    inputs: the same entries kept, and values within rtol 1e-5 / atol 1e-6
    (the same SGD steps, gradients summed in another order)."""
    from repro.core import client as jclient
    from repro_torch.core import client as tclient
    params = tpm.init_lenet(torch.Generator().manual_seed(1), image_size=12,
                            device="cpu")
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 8, 12, 12, 1), generator=gen)
    y = torch.randint(0, 10, (2, 8), generator=gen)
    residual = {k: 1e-3 * torch.randn(v.shape, generator=gen)
                for k, v in params.items()}
    cfg = tclient.ClientConfig(learning_rate=0.05, upload=upload,
                               masking=tmask.MaskingConfig(
                                   gamma=0.3, mode="selective",
                                   use_kernel=True))
    loss = tpm.classifier_loss(tpm.lenet_forward)
    up, new_res, _, _ = tclient.client_update(loss, params, (x, y), cfg,
                                              residual=residual)
    local, _ = tclient.local_sgd(loss, params, (x, y), cfg)
    for k, p in params.items():
        delta = (local[k] - p) + residual[k]
        if upload == "delta":
            assert torch.equal(up[k] + new_res[k], delta), k
        elif p.numel() >= 256:
            kept = up[k] != 0
            assert torch.equal(up[k][kept], (p + delta)[kept]), k
            assert not bool(torch.signbit(up[k][~kept]).any()), k
        else:
            assert torch.equal(up[k], p + delta), k

    jcfg = jclient.ClientConfig(learning_rate=0.05, upload=upload,
                                masking=jmask.MaskingConfig(
                                    gamma=0.3, mode="selective",
                                    use_kernel=True))
    want_up, want_res, _, _ = jclient.client_update(
        jpm.classifier_loss(jpm.lenet_forward),
        jax.tree.map(jnp.asarray, bridge.params_to_numpy(params)),
        (jnp.asarray(x.numpy()), jnp.asarray(y.numpy().astype(np.int32))),
        jax.random.PRNGKey(0), jcfg,
        residual=jax.tree.map(jnp.asarray, bridge.params_to_numpy(residual)))
    for got, want in ((up, want_up), (new_res, want_res)):
        for name, leaf in bridge.flatten_tree(jax.device_get(want)).items():
            leaf = np.asarray(leaf)
            np.testing.assert_array_equal(got[name].numpy() != 0, leaf != 0,
                                          err_msg=name)
            np.testing.assert_allclose(got[name].numpy(), leaf, rtol=1e-5,
                                       atol=1e-6, err_msg=name)
