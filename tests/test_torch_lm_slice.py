"""The paper's other two experiments through the round: VGG (Figs. 6–7) and
the GRU language model (Figs. 8–9), each through the reference's
``FederatedServer.from_strategy`` and the port's, side by side on the CPU
on the cohort engine at M = 8 for 6 rounds.

The port draws its participant scores from the caller here: the
reference's own ``jax.random`` draws, recomputed from its per-round key
chain.  Under random masking (Alg. 2, the baseline of Figs. 6, 7 and 9) the
reference's per-entry mask draws are injected the same way through
``mask_scores``: ``key, sub = split(key)``; ``_, mask_key = split(sub)``;
client i's key is ``split(mask_key, M)[i]``, leaf j's
``split(client_key, L)[j]``, and the draw ``uniform(leaf_key, (size,))``.

Tolerance: ``num_sampled``, bucket sizes and wire bytes exact; losses
rtol 1e-3; final parameters within atol 1e-3 entrywise and 1e-3 relative
L2 over the model, the LeNet slice test's tolerance and for its reason
(XLA and PyTorch reduce in different orders, and after a few rounds a
delta entry lying on a candidate threshold can flip its mask).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masking as jmask
from repro.core import strategy as jst
from repro.core.server import FederatedServer as JaxServer
from repro.data.partition import iid_partition_images
from repro.data.synthetic import class_gaussian_images
from repro.models import paper_models as jpm
from repro_torch import bridge
from repro_torch.core import masking as tmask
from repro_torch.core import strategy as tst
from repro_torch.core.federated import cohort_select
from repro_torch.core.server import FederatedServer
from repro_torch.data.partition import partition_text
from repro_torch.data.synthetic import markov_text
from repro_torch.models import paper_models as tpm

M, ROUNDS = 8, 6
SAMPLED = [7, 7, 6, 5, 5, 4]


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


def _round_sub(t: int, seed: int = 0):
    key = jax.random.PRNGKey(seed)
    for _ in range(t):
        key, sub = jax.random.split(key)
    return sub


def reference_scores(t: int, num_clients: int) -> np.ndarray:
    """Round t's uniform participant scores as the reference draws them."""
    sample_key, _ = jax.random.split(_round_sub(t))
    return np.asarray(jax.random.uniform(sample_key, (num_clients,)))


def _leaf_keys(t: int, num_clients: int, num_leaves: int):
    """(num_clients, num_leaves) per-leaf random-mask keys of round t."""
    _, mask_key = jax.random.split(_round_sub(t))
    return [jax.random.split(ck, num_leaves)
            for ck in jax.random.split(mask_key, num_clients)]


def reference_mask_scores(params_np, min_leaf_size: int = 256):
    """``mask_scores(t, M)`` giving the reference's draws for every
    maskable leaf."""
    leaves = bridge.flatten_tree(params_np)

    def draw(t, num_clients):
        keys = _leaf_keys(t, num_clients, len(leaves))
        return {name: np.stack([np.asarray(jax.random.uniform(
                    keys[i][j], (leaf.size,))) for i in range(num_clients)])
                for j, (name, leaf) in enumerate(leaves.items())
                if leaf.size >= min_leaf_size}
    return draw


def _vgg_setup():
    ds = class_gaussian_images(num_train=512, image_size=16, channels=3,
                               noise=0.6, seed=0)
    xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, M, 16, seed=0)
    p0 = jax.device_get(jpm.init_vgg(jax.random.PRNGKey(0), 16, 3,
                                     widths=(16, 32, 64)))
    return ((xs, ys), ns, p0, jpm.classifier_loss(jpm.vgg_forward),
            tpm.classifier_loss(tpm.vgg_forward))


def _gru_setup():
    ds = markov_text(num_train=M * 400, vocab_size=256, seed=0)
    xs, ys, ns = partition_text(ds.train_tokens, M, 8, 24, seed=0)
    p0 = jax.device_get(jpm.init_gru_lm(jax.random.PRNGKey(0), 256, 64, 64))
    return (xs, ys), ns, p0, jpm.gru_lm_loss, tpm.gru_lm_loss


def _policies(mode):
    if mode == "random":
        return jst.MaskPolicy.random(0.5), tst.MaskPolicy.random(0.5)
    return (jst.MaskPolicy.selective(0.5, backend="kernel"),
            tst.MaskPolicy.selective(0.5, backend="kernel"))


def _side_by_side(setup, mode, record=None):
    batches, ns, p0, jloss, tloss = setup()
    jpol, tpol = _policies(mode)
    ref = JaxServer.from_strategy(jst.get("fig5", masking=jpol), jloss,
                                  jax.tree.map(jnp.asarray, p0), M, seed=0)
    ref.run(tuple(jnp.asarray(b) for b in batches), ns, ROUNDS)
    port = FederatedServer.from_strategy(
        tst.get("fig5", masking=tpol), tloss,
        bridge.params_from_numpy(p0, device="cpu"), M, device="cpu",
        scores=reference_scores,
        mask_scores=reference_mask_scores(p0) if mode == "random" else None)
    with pytest.MonkeyPatch.context() as mp:
        if record is not None:
            keep_fn = tmask.random_keep
            mp.setattr(tmask, "random_keep", lambda s, g: record.append(
                keep_fn(s, g)) or record[-1])
        port.run(batches, ns, ROUNDS)
    return ref, port, p0


@pytest.fixture(scope="module")
def vgg_runs():
    return _side_by_side(_vgg_setup, "kernel")


@pytest.fixture(scope="module")
def gru_runs():
    return _side_by_side(_gru_setup, "kernel")


@pytest.fixture(scope="module")
def gru_random_runs():
    keeps = []
    ref, port, p0 = _side_by_side(_gru_setup, "random", record=keeps)
    return ref, port, p0, keeps


RUNS = ["vgg_runs", "gru_runs", "gru_random_runs"]
UPLOAD_BYTES = {"vgg_runs": 365_276, "gru_runs": 181_032,
                "gru_random_runs": 181_032}


@pytest.mark.parametrize("runs", RUNS)
def test_participants_buckets_and_bytes_exact(runs, request):
    ref, port = request.getfixturevalue(runs)[:2]
    sampled = [r.num_sampled for r in port.history]
    assert sampled == SAMPLED == [r.num_sampled for r in ref.history]
    assert [r.cohort_size for r in port.history] == [8] * 5 + [4]
    assert port.client_upload_bytes == UPLOAD_BYTES[runs] == \
        ref.client_upload_bytes
    assert port.summary()["transport_bytes"] == \
        ref.summary()["transport_bytes"] == sum(SAMPLED) * UPLOAD_BYTES[runs]
    assert port.summary()["codec"] == ref.summary()["codec"]


@pytest.mark.parametrize("runs", RUNS)
def test_losses_and_parameters_match(runs, request):
    ref, port = request.getfixturevalue(runs)[:2]
    np.testing.assert_allclose([r.mean_loss for r in port.history],
                               [r.mean_loss for r in ref.history], rtol=1e-3)
    want = bridge.flatten_tree(jax.device_get(ref.params))
    assert list(port.params) == list(want)
    diff_sq = norm_sq = 0.0
    for name, leaf in port.params.items():
        got = leaf.numpy()
        np.testing.assert_allclose(got, want[name], rtol=1e-3, atol=1e-3,
                                   err_msg=name)
        diff_sq += float(np.sum((got - want[name]) ** 2))
        norm_sq += float(np.sum(want[name] ** 2))
    assert (diff_sq / norm_sq) ** 0.5 < 1e-3


@pytest.mark.parametrize("runs", RUNS)
def test_learns_and_stays_finite(runs, request):
    port = request.getfixturevalue(runs)[1]
    losses = [r.mean_loss for r in port.history]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(bool(torch.isfinite(v).all()) for v in port.params.values())


def test_random_kept_sets_are_the_reference_draws(gru_random_runs):
    """Every upload of every round keeps exactly the index set the
    reference's ``random_mask`` keeps for that client, leaf and round."""
    _, port, p0, keeps = gru_random_runs
    leaves = bridge.flatten_tree(p0)
    names = [n for n, leaf in leaves.items() if leaf.size >= 256]
    assert len(keeps) == ROUNDS * len(names)
    for r, rec in enumerate(port.history):
        t = rec.round
        if rec.cohort_size < M:
            ids, _ = cohort_select(torch.tensor(reference_scores(t, M)),
                                   port.schedule, t, M, rec.cohort_size)
            ids = ids.tolist()
        else:
            ids = list(range(M))
        keys = _leaf_keys(t, M, len(leaves))
        for j, name in enumerate(names):
            got = keeps[r * len(names) + j]
            leaf_index = list(leaves).index(name)
            size = leaves[name].size
            assert tuple(got.shape) == (len(ids), size)
            assert (got.sum(1) == round(0.5 * size)).all()
            for row, client in enumerate(ids):
                want = np.asarray(jmask.random_mask(
                    keys[client][leaf_index], jnp.ones(size), 0.5)) != 0
                np.testing.assert_array_equal(got[row].numpy(), want,
                                              err_msg=f"{t} {client} {name}")


def test_oracle_body_equals_cohort_body_under_random_masking():
    """engine="full" masks all M clients with all M rows of the round's
    scores, the cohort engine gathers its members' rows: the same clients
    mask the same entries, so both engines agree."""
    batches, ns, p0, _, tloss = _gru_setup()
    runs = []
    for engine in ("cohort", "full"):
        server = FederatedServer.from_strategy(
            tst.get("fig5", masking=tst.MaskPolicy.random(0.5)), tloss,
            bridge.params_from_numpy(p0, device="cpu"), M, engine=engine,
            device="cpu", scores=reference_scores,
            mask_scores=reference_mask_scores(p0))
        server.run(batches, ns, ROUNDS)
        runs.append(server)
    cohort, full = runs
    assert cohort.history[-1].cohort_size == 4
    assert full.history[-1].cohort_size == 8
    assert [r.num_sampled for r in cohort.history] == \
        [r.num_sampled for r in full.history]
    assert cohort.summary()["transport_bytes"] == \
        full.summary()["transport_bytes"]
    for name, leaf in cohort.params.items():
        np.testing.assert_allclose(leaf.numpy(), full.params[name].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_server_draws_its_own_mask_scores_per_round():
    """Without ``mask_scores`` the server draws fresh (M, *shape) uniforms
    for every maskable leaf each round (``masking.client_mask_scores``),
    and none at all when the policy does not mask at random."""
    params = tpm.init_gru_lm(torch.Generator().manual_seed(0), 64, 16, 16,
                             device="cpu")
    server = FederatedServer.from_strategy(
        tst.get("fig5", masking=tst.MaskPolicy.random(0.5)),
        tpm.gru_lm_loss, params, 4, device="cpu", seed=3)
    a, b = server.round_mask_scores(1), server.round_mask_scores(2)
    assert list(a) == [k for k, v in params.items() if v.numel() >= 256]
    for k in a:
        assert tuple(a[k].shape) == (4,) + tuple(params[k].shape)
        assert not torch.equal(a[k], b[k])
        assert 0.0 <= float(a[k].min()) and float(a[k].max()) < 1.0
    plain = FederatedServer.from_strategy(tst.get("fig5"), tpm.gru_lm_loss,
                                          params, 4, device="cpu")
    assert plain.round_mask_scores(1) is None
