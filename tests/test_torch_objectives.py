"""The port's local objectives (``repro_torch/core/objectives.py``: FedProx
and FedDyn with its per-client drift) against the JAX package, on the CPU:
one client's update, and the ``fig5-prox``, ``fig5-dyn`` and ``noniid-dyn``
server runs.

Server runs take the reference's participant draws.  Exact: participants
(``noniid-dyn``'s importance sampler records its selection every round on
both sides), buckets, ``num_sampled`` and bytes.  Floats: one client's update within
rtol 1e-5 / atol 1e-6 (the same SGD steps, gradients summed in another
order); server runs' losses rtol 1e-3, parameters, drift and norms atol
1e-3 (after a few rounds a delta entry lying on a candidate threshold can
flip its mask, as in ``tests/test_torch_slice.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client as jclient
from repro.core import masking as jmask
from repro.core import strategy as jst
from repro.core.objectives import LocalObjective as JObjective
from repro.core.server import FederatedServer as JaxServer
from repro.data import partition as jpart
from repro.data.synthetic import class_gaussian_images
from repro.models import paper_models as jpm
from repro_torch import bridge
from repro_torch.core import client as tclient
from repro_torch.core import masking as tmask
from repro_torch.core import strategy as tst
from repro_torch.core.objectives import LocalObjective
from repro_torch.core.server import FederatedServer
from repro_torch.models import paper_models as tpm
from test_torch_slice import recording_sampler, reference_scores

M, ROUNDS, BATCH = 8, 6, 16


def _tree(seed: int, params, scale: float):
    gen = torch.Generator().manual_seed(seed)
    return {k: scale * torch.randn(v.shape, generator=gen)
            for k, v in params.items()}


def _j(tree):
    return jax.tree.map(jnp.asarray, bridge.params_to_numpy(tree))


def test_inactive_objectives_return_the_loss_itself():
    fn = object()
    for obj in (LocalObjective.none(), LocalObjective.prox(0.0),
                LocalObjective.dyn(0.0)):
        assert not obj.active and not obj.uses_drift
        assert obj.localize(fn) is fn
        assert obj.localize(fn, {"w": torch.zeros(2)}, None) is fn
        assert obj.update_drift(None, {"w": torch.zeros(2)}) is None
    assert LocalObjective.prox(0.1).active
    assert not LocalObjective.prox(0.1).uses_drift
    assert LocalObjective.dyn(0.1).uses_drift
    with pytest.raises(ValueError, match="drift"):
        LocalObjective.dyn(0.1).localize(fn, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="mu"):
        LocalObjective.prox(-1.0)
    with pytest.raises(ValueError, match="alpha"):
        LocalObjective.dyn(-1.0)
    with pytest.raises(ValueError, match="kind"):
        LocalObjective(kind="bogus")


@pytest.mark.parametrize("kind,strength,masked", [
    ("prox", 0.1, False), ("prox", 1.0, True), ("dyn", 0.1, True),
    ("dyn", 0.5, False)])
def test_one_client_update_and_drift_match(kind, strength, masked):
    """Upload, residual, drift and loss of one client's prox or dyn round
    against the reference's ``client_update``; the drift moves by
    -alpha times the honest pre-mask delta."""
    params = tpm.init_lenet(torch.Generator().manual_seed(1), image_size=12,
                            device="cpu")
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 8, 12, 12, 1), generator=gen)
    y = torch.randint(0, 10, (2, 8), generator=gen)
    drift = _tree(3, params, 1e-2) if kind == "dyn" else None
    residual = _tree(4, params, 1e-3)
    obj = getattr(LocalObjective, kind)(strength)
    mask = dict(gamma=0.3, mode="selective", use_kernel=True) if masked \
        else {}
    cfg = tclient.ClientConfig(learning_rate=0.05, objective=obj,
                               masking=tmask.MaskingConfig(**mask))
    loss = tpm.classifier_loss(tpm.lenet_forward)
    up, new_res, new_drift, mean_loss = tclient.client_update(
        loss, params, (x, y), cfg, residual=residual, drift=drift)

    jcfg = jclient.ClientConfig(
        learning_rate=0.05, objective=getattr(JObjective, kind)(strength),
        masking=jmask.MaskingConfig(**mask))
    want = jclient.client_update(
        jpm.classifier_loss(jpm.lenet_forward), _j(params),
        (jnp.asarray(x.numpy()), jnp.asarray(y.numpy().astype(np.int32))),
        jax.random.PRNGKey(0), jcfg, residual=_j(residual),
        drift=None if drift is None else _j(drift))
    assert float(mean_loss) == pytest.approx(float(want[3]), rel=1e-5)
    pairs = [(up, want[0]), (new_res, want[1])]
    if kind == "dyn":
        pairs.append((new_drift, want[2]))
        local, _ = tclient.local_sgd(obj.localize(loss, params, drift),
                                     params, (x, y), cfg)
        for k, h in drift.items():
            torch.testing.assert_close(
                new_drift[k], h - strength * (local[k] - params[k]),
                rtol=0, atol=0)
    else:
        assert new_drift is None and want[2] is None
    for got, ref in pairs:
        for name, leaf in bridge.flatten_tree(jax.device_get(ref)).items():
            np.testing.assert_allclose(got[name].numpy(), np.asarray(leaf),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


# -------------------------------------------------------------- server runs
PRESETS = ("fig5-prox", "fig5-dyn", "noniid-dyn")


@pytest.fixture(scope="module", params=PRESETS)
def runs(request):
    """The reference's server and the port's on one preset, the port fed
    the reference's participant draws.  ``noniid-dyn`` runs as the card
    runs it: kernel masking on a Dirichlet(0.5) partition; the other two
    as the presets define them."""
    name = request.param
    ds = class_gaussian_images(num_train=512, image_size=12, seed=0)
    split = (jpart.dirichlet_partition_images if name == "noniid-dyn"
             else jpart.iid_partition_images)
    xs, ys, ns = split(ds.train_x, ds.train_y, M, BATCH, seed=0)
    p0 = jpm.init_lenet(jax.random.PRNGKey(0), image_size=12)
    js, ts = jst.get(name), tst.get(name)
    if name == "noniid-dyn":
        js = js.with_masking(jst.MaskPolicy.selective(0.5, backend="kernel"))
        ts = ts.with_masking(tst.MaskPolicy.selective(0.5, backend="kernel"))
    selected = {"ref": [], "port": []}
    if js.sampler.adaptive:
        js = js.replace(sampler=recording_sampler(js.sampler,
                                                  selected["ref"], True))
        ts = ts.replace(sampler=recording_sampler(ts.sampler,
                                                  selected["port"], False))
    ref = JaxServer.from_strategy(
        js, jpm.classifier_loss(jpm.lenet_forward), p0, M, seed=0)
    ref.run((jnp.asarray(xs), jnp.asarray(ys)), ns, ROUNDS)
    port = FederatedServer.from_strategy(
        ts, tpm.classifier_loss(tpm.lenet_forward),
        bridge.params_from_numpy(jax.device_get(p0), device="cpu"), M,
        device="cpu", scores=reference_scores)
    port.run((xs, ys), ns, ROUNDS)
    return name, ref, port, selected


def test_participants_buckets_and_bytes_exact(runs):
    name, ref, port, selected = runs
    for field in ("num_sampled", "cohort_size", "transport_bytes"):
        assert [getattr(r, field) for r in port.history] == \
            [getattr(r, field) for r in ref.history], field
    assert port.summary()["transport_bytes"] == \
        ref.summary()["transport_bytes"]
    assert port.summary()["codec"] == ref.summary()["codec"]
    assert len(selected["port"]) == len(selected["ref"]) == (
        ROUNDS if name == "noniid-dyn" else 0)
    for got, want in zip(selected["port"], selected["ref"]):
        np.testing.assert_array_equal(got, want)


def test_losses_parameters_drift_and_norms_match(runs):
    name, ref, port, _ = runs
    np.testing.assert_allclose([r.mean_loss for r in port.history],
                               [r.mean_loss for r in ref.history], rtol=1e-3)
    want = bridge.flatten_tree(jax.device_get(ref.params))
    for k, leaf in port.params.items():
        np.testing.assert_allclose(leaf.numpy(), want[k], rtol=0, atol=1e-3,
                                   err_msg=k)
    if name == "fig5-prox":
        assert port.store.trees == ("residuals",)
        return
    want_drift = bridge.flatten_tree(jax.device_get(
        ref.store.dense_view("drift")))
    drift = port.store.dense_view("drift")
    assert port.store.trees == ("residuals", "drift")
    for k, leaf in drift.items():
        np.testing.assert_allclose(leaf.numpy(), want_drift[k], rtol=0,
                                   atol=1e-3, err_msg=k)
    assert float(sum(v.abs().sum() for v in drift.values())) > 0
    if name == "noniid-dyn":
        np.testing.assert_allclose(port.store.norms.numpy(),
                                   np.asarray(ref.store.norms), rtol=0,
                                   atol=1e-3)
