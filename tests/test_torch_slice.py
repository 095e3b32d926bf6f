"""The whole slice — the fig5 round with kernel top-k masking, COO wire and
FedAvg on LeNet — through the reference's ``FederatedServer.from_strategy``
and the port's, both on the CPU; plus the port's import hygiene.

The port draws its participant scores from the caller here: the reference's
own ``jax.random`` draws, recomputed from its per-round key chain
(``key, sub = split(key)``; ``sample_key, _ = split(sub)``).
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import strategy as jst
from repro.core.server import FederatedServer as JaxServer
from repro.data.partition import iid_partition_images
from repro.data.synthetic import class_gaussian_images
from repro.models import paper_models as jpm
from repro_torch import bridge
from repro_torch.core import strategy as tst
from repro_torch.core.server import FederatedServer
from repro_torch.models import paper_models as tpm

ROOT = Path(__file__).resolve().parents[1]
M, ROUNDS, BATCH = 8, 6, 16


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


def reference_draws(t: int, num_clients: int, seed: int = 0,
                    hetero: bool = False):
    """Round t's uniform draws as the reference server makes them from
    ``PRNGKey(seed)``: ``(scores, drop_scores)``.  Its round key splits two
    ways (sample, mask) without a hetero fleet and three ways (sample,
    mask, drop) with one; every sampler draws its (M,) uniforms from the
    sample key, the dropout from the drop key (None without a fleet)."""
    key = jax.random.PRNGKey(seed)
    for _ in range(t):
        key, sub = jax.random.split(key)
    if not hetero:
        sample_key, _ = jax.random.split(sub)
        return np.asarray(jax.random.uniform(sample_key, (num_clients,))), None
    sample_key, _, drop_key = jax.random.split(sub, 3)
    return (np.asarray(jax.random.uniform(sample_key, (num_clients,))),
            np.asarray(jax.random.uniform(drop_key, (num_clients,))))


def recording_sampler(sampler, log: list, traced: bool):
    """``sampler`` (either package's) that appends each round's
    participation mask to ``log`` as a numpy array; ``traced`` for the
    reference, whose ``select`` runs inside its compiled round (an ordered
    ``jax.debug.callback``)."""
    base = type(sampler)

    @dataclasses.dataclass(frozen=True)
    class Recording(base):
        def select(self, *args, **kwargs):
            part, weights = base.select(self, *args, **kwargs)
            if traced:
                jax.debug.callback(
                    lambda p: log.append(np.asarray(p).copy()), part,
                    ordered=True)
            else:
                log.append(part.numpy().copy())
            return part, weights

    return Recording(**dataclasses.asdict(sampler))


def reference_scores(t: int, num_clients: int, seed: int = 0) -> np.ndarray:
    """Round t's uniform participant scores as the reference server draws
    them from ``PRNGKey(seed)``, without a hetero fleet."""
    return reference_draws(t, num_clients, seed)[0]


@pytest.fixture(scope="module")
def slice_runs():
    ds = class_gaussian_images(num_train=512, image_size=12, seed=0)
    xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, M, BATCH,
                                      seed=0)
    p0 = jpm.init_lenet(jax.random.PRNGKey(0), image_size=12)
    ref = JaxServer.from_strategy(
        jst.get("fig5", masking=jst.MaskPolicy.selective(0.5,
                                                         backend="kernel")),
        jpm.classifier_loss(jpm.lenet_forward), p0, M, seed=0)
    ref.run((jnp.asarray(xs), jnp.asarray(ys)), ns, ROUNDS)
    port = FederatedServer.from_strategy(
        tst.get("fig5", masking=tst.MaskPolicy.selective(0.5,
                                                         backend="kernel")),
        tpm.classifier_loss(tpm.lenet_forward),
        bridge.params_from_numpy(jax.device_get(p0), device="cpu"), M,
        device="cpu", scores=reference_scores)
    port.run((xs, ys), ns, ROUNDS)
    return ref, port


def test_slice_participants_buckets_and_bytes_exact(slice_runs):
    ref, port = slice_runs
    sampled = [r.num_sampled for r in port.history]
    assert sampled == [7, 7, 6, 5, 5, 4]
    assert sampled == [r.num_sampled for r in ref.history]
    assert [r.cohort_size for r in port.history] == [8] * 5 + [4]
    assert port.summary()["transport_bytes"] == 4_215_456 == \
        ref.summary()["transport_bytes"]
    assert port.client_upload_bytes == 123_984
    assert port.summary()["codec"] == ref.summary()["codec"]


def test_slice_compile_s_on_the_reference_rounds(slice_runs):
    """Both servers time a build on the same rounds (where the bucket
    changes, 8 -> 4) and on no other, outside ``wall_s``."""
    ref, port = slice_runs
    built = [r.compile_s > 0 for r in port.history]
    assert built == [r.compile_s > 0 for r in ref.history]
    assert built == [True, False, False, False, False, True]
    assert port.summary()["compile_s"] == pytest.approx(
        sum(r.compile_s for r in port.history))


def test_slice_losses_and_parameters_match(slice_runs):
    """Tolerance: per-round mean loss rtol 1e-3; final parameters within
    atol 1e-3 entrywise and 1e-3 relative L2 over the model.  XLA and
    PyTorch reduce in different orders, and after a few rounds a rare
    delta entry lying on a candidate threshold flips its mask (the first
    three rounds agree to ~3e-8)."""
    ref, port = slice_runs
    np.testing.assert_allclose([r.mean_loss for r in port.history],
                               [r.mean_loss for r in ref.history], rtol=1e-3)
    want = bridge.flatten_tree(jax.device_get(ref.params))
    diff_sq = norm_sq = 0.0
    for name, leaf in port.params.items():
        got = leaf.numpy()
        np.testing.assert_allclose(got, want[name], rtol=1e-3, atol=1e-3,
                                   err_msg=name)
        diff_sq += float(np.sum((got - want[name]) ** 2))
        norm_sq += float(np.sum(want[name] ** 2))
    assert (diff_sq / norm_sq) ** 0.5 < 1e-3


def test_slice_learns_and_stays_finite(slice_runs):
    _, port = slice_runs
    losses = [r.mean_loss for r in port.history]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(bool(torch.isfinite(v).all()) for v in port.params.values())


def test_full_engine_matches_cohort_engine():
    """engine="full" runs every client every round; the cohort engine only
    the bucket.  Same participants and bytes; floats within rtol 1e-5
    (cuDNN/oneDNN batch the clients differently)."""
    ds = class_gaussian_images(num_train=256, image_size=12, seed=1)
    xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, 8, 16, seed=1)
    st = tst.get("fig5", masking=tst.MaskPolicy.selective(0.5,
                                                          backend="kernel"))
    runs = []
    for engine in ("cohort", "full"):
        params = tpm.init_lenet(torch.Generator().manual_seed(3),
                                image_size=12, device="cpu")
        server = FederatedServer.from_strategy(
            st, tpm.classifier_loss(tpm.lenet_forward), params, 8,
            engine=engine, seed=5, device="cpu")
        server.run((xs, ys), ns, 7)
        runs.append(server)
    cohort, full = runs
    assert [r.num_sampled for r in cohort.history] == \
        [r.num_sampled for r in full.history]
    assert cohort.history[-1].cohort_size == 4
    assert full.history[-1].cohort_size == 8
    assert cohort.summary()["transport_bytes"] == \
        full.summary()["transport_bytes"]
    for name, leaf in cohort.params.items():
        np.testing.assert_allclose(leaf.numpy(), full.params[name].numpy(),
                                   rtol=1e-5, atol=1e-6)


def _reference_and_port(preset: str, rounds: int, eval_every: int = 0,
                        kernel: bool = False):
    """The reference's server and the port's on one preset (LeNet-12, M =
    8; ``kernel``: selective masking at gamma 0.5 on the kernel backend),
    the port fed the reference's participant scores."""
    ds = class_gaussian_images(num_train=512, image_size=12, seed=0)
    xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, M, BATCH,
                                      seed=0)
    p0 = jpm.init_lenet(jax.random.PRNGKey(0), image_size=12)
    ref = JaxServer.from_strategy(
        jst.get(preset, masking=jst.MaskPolicy.selective(
            0.5, backend="kernel")) if kernel else jst.get(preset),
        jpm.classifier_loss(jpm.lenet_forward), p0, M, seed=0,
        eval_fn=jpm.classifier_accuracy(jpm.lenet_forward))
    ref.run((jnp.asarray(xs), jnp.asarray(ys)), ns, rounds,
            eval_every=eval_every,
            eval_data=(jnp.asarray(ds.test_x), jnp.asarray(ds.test_y)))
    port = FederatedServer.from_strategy(
        tst.get(preset, masking=tst.MaskPolicy.selective(
            0.5, backend="kernel")) if kernel else tst.get(preset),
        tpm.classifier_loss(tpm.lenet_forward),
        bridge.params_from_numpy(jax.device_get(p0), device="cpu"), M,
        device="cpu", scores=reference_scores,
        eval_fn=tpm.classifier_accuracy(tpm.lenet_forward))
    port.run((xs, ys), ns, rounds, eval_every=eval_every,
             eval_data=(torch.as_tensor(ds.test_x),
                        torch.as_tensor(ds.test_y)))
    return ref, port


@pytest.mark.parametrize("preset", ["dense-baseline", "fig3", "fig4"])
def test_paper_presets_match_the_reference_server(preset):
    """The paper's round with one lever off, 4 rounds: m_t, buckets and
    bytes exact every round; losses rtol 1e-5 and parameters atol 1e-5
    (measured: 1e-7 and 5e-8)."""
    ref, port = _reference_and_port(preset, 4)
    for field in ("num_sampled", "cohort_size", "transport_bytes"):
        assert [getattr(r, field) for r in port.history] == \
            [getattr(r, field) for r in ref.history], field
    assert port.summary()["codec"] == ref.summary()["codec"]
    np.testing.assert_allclose([r.mean_loss for r in port.history],
                               [r.mean_loss for r in ref.history], rtol=1e-5)
    want = bridge.flatten_tree(jax.device_get(ref.params))
    for name, leaf in port.params.items():
        np.testing.assert_allclose(leaf.numpy(), want[name], rtol=0,
                                   atol=1e-5, err_msg=name)


def test_fig5_twenty_round_acceptance():
    """20 rounds of the fig5 preset as it stands, evaluated every 10: m_t
    and bytes exact every round; per-round loss within rtol 1e-3 and test
    accuracy within 0.01 of the reference's (measured 3.6e-6 and 0), and
    the port learns."""
    ref, port = _reference_and_port("fig5", 20, 10)
    sampled = [r.num_sampled for r in port.history]
    assert sampled == [r.num_sampled for r in ref.history]
    assert sampled == [7, 7, 6, 5, 5, 4, 4, 4, 3, 3, 3] + [2] * 9
    assert [r.transport_bytes for r in port.history] == \
        [r.transport_bytes for r in ref.history]
    assert port.summary()["transport_bytes"] == sum(sampled) * 123_984
    np.testing.assert_allclose([r.mean_loss for r in port.history],
                               [r.mean_loss for r in ref.history], rtol=1e-3)
    acc = [r.eval_metric for r in port.history if r.eval_metric is not None]
    want = [r.eval_metric for r in ref.history if r.eval_metric is not None]
    assert len(acc) == len(want) == 2
    np.testing.assert_allclose(acc, want, rtol=0, atol=0.01)
    assert acc[-1] > acc[0] + 0.1


# ---------------------------------------------------------- import hygiene
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_the_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .replace(".__init__", "")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(n for n in sys.modules\n"
            "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
