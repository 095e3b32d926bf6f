"""``RoundRecord.compile_s`` in the port's server: the build of a bucket's
round (and, on a card, of the kernel library) is timed on the round that
first needs it and kept out of ``wall_s``, as the reference keeps its AOT
compile out of ``wall_s``."""

import time

import pytest
import torch

from repro_torch.core import strategy as tst
from repro_torch.core.server import FederatedServer
from repro_torch.data.partition import iid_partition_images
from repro_torch.data.synthetic import class_gaussian_images
from repro_torch.kernels import build
from repro_torch.models import paper_models as tpm

M, ROUNDS = 8, 6
BUCKETS = [8] * 5 + [4]          # the fig5 ladder at M = 8: 8 -> 4


def _run(rounds: int = ROUNDS, eval_every: int = 0):
    ds = class_gaussian_images(num_train=256, image_size=12, seed=0)
    xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, M, 16, seed=0)
    server = FederatedServer.from_strategy(
        tst.get("fig5", masking=tst.MaskPolicy.selective(0.5,
                                                         backend="kernel")),
        tpm.classifier_loss(tpm.lenet_forward),
        tpm.init_lenet(torch.Generator().manual_seed(0), image_size=12,
                       device="cpu"),
        M, eval_fn=tpm.classifier_accuracy(tpm.lenet_forward), seed=0,
        device="cpu")
    eval_data = (torch.as_tensor(ds.test_x), torch.as_tensor(ds.test_y))
    t0 = time.perf_counter()
    server.run((xs, ys), ns, rounds, eval_every=eval_every,
               eval_data=eval_data)
    return server, time.perf_counter() - t0


def test_compile_s_is_nonzero_exactly_on_bucket_change_rounds():
    server, _ = _run(eval_every=2)
    assert [r.cohort_size for r in server.history] == BUCKETS
    assert [r.compile_s > 0 for r in server.history] == [
        True, False, False, False, False, True]
    assert all(r.wall_s > 0 for r in server.history)


def test_summary_compile_s_is_the_sum_of_the_rounds():
    server, _ = _run()
    summ = server.summary()
    assert summ["compile_s"] == sum(r.compile_s for r in server.history)
    assert summ["steady_wall_s"] == sum(r.wall_s for r in server.history)
    assert summ["compile_s"] > 0


def test_a_later_run_builds_only_new_buckets():
    """A second ``run`` on the same server finds its buckets built."""
    server, _ = _run(rounds=3)
    ds = class_gaussian_images(num_train=256, image_size=12, seed=0)
    xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, M, 16, seed=0)
    server.run((xs, ys), ns, 3)
    assert [r.cohort_size for r in server.history] == BUCKETS
    assert [r.compile_s > 0 for r in server.history] == [
        True, False, False, False, False, True]


def test_a_slow_build_lands_in_compile_s_not_in_wall_s(monkeypatch):
    """The build and the rounds are disjoint intervals of the run, so the
    0.2 s a build sleeps counts in ``compile_s`` and the rounds' sum stays
    below the run's wall time less both sleeps."""
    real = tst.build_round

    def slow_build_round(*args, **kwargs):
        time.sleep(0.2)
        return real(*args, **kwargs)

    monkeypatch.setattr(tst, "build_round", slow_build_round)
    server, run_s = _run()
    changed = [r.compile_s for r in server.history if r.compile_s > 0]
    assert len(changed) == 2 and all(c >= 0.2 for c in changed)
    summ = server.summary()
    assert summ["steady_wall_s"] <= run_s - 0.4
    assert summ["steady_wall_s"] + summ["compile_s"] <= run_s


def test_cpu_server_never_touches_the_kernel_library(monkeypatch):
    def no_library():
        raise AssertionError("the kernel library was loaded on the CPU")

    monkeypatch.setattr(build, "library", no_library)
    server, _ = _run(rounds=2)
    assert len(server.history) == 2


@pytest.mark.parametrize("masking, codec, want", [
    (tst.MaskPolicy.selective(0.5, backend="kernel"), "jnp", True),
    (tst.MaskPolicy.selective(0.5), "jnp", False),
    (tst.MaskPolicy.random(0.5), "jnp", False),
    (tst.MaskPolicy.selective(1.0, backend="kernel"), "jnp", False),
    (tst.MaskPolicy.none(), "jnp", False),
    (tst.MaskPolicy.selective(0.5), "fused", True),
])
def test_launches_kernels_follows_the_masking_and_the_codec(masking, codec,
                                                            want):
    st = tst.get("fig5").with_masking(masking, codec=tst.default_codec(
        masking, backend=codec))
    assert tst.launches_kernels(st) is want


@pytest.mark.parametrize("backend, loads", [("kernel", 1), ("jnp", 0)])
def test_a_card_round_loads_the_library_only_when_it_launches_kernels(
        monkeypatch, backend, loads):
    """``_round_fn`` on a CUDA server: the library is loaded while building
    a kernel round, never for a round without kernels.  (The round is built,
    not run, so this holds without a card.)"""
    calls = []
    monkeypatch.setattr(build, "library", lambda: calls.append(1))
    server = FederatedServer.from_strategy(
        tst.get("fig5", masking=tst.MaskPolicy.selective(0.5,
                                                         backend=backend)),
        tpm.classifier_loss(tpm.lenet_forward),
        tpm.init_lenet(torch.Generator().manual_seed(0), image_size=12,
                       device="cpu"),
        M, seed=0, device="cpu")
    server.device = torch.device("cuda")
    _, compile_s = server._round_fn(M)
    assert len(calls) == loads and compile_s > 0
    assert server._round_fn(M)[1] == 0.0 and len(calls) == loads


def test_a_failed_build_raises(monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("build failed")

    monkeypatch.setattr(tst, "build_round", broken)
    with pytest.raises(RuntimeError, match="build failed"):
        _run(rounds=1)


def test_round_time_entry_point_reports_compile_s_apart():
    from repro_torch.launch import round_time
    rec = round_time.round_times("cpu", clients=8, rounds=6, batch=16,
                                 image_size=12)
    assert rec["buckets"] == BUCKETS and rec["device"] == "cpu"
    assert [c > 0 for c in rec["compile_s"]] == [
        True, False, False, False, False, True]
    assert rec["summary_compile_s"] == sum(rec["compile_s"])
    assert rec["steady_wall_s"] == sum(rec["wall_s"])
    assert rec["first_round_s"] == rec["wall_s"][0]


ROUND_TIME_KEYS = {"device", "device_name", "buckets", "wall_s", "compile_s",
                   "first_round_s", "later_median_s", "first_over_later",
                   "summary_compile_s", "steady_wall_s"}


def test_round_time_defaults_to_fig5_with_unchanged_output(monkeypatch,
                                                           capsys):
    """``--preset`` defaults to fig5: the same call and the same keys as
    before the option; another preset is timed through the same call."""
    from repro_torch.launch import round_time
    calls = []
    monkeypatch.setattr(round_time, "round_times",
                        lambda device, **kw: calls.append((device, kw)) or {})
    round_time.main(["--device", "cpu"])
    round_time.main(["--device", "cpu", "--preset", "noniid-dyn"])
    assert calls == [("cpu", {"preset": "fig5"}),
                     ("cpu", {"preset": "noniid-dyn"})]
    assert capsys.readouterr().out.splitlines() == ["{}", "{}"]
    with pytest.raises(SystemExit):
        round_time.main(["--preset", "bogus"])


@pytest.mark.parametrize("preset, fleet", [("fig5", False),
                                           ("hetero-dropout", True),
                                           ("noniid-dyn", False)])
def test_round_time_presets(preset, fleet):
    from repro_torch.launch import round_time
    rec = round_time.round_times("cpu", clients=8, rounds=4, batch=16,
                                 image_size=12, preset=preset)
    extra = {"sim_total_s", "dropped_uploads"} if fleet else set()
    assert set(rec) == ROUND_TIME_KEYS | extra
    assert len(rec["wall_s"]) == 4 and rec["compile_s"][0] > 0
    if fleet:
        assert rec["sim_total_s"] > 0 and rec["buckets"] == [8] * 4
