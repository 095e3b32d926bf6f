"""The scan form of the round (``build_round(form="scan")``,
``make_cohort_scan``) and the server's ``scan_rounds`` on the CPU, beside
the reference's ``make_cohort_scan`` and its ``scan_rounds`` server.

* ``_segments``: the port's segment plan equals the reference's, exactly.
* ``build_round(form="scan")`` against the reference's scan at reduced
  width, with the reference's draws injected (participant scores, and the
  per-entry random-mask and dropout draws): m_t, cohort ids, kept index
  sets and wire bytes exact; losses, parameters, residuals and norms within
  rtol 1e-3 (the slice tests' tolerance, for their reason: XLA and PyTorch
  reduce in different orders).
* A server with ``scan_rounds=True`` against ``False``: histories,
  parameters and store bit for bit; ``compile_s`` on the first round of
  each new (form, bucket); ``wall_s`` the segment's mean; eval on segment
  ends.
* The reference server with ``scan_rounds=True`` against the port's:
  ``num_sampled``, ``cohort_size`` and ``transport_bytes`` exact.

On a card the same form replays a CUDA graph; ``tests/test_torch_cuda.py``
and ``chip_smoke.py``'s ``scan_path`` hold it bit for bit against the eager
loop there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import federated as jfed
from repro.core import masking as jmask
from repro.core import strategy as jst
from repro.core.sampling import StaticSampling as JStatic
from repro.core.server import FederatedServer as JaxServer
from repro.data.partition import iid_partition_images
from repro.data.synthetic import class_gaussian_images
from repro.models import paper_models as jpm
from repro_torch import bridge
from repro_torch.core import federated as tfed
from repro_torch.core import masking as tmask
from repro_torch.core import strategy as tst
from repro_torch.core.sampling import StaticSampling as TStatic
from repro_torch.core.server import FederatedServer
from repro_torch.models import paper_models as tpm

M, IMAGE, BATCH = 8, 12, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: with several test workers on one machine, torch's
    intra-op threads only contend.  Restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def data():
    ds = class_gaussian_images(num_train=256, image_size=IMAGE, seed=0)
    xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, M, BATCH,
                                      seed=0)
    p0 = jax.device_get(jpm.init_lenet(jax.random.PRNGKey(0),
                                       image_size=IMAGE))
    return (xs, ys), ns, p0, (ds.test_x, ds.test_y)


TLOSS = tpm.classifier_loss(tpm.lenet_forward)
JLOSS = jpm.classifier_loss(jpm.lenet_forward)


def _port_server(data, st, num_clients=M, **kw):
    _, _, p0, _ = data
    kw.setdefault("eval_fn", tpm.classifier_accuracy(tpm.lenet_forward))
    return FederatedServer.from_strategy(
        st, TLOSS, bridge.params_from_numpy(p0, device="cpu"), num_clients,
        device="cpu", seed=0, **kw)


def _ref_server(data, st, num_clients=M, **kw):
    _, _, p0, _ = data
    kw.setdefault("eval_fn", jpm.classifier_accuracy(jpm.lenet_forward))
    return JaxServer.from_strategy(st, JLOSS, jax.tree.map(jnp.asarray, p0),
                                   num_clients, seed=0, **kw)


# ------------------------------------------------------------- _segments
FIG5_PLAN = [(32, 6), (16, 6)]     # m_t 29 ... 18, then 16 ... 10
SEGMENT_PRESETS = ["fig5", "dense-baseline", "fig3-importance",
                   "hetero-dropout"]


def _evals(start: int, rounds: int, eval_every: int) -> set:
    """The reference's eval rounds (``FederatedServer.run``)."""
    if not eval_every:
        return set()
    return {t for t in range(start + 1, start + rounds + 1)
            if t % eval_every == 0 or t == start + rounds}


@pytest.mark.parametrize("preset", SEGMENT_PRESETS)
@pytest.mark.parametrize("engine", ["cohort", "full"])
@pytest.mark.parametrize("eval_every", [0, 3])
@pytest.mark.parametrize("start", [0, 5])
def test_segments_equal_the_references(data, preset, engine, eval_every,
                                       start):
    """Host-only: the port's plan of (bucket, rounds) segments is the
    reference's for M = 32 over 12 rounds, also from a restored round
    counter, and every round is its own segment without scan_rounds."""
    rounds = 12
    for scan in (True, False):
        port = _port_server(data, tst.get(preset), 32, engine=engine,
                            scan_rounds=scan)
        ref = _ref_server(data, jst.get(preset), 32, engine=engine,
                          scan_rounds=scan)
        port._round = start
        evals = _evals(start, rounds, eval_every)
        assert port._eval_rounds(rounds, eval_every) == evals
        got = port._segments(rounds, evals, start)
        want = ref._segments(rounds, evals, start)
        assert [(b, list(ts)) for b, ts in got] == \
            [(int(b), list(ts)) for b, ts in want]
        assert [t for _, ts in got for t in ts] == list(
            range(start + 1, start + rounds + 1))
        if not scan:
            assert all(len(ts) == 1 for _, ts in got)
        elif preset == "fig5" and engine == "cohort" and start == 0 and \
                eval_every == 0:
            assert [(b, len(ts)) for b, ts in got] == FIG5_PLAN


# -------------------------------- the scan form beside the reference's
def _round_subs(seed: int, rounds: int):
    key, subs = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def _ref_draws(sub, num_clients: int, leaves: dict, hetero: bool):
    """One round's draws as the reference's round makes them from its key:
    (scores, drop scores or None, {leaf: (M, size)} random-mask scores)."""
    if hetero:
        sample_key, mask_key, drop_key = jax.random.split(sub, 3)
        drop = np.asarray(jax.random.uniform(drop_key, (num_clients,)))
    else:
        sample_key, mask_key = jax.random.split(sub)
        drop = None
    scores = np.asarray(jax.random.uniform(sample_key, (num_clients,)))
    client_keys = jax.random.split(mask_key, num_clients)
    names = list(leaves)
    mask = {}
    for j, name in enumerate(names):
        size = leaves[name].size
        if size < 256:
            continue
        mask[name] = np.stack([np.asarray(jax.random.uniform(
            jax.random.split(ck, len(names))[j], (size,)))
            for ck in client_keys]).reshape((num_clients,) +
                                            leaves[name].shape)
    return scores, drop, mask, sample_key, client_keys


SCAN_CASES = {
    # name: (preset, overrides, bucket, rounds, random mask, hetero)
    "oracle-random-ef": ("fig5", {}, M, 5, True, False),
    "cohort-random-ef": ("fig5", {"sampling": "static-half"}, 4, 4, True,
                         False),
    "oracle-dropout": ("hetero-dropout", {}, M, 4, False, True),
    "cohort-importance": ("fig3-importance", {"sampling": "static-half"}, 4,
                          4, False, False),
}


def _case_strategies(case):
    preset, over, _, _, random_mask, _ = SCAN_CASES[case]
    jkw, tkw = {}, {}
    if over.get("sampling") == "static-half":
        jkw["sampling"] = JStatic(initial_rate=0.5, min_clients=2)
        tkw["sampling"] = TStatic(initial_rate=0.5, min_clients=2)
    if random_mask:
        jkw.update(masking=jst.MaskPolicy.random(0.5), error_feedback=True)
        tkw.update(masking=tst.MaskPolicy.random(0.5), error_feedback=True)
    return jst.get(preset, **jkw), tst.get(preset, **tkw)


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_form_matches_the_references_scan(data, case):
    (xs, ys), ns, p0, _ = data
    _, _, bucket, rounds, random_mask, hetero = SCAN_CASES[case]
    jst_, tst_ = _case_strategies(case)
    subs = _round_subs(7, rounds)
    leaves = bridge.flatten_tree(p0)
    draws = [_ref_draws(s, M, leaves, hetero) for s in subs]
    ts = list(range(1, rounds + 1))

    jfn = jax.jit(jst.build_round(jst_, JLOSS, M, form="scan",
                                  cohort_size=bucket))
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = [jax.tree.map(jnp.zeros_like, jax.tree.map(
        lambda v: jnp.broadcast_to(v, (M,) + v.shape), jp))]
    if jst_.sampler.adaptive:
        jstate.append(jnp.ones((M,), jnp.float32))
    jout = jfn(jp, *jstate, (jnp.asarray(xs), jnp.asarray(ys)),
               jnp.asarray(ns, jnp.float32), jnp.asarray(ts, jnp.float32),
               jnp.stack(subs))
    jmetrics = jout[-1]

    tfn = tst.build_round(tst_, TLOSS, M, form="scan", cohort_size=bucket)
    assert isinstance(tfn, tfed.CohortScan)
    tp = bridge.params_from_numpy(p0, device="cpu")
    tstate = {"residuals": {k: torch.zeros((M,) + v.shape)
                            for k, v in tp.items()}}
    if tst_.sampler.adaptive:
        tstate["norms"] = torch.ones((M,))
    scores = torch.from_numpy(np.stack([d[0] for d in draws]))
    drop = (torch.from_numpy(np.stack([d[1] for d in draws])) if hetero
            else None)
    mask = ({k: torch.from_numpy(np.stack([d[2][k] for d in draws]))
             for k in draws[0][2]} if random_mask else None)
    keeps = []
    with pytest.MonkeyPatch.context() as mp:
        keep_fn = tmask.random_keep
        mp.setattr(tmask, "random_keep", lambda s, g: keeps.append(
            keep_fn(s, g)) or keeps[-1])
        params, state, metrics = tfn(
            tp, tstate, [torch.as_tensor(xs), torch.as_tensor(ys)],
            torch.as_tensor(ns, dtype=torch.float32), ts, scores, mask, drop)

    # discrete: m_t every round, and the codec's exact bytes
    np.testing.assert_array_equal(metrics["num_sampled"].numpy(),
                                  np.asarray(jmetrics["num_sampled"]))
    assert tst_.codec.wire_bytes(tp) == jst_.codec.wire_bytes(jp)
    if hetero:
        np.testing.assert_array_equal(metrics["arrived_mask"].numpy(),
                                      np.asarray(jmetrics["arrived_mask"]))
    # cohort ids and kept index sets, round by round
    names = [n for n, leaf in leaves.items() if leaf.size >= 256]
    assert len(keeps) == (rounds * len(names) if random_mask else 0)
    for r, t in enumerate(ts):
        sample_key, client_keys = draws[r][3], draws[r][4]
        if bucket < M and not tst_.sampler.adaptive:
            got_ids, got_valid = tfed.cohort_select(
                scores[r], tst_.sampling, t, M, bucket)
            want_ids, want_valid = jfed.cohort_select(
                sample_key, jst_.sampling, t, M, bucket)
            np.testing.assert_array_equal(got_ids.numpy(),
                                          np.asarray(want_ids))
            np.testing.assert_array_equal(got_valid.numpy(),
                                          np.asarray(want_valid))
            ids = got_ids.tolist()
        else:
            ids = list(range(M))
        for j, name in enumerate(names):
            got = keeps[r * len(names) + j] if random_mask else None
            if got is None:
                continue
            li = list(leaves).index(name)
            size = leaves[name].size
            for row, client in enumerate(ids):
                want = np.asarray(jmask.random_mask(
                    jax.random.split(client_keys[client], len(leaves))[li],
                    jnp.ones(size), 0.5)) != 0
                np.testing.assert_array_equal(got[row].numpy(), want)
    # floats
    np.testing.assert_allclose(metrics["mean_loss"].numpy(),
                               np.asarray(jmetrics["mean_loss"]), rtol=1e-3)
    want_p = bridge.flatten_tree(jax.device_get(jout[0]))
    for k, v in params.items():
        np.testing.assert_allclose(v.numpy(), want_p[k], rtol=1e-3,
                                   atol=1e-3, err_msg=k)
    want_r = bridge.flatten_tree(jax.device_get(jout[1]))
    for k, v in state["residuals"].items():
        np.testing.assert_allclose(v.numpy(), want_r[k], rtol=1e-3,
                                   atol=1e-3, err_msg=k)
    if tst_.sampler.adaptive:
        np.testing.assert_allclose(state["norms"].numpy(),
                                   np.asarray(jout[2]), rtol=1e-3)


def test_scan_form_equals_its_own_eager_loop_bit_for_bit(data):
    """On the CPU the scan form is the eager round in a loop: the same
    bits as calling ``build_round(form="cohort")`` round by round."""
    (xs, ys), ns, p0, _ = data
    st = tst.get("noniid-dyn", error_feedback=True,
                 sampling=TStatic(initial_rate=0.5, min_clients=2))
    tp = bridge.params_from_numpy(p0, device="cpu")
    zeros = {k: torch.zeros((M,) + v.shape) for k, v in tp.items()}
    state = {"residuals": zeros, "drift": dict(zeros),
             "norms": torch.ones((M,))}
    batches = [torch.as_tensor(xs), torch.as_tensor(ys)]
    n = torch.as_tensor(ns, dtype=torch.float32)
    gen = torch.Generator().manual_seed(3)
    scores = torch.rand((3, M), generator=gen)
    scan = tst.build_round(st, TLOSS, M, form="scan", cohort_size=4)
    eager = tst.build_round(st, TLOSS, M, form="cohort", cohort_size=4)
    p_s, s_s, m_s = scan(tp, state, batches, n, [1, 2, 3], scores)
    p_e, s_e = tp, state
    losses = []
    for i, t in enumerate([1, 2, 3]):
        p_e, s_e, m = eager(p_e, s_e, batches, n, t, scores[i])
        losses.append(m["mean_loss"])
    assert all(torch.equal(p_s[k], p_e[k]) for k in p_e)
    for tree in ("residuals", "drift"):
        assert all(torch.equal(s_s[tree][k], s_e[tree][k])
                   for k in s_e[tree])
    assert torch.equal(s_s["norms"], s_e["norms"])
    assert torch.equal(m_s["mean_loss"], torch.stack(losses))
    assert scan.graphs == 0 and scan.replays == 0


# ------------------------------------------------ scan_rounds True vs False
SERVER_CASES = {
    "fig5-kernel": ("fig5", dict(masking=tst.MaskPolicy.selective(
        0.5, backend="kernel")), "cohort"),
    "fig5-fused-int8-ef": ("fig5-fused-int8", dict(error_feedback=True),
                           "cohort"),
    "noniid-dyn": ("noniid-dyn", {}, "cohort"),
    "hetero-dropout": ("hetero-dropout", {}, "cohort"),
    "fig3-importance-full": ("fig3-importance", {}, "full"),
    "byzantine-signflip": ("byzantine-signflip", {}, "cohort"),
    "gauss-attack-full": ("fig5", "gauss", "full"),
    "random-mask": ("fig5", dict(masking=tst.MaskPolicy.random(0.5)),
                    "cohort"),
}


def _server_strategy(case):
    preset, over, engine = SERVER_CASES[case]
    if over == "gauss":
        from repro_torch.core.attacks import AttackModel
        return tst.get(preset).replace(attack=AttackModel(
            kind="gauss", fraction=0.3, sigma=1.0)), engine
    return tst.get(preset, **over), engine


def _run_pair(data, case, rounds=6, eval_every=2):
    batches, ns, _, (tx, ty) = data
    st, engine = _server_strategy(case)
    runs = {}
    for scan in (True, False):
        server = _port_server(data, st, engine=engine, scan_rounds=scan)
        server.run(batches, ns, rounds, eval_every=eval_every,
                   eval_data=(torch.as_tensor(tx), torch.as_tensor(ty)))
        runs[scan] = server
    return runs[True], runs[False]


FIELDS = ("round", "num_sampled", "mean_loss", "transport_units",
          "transport_bytes", "eval_metric", "cohort_size", "flop_proxy",
          "quarantined", "sim_round_s", "straggler_s", "dropped",
          "adversarial")


def _nan_eq(a, b):
    return a == b or (a != a and b != b)


@pytest.mark.parametrize("case", list(SERVER_CASES))
def test_scan_rounds_equals_the_round_loop_bit_for_bit(data, case):
    scan, loop = _run_pair(data, case)
    for a, b in zip(scan.history, loop.history):
        assert all(_nan_eq(getattr(a, f), getattr(b, f)) for f in FIELDS), \
            (a, b)
    assert len(scan.history) == len(loop.history) == 6
    assert all(torch.equal(v, loop.params[k]) for k, v in scan.params.items())
    for tree in scan.store.trees:
        want = loop.store.dense_view(tree)
        assert all(torch.equal(v, want[k])
                   for k, v in scan.store.dense_view(tree).items())
    if scan.store.norms is not None:
        assert torch.equal(scan.store.norms, loop.store.norms)
    assert scan._generator.get_state().equal(loop._generator.get_state())
    assert scan._drop_generator.get_state().equal(
        loop._drop_generator.get_state())


@pytest.mark.parametrize("case", ["fig5-kernel", "hetero-dropout"])
def test_segment_records(data, case):
    """``compile_s`` on the first round of each new (form, bucket) only;
    ``wall_s`` the segment's mean (equal across its rounds); the eval
    metric on segment ends, which the eval rounds are."""
    scan, _ = _run_pair(data, case, rounds=6, eval_every=2)
    evals = {2, 4, 6}
    segments = scan._segments(6, evals, 0)
    seen = set()
    for bucket, ts in segments:
        recs = [scan.history[t - 1] for t in ts]
        assert len({r.wall_s for r in recs}) == 1 and recs[0].wall_s > 0
        assert (recs[0].compile_s > 0) == (bucket not in seen)
        assert all(r.compile_s == 0.0 for r in recs[1:])
        seen.add(bucket)
        for r in recs:
            assert (r.eval_metric is not None) == (r.round in evals)
            if r.round in evals:
                assert r.round == ts[-1]
    assert [len(ts) for _, ts in segments] == (
        [2, 2, 1, 1] if case == "fig5-kernel" else [2, 2, 2])


def test_compile_key_differs_from_the_references_where_eval_splits(data):
    """The port keys a built round by (form, bucket), the reference by
    (bucket, segment length): where an eval round cuts a bucket into
    segments of another length the reference compiles again and the port
    does not (fig5, M = 8, 6 rounds, eval every 2: segments 8 x [1, 2],
    [3, 4], [5] and 4 x [6])."""
    batches, ns, _, (tx, ty) = data
    jst_ = jst.get("fig5", masking=jst.MaskPolicy.selective(
        0.5, backend="kernel"))
    tst_ = tst.get("fig5", masking=tst.MaskPolicy.selective(
        0.5, backend="kernel"))
    ref = _ref_server(data, jst_)
    ref.run((jnp.asarray(batches[0]), jnp.asarray(batches[1])), ns, 6,
            eval_every=2, eval_data=(jnp.asarray(tx), jnp.asarray(ty)))
    port = _port_server(data, tst_)
    port.run(batches, ns, 6, eval_every=2,
             eval_data=(torch.as_tensor(tx), torch.as_tensor(ty)))
    assert [r.cohort_size for r in port.history] == [8] * 5 + [4]
    assert [r.compile_s > 0 for r in ref.history] == [
        True, False, False, False, True, True]
    assert [r.compile_s > 0 for r in port.history] == [
        True, False, False, False, False, True]


# ----------------------------------------- the reference's scan server beside
def _ref_scores(subs, hetero: bool):
    def scores(t, num_clients):
        return _ref_draws(subs[t - 1], num_clients, {}, hetero)[0]

    def drops(t, num_clients):
        return _ref_draws(subs[t - 1], num_clients, {}, hetero)[1]
    return scores, drops


@pytest.mark.parametrize("preset", ["fig5", "dense-baseline", "fig3",
                                    "hetero-dropout"])
def test_ledger_equals_the_reference_scan_server(data, preset):
    batches, ns, _, (tx, ty) = data
    hetero = preset == "hetero-dropout"
    rounds = 6
    subs = _round_subs(0, rounds)
    scores, drops = _ref_scores(subs, hetero)
    ref = _ref_server(data, jst.get(preset), scan_rounds=True)
    ref.run((jnp.asarray(batches[0]), jnp.asarray(batches[1])), ns, rounds,
            eval_every=3, eval_data=(jnp.asarray(tx), jnp.asarray(ty)))
    port = _port_server(data, tst.get(preset), scores=scores,
                        drop_scores=drops if hetero else None)
    port.run(batches, ns, rounds, eval_every=3,
             eval_data=(torch.as_tensor(tx), torch.as_tensor(ty)))
    assert port.scan_rounds and ref.scan_rounds

    def ledger(s):
        return [(r.num_sampled, r.cohort_size, r.transport_bytes)
                for r in s.history]
    assert ledger(port) == ledger(ref)
    assert [r.eval_metric is not None for r in port.history] == \
        [r.eval_metric is not None for r in ref.history]
    if hetero:
        assert [r.dropped for r in port.history] == \
            [r.dropped for r in ref.history]
