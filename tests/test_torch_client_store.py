"""The port's client-state store (``repro_torch/core/client_store.py``)
against the reference's ``repro/core/client_store.py``, on the CPU.

One scripted sequence of gathers, commit-masked scatters over two trees,
``mark_dispatched`` calls and an over-capacity round runs on both packages'
``DenseStore`` and ``ShardedStore`` (retention 4 of 10 clients, so slots
are evicted and refilled): pools or dense stacks, ``slot_ids``,
``slot_round``, ``evictions``, ``versions``, ``staleness`` and every
``memory_bytes()`` field are held exact after every step.  A ``state()``
of either package loads into the other.  The reference's own semantic
cases (``tests/test_client_store.py``) run on the port beside them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client_store as jcs
from repro_torch.core import client_store as tcs

M, RETENTION = 10, 4
SHAPES = {"a.w": (3, 2), "b": (4,), "c": ()}


def _templates():
    rng = np.random.default_rng(0)
    arrays = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v.copy()) for k, v in arrays.items()})


def _stores(kind):
    jt, tt = _templates()
    kw = dict(track_norms=True)
    if kind == "sharded":
        return (jcs.ShardedStore(M, jt, RETENTION, extra_trees={"drift": jt},
                                 **kw),
                tcs.ShardedStore(M, tt, RETENTION, extra_trees={"drift": tt},
                                 **kw))
    return (jcs.DenseStore(M, jt, extra_trees={"drift": jt}, **kw),
            tcs.DenseStore(M, tt, extra_trees={"drift": tt}, **kw))


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((n,) + s).astype(np.float32)
            for k, s in SHAPES.items()}


def _assert_same(ref, port, evictions: bool = True):
    """Every piece of state and accounting of the two stores, exact (the
    eviction counter is not state, so a loaded store starts it anew)."""
    for tree in ("residuals", "drift"):
        want, got = ref.dense_view(tree), port.dense_view(tree)
        for k in SHAPES:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"{tree} {k}")
        everyone = np.arange(M)
        for k, v in port.gather(everyone, tree).items():
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(ref.gather(everyone, tree)[k]))
    if port.kind == "sharded":
        for tree, pool in port._pools.items():
            for k, v in pool.items():
                np.testing.assert_array_equal(
                    v.numpy(), np.asarray(ref._pools[tree][k]))
        np.testing.assert_array_equal(port._slot_ids, ref._slot_ids)
        np.testing.assert_array_equal(port._slot_round, ref._slot_round)
        assert port._slot_of == ref._slot_of
        if evictions:
            assert port.evictions == ref.evictions
    np.testing.assert_array_equal(port.versions, ref.versions)
    np.testing.assert_array_equal(port.staleness(np.arange(M), 9),
                                  ref.staleness(np.arange(M), 9))
    np.testing.assert_array_equal(port.norms.numpy(), np.asarray(ref.norms))
    mem, want = port.memory_bytes(), ref.memory_bytes()
    if not evictions:
        mem.pop("evictions", None)
        want.pop("evictions", None)
    assert mem == want


# Round, ids, commit mask: 4 slots fill, client 6 refreshes its slot, then
# rounds 3-5 evict least-recently-committed owners (ties by slot index),
# an uncommitted row takes no slot, and round 5 re-admits evicted clients.
SCRIPT = [
    (1, [1, 4, 6], [1.0, 0.0, 1.0]),
    (2, [2, 3, 6], [1.0, 1.0, 1.0]),
    (3, [5, 7], [1.0, 1.0]),
    (4, [0, 1, 8, 9], [1.0, 1.0, 1.0, 0.0]),
    (5, [1, 2, 3, 4], [0.0, 1.0, 1.0, 1.0]),
]


@pytest.mark.parametrize("kind", ["dense", "sharded"])
def test_scripted_sequence_matches_the_reference_store(kind):
    ref, port = _stores(kind)
    _assert_same(ref, port)
    for step, (rnd, ids, commit) in enumerate(SCRIPT):
        ids, commit = np.asarray(ids), np.asarray(commit, np.float32)
        for j, tree in enumerate(("residuals", "drift")):
            rows = _rows(10 * step + j, len(ids))
            ref.scatter(ids, {k: jnp.asarray(v) for k, v in rows.items()},
                        commit, rnd, tree=tree)
            # The port's commit mask may live on the device as a tensor.
            port.scatter(torch.from_numpy(ids),
                         {k: torch.from_numpy(v) for k, v in rows.items()},
                         torch.from_numpy(commit), rnd, tree=tree)
        ref.mark_dispatched(ids, rnd)
        port.mark_dispatched(ids, rnd)
        values = np.linspace(0.5, 2.0, len(ids)).astype(np.float32)
        ref.update_norms(ids, jnp.asarray(values))
        port.update_norms(ids, values)
        _assert_same(ref, port)
    if kind == "sharded":
        assert port.evictions >= 3
        over = np.arange(RETENTION + 1)
        rows = _rows(99, len(over))
        for store, conv in ((ref, jnp.asarray), (port, torch.from_numpy)):
            with pytest.raises(ValueError, match="retains only"):
                store.scatter(over, {k: conv(v) for k, v in rows.items()},
                              np.ones(len(over), np.float32), 6)


@pytest.mark.parametrize("kind", ["dense", "sharded"])
def test_state_crosses_between_the_packages(kind):
    """A reference ``state()`` loads with the port's ``load_state`` and the
    port's with the reference's: the same dense views, directory and
    vectors."""
    ref, port = _stores(kind)
    for rnd, ids, commit in SCRIPT[:4]:
        rows = _rows(rnd, len(ids))
        ref.scatter(np.asarray(ids), {k: jnp.asarray(v)
                                      for k, v in rows.items()},
                    np.asarray(commit, np.float32), rnd)
        ref.mark_dispatched(np.asarray(ids), rnd)
    ref.update_norms(np.asarray([3, 5]), jnp.asarray([0.25, 4.0]))
    state = ref.state()
    port.load_state({key: ({k: np.asarray(v) for k, v in value.items()}
                           if isinstance(value, dict) else np.asarray(value))
                     for key, value in state.items()})
    _assert_same(ref, port, evictions=False)
    back, _ = _stores(kind)
    back.load_state({key: ({k: jnp.asarray(v.numpy()) for k, v in value.items()}
                           if isinstance(value, dict)
                           else jnp.asarray(value.numpy()))
                     for key, value in port.state().items()})
    _assert_same(back, port, evictions=False)
    assert set(port.state()) == set(state)


def test_load_state_rejects_a_wrong_shape_before_assigning():
    _, port = _stores("sharded")
    state = {k: v for k, v in port.state().items()}
    state["slots"] = {k: torch.zeros((RETENTION + 2,) + s)
                      for k, s in SHAPES.items()}
    port.versions[3] = 7
    with pytest.raises(ValueError, match="shape"):
        port.load_state(state)
    assert port.versions[3] == 7


# ---- the reference's semantic cases, on the port -------------------------
def _template():
    return {"w": torch.zeros(320), "b": torch.zeros(())}


def test_make_store_kinds_and_validation():
    t = _template()
    assert tcs.make_store("dense", M, t).kind == "dense"
    sh = tcs.make_store("sharded", M, t, retention=4)
    assert sh.kind == "sharded" and sh.retention == 4
    with pytest.raises(ValueError, match="unknown store kind"):
        tcs.make_store("mmap", M, t)
    with pytest.raises(ValueError, match="retention="):
        tcs.make_store("sharded", M, t)
    for bad in (0, M + 1):
        with pytest.raises(ValueError, match="retention must be"):
            tcs.ShardedStore(M, t, retention=bad)


@pytest.mark.parametrize("kind", ["dense", "sharded"])
def test_gather_zero_on_miss_and_commit_mask(kind):
    store = tcs.make_store(kind, M, _template(), retention=4)
    for leaf in store.gather([3, 7, 9]).values():
        assert not leaf.any()
    ids = np.asarray([2, 5])
    store.scatter(ids, {"w": torch.ones((2, 320)), "b": torch.full((2,), 3.)},
                  np.asarray([1.0, 0.0], np.float32), 1)
    got = store.gather(ids)
    assert (got["w"][0] == 1.0).all() and float(got["b"][0]) == 3.0
    assert not got["w"][1].any() and float(got["b"][1]) == 0.0


def test_lru_eviction_zeroes_every_tree_and_counts():
    t = _template()
    sh = tcs.ShardedStore(M, t, retention=2, extra_trees={"drift": t})
    one = {"w": torch.ones((1, 320)), "b": torch.ones((1,))}
    keep = np.ones((1,), np.float32)
    sh.scatter([0], one, keep, 1)
    sh.scatter([0], one, keep, 1, tree="drift")
    sh.scatter([1], one, keep, 2)
    assert sh.evictions == 0
    sh.scatter([2], one, keep, 3)          # evicts client 0 (oldest)
    assert sh.evictions == 1
    assert not sh.gather([0])["w"].any()
    assert (sh.gather([1])["w"] == 1.0).all()
    assert (sh.gather([2])["w"] == 1.0).all()
    # Client 2 took client 0's slot: its drift row was zeroed first.
    assert not sh.gather([2], "drift")["w"].any()
    assert not sh.gather([0], "drift")["w"].any()


def test_version_vector_and_staleness():
    sh = tcs.ShardedStore(M, _template(), retention=4)
    sh.mark_dispatched(np.asarray([1, 4]), 3)
    np.testing.assert_array_equal(sh.staleness(np.asarray([1, 4]), 7), [4, 4])
    sh.mark_dispatched(np.asarray([4]), 7)
    np.testing.assert_array_equal(sh.staleness(np.asarray([1, 4]), 7), [4, 0])
    np.testing.assert_array_equal(sh.staleness([0], 2), [2])


def test_memory_bytes_retention_bound():
    sh = tcs.ShardedStore(M, _template(), retention=4, track_norms=True)
    mem = sh.memory_bytes()
    per_client = mem["client_bytes"]
    assert per_client == 321 * 4
    assert mem["dense_equiv_bytes"] == per_client * M
    assert mem["residual_bytes"] == per_client * (4 + 1)
    assert mem["residual_bytes"] * M <= 5 * mem["dense_equiv_bytes"]
    assert mem["vector_bytes"] == M * (8 + 4) + 4 * (8 + 8)
    dense = tcs.DenseStore(M, _template()).memory_bytes()
    assert dense["residual_bytes"] == dense["dense_equiv_bytes"]
    assert dense["vector_bytes"] == M * 8
