"""The port's pod round (``repro_torch.launch.fedtrain``) and the axis-0
wire budget against the reference on the CPU.

Shapes are the reference's own pod-round tests': ``qwen2-1.5b.reduced()``
(one layer, d_model 256, vocab 512), C = 4 clients, E = 2 local steps, b =
2 sequences of T = 32 tokens, learning rate 0.5, gamma 0.3.  Parameters
are the reference's, carried over by ``bridge.params_from_numpy``; tokens
come from numpy with a seed.

Tolerances.
- Discrete outputs exact: keep masks (both routes, on the same deltas),
  ``num_sampled``, wire slots and bytes.
- The local update (fp32 compute): deltas and losses rtol 1e-4 / atol
  1e-5; the weighted upload of the same masked deltas rtol 1e-6 (fp32
  sums of bf16 products in another order).
- The round, fp32 compute: ``mean_loss`` rtol 1e-4; every parameter
  within atol 1e-3, and all but 0.01% of them within rtol 1e-4 / atol
  1e-5.  The remainder is where the two packages' fp32 deltas (1e-5
  apart, relative) round to different bf16 values for the upload (one
  bf16 ulp, 2^-8 relative, of a weighted delta) or sit on a client's
  threshold (about 15 of 623,616 entries here).
- The round, the config's bf16 compute: ``mean_loss`` rtol 1e-3; with a
  dense upload every parameter within atol 1e-3 (PERF.md section 2's
  round tolerance).  With masking, XLA's fused bf16 chains and torch's
  rounding after each op move the deltas by about 1%, so entries near a
  client's threshold flip: at least 99% of the parameters within atol
  1e-3 and the update's relative L2 difference under 0.1.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import get_arch as ref_get_arch
from repro.core import codecs as ref_codecs
from repro.core import strategy as ref_strategy
from repro.launch import fedtrain as ref_ft
from repro.models import transformer as ref_tr
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import codecs
from repro_torch.core import strategy
from repro_torch.launch import fedtrain as ft

C, E, B, T = 4, 2, 2, 32
LR, GAMMA = 0.5, 0.3
PART = np.array([1.0, 0.0, 1.0, 1.0], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: with several test workers on one machine, torch's
    intra-op threads only contend (the tier-1 run's six workers made
    these files about ten times slower).  Restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfgs(dtype: str):
    return (dataclasses.replace(get_arch("qwen2-1.5b").reduced(),
                                compute_dtype=dtype),
            dataclasses.replace(ref_get_arch("qwen2-1.5b").reduced(),
                                compute_dtype=dtype))


def _fed_cfgs(num_clients=C, **kw):
    kw = {"local_steps": E, "learning_rate": LR, "gamma": GAMMA, **kw}
    return (ft.FedPodConfig(num_clients=num_clients, **kw),
            ref_ft.FedPodConfig(num_clients=num_clients, **kw))


def _problem(dtype: str, num_clients: int = C, seed: int = 1):
    cfg, rcfg = _cfgs(dtype)
    ref_params = ref_tr.init_params(jax.random.PRNGKey(0), rcfg)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                      device="cpu")
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (num_clients, E, B, T)).astype(np.int32)
    batches = {"tokens": toks, "labels": np.roll(toks, -1, -1)}
    return cfg, rcfg, params, ref_params, batches


def _torch_batches(batches):
    return {k: torch.from_numpy(v.copy()) for k, v in batches.items()}


def _flat(tree) -> dict:
    return bridge.flatten_tree(jax.tree.map(np.asarray, tree))


def _vector(d: dict) -> np.ndarray:
    return np.concatenate([np.asarray(v, np.float32).ravel()
                           for v in d.values()])


# ------------------------------------------------------ the axis-0 wire
SHAPES = {"a": (40, 40), "b": (1000,), "c": (3, 2, 257), "d": (28, 256),
          "e": (8, 8), "f": (152, 3)}


@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("gamma", [0.1, 0.3, 0.5])
def test_axis0_codec_slots_and_wire_bytes_match_reference(chain, gamma):
    port = codecs.SparseCodec(gamma=gamma, axis0_slices=not chain)
    ref = ref_codecs.SparseCodec(gamma=gamma, axis0_slices=not chain)
    if chain:
        port = codecs.with_axis0_slices(
            codecs.ChainCodec((codecs.SparseCodec(gamma=gamma),
                               codecs.Int8Codec())))
        ref = ref_codecs.with_axis0_slices(
            ref_codecs.ChainCodec((ref_codecs.SparseCodec(gamma=gamma),
                                   ref_codecs.Int8Codec())))
        assert port.stages[0].axis0_slices and ref.stages[0].axis0_slices
    assert port.name == ref.name
    sparse, ref_sparse = (port.stages[0], ref.stages[0]) if chain \
        else (port, ref)
    for name, shape in SHAPES.items():
        leaf = jnp.zeros(shape, jnp.float32)
        assert sparse._leaf_slots(shape) == ref_sparse._leaf_slots(leaf), name
    tree = {k: torch.zeros(s) for k, s in SHAPES.items()}
    ref_tree = {k: jnp.zeros(s, jnp.float32) for k, s in SHAPES.items()}
    assert port.wire_bytes(tree) == ref.wire_bytes(ref_tree)


def test_axis0_wire_bytes_of_the_reduced_model_match_reference():
    cfg, rcfg, params, ref_params, _ = _problem("float32")
    for name in ("fig5", "fig5-int8"):          # a sparse stage, a chain
        port = ft.FedPodConfig.from_strategy(strategy.get(name), C).codec
        ref = ref_ft.FedPodConfig.from_strategy(ref_strategy.get(name),
                                                C).codec
        assert port.wire_bytes(params) == ref.wire_bytes(ref_params), name


def test_axis0_roundtrip_is_exact_within_the_slice_budget():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 5, 300), generator=gen)
    cfg, _ = _fed_cfgs(2, gamma=0.2)
    masked = ft.mask_deltas({"w": x}, cfg)
    codec = codecs.SparseCodec(gamma=0.2, min_leaf_size=1, axis0_slices=True)
    back = codecs.roundtrip_stacked(codec, masked)
    assert torch.equal(back["w"], masked["w"])


def test_from_strategy_matches_reference_for_every_preset():
    assert set(strategy.names()) == set(ref_strategy.names())
    for name in ref_strategy.names():
        port = ft.FedPodConfig.from_strategy(strategy.get(name), 8, 3)
        ref = ref_ft.FedPodConfig.from_strategy(ref_strategy.get(name), 8, 3)
        for field in dataclasses.fields(ref):
            a, b = getattr(port, field.name), getattr(ref, field.name)
            if field.name == "codec":
                assert a.name == b.name, name
                stages = getattr(a, "stages", (a,))
                ref_stages = getattr(b, "stages", (b,))
                assert [getattr(s, "axis0_slices", None) for s in stages] == \
                    [getattr(s, "axis0_slices", None) for s in ref_stages]
            else:
                assert a == b, (name, field.name)


# ------------------------------------------------------------- masking
def test_threshold_mask_keep_bits_exact():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (3, 2, 257)))
    for shape in ((3, 2, 257), (3, 514)):
        xs = x.reshape(shape)
        ref = np.asarray(ref_ft._threshold_mask(jnp.asarray(xs), 0.25, 40))
        got = ft._threshold_mask(torch.from_numpy(xs.copy()), 0.25, 40)
        assert np.array_equal(ref != 0, got.numpy() != 0)
        assert np.array_equal(ref, got.numpy())


def _deltas(seed: int):
    key = jax.random.PRNGKey(seed)
    x = jax.random.normal(key, (2, 3, 1024)).at[:, 1].multiply(0.01)
    return {"w": jax.random.normal(key, (2, 40, 40)),
            "v": jax.random.normal(jax.random.fold_in(key, 1), (2, 1000)),
            "stack": x,
            "small": jax.random.normal(jax.random.fold_in(key, 2), (2, 50))}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mask_deltas_keep_bits_exact(use_kernel):
    deltas = _deltas(9)
    port_cfg, ref_cfg = _fed_cfgs(2, gamma=0.2, use_kernel=use_kernel)
    ref = ref_ft.mask_deltas(jax.random.PRNGKey(9), deltas, ref_cfg)
    got = ft.mask_deltas({k: torch.from_numpy(np.array(v))
                          for k, v in deltas.items()}, port_cfg)
    for name in deltas:
        r = np.asarray(ref[name])
        assert np.array_equal(r != 0, got[name].numpy() != 0), name
        assert np.array_equal(r, got[name].numpy()), name
    for c in range(2):               # per slice, as Alg. 4's layer loop
        for g in range(3):
            kept = int((got["stack"][c, g] != 0).sum())
            k = round(0.2 * 1024)
            assert int(0.9 * k) - 2 <= kept <= k


def test_random_mask_exact_with_the_reference_scores():
    deltas = _deltas(4)
    port_cfg, ref_cfg = _fed_cfgs(2, gamma=0.3, masking="random")
    key = jax.random.PRNGKey(5)
    ref = ref_ft.mask_deltas(key, deltas, ref_cfg)
    leaves, treedef = jax.tree_util.tree_flatten(deltas)
    keys = jax.random.split(key, len(leaves))
    scores = {}
    for leaf, lk in zip(leaves, keys):      # the reference's own draws
        lead = leaf.shape[:2] if leaf.ndim > 2 else leaf.shape[:1]
        draw = jax.random.uniform(lk, lead + (leaf.size // int(np.prod(lead)),))
        scores[id(leaf)] = np.asarray(draw)
    names = jax.tree_util.tree_unflatten(treedef, list(range(len(leaves))))
    port_scores = {name: torch.from_numpy(scores[id(leaves[i])].copy())
                   for name, i in names.items()}
    got = ft.mask_deltas({k: torch.from_numpy(np.array(v))
                          for k, v in deltas.items()}, port_cfg, port_scores)
    for name in deltas:
        assert np.array_equal(np.asarray(ref[name]), got[name].numpy()), name


# ------------------------------------------------------------- the round
@pytest.fixture(scope="module")
def fp32_round():
    """Both packages' round, local updates and masks, fp32 compute."""
    cfg, rcfg, params, ref_params, batches = _problem("float32")
    port_cfg, ref_cfg = _fed_cfgs()
    ns = np.ones((C,), np.float32)
    ref_new, ref_m = jax.jit(ref_ft.make_fed_round(rcfg, ref_cfg))(
        ref_params, batches, ns, PART, jax.random.PRNGKey(1))
    seen = {}
    new, m = ft.make_fed_round(cfg, port_cfg, observe=lambda c, d, k:
                               seen.setdefault(c, (d, k)))(
        params, _torch_batches(batches), torch.from_numpy(ns),
        torch.from_numpy(PART))
    ref_deltas, ref_losses = jax.vmap(lambda b: ref_ft._make_local_update(
        rcfg, ref_cfg)(ref_params, b))(batches)
    return {"cfg": cfg, "params": params, "ref_new": _flat(ref_new),
            "ref_m": ref_m, "new": new, "m": m, "seen": seen,
            "ref_deltas": _flat(ref_deltas), "ref_losses": ref_losses,
            "batches": batches}


def test_local_update_matches_reference(fp32_round):
    run = fp32_round
    local = ft._make_local_update(run["cfg"], _fed_cfgs()[0])
    for c in range(C):
        delta, loss = local(run["params"], {k: torch.from_numpy(v[c].copy())
                                            for k, v in run["batches"].items()})
        np.testing.assert_allclose(float(loss), float(run["ref_losses"][c]),
                                   rtol=1e-4)
        for name, d in delta.items():
            np.testing.assert_allclose(d.numpy(), run["ref_deltas"][name][c],
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_weighted_upload_matches_reference(fp32_round):
    masked = {k: v for k, v in run_masks(fp32_round).items()}
    w = np.array([0.25, 0.0, 0.5, 0.25], np.float32)
    ref = _flat(ref_ft._weighted_upload(
        jnp.asarray(w), bridge.unflatten_tree(
            {k: jnp.asarray(v) for k, v in masked.items()})))
    got = ft._weighted_upload(torch.from_numpy(w),
                              {k: torch.from_numpy(v) for k, v in masked.items()})
    for name in masked:
        assert got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].numpy(), ref[name], rtol=1e-6,
                                   atol=1e-9, err_msg=name)


def run_masks(run) -> dict:
    """The port's round's masked deltas, (C, ...) numpy per leaf."""
    return {name: np.stack([run["seen"][c][1][name][0].numpy()
                            for c in range(C)])
            for name in run["params"]}


def test_fed_round_masks_are_mask_deltas_of_its_deltas(fp32_round):
    cfg, _ = _fed_cfgs()
    for c, (delta, masked) in fp32_round["seen"].items():
        again = ft.mask_deltas(delta, cfg)
        for name in masked:
            assert torch.equal(again[name], masked[name]), (c, name)


def test_fed_round_matches_reference_fp32(fp32_round):
    run = fp32_round
    assert float(run["m"]["num_sampled"]) == float(run["ref_m"]["num_sampled"]) \
        == 3.0
    np.testing.assert_allclose(float(run["m"]["mean_loss"]),
                               float(run["ref_m"]["mean_loss"]), rtol=1e-4)
    ref, got = _vector(run["ref_new"]), _vector(run["new"])
    diff = np.abs(ref - got)
    assert diff.max() <= 1e-3
    outside = diff > 1e-5 + 1e-4 * np.abs(ref)
    assert outside.sum() <= 1e-4 * ref.size, outside.sum()


@pytest.mark.parametrize("masking", ["none", "selective"])
def test_fed_round_matches_reference_bf16(masking):
    cfg, rcfg, params, ref_params, batches = _problem("bfloat16")
    port_cfg, ref_cfg = _fed_cfgs(masking=masking)
    ns = np.ones((C,), np.float32)
    ref_new, ref_m = jax.jit(ref_ft.make_fed_round(rcfg, ref_cfg))(
        ref_params, batches, ns, PART, jax.random.PRNGKey(1))
    new, m = ft.make_fed_round(cfg, port_cfg)(
        params, _torch_batches(batches), torch.from_numpy(ns),
        torch.from_numpy(PART))
    assert float(m["num_sampled"]) == float(ref_m["num_sampled"]) == 3.0
    np.testing.assert_allclose(float(m["mean_loss"]),
                               float(ref_m["mean_loss"]), rtol=1e-3)
    ref, got = _vector(_flat(ref_new)), _vector(new)
    base = _vector(params)
    diff = np.abs(ref - got)
    if masking == "none":
        assert diff.max() <= 1e-3
    else:
        assert (diff > 1e-3).mean() < 0.01
        assert np.linalg.norm((ref - base) - (got - base)) \
            < 0.1 * np.linalg.norm(ref - base)


def test_fed_round_kernel_route_matches_reference():
    cfg, rcfg, params, ref_params, batches = _problem("float32")
    port_cfg, ref_cfg = _fed_cfgs(use_kernel=True)
    ns = np.ones((C,), np.float32)
    ref_new, ref_m = jax.jit(ref_ft.make_fed_round(rcfg, ref_cfg))(
        ref_params, batches, ns, PART, jax.random.PRNGKey(1))
    new, m = ft.make_fed_round(cfg, port_cfg)(
        params, _torch_batches(batches), torch.from_numpy(ns),
        torch.from_numpy(PART))
    assert float(m["num_sampled"]) == float(ref_m["num_sampled"])
    np.testing.assert_allclose(float(m["mean_loss"]),
                               float(ref_m["mean_loss"]), rtol=1e-4)
    ref, got = _vector(_flat(ref_new)), _vector(new)
    diff = np.abs(ref - got)
    assert diff.max() <= 1e-3
    assert (diff > 1e-5 + 1e-4 * np.abs(ref)).sum() <= 1e-4 * ref.size


def test_fed_round_learns():
    """The reference's three-round check: participation respected, the
    loss falls."""
    cfg, _, params, _, batches = _problem("bfloat16")
    port_cfg, _ = _fed_cfgs()
    fed_round = ft.make_fed_round(cfg, port_cfg)
    tb = _torch_batches(batches)
    part = torch.tensor([1.0, 1.0, 1.0, 0.0])
    losses = []
    for t in range(3):
        params, m = fed_round(params, tb, torch.ones(C), part, key=(0, t))
        assert int(m["num_sampled"]) == 3
        losses.append(float(m["mean_loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# ------------------------------------------------------ the cohort form
def test_cohort_round_world_size_one_equals_full_round(fp32_round):
    run = fp32_round
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        cohort = ft.make_cohort_fed_round(run["cfg"], _fed_cfgs()[0], 4)
        new, m = cohort(run["params"], _torch_batches(run["batches"]),
                        torch.ones(C), [0, 1, 2, 3], torch.from_numpy(PART))
    finally:
        dist.destroy_process_group()
    assert float(m["num_sampled"]) == float(run["m"]["num_sampled"])
    np.testing.assert_allclose(float(m["mean_loss"]),
                               float(run["m"]["mean_loss"]), rtol=1e-6)
    for name, p in new.items():
        np.testing.assert_allclose(p.numpy(), run["new"][name].numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=name)


def _two_rank_problem():
    """8 registered clients, the reduced model from a torch seed, and two
    cohorts: A = all of C = 4 (a cohort of 4), B = 5 participants of 8 in
    a cohort of 6 (one padding slot)."""
    cfg = get_arch("qwen2-1.5b").reduced()
    from repro_torch.models import transformer as tr
    params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (8, E, B, T)).astype(np.int32))
    batches = {"tokens": toks, "labels": torch.roll(toks, -1, -1)}
    part8 = torch.tensor([1., 0., 1., 1., 0., 1., 0., 1.])
    cases = {"A": (4, [0, 1, 2, 3], torch.tensor([1., 0., 1., 1.])),
             "B": (8, [0, 2, 3, 5, 7, 1], torch.tensor([1.] * 5 + [0.]))}
    return cfg, params, batches, part8, cases


def _rank_main(rank: int, path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}/store",
                            rank=rank, world_size=2)
    try:
        cfg, params, batches, _, cases = _two_rank_problem()
        out = {}
        try:
            ft.make_cohort_fed_round(cfg, ft.FedPodConfig(num_clients=8), 3)
        except ValueError as e:
            out["odd_cohort"] = str(e)
        for name, (num, ids, valid) in cases.items():
            seen = {}
            fed_cfg = ft.FedPodConfig(num_clients=num, local_steps=E,
                                      learning_rate=LR, gamma=GAMMA)
            cohort = ft.make_cohort_fed_round(
                cfg, fed_cfg, len(ids),
                observe=lambda c, d, k, seen=seen: seen.__setitem__(c, k))
            sub = {k: v[:num] for k, v in batches.items()}
            new, m = cohort(params, sub, torch.ones(num), ids, valid)
            out[name] = (new, {k: float(v) for k, v in m.items()}, seen)
        torch.save(out, os.path.join(path, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_cohort_round_on_two_gloo_processes_equals_full_round(tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for r in range(2):          # a cohort the ranks cannot split evenly
        assert "not divisible by the world size (2)" in ranks[r]["odd_cohort"]

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg, params, batches, part8, cases = _two_rank_problem()
        for name, (num, ids, valid) in cases.items():
            full_part = part8[:num] if name == "B" else valid
            seen = {}
            fed_cfg = ft.FedPodConfig(num_clients=num, local_steps=E,
                                      learning_rate=LR, gamma=GAMMA)
            new, m = ft.make_fed_round(
                cfg, fed_cfg, observe=lambda c, d, k: seen.__setitem__(c, k))(
                params, {k: v[:num] for k, v in batches.items()},
                torch.ones(num), full_part)
            masks = {**ranks[0][name][2], **ranks[1][name][2]}
            assert sorted(masks) == sorted(ids)
            for c, mask in masks.items():          # identical masks
                for leaf, v in mask.items():
                    assert torch.equal(v, seen[c][leaf]), (name, c, leaf)
            for r in range(2):
                got, metrics, _ = ranks[r][name]
                assert metrics["num_sampled"] == float(m["num_sampled"])
                np.testing.assert_allclose(metrics["mean_loss"],
                                           float(m["mean_loss"]), rtol=1e-6)
                for leaf, p in got.items():
                    np.testing.assert_allclose(p.numpy(), new[leaf].numpy(),
                                               rtol=0, atol=1e-5)
    finally:
        torch.set_num_threads(saved)
