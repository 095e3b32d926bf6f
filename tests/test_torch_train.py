"""The port's training path against the reference on the CPU: the cross
entropy and ``lm_loss`` with their gradients, remat, the optimizers and
schedules, ``make_train_step``, the loader and the ``launch.train`` CLI.

Model: ``qwen2-1.5b.reduced()`` (one layer, d_model 256, vocab 512; two
layers for the remat check), b = 2 sequences of T = 32 tokens from numpy
with a seed; parameters are the reference's, carried over by the bridge.

Tolerances.
- ``cross_entropy``, weighted and not, and ``lm_loss`` under fp32 compute:
  rtol 1e-5.  Their gradients against ``jax.grad``: rtol 1e-4 / atol
  1e-5.
- Under the config's bf16 compute: the loss rtol 1e-3, and each gradient
  leaf within 2% of its largest magnitude (XLA fuses bf16 chains and
  rounds once where torch rounds after each op; logits and activations
  differ by a few bf16 ulps).
- remat on and off: the same bits (the recomputed forward is the
  forward).
- Optimizers and schedules on a small tree, three updates: rtol 1e-6 /
  atol 1e-7 (Adafactor's factored means sum in other orders).
- ``make_train_step`` applies its update leaf by leaf, in place: the bits
  of the whole-tree update, under AdamW, SGD and Adafactor.
- ``make_train_step``, three AdamW steps under fp32 compute: loss and
  grad norm rtol 1e-4; all but 0.01% of the parameters within atol 2e-5,
  and the rest within the two runs' Adam steps (2 lr a step).  Adam's
  normalised step turns a gradient that is rounding noise into a step of
  up to lr: the key bias's true gradient is 0 (it shifts a query's logits
  by a constant), and a few other entries have gradients near 0.
- The loader: byte-identical arrays.
- The zoo (reduced ``rwkv6-1.6b``, ``hymba-1.5b`` cut to two layers, one
  full and one sliding, ``gemma2-2b`` and ``qwen2-moe-a2.7b``), fp32: every
  leaf's gradient (through ``Wkv6Function`` / ``SsmScanFunction``, their
  plain backwards on the CPU; through gemma2's softcaps and embedding
  scale; through the MoE's gates, experts and aux loss) against
  ``jax.grad`` of the reference's ``lm_loss``, rtol 1e-4 / atol 1e-5 as
  the qwen2 case.
- The reference's federated command on reduced rwkv6 (``--gamma 0.2
  --beta 0.1``, 2 rounds, 4 clients): ``sampled`` each round equal to the
  reference's ``DynamicSampling``, finite losses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.configs import get_arch as ref_get_arch
from repro.data import loader as ref_loader
from repro.data.synthetic import markov_text as ref_markov_text
from repro.launch import steps as ref_steps
from repro.models import transformer as ref_tr
from repro_torch import bridge, optim
from repro_torch.configs import get_arch
from repro_torch.data import loader
from repro_torch.launch import steps
from repro_torch.launch import train
from repro_torch.models import transformer as tr

B, T = 2, 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: with several test workers on one machine, torch's
    intra-op threads only contend (the tier-1 run's six workers made
    these files about ten times slower).  Restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfgs(dtype: str, **kw):
    return (dataclasses.replace(get_arch("qwen2-1.5b").reduced(**kw),
                                compute_dtype=dtype),
            dataclasses.replace(ref_get_arch("qwen2-1.5b").reduced(**kw),
                                compute_dtype=dtype))


def _batch(cfg, seed: int = 0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, -1)}


def _tb(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _port_grads(params, cfg, batch, remat=True):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    logits, aux = tr.forward(leaves, cfg, _tb(batch)["tokens"], remat=remat)
    loss = tr.cross_entropy(logits, _tb(batch)["labels"]) + \
        cfg.router_aux_coef * aux
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def loss_case(request):
    dtype = request.param
    cfg, rcfg = _cfgs(dtype)
    ref_params = ref_tr.init_params(jax.random.PRNGKey(0), rcfg)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                      device="cpu")
    batch = _batch(cfg)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: ref_tr.lm_loss(p, rcfg, batch))(ref_params)
    return {"dtype": dtype, "cfg": cfg, "params": params, "batch": batch,
            "ref_loss": float(ref_loss),
            "ref_grads": bridge.flatten_tree(
                jax.tree.map(lambda g: np.asarray(g, np.float32), ref_grads))}


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_and_its_gradient_match_reference(weighted, dtype):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((2, 16, 300))).astype(np.float32)
    labels = rng.integers(0, 300, (2, 16)).astype(np.int32)
    w = (rng.random((2, 16)) > 0.3).astype(np.float32) if weighted else None
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref, ref_g = jax.value_and_grad(
        lambda x: ref_tr.cross_entropy(x, labels, w))(jnp.asarray(logits, jdt))
    x = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    got = tr.cross_entropy(x, torch.from_numpy(labels),
                           None if w is None else torch.from_numpy(w))
    (g,) = torch.autograd.grad(got, [x])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    tol = dict(rtol=1e-5, atol=1e-7) if dtype == "float32" else \
        dict(rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(g.float().numpy(),
                               np.asarray(ref_g, np.float32), **tol)


def test_cross_entropy_masks_weight_zero_positions():
    logits = torch.randn((1, 6, 10), generator=torch.Generator().manual_seed(0))
    labels = torch.arange(6)[None] % 10
    w = torch.tensor([[0., 0., 1., 1., 1., 1.]])
    assert torch.allclose(tr.cross_entropy(logits, labels, w),
                          tr.cross_entropy(logits[:, 2:], labels[:, 2:]))


def test_lm_loss_matches_reference(loss_case):
    case = loss_case
    loss = tr.lm_loss(case["params"], case["cfg"], _tb(case["batch"]))
    rtol = 1e-5 if case["dtype"] == "float32" else 1e-3
    np.testing.assert_allclose(float(loss), case["ref_loss"], rtol=rtol)


def test_lm_loss_gradients_match_jax_grad(loss_case):
    case = loss_case
    loss, grads = _port_grads(case["params"], case["cfg"], case["batch"])
    assert list(grads) == list(case["ref_grads"])
    for name, g in grads.items():
        want = case["ref_grads"][name]
        if case["dtype"] == "float32":
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        else:
            scale = np.abs(want).max()
            assert np.abs(g.float().numpy() - want).max() <= 0.02 * scale, name


@pytest.mark.parametrize("span", [1, 2])
def test_remat_gives_the_same_gradients(span):
    cfg, _ = _cfgs("float32", num_layers=2)
    cfg = dataclasses.replace(cfg, remat_span=span)
    params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    batch = _batch(cfg, seed=2)
    loss_on, on = _port_grads(params, cfg, batch, remat=True)
    loss_off, off = _port_grads(params, cfg, batch, remat=False)
    assert loss_on == loss_off
    for name in on:
        assert torch.equal(on[name], off[name]), name


def _zoo_cfgs(arch: str):
    """fp32 reduced configs of ``arch`` for both packages; hymba's pattern
    cut to its first two layers (full attention, then sliding)."""
    out = []
    for get in (get_arch, ref_get_arch):
        cfg = dataclasses.replace(get(arch).reduced(), compute_dtype="float32")
        if arch == "hymba-1.5b":
            cfg = dataclasses.replace(cfg, layer_pattern=cfg.layer_pattern[:2],
                                      num_layers=2)
        out.append(cfg)
    return out


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b", "gemma2-2b",
                                  "qwen2-moe-a2.7b"])
def test_zoo_lm_loss_gradients_match_jax_grad(arch):
    cfg, rcfg = _zoo_cfgs(arch)
    params = tr.init_params(torch.Generator().manual_seed(1), cfg,
                            device="cpu")
    ref_params = bridge.params_to_numpy(params)
    batch = _batch(cfg, seed=4)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_tr.lm_loss(p, rcfg, batch)))(ref_params)
    ref_grads = bridge.flatten_tree(
        jax.tree.map(lambda g: np.asarray(g, np.float32), ref_grads))
    loss, grads = _port_grads(params, cfg, batch)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
    assert list(grads) == list(ref_grads)
    if cfg.moe_experts:     # the aux term reaches the router
        assert cfg.router_aux_coef > 0
        assert float(grads["layers.0.moe.router"].abs().max()) > 0
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_lm_loss_trains_through_the_plain_recurrences():
    """rwkv6 and hymba (reduced): on the CPU the wkv6 and ssm_scan plain
    versions carry gradients to every parameter."""
    for arch in ("rwkv6-1.6b", "hymba-1.5b"):
        cfg = dataclasses.replace(get_arch(arch).reduced(),
                                  compute_dtype="float32")
        if arch == "hymba-1.5b":
            cfg = dataclasses.replace(cfg, layer_pattern=cfg.layer_pattern[:1],
                                      num_layers=1)
        params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
        _, grads = _port_grads(params, cfg, _batch(cfg, seed=3))
        missing = [k for k, g in grads.items()
                   if not torch.isfinite(g).all() or
                   (g.abs().sum() == 0 and "norm" not in k)]
        assert not missing, (arch, missing)


# ------------------------------------------------------------ optimizers
TREE = {"a": (4, 3), "b": (5,), "c": (2, 3, 4)}


def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in TREE.items()}


def _flat_state(state) -> dict:
    return bridge.flatten_tree(jax.tree.map(np.asarray, state))


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd-momentum": lambda m: m.sgd(0.1, momentum=0.9),
    "sgd-nesterov": lambda m: m.sgd(0.1, momentum=0.9, nesterov=True),
    "adam": lambda m: m.adam(1e-2),
    "adamw": lambda m: m.adamw(m.warmup_cosine(1e-2, 1, 5)),
    "adafactor": lambda m: m.adafactor(m.cosine_decay(1e-2, 4)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_reference_for_three_updates(name):
    ref_opt, opt = OPTIMIZERS[name](ref_optim), OPTIMIZERS[name](optim)
    ref_p, p = _tree(0), _torch_tree(_tree(0))
    ref_s, s = ref_opt.init(ref_p), opt.init(p)
    for step in range(3):
        g = _tree(10 + step)
        ref_u, ref_s = ref_opt.update(g, ref_s, ref_p)
        u, s = opt.update(_torch_tree(g), s, p)
        ref_p = ref_optim.apply_updates(ref_p, ref_u)
        p = optim.apply_updates(p, u)
        for k in TREE:
            np.testing.assert_allclose(u[k].numpy(), np.asarray(ref_u[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    ref_flat, flat = _flat_state(ref_s), bridge.flatten_tree(s)
    assert list(flat) == list(ref_flat)
    for k, v in flat.items():
        if v is None:
            assert ref_flat[k] is None
        else:
            np.testing.assert_allclose(v.numpy(), ref_flat[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)


def test_clip_by_global_norm_matches_reference():
    g = _tree(3)
    for max_norm in (0.5, 100.0):
        ref_c, ref_n = ref_optim.clip_by_global_norm(g, max_norm)
        c, n = optim.clip_by_global_norm(_torch_tree(g), max_norm)
        np.testing.assert_allclose(float(n), float(ref_n), rtol=1e-6)
        for k in TREE:
            np.testing.assert_allclose(c[k].numpy(), np.asarray(ref_c[k]),
                                       rtol=1e-6)


@pytest.mark.parametrize("name", ["constant", "cosine_decay",
                                  "warmup_cosine"])
def test_schedules_match_reference(name):
    args = {"constant": (3e-4,), "cosine_decay": (1e-3, 10, 0.1),
            "warmup_cosine": (1e-3, 3, 10, 1e-5)}[name]
    ref_fn, fn = getattr(ref_optim, name)(*args), getattr(optim, name)(*args)
    for count in range(14):
        np.testing.assert_allclose(
            float(fn(torch.tensor(count, dtype=torch.int32))),
            float(ref_fn(jnp.asarray(count, jnp.int32))), rtol=1e-6)


# ------------------------------------------------------------ train step
def test_train_step_matches_reference_for_three_adamw_steps():
    cfg, rcfg = _cfgs("float32")
    ref_step = jax.jit(ref_steps.make_train_step(rcfg, learning_rate=1e-3))
    step = steps.make_train_step(cfg, learning_rate=1e-3)
    ref_params = ref_tr.init_params(jax.random.PRNGKey(0), rcfg)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                      device="cpu")
    ref_state = ref_steps.make_train_step(rcfg).optimizer.init(ref_params)
    state = step.optimizer.init(params)
    for i in range(3):
        batch = _batch(cfg, seed=10 + i)
        ref_params, ref_state, ref_m = ref_step(ref_params, ref_state, batch)
        params, state, m = step(params, state, _tb(batch))
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-4)
    ref_flat = bridge.flatten_tree(jax.tree.map(np.asarray, ref_params))
    assert all(v.dtype == torch.float32 for v in params.values())
    got = np.concatenate([v.numpy().ravel() for v in params.values()])
    want = np.concatenate([ref_flat[k].ravel() for k in params])
    diff = np.abs(got - want)
    assert diff.max() <= 3 * 2 * 1e-3          # 3 steps of at most lr each
    assert (diff > 2e-5).sum() <= 1e-4 * diff.size, (diff > 2e-5).sum()


@pytest.mark.parametrize("optimizer", ["adamw", "sgd", "adafactor"])
def test_train_step_updates_leaf_by_leaf_with_the_whole_tree_bits(optimizer):
    """The step clips, updates and applies one leaf at a time, in the dicts
    it was given: three steps give the bits of the whole-tree
    ``clip_by_global_norm`` / ``update`` / ``apply_updates`` path."""
    cfg, _ = _cfgs("float32")
    step = steps.make_train_step(cfg, learning_rate=1e-2,
                                 optimizer=optimizer)
    opt = step.optimizer
    params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    want = {k: v.clone() for k, v in params.items()}
    state, want_state = opt.init(params), opt.init(want)
    for i in range(3):
        batch = _tb(_batch(cfg, seed=20 + i))
        new, new_state, m = step(params, state, batch)
        assert new is params and new_state is state     # consumed
        leaves = {k: p.detach().requires_grad_() for k, p in want.items()}
        loss = tr.lm_loss(leaves, cfg, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            grads, gnorm = optim.clip_by_global_norm(
                dict(zip(want, grads)), 1.0)
            updates, want_state = opt.update(grads, want_state, want)
            want = optim.apply_updates(want, updates)
        assert float(m["loss"]) == float(loss.detach())
        assert float(m["grad_norm"]) == float(gnorm)
    assert int(state["count"]) == int(want_state["count"]) == 3
    for k in want:
        assert torch.equal(params[k], want[k]), k


def test_train_step_casts_matrices_to_the_compute_dtype():
    """bf16 compute: the loss runs on bf16 casts of the fp32 matrices and
    the master weights, gradients and optimizer state stay fp32."""
    cfg, _ = _cfgs("bfloat16")
    step = steps.make_train_step(cfg, learning_rate=1e-3)
    assert step.optimizer is not None
    params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    state = step.optimizer.init(params)
    new, state, m = step(params, state, _tb(_batch(cfg)))
    assert all(v.dtype == torch.float32 for v in new.values())
    assert all(v.dtype == torch.float32 for v in state["nu"].values())
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


# ----------------------------------------------------------------- loader
def test_loader_is_byte_identical():
    tokens = ref_markov_text(num_train=5000, seed=4).train_tokens
    x, y = loader.tokens_for_training(tokens, 4, 64, seed=7)
    rx, ry = ref_loader.tokens_for_training(tokens, 4, 64, seed=7)
    assert x.dtype == rx.dtype and x.tobytes() == rx.tobytes()
    assert y.tobytes() == ry.tobytes()
    xs, ys = x.reshape(-1, 64), y.reshape(-1, 64)
    ours, theirs = (loader.batched_stream(xs, ys, 5, seed=1),
                    ref_loader.batched_stream(xs, ys, 5, seed=1))
    for _ in range(30):                  # past one epoch
        (a, b), (c, d) = next(ours), next(theirs)
        assert a.tobytes() == c.tobytes() and b.tobytes() == d.tobytes()


# -------------------------------------------------------------------- CLI
def _losses(out: str, word: str) -> list:
    return [float(line.split("loss=")[1].split()[0])
            for line in out.splitlines() if line.startswith(word)]


def test_train_cli_runs_both_modes_and_the_loss_falls(capsys, tmp_path):
    train.main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                "--steps", "6", "--batch", "4", "--seq", "64", "--lr",
                "3e-3", "--ckpt", str(tmp_path / "std")])
    std = _losses(capsys.readouterr().out, "step")
    assert len(std) == 6 and std[-1] < std[0]
    assert (tmp_path / "std" / "step_00000006" / "manifest.json").exists()
    train.main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                "--mode", "federated", "--rounds", "4", "--clients", "4",
                "--gamma", "0.2", "--beta", "0.1", "--batch", "2", "--seq",
                "64", "--lr", "0.05"])
    out = capsys.readouterr().out
    fed = _losses(out, "round")
    assert len(fed) == 4 and fed[-1] < fed[0]
    assert "round 2: sampled=" in out and "model-units dt=" in out
    with pytest.raises(ValueError, match="mesh"):
        train.main(["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
                    "--mesh", "2x1", "--steps", "1"])


def test_train_cli_runs_the_references_federated_rwkv6_command(capsys):
    """``--arch rwkv6-1.6b --reduced --mode federated --clients 4 --gamma
    0.2 --beta 0.1``, the reference's own example, on the CPU: two rounds
    whose ``sampled`` follows the reference's DynamicSampling."""
    from repro.core.sampling import DynamicSampling
    train.main(["--arch", "rwkv6-1.6b", "--reduced", "--device", "cpu",
                "--mode", "federated", "--clients", "4", "--gamma", "0.2",
                "--beta", "0.1", "--rounds", "2", "--batch", "1", "--seq",
                "32", "--local-steps", "1"])
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("round")]
    schedule = DynamicSampling(initial_rate=1.0, beta=0.1)
    assert len(lines) == 2
    for t, line in enumerate(lines, start=1):
        sampled = int(line.split("sampled=")[1].split("/")[0])
        assert sampled == int(schedule.num_clients(t, 4)), line
    assert all(np.isfinite(x) for x in _losses("\n".join(lines), "round"))


def test_synth_batches_match_reference():
    cfg = get_arch("qwen2-1.5b").reduced()
    from repro.launch import train as ref_train
    ref = ref_train.synth_batches(ref_get_arch("qwen2-1.5b").reduced(), 3,
                                  16, 4, seed=2)
    got = train.synth_batches(cfg, 3, 16, 4, seed=2)
    for a, b in zip(got, ref):
        for k in ("tokens", "labels"):
            assert np.array_equal(a[k].numpy(), np.asarray(b[k]))
