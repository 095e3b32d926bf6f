"""The port's last four zoo configs against the reference on the CPU: the
two modality stubs (``audio_stub``: musicgen-medium; ``vision_stub`` with
prefix embeddings: internvl2-26b), qwen2-72b and llama4-maverick-400b-a17b
(chunked attention, top-1 MoE with a shared expert on alternating layers),
the musicgen pod round on kernels 1-3's plain versions, and the three
examples.

Each case builds the reference's parameters once (``PRNGKey(0)``),
carries them across the bridge, and runs the same numpy tokens (seed 1)
through both packages: ``forward``, ``lm_loss`` with its gradients, every
decode step, and greedy ``generate``.

Cases (``reduced()`` configs: d 256, vocab 512, 4 heads of 32):
- ``musicgen``: 1 layer, 4 codebooks (a 2048-row embedding and head),
  LayerNorm, plain GELU; (2, 4, 16) token grids, (2, 16, 4, 512) logits;
- ``internvl2``: 1 layer, 8 prefix embeddings (numpy, seed 2) before 16
  tokens; decode runs the tokens alone, as the reference's does;
- ``qwen2-72b``: 1 layer, QKV bias;
- ``llama4``: the whole 4-layer pattern (chunked attention in windows of
  32 on three, full on the fourth; top 1 of 4 experts and a shared expert
  on the first and third), 40 tokens so a chunk boundary is crossed; fp32
  only: a bf16 activation near a routing tie may pick another expert.

Tolerances (those of ``tests/test_torch_serve.py`` and
``tests/test_torch_train.py``).
- fp32: logits rtol 1e-4 / atol 1e-4; the loss rtol 1e-5; gradients rtol
  1e-4 / atol 1e-5; greedy tokens and llama4's routing (expert ids,
  capacity positions, keep masks) exact.
- bf16 compute: logits atol 0.125 (XLA fuses bf16 chains and rounds once
  where torch rounds after each op); the loss rtol 1e-3 and each gradient
  leaf within 2% of its largest magnitude; greedy tokens held to the
  port's own second run.
- forward == decode, fp32: atol 2e-3 / rtol 1e-3 (the reference's
  ``tests/test_models.py``).
- The musicgen pod round (d 128, vocab 128, fp32 compute, C = 4, E = 2,
  kernel route): keep masks exact on the reference's deltas;
  ``num_sampled`` exact, ``mean_loss`` rtol 1e-4, parameters within
  ``tests/test_torch_fedtrain.py``'s bounds.
"""

import dataclasses
import inspect
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch import fedtrain as ref_ft
from repro.launch import serve as ref_serve
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tr
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.launch import fedtrain as ft
from repro_torch.launch import serve, steps
from repro_torch.models import moe
from repro_torch.models import transformer as tr

ROOT = Path(__file__).resolve().parents[1]
B = 2
PROMPT, GEN = 8, 6
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=0.0, atol=0.125)
CONSISTENCY_TOL = dict(rtol=1e-3, atol=2e-3)
CASE_ARCH = {"musicgen": "musicgen-medium", "internvl2": "internvl2-26b",
             "qwen2-72b": "qwen2-72b", "llama4": "llama4-maverick-400b-a17b"}
CASE_T = {"musicgen": 16, "internvl2": 16, "qwen2-72b": 16, "llama4": 40}
CASES = [(case, dtype) for case in ("musicgen", "internvl2", "qwen2-72b")
         for dtype in ("float32", "bfloat16")] + [("llama4", "float32")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many tiny torch ops: with several test workers on one machine,
    intra-op threads only contend.  Restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(get, case: str, dtype: str):
    return dataclasses.replace(get(CASE_ARCH[case]).reduced(),
                               compute_dtype=dtype, param_dtype_serve=dtype)


def _inputs(cfg, T: int):
    """Tokens (B, T) or (B, K, T), labels (the tokens shifted by one) and,
    for a vision config, (B, P, d) prefix embeddings, all numpy."""
    rng = np.random.default_rng(1)
    shape = (B, cfg.num_codebooks, T) if cfg.modality == "audio_stub" \
        else (B, T)
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, -1)}
    if cfg.modality == "vision_stub":
        batch["prefix_embeds"] = np.random.default_rng(2).standard_normal(
            (B, cfg.num_prefix_embeddings, cfg.d_model)).astype(np.float32)
    return batch


def _tb(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def run(request):
    """Both packages' inputs and the reference's outputs for one case."""
    case, dtype = request.param
    cfg, rcfg = _cfg(get_arch, case, dtype), _cfg(ref_get_arch, case, dtype)
    key = jax.random.PRNGKey(0)
    ref_params = ref_tr.init_params(key, rcfg, dtype)
    ref_train = ref_tr.init_params(key, rcfg, "float32")
    T = CASE_T[case]
    batch = _inputs(cfg, T)
    prefix = batch.get("prefix_embeds")
    out = {"case": case, "dtype": dtype, "cfg": cfg, "T": T,
           "batch": batch,
           "params": bridge.params_from_numpy(
               jax.tree.map(np.asarray, ref_params), device="cpu"),
           "train_params": bridge.params_from_numpy(
               jax.tree.map(np.asarray, ref_train), device="cpu")}
    ref_logits, ref_aux = jax.jit(lambda p, t, e: ref_tr.forward(
        p, rcfg, t, e))(ref_params, batch["tokens"], prefix)
    out["ref_logits"] = np.asarray(ref_logits, np.float32)
    out["ref_aux"] = float(ref_aux)
    ref_batch = dict(batch)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_tr.lm_loss(p, rcfg, b)))(ref_train, ref_batch)
    out["ref_loss"] = float(loss)
    out["ref_grads"] = bridge.flatten_tree(
        jax.tree.map(lambda g: np.asarray(g, np.float32), grads))
    step = jax.jit(lambda p, s, t: ref_tr.decode_step(p, rcfg, s, t))
    state = ref_tr.init_decode_state(rcfg, B, T + 1, dtype)
    dec = []
    for t in range(T):
        lg, state = step(ref_params, state, batch["tokens"][..., t:t + 1])
        dec.append(np.asarray(lg))
    out["ref_decode"] = np.concatenate(dec, 1)
    if dtype == "float32":
        out["ref_generate"] = np.asarray(ref_serve.generate(
            rcfg, ref_params, jnp.asarray(batch["tokens"][..., :PROMPT]),
            GEN, PROMPT + GEN + 1, 0.0, 0))
    return out


def _tol(run):
    return FP32_TOL if run["dtype"] == "float32" else BF16_TOL


def _prefix(run):
    p = run["batch"].get("prefix_embeds")
    return None if p is None else torch.from_numpy(p.copy())


# ------------------------------------------------------------- the configs
def test_new_archs_register_with_the_reference_widths():
    full = {"musicgen-medium": 1_384_418_304, "internvl2-26b": 19_862_722_560,
            "qwen2-72b": 72_706_203_648,
            "llama4-maverick-400b-a17b": 400_713_815_040}
    for arch, n in full.items():
        cfg = get_arch(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            ref_get_arch(arch))
        assert tr.param_count(steps.params_specs(cfg)) == n, arch
    audio = steps.params_specs(get_arch("musicgen-medium"))
    assert tuple(audio["embed"].shape) == (4 * 2048, 1536)
    assert tuple(audio["lm_head"].shape) == (1536, 4 * 2048)
    llama = get_arch("llama4-maverick-400b-a17b")
    assert llama.padded_experts == 128 and llama.moe_topk == 1
    assert {str(t.dtype) for n, t in steps.params_specs(llama).items()
            if not n.endswith(".router")} == {"torch.bfloat16"}


# ---------------------------------------------------------- the reduced runs
def test_forward_logits_match_reference(run):
    cfg = run["cfg"]
    with torch.no_grad():
        logits, aux = tr.forward(run["params"], cfg,
                                 torch.from_numpy(run["batch"]["tokens"]),
                                 _prefix(run))
    T = run["T"] + cfg.num_prefix_embeddings
    want = (B, T, cfg.num_codebooks, cfg.vocab_size) \
        if run["case"] == "musicgen" else (B, T, tr.padded_vocab(cfg))
    assert tuple(logits.shape) == want
    assert logits.dtype == tr._dt(run["dtype"])
    if run["case"] == "llama4":
        assert float(aux) > 0.0
        np.testing.assert_allclose(float(aux), run["ref_aux"], rtol=1e-5)
    else:
        assert float(aux) == run["ref_aux"] == 0.0
    np.testing.assert_allclose(logits.float().numpy(), run["ref_logits"],
                               **_tol(run))
    prefill = steps.make_prefill_step(cfg)(run["params"], _tb(run["batch"]))
    assert prefill.dtype == torch.float32
    np.testing.assert_allclose(prefill.numpy(), run["ref_logits"][:, -1],
                               **_tol(run))


def test_lm_loss_and_gradients_match_reference(run):
    """fp32 master weights under the case's compute dtype, as the
    reference's ``lm_loss`` takes them."""
    leaves = {k: v.clone().requires_grad_()
              for k, v in run["train_params"].items()}
    loss = tr.lm_loss(leaves, run["cfg"], _tb(run["batch"]))
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    assert set(grads) == set(run["ref_grads"])
    if run["dtype"] == "float32":
        np.testing.assert_allclose(float(loss.detach()), run["ref_loss"],
                                   rtol=1e-5)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), run["ref_grads"][name],
                                       rtol=1e-4, atol=1e-5, err_msg=name)
    else:
        np.testing.assert_allclose(float(loss.detach()), run["ref_loss"],
                                   rtol=1e-3)
        for name, g in grads.items():
            want = run["ref_grads"][name]
            err = np.abs(g.float().numpy() - want).max()
            assert err <= 0.02 * np.abs(want).max(), (name, err)
    if run["case"] == "internvl2":      # the prefix positions carry weight 0
        P = run["cfg"].num_prefix_embeddings
        b = _tb(run["batch"])
        b["labels"] = b["labels"].clone()
        with torch.no_grad():
            logits, _ = tr.forward(run["train_params"], run["cfg"],
                                   b["tokens"], b["prefix_embeds"])
            text = tr.cross_entropy(logits[:, P:], b["labels"])
            np.testing.assert_allclose(
                float(tr.lm_loss(run["train_params"], run["cfg"], b)),
                float(text), rtol=1e-6)


def test_decode_steps_match_reference(run):
    cfg = run["cfg"]
    serve_step = steps.make_serve_step(cfg)
    state = tr.init_decode_state(cfg, B, run["T"] + 1, device="cpu")
    toks = torch.from_numpy(run["batch"]["tokens"])
    view = tr.layer_view(run["params"], cfg)
    got = []
    for t in range(run["T"]):
        lg, state = serve_step(view, state, {"tokens": toks[..., t:t + 1]})
        got.append(lg)
    got = torch.cat(got, 1)
    want = (B, run["T"], cfg.num_codebooks, cfg.vocab_size) \
        if run["case"] == "musicgen" else (B, run["T"], cfg.vocab_size)
    assert tuple(got.shape) == want and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), run["ref_decode"], **_tol(run))


def test_generate_greedy_matches_reference(run):
    cfg = run["cfg"]
    prompts = torch.from_numpy(run["batch"]["tokens"][..., :PROMPT].copy())
    got = serve.generate(cfg, run["params"], prompts, GEN, PROMPT + GEN + 1)
    assert tuple(got.shape) == tuple(prompts.shape[:-1]) + (GEN,)
    assert got.dtype == torch.int32
    assert int(got.min()) >= 0 and int(got.max()) < cfg.vocab_size
    if run["dtype"] == "float32":
        assert np.array_equal(got.numpy(), run["ref_generate"])
    else:
        assert torch.equal(got, serve.generate(cfg, run["params"], prompts,
                                               GEN, PROMPT + GEN + 1))


@pytest.mark.parametrize("case", ["musicgen", "internvl2", "qwen2-72b"])
def test_decode_agrees_with_forward(case):
    """The port's own serve == prefill check in fp32, as
    ``tests/test_torch_serve.py``'s; internvl2 with a zero-length prefix
    (B, 0, d), which the reference's forward accepts.  Not llama4: its
    decode routes each step's B tokens as one group of capacity 1."""
    cfg = _cfg(get_arch, case, "float32")
    params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                            "float32", device="cpu")
    T = CASE_T[case]
    toks = torch.from_numpy(_inputs(cfg, T)["tokens"])
    prefix = torch.zeros((B, 0, cfg.d_model)) \
        if cfg.modality == "vision_stub" else None
    model = tr.Decoder(cfg, params)
    state = tr.init_decode_state(cfg, B, T + 1, device="cpu")
    with torch.no_grad():
        fwd = model(toks, prefix)
        if case != "musicgen":
            fwd = fwd[..., :cfg.vocab_size]
        dec = []
        for t in range(T):
            lg, state = model.decode_step(state, toks[..., t:t + 1])
            dec.append(lg)
    np.testing.assert_allclose(torch.cat(dec, 1).numpy(), fwd.numpy(),
                               **CONSISTENCY_TOL)


# ------------------------------------------------------- llama4's routing
def _reference_routing(router, x, topk: int, group: int = 512):
    """The reference's routing lines (``src/repro/models/moe.py``: the
    softmax, ``lax.top_k``, the token-major cumsum and the capacity) on
    one MoE layer's captured inputs."""
    n, d = x.shape[0] * x.shape[1], x.shape[2]
    g = min(group, n)
    G = -(-n // g)
    xg = jnp.pad(jnp.asarray(x).reshape(n, d),
                 ((0, G * g - n), (0, 0))).reshape(G, g, d)
    probs = jax.nn.softmax(xg.astype(jnp.float32) @ router, axis=-1)
    _, ids = jax.lax.top_k(probs, topk)
    E = router.shape[1]
    cap = max(1, int(g * topk / E * 1.25))
    flat = jax.nn.one_hot(ids, E, dtype=jnp.int32).reshape(G, g * topk, E)
    pos = jnp.max(jnp.cumsum(flat, axis=1) * flat - 1,
                  axis=-1).reshape(G, g, topk)
    return np.asarray(ids), np.asarray(pos), np.asarray((pos < cap) &
                                                        (pos >= 0)), cap


def test_llama4_routing_matches_reference(monkeypatch):
    """Every MoE layer of the reduced llama4 forward (top 1 of 4 experts,
    2 x 40 tokens in one group): the port's expert ids, capacity positions
    and keep masks equal the reference's on the reference's own layer
    inputs, captured from its jitted forward."""
    cfg, rcfg = (_cfg(get, "llama4", "float32")
                 for get in (get_arch, ref_get_arch))
    ref_params = ref_tr.init_params(jax.random.PRNGKey(0), rcfg, "float32")
    toks = _inputs(cfg, CASE_T["llama4"])["tokens"]
    captured = []
    original = ref_moe.moe_ffn

    def capture(params, x, **kw):
        jax.debug.callback(lambda r, v: captured.append(
            (np.asarray(r), np.asarray(v))), params["router"], x,
            ordered=True)
        return original(params, x, **kw)

    monkeypatch.setattr(ref_moe, "moe_ffn", capture)
    jax.block_until_ready(jax.jit(lambda p, t: ref_tr.forward(p, rcfg, t))(
        ref_params, toks))
    routes = []
    route = moe.route

    def record(*args, **kw):
        r = route(*args, **kw)
        routes.append(r)
        return r

    monkeypatch.setattr(moe, "route", record)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                      device="cpu")
    with torch.no_grad():
        tr.forward(params, cfg, torch.from_numpy(toks))
    moe_layers = sum(s.mlp == "moe" for s in cfg.layer_pattern)
    assert len(routes) == len(captured) == moe_layers * cfg.num_groups == 2
    for r, (router, x) in zip(routes, captured):
        ids, pos, keep, cap = _reference_routing(router, x, cfg.moe_topk)
        assert r.capacity == cap
        assert np.array_equal(r.expert_ids.numpy(), ids)
        assert np.array_equal(r.positions.numpy(), pos)
        assert np.array_equal(r.keep.numpy(), keep)
        assert ids.shape[-1] == 1 and len(np.unique(ids)) > 1


# ------------------------------------------------- the modality contracts
def test_vision_requires_prefix_and_text_refuses_it():
    cfg = _cfg(get_arch, "internvl2", "float32")
    params = tr.init_params(None, cfg, "float32", device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="requires prefix_embeds"):
        tr.forward(params, cfg, toks)
    text = _cfg(get_arch, "qwen2-72b", "float32")
    with pytest.raises(ValueError, match="takes no prefix_embeds"):
        tr.forward(tr.init_params(None, text, "float32", device="cpu"),
                   text, toks, torch.zeros((1, 2, text.d_model)))


def test_reference_generate_drops_prefix_embeds_and_the_port_takes_none():
    """A fault of the reference (ROADMAP Queue 3): its ``generate`` takes
    ``prefix_embeds`` and never reads it, so the tokens are the same with
    and without an image.  The port's ``generate`` has no such argument."""
    rcfg = _cfg(ref_get_arch, "internvl2", "float32")
    ref_params = ref_tr.init_params(jax.random.PRNGKey(0), rcfg, "float32")
    batch = _inputs(rcfg, PROMPT)
    prompts = jnp.asarray(batch["tokens"])
    without = ref_serve.generate(rcfg, ref_params, prompts, 3, PROMPT + 4)
    image = jnp.asarray(batch["prefix_embeds"]) * 100.0
    with_image = ref_serve.generate(rcfg, ref_params, prompts, 3, PROMPT + 4,
                                    prefix_embeds=image)
    assert np.array_equal(np.asarray(without), np.asarray(with_image))
    # and the image does change the model's output where it is read
    forward = jax.jit(lambda p, t, e: ref_tr.forward(p, rcfg, t, e)[0])
    logits = [np.asarray(forward(ref_params, prompts, e))
              for e in (image, image * 0.0)]
    assert np.abs(logits[0] - logits[1]).max() > 1e-3
    assert "prefix_embeds" not in inspect.signature(serve.generate).parameters


def test_serve_cli_runs_musicgen_on_the_cpu(capsys):
    serve.main(["--arch", "musicgen-medium", "--reduced", "--batch", "2",
                "--prompt-len", "3", "--gen", "2", "--device", "cpu"])
    assert "generated (2, 4, 2) on cpu" in capsys.readouterr().out


# ------------------------------------------------- the musicgen pod round
def test_musicgen_pod_round_kernel_route_matches_reference(monkeypatch):
    """Reduced musicgen at d 128, vocab 128 (fp32 compute; 512 embedding
    rows, each its own first-axis slice) in the pod round on (C, E, b, K,
    T) codebook batches, selective masking on kernels 1-3's plain versions
    against the reference's ``make_fed_round`` on its Pallas kernels.  The
    reference's deltas and masks are read out of its jitted round; the
    port masks the same deltas."""
    C, E, b, T = 4, 2, 2, 16
    cfg, rcfg = (dataclasses.replace(
        get("musicgen-medium").reduced(d_model=128, vocab=128),
        compute_dtype="float32") for get in (get_arch, ref_get_arch))
    kw = dict(local_steps=E, learning_rate=0.5, gamma=0.3, use_kernel=True)
    port_cfg = ft.FedPodConfig(num_clients=C, **kw)
    ref_cfg = ref_ft.FedPodConfig(num_clients=C, **kw)
    ref_params = ref_tr.init_params(jax.random.PRNGKey(0), rcfg)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                      device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (C, E, b, cfg.num_codebooks, T)).astype(np.int32)
    batches = {"tokens": toks, "labels": np.roll(toks, -1, -1)}
    part = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    ns = np.ones((C,), np.float32)
    captured = []
    original = ref_ft.mask_deltas

    def capture(key, deltas, fed_cfg):
        masked = original(key, deltas, fed_cfg)
        jax.debug.callback(lambda d, m: captured.append(
            (jax.tree.map(np.asarray, d), jax.tree.map(np.asarray, m))),
            deltas, masked, ordered=True)
        return masked

    monkeypatch.setattr(ref_ft, "mask_deltas", capture)
    ref_new, ref_m = jax.jit(ref_ft.make_fed_round(rcfg, ref_cfg))(
        ref_params, batches, ns, part, jax.random.PRNGKey(1))
    new, m = ft.make_fed_round(cfg, port_cfg)(
        params, _tb(batches), torch.from_numpy(ns), torch.from_numpy(part))
    assert float(m["num_sampled"]) == float(ref_m["num_sampled"]) == 3.0
    np.testing.assert_allclose(float(m["mean_loss"]),
                               float(ref_m["mean_loss"]), rtol=1e-4)
    ref = np.concatenate([np.asarray(v, np.float32).ravel() for v in
                          bridge.flatten_tree(jax.tree.map(
                              np.asarray, ref_new)).values()])
    got = np.concatenate([v.numpy().ravel() for v in new.values()])
    diff = np.abs(ref - got)
    assert diff.max() <= 1e-3
    assert (diff > 1e-5 + 1e-4 * np.abs(ref)).sum() <= 1e-4 * ref.size
    # keep masks: the port's kernel route on the reference's own deltas
    (ref_deltas, ref_masked), = captured
    deltas = {k: torch.from_numpy(v.copy())
              for k, v in bridge.flatten_tree(ref_deltas).items()}
    masked = ft.mask_deltas(deltas, port_cfg)
    for name, want in bridge.flatten_tree(ref_masked).items():
        assert np.array_equal(masked[name].numpy() != 0, want != 0), name
        assert np.array_equal(masked[name].numpy(), want), name
    assert tuple(masked["embed"].shape) == (C, 4 * 128, 128)
    assert int((masked["embed"] != 0).sum()) > 0


# ------------------------------------------------------------- examples
def test_quickstart_torch_runs_on_the_cpu(capsys):
    demo = runpy.run_path(str(ROOT / "examples" / "quickstart_torch.py"))
    demo["main"](["--clients", "4", "--rounds", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["strategy", "accuracy", "transport",
                              "wire", "MB", "codec"]
    assert len(out) == 6
    assert out[1].split()[-1] == "identity"
    assert out[-1].split()[-1] == "sparse(gamma=0.5)+int8"


def test_federated_lm_torch_runs_on_the_cpu(capsys):
    demo = runpy.run_path(str(ROOT / "examples" / "federated_lm_torch.py"))
    demo["main"](["--clients", "2", "--rounds", "2", "--batch", "1",
                  "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "round   1: sampled=2/2" in out
    assert "done: total transport" in out


def test_comm_budget_planner_torch_prints_the_references_table(
        capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["comm_budget_planner.py"])
    runpy.run_path(str(ROOT / "examples" / "comm_budget_planner.py"),
                   run_name="__main__")
    want = capsys.readouterr().out
    port = runpy.run_path(str(ROOT / "examples" /
                              "comm_budget_planner_torch.py"))
    port["main"]([])
    got = capsys.readouterr().out
    assert got == want
    assert "llama4-maverick-400b-a17b" in got and got.count(" GB ") == 20
