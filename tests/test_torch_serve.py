"""The port's serving slice (configs, models/transformer, launch/steps,
launch/serve, the bridge's tuple layers) against the reference on the CPU.

Each case builds the reference's parameters once, carries them across the
bridge, and runs the same tokens through both packages: the prefill
forward, the prefill step, every decode step of a 40-token sequence, and
greedy ``generate``.  The sequence is longer than the reduced configs'
32-token sliding window, so Hymba's ring buffers wrap.

Cases (``reduced()`` configs; the reference's seed 0 for the parameters,
``fold_in(key, 1)`` for the tokens):
- ``rwkv``: rwkv6-1.6b reduced to 2 layers (2 groups of its 1-spec
  pattern), so the group loop runs twice;
- ``hymba``: hymba-1.5b reduced, its 16-spec pattern cut to the first two
  specs (full + sliding) at 4 layers, 2 groups, to keep the reference's
  compile time down; 4 heads over 4 KV heads (no GQA);
- ``hymba-gqa``: the same with 2 KV heads, which exercises the grouped
  heads as the full 25/5 config does.

Tolerances.  fp32 (params and compute): logits rtol 1e-4 with atol 1e-4
(XLA and torch sum in other orders; logits are up to about 4); greedy
tokens exact.  bf16, the serve dtype: atol 0.125 on logits up to about 4
(8 bf16 ulps there): XLA:CPU fuses chains of bf16 elementwise ops and rounds
once where torch rounds after every op, and the two round bf16 products
differently.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_arch as ref_get_arch
from repro.launch import serve as ref_serve
from repro.launch import steps as ref_steps
from repro.models import transformer as ref_tr
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.launch import serve, steps
from repro_torch.models import transformer as tr

T_SEQ = 40          # > the reduced sliding window of 32
PROMPT, GEN = 24, 16
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=0.0, atol=0.125)
FULL_PARAMS = {"rwkv6-1.6b": 1_483_280_384, "hymba-1.5b": 1_403_905_600,
               "qwen2-1.5b": 1_543_910_912}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """A decode step is hundreds of tiny torch ops: with several test
    workers on one machine, intra-op threads only contend (a 10x slowdown
    under the tier-1 run's workers).  Restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _case_cfg(get, case: str, dtype: str):
    arch = "rwkv6-1.6b" if case == "rwkv" else "hymba-1.5b"
    cfg = get(arch).reduced()
    if case == "rwkv":
        cfg = dataclasses.replace(cfg, num_layers=2)
    else:
        cfg = dataclasses.replace(cfg, layer_pattern=cfg.layer_pattern[:2],
                                  num_layers=4)
    if case == "hymba-gqa":
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    return dataclasses.replace(cfg, compute_dtype=dtype,
                               param_dtype_serve=dtype)


def _path_name(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


# --------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match_reference(arch, reduced):
    port, ref = get_arch(arch), ref_get_arch(arch)
    if reduced:
        port, ref = port.reduced(), ref.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.resolved_head_dim, port.num_groups) == \
        (ref.resolved_head_dim, ref.num_groups)


def test_unported_archs_raise_naming_the_roadmap():
    with pytest.raises(KeyError, match="item 16"):
        get_arch("gemma2-2b")
    with pytest.raises(KeyError, match="unknown"):
        get_arch("gpt-5")
    cfg = dataclasses.replace(get_arch("hymba-1.5b").reduced(),
                              modality="audio_stub")
    with pytest.raises(NotImplementedError, match="item 16"):
        tr.init_params(None, cfg, device="cpu")


# ------------------------------------------------------- params and bridge
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_param_specs_match_reference(arch):
    cfg = get_arch(arch)
    port = steps.params_specs(cfg, cfg.param_dtype_serve)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        ref_steps.params_specs(ref_get_arch(arch), cfg.param_dtype_serve))
    assert list(port) == [_path_name(path) for path, _ in flat]
    assert [tuple(t.shape) for t in port.values()] == \
        [tuple(leaf.shape) for _, leaf in flat]
    assert all(t.dtype == torch.bfloat16 for t in port.values())
    assert tr.param_count(port) == FULL_PARAMS[arch]


@pytest.mark.parametrize("case", ["rwkv", "hymba"])
def test_init_params_names_shapes_and_distributions(case):
    """Names, shapes and constants exact; random leaves at the reference's
    scale (their sample standard deviations within 15%, 30% for a leaf of
    fewer than 4096 entries)."""
    port = tr.init_params(torch.Generator().manual_seed(0),
                          _case_cfg(get_arch, case, "float32"), "float32",
                          device="cpu")
    ref = ref_tr.init_params(jax.random.PRNGKey(0),
                             _case_cfg(ref_get_arch, case, "float32"),
                             "float32")
    flat, _ = jax.tree_util.tree_flatten_with_path(ref)
    assert list(port) == [_path_name(path) for path, _ in flat]
    for (path, leaf), (name, t) in zip(flat, port.items()):
        leaf = np.asarray(leaf)
        assert tuple(t.shape) == leaf.shape, name
        if leaf.std() == 0:             # constants: norms, mixes, biases
            assert np.array_equal(t.numpy(), leaf), name
        else:                           # same scale, other random numbers
            rel = 0.15 if leaf.size >= 4096 else 0.3
            assert t.std().item() == pytest.approx(float(leaf.std()),
                                                   rel=rel), name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bridge_round_trip_with_tuple_layers(arch):
    ref = ref_tr.init_params(jax.random.PRNGKey(1),
                             ref_get_arch(arch).reduced(), "float32")
    port = bridge.params_from_numpy(jax.tree.map(np.asarray, ref),
                                    device="cpu")
    assert isinstance(bridge.unflatten_tree(port)["layers"], tuple)
    back = bridge.params_to_numpy(port)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref)):
        assert np.array_equal(a, np.asarray(b))


def test_bridge_keeps_bfloat16_bits():
    ref = ref_tr.init_params(jax.random.PRNGKey(2),
                             ref_get_arch("rwkv6-1.6b").reduced(),
                             "bfloat16")
    port = bridge.params_from_numpy(jax.tree.map(np.asarray, ref),
                                    device="cpu")
    for leaf, t in zip(jax.tree_util.tree_leaves(ref), port.values()):
        assert t.dtype == torch.bfloat16
        assert np.array_equal(t.float().numpy(),
                              np.asarray(leaf, np.float32))


# ------------------------------------------------- the serving path, per case
CASES = [(case, dtype) for dtype in ("float32", "bfloat16")
         for case in ("rwkv", "hymba", "hymba-gqa")]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def served(request):
    """Both packages' outputs for one case, computed once."""
    case, dtype = request.param
    ref_cfg = _case_cfg(ref_get_arch, case, dtype)
    cfg = _case_cfg(get_arch, case, dtype)
    key = jax.random.PRNGKey(0)
    ref_params = ref_tr.init_params(key, ref_cfg, dtype)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                      device="cpu")
    toks = np.array(jax.random.randint(jax.random.fold_in(key, 1),
                                       (2, T_SEQ), 0, cfg.vocab_size),
                    np.int32)
    out = {"case": case, "dtype": dtype, "cfg": cfg, "params": params,
           "tokens": toks}
    out["ref_logits"] = np.asarray(jax.jit(
        lambda p, t: ref_tr.forward(p, ref_cfg, t)[0])(ref_params, toks),
        np.float32)
    out["ref_prefill"] = np.asarray(jax.jit(ref_steps.make_prefill_step(
        ref_cfg))(ref_params, {"tokens": toks}))
    step = jax.jit(lambda p, s, t: ref_tr.decode_step(p, ref_cfg, s, t))
    state = ref_tr.init_decode_state(ref_cfg, 2, T_SEQ + 1, dtype)
    logits = []
    for t in range(T_SEQ):
        lg, state = step(ref_params, state, toks[:, t:t + 1])
        logits.append(np.asarray(lg))
    out["ref_decode"] = np.concatenate(logits, 1)
    if dtype == "float32":
        out["ref_generate"] = np.asarray(ref_serve.generate(
            ref_cfg, ref_params, jnp.asarray(toks[:, :PROMPT]), GEN,
            PROMPT + GEN + 1, 0.0, 0))
    return out


def _tol(served):
    return FP32_TOL if served["dtype"] == "float32" else BF16_TOL


def test_forward_logits_match_reference(served):
    cfg = served["cfg"]
    with torch.no_grad():
        logits, aux = tr.forward(served["params"], cfg,
                                 torch.from_numpy(served["tokens"]))
    assert logits.shape == (2, T_SEQ, tr.padded_vocab(cfg))
    assert logits.dtype == tr._dt(served["dtype"])
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.float().numpy(), served["ref_logits"],
                               **_tol(served))


def test_prefill_step_matches_reference(served):
    prefill = steps.make_prefill_step(served["cfg"])
    got = prefill(served["params"],
                  {"tokens": torch.from_numpy(served["tokens"])})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), served["ref_prefill"],
                               **_tol(served))


def test_decode_steps_match_reference(served):
    """Every position of a 40-token sequence, token by token: the first 8
    steps are plain decode, the rest run past the 32-slot window."""
    cfg = served["cfg"]
    serve_step = steps.make_serve_step(cfg)
    state = tr.init_decode_state(cfg, 2, T_SEQ + 1, device="cpu")
    toks = torch.from_numpy(served["tokens"])
    logits = []
    for t in range(T_SEQ):
        lg, state = serve_step(served["params"], state,
                               {"tokens": toks[:, t:t + 1]})
        logits.append(lg)
    assert state.position == T_SEQ
    got = torch.cat(logits, 1)
    assert got.shape == (2, T_SEQ, cfg.vocab_size)
    np.testing.assert_allclose(got[:, :8].numpy(),
                               served["ref_decode"][:, :8], **_tol(served))
    np.testing.assert_allclose(got.numpy(), served["ref_decode"],
                               **_tol(served))


def test_generate_greedy_matches_reference(served):
    """Greedy tokens, exact at fp32 (the reference's seed 0).  At bf16 the
    two packages' logits differ by a few ulps, so a near tie may break the
    other way: the test holds the port's own run to its logits instead."""
    cfg = served["cfg"]
    prompts = torch.from_numpy(served["tokens"][:, :PROMPT])
    got = serve.generate(cfg, served["params"], prompts, GEN,
                         PROMPT + GEN + 1)
    assert got.shape == (2, GEN) and got.dtype == torch.int32
    assert int(got.min()) >= 0 and int(got.max()) < cfg.vocab_size
    if served["dtype"] == "float32":
        assert np.array_equal(got.numpy(), served["ref_generate"])
    else:
        assert torch.equal(got, serve.generate(cfg, served["params"],
                                               prompts, GEN,
                                               PROMPT + GEN + 1))


def test_decode_agrees_with_forward(served):
    """The port's own serve == prefill check, the reference's
    tests/test_models.py tolerance at fp32 (atol 2e-3, rtol 1e-3)."""
    cfg = served["cfg"]
    model = tr.Decoder(cfg, served["params"])
    toks = torch.from_numpy(served["tokens"])
    state = tr.init_decode_state(cfg, 2, T_SEQ + 1, device="cpu")
    with torch.no_grad():
        fwd = model(toks)[..., :cfg.vocab_size].float()
        dec = []
        for t in range(T_SEQ):
            lg, state = model.decode_step(state, toks[:, t:t + 1])
            dec.append(lg)
    tol = (dict(atol=2e-3, rtol=1e-3) if served["dtype"] == "float32"
           else BF16_TOL)
    np.testing.assert_allclose(torch.cat(dec, 1).numpy(), fwd.numpy(), **tol)


def test_temperature_sampling_uses_the_generator():
    logits = torch.randn((3, 1, 50), generator=torch.Generator()
                         .manual_seed(0))
    draws = [serve.sample_tokens(logits, torch.Generator().manual_seed(7),
                                 temperature=0.8) for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert draws[0].shape == (3, 1) and draws[0].dtype == torch.int32
    assert torch.equal(serve.sample_tokens(logits),
                       logits.argmax(-1).to(torch.int32))


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--arch", "rwkv6-1.6b", "--reduced", "--batch", "2",
                "--prompt-len", "4", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 3) on cpu" in out
