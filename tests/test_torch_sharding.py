"""The port's sharded layer against the reference on the CPU: placements,
sharded steps on a 2 x 2 gloo mesh, masking over shards, the silo pod
round and the store over a mesh.

Placement parity: every leaf of all ten archs at full width (the
reference's ``steps.params_specs`` by ``jax.eval_shape``, the port's on
the ``meta`` device) gets the same spec from ``launch/shardings.py`` as
from the reference's rules, on fake meshes {data 16, model 16}, {pod 2,
data 16, model 16} and {data 2, model 4}, with FSDP on and off: the
parameters, their optimizer state (AdamW and Adafactor's factored
moments), the batches and the decode caches of every input shape, and
the pod round's layout (``fed_layout``).  Exact.

The 2 x 2 mesh: four gloo processes run ``tests/torch_sharded_worker.py``
once for the module.  Tolerances:
- three AdamW steps (lr 1e-3) of reduced qwen2-1.5b, qwen2-moe-a2.7b (4
  experts, expert parallel), rwkv6-1.6b (wkv6 over the ranks' heads) and
  hymba-1.5b (two layers; ssm_scan over the ranks' channels), fp32, on the
  sharded path as every caller runs it: ``mesh_hints`` round the block
  outputs' gradients to bf16, as the reference's hints do.  The unsharded
  port is the same step on a 1 x 1 mesh (rank 0 alone, the same hints);
  the reference is its step with its hints on a 1 x 1 Auto-axis mesh,
  but for hymba, whose hinted reference step raises in fp32 (the bf16
  cotangent of an fp32 output meets an fp32 one in ``0.5 * (y + s)``), so
  it is held to the unhinted reference.  Tensor parallelism splits the
  contractions, so the sums round in other orders, and the bf16 rounding
  turns a last-bit difference into a bf16 step now and then.  Readings on
  this CPU (sharded against 1 x 1 / against the hinted reference): loss
  rtol at most 1.6e-5 / 5.0e-6, grad norm 1.4e-4 / 2.5e-5, the
  parameters' change over the three steps in L2 (``_update_gap``) 1.2e-2
  (hymba; the others 1.5e-3 to 4.6e-3) / 4.2e-3; the rounding itself (the
  reference unhinted against hinted) moves that change by 2.1e-2 to
  4.7e-2, hymba's 2.6e-2.  Bounds: loss rtol 1e-4, grad norm 5e-4, every
  parameter within 2 lr a step (Adam turns noise in a near-zero gradient
  into a step of up to lr), the change's gap 2e-2 against 1 x 1, 1e-2
  against the hinted reference and 5e-2 against hymba's unhinted one.
- the sharded prefill and the prompt decoded token by token into a cache
  whose slots are over "model" (partial softmax sums all-reduced): rtol
  1e-4 / atol 1e-5 of the unsharded port.
- the kernel-route masks over 2 silos x 2 model ranks: bit for bit the
  unsharded ``mask_deltas``; the wire bytes exact; two silo pod rounds
  against the same two on the 1 x 1 mesh: loss rtol 1e-4, parameters
  rtol / atol 1e-3 (the slice tests' pod-round tolerance; read: loss
  1.5e-6, parameters inside by 1.2e-5); against ``make_fed_round``, which
  does not round: loss rtol 1e-4 (read 8.2e-6), the change's gap 5e-2
  (read 2.5e-2).
- the dense and sharded stores over the data axis: every gather, the
  norms and the state bit for bit an unsharded twin's.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_arch as ref_get_arch
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_shape as ref_get_shape
from repro.configs import supports_shape as ref_supports_shape
from repro.launch import fedtrain as ref_fedtrain
from repro.launch import shardings as ref_sh
from repro.launch import steps as ref_steps
from repro.models import transformer as ref_tr
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_arch, get_shape
from repro_torch.configs import supports_shape
from repro_torch.launch import fedtrain, shardings as sh, steps
from repro_torch.launch.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
TRAIN_ARCHS = ("qwen2-1.5b", "qwen2-moe-a2.7b", "rwkv6-1.6b", "hymba-1.5b")
REF_HINTS_ARCHS = TRAIN_ARCHS[:3]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: with several test workers on one machine, torch's
    intra-op threads only contend.  Restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------------------
# placement parity on fake meshes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def meshes():
    """The three meshes as ``DeviceMesh`` objects on a 512-rank fake
    process group (destroyed after the module), beside the reference's
    view of each."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    out = {key: (make_mesh(dims, names, "cpu"),
                 jax.sharding.AbstractMesh(dims, names))
           for key, (dims, names) in MESHES.items()}
    yield out
    dist.destroy_process_group()


def _norm(spec) -> tuple:
    """A spec as tuples of axis names, no trailing Nones."""
    out = [None if e is None or e == () else
           ((e,) if isinstance(e, str) else tuple(e)) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _ref_flat(tree) -> dict:
    return bridge.flatten_tree(tree)


@pytest.fixture(scope="module")
def ref_param_specs():
    return {a: ref_steps.params_specs(ref_get_arch(a)) for a in ARCH_IDS}


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_placements_match_the_reference(meshes, ref_param_specs,
                                              arch, mesh_key, fsdp):
    mesh, ref_mesh = meshes[mesh_key]
    ref = _ref_flat(ref_sh.params_shardings(ref_param_specs[arch], ref_mesh,
                                            fsdp=fsdp))
    got = sh.params_shardings(steps.params_specs(get_arch(arch)), mesh,
                              fsdp=fsdp)
    assert list(got) == list(ref)
    bad = {k: (got[k].spec, _norm(ref[k].spec)) for k in got
           if _norm(got[k].spec) != _norm(ref[k].spec)}
    assert not bad
    # the placements read back are the spec they came from
    for k, s in got.items():
        assert sh.spec_of(sh.to_placements(s.spec, mesh), mesh) == s.spec


@pytest.mark.parametrize("mesh_key", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_optimizer_state_placements_match_the_reference(
        meshes, ref_param_specs, arch, mesh_key):
    """AdamW's moments mirror the parameters; for Adafactor's factored
    (vr, vc) each takes its dims of the parameter's spec."""
    from repro.optim import adafactor as ref_adafactor, adamw as ref_adamw

    from repro_torch.optim import adafactor, adamw
    mesh, ref_mesh = meshes[mesh_key]
    ref_psh = ref_sh.params_shardings(ref_param_specs[arch], ref_mesh)
    specs = steps.params_specs(get_arch(arch))
    psh = sh.params_shardings(specs, mesh)
    for ref_opt, opt in ((ref_adamw, adamw), (ref_adafactor, adafactor)):
        ref_state = jax.eval_shape(ref_opt(1e-3).init,
                                   ref_param_specs[arch])
        ref_like = ref_sh.params_shardings_like(ref_state, ref_psh, ref_mesh)
        got = sh.params_shardings_like(opt(1e-3).init(specs), psh, mesh)
        for key, tree in got.items():
            if tree is None:
                assert ref_like[key] is None
                continue
            if isinstance(tree, sh.Sharding):
                assert _norm(tree.spec) == _norm(ref_like[key].spec) == ()
                continue
            want = _ref_flat(ref_like[key])
            for name, leaf in tree.items():
                for sub, s in (leaf.items() if isinstance(leaf, dict)
                               else [(None, leaf)]):
                    ref_s = want[name if sub is None else f"{name}.{sub}"]
                    assert _norm(s.spec) == _norm(ref_s.spec), (key, name,
                                                                 sub)


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_placements_match_the_reference(meshes, arch,
                                                        mesh_key):
    mesh, ref_mesh = meshes[mesh_key]
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    for name in INPUT_SHAPES:
        shape, rshape = get_shape(name), ref_get_shape(name)
        assert supports_shape(cfg, shape) == ref_supports_shape(rcfg, rshape)
        if not supports_shape(cfg, shape):
            continue
        batch = steps.batch_specs(cfg, shape)
        ref_batch = ref_steps.batch_specs(rcfg, rshape)
        assert {k: tuple(v.shape) for k, v in batch.items()} == \
            {k: tuple(v.shape) for k, v in ref_batch.items()}
        got = sh.batch_shardings(batch, mesh)
        want = ref_sh.batch_shardings(ref_batch, ref_mesh)
        assert {k: _norm(v.spec) for k, v in got.items()} == \
            {k: _norm(v.spec) for k, v in want.items()}
        if shape.mode != "decode":
            continue
        state = steps.decode_state_specs(cfg, shape)
        got = sh.decode_state_shardings(state, mesh)
        want = ref_sh.decode_state_shardings(
            ref_steps.decode_state_specs(rcfg, rshape), ref_mesh)
        for pos, (g, w) in enumerate(zip(got.caches, want.caches)):
            gl, wl = _cache_leaves(g), _cache_leaves(w)
            assert gl.keys() == wl.keys()
            for k in gl:
                assert _norm(gl[k].spec) == _norm(wl[k].spec), (name, pos, k)


def _cache_leaves(node, prefix: str = "") -> dict:
    """A cache's shardings by path, tensor leaves of ndim >= 2 only (the
    reference's KV index is a (G,) vector, the port's a Python int)."""
    if "k" in getattr(node, "_fields", ()):      # a KVCache
        return {f"{prefix}{f}": getattr(node, f) for f in ("k", "v")}
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out.update(_cache_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix.rstrip("."): node}


def test_shapes_and_their_support_match_the_reference():
    assert list(INPUT_SHAPES) == list(REF_SHAPES)
    for name in INPUT_SHAPES:
        a, b = get_shape(name), ref_get_shape(name)
        assert (a.name, a.seq_len, a.global_batch, a.mode) == \
            (b.name, b.seq_len, b.global_batch, b.mode)
    for arch in ARCH_IDS:
        for name in INPUT_SHAPES:
            assert supports_shape(get_arch(arch), get_shape(name)) == \
                ref_supports_shape(ref_get_arch(arch), ref_get_shape(name))


@pytest.mark.parametrize("mesh_key", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-72b",
                                  "llama4-maverick-400b-a17b"])
def test_pod_round_layout_matches_the_reference(meshes, ref_param_specs,
                                                arch, mesh_key):
    """``fed_layout`` and the silo's parameter layout and dtype, as the
    reference's ``lower_fed_round`` lays them out."""
    mesh, ref_mesh = meshes[mesh_key]
    assert fedtrain.fed_layout(mesh) == ref_fedtrain.fed_layout(ref_mesh)
    client_axis, fsdp_axes = ref_fedtrain.fed_layout(ref_mesh)
    chips = int(np.prod(list(ref_mesh.shape.values())))
    silo_chips = chips // ref_mesh.shape[client_axis]
    n = sum(int(np.prod(v.shape)) for v in
            jax.tree_util.tree_leaves(ref_param_specs[arch]))
    want_dtype = "float32" if 4 * n / silo_chips < 6e9 else "bfloat16"
    assert fedtrain.silo_param_dtype(get_arch(arch), mesh) == want_dtype
    ref = _ref_flat(ref_sh.params_shardings(
        ref_param_specs[arch], ref_mesh, fsdp=bool(fsdp_axes),
        fsdp_axes=fsdp_axes or None))
    got = fedtrain.silo_shardings(steps.params_specs(get_arch(arch)), mesh)
    silo = fedtrain.silo_mesh(mesh)
    assert silo.mesh_dim_names == tuple(a for a in ref_mesh.axis_names
                                        if a != client_axis)
    assert {k: _norm(v.spec) for k, v in got.items()} == \
        {k: _norm(v.spec) for k, v in ref.items()}


# ---------------------------------------------------------------------------
# the 2 x 2 gloo mesh
# ---------------------------------------------------------------------------
def _arch_cfgs(arch: str):
    out = []
    for get in (get_arch, ref_get_arch):
        cfg = dataclasses.replace(get(arch).reduced(), compute_dtype="float32",
                                  param_dtype_serve="float32")
        if arch == "hymba-1.5b":
            cfg = dataclasses.replace(cfg, layer_pattern=cfg.layer_pattern[:2],
                                      num_layers=2)
        out.append(cfg)
    return out


def _batches(cfg, seed: int, n: int = 3, B: int = 4, T: int = 32):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
        out.append({"tokens": toks, "labels": np.roll(toks, -1, -1)})
    return out


def _t(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ref_steps(rcfg, params, batches, hints: bool) -> dict:
    """The reference's three AdamW steps; with ``hints``, its sharding
    hints on a 1 x 1 Auto-axis mesh, which round the block outputs'
    gradients to bf16 as every sharded step does."""
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    make = ref_steps.make_train_step
    step = jax.jit(make(rcfg, learning_rate=LR,
                        hints=ref_steps.mesh_hints(mesh) if hints else None))
    state = make(rcfg).optimizer.init(params)
    losses, norms = [], []
    with mesh:
        for b in batches:
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return {"loss": losses, "grad_norm": norms,
            "params": bridge.flatten_tree(jax.tree.map(np.asarray, params))}


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Inputs made here, the four ranks run once, the reference's three
    AdamW steps on the same inputs, unhinted and (where it runs) hinted;
    returns (inputs, rank 0's outputs, the reference's results)."""
    tmp = tmp_path_factory.mktemp("sharded")
    inputs, ref = {"lr": LR, "train": {}}, {}
    for i, arch in enumerate(TRAIN_ARCHS):
        cfg, rcfg = _arch_cfgs(arch)
        ref_params = ref_tr.init_params(jax.random.PRNGKey(i), rcfg)
        params = bridge.params_from_numpy(jax.tree.map(np.asarray,
                                                       ref_params),
                                          device="cpu")
        batches = _batches(cfg, 20 + i)
        inputs["train"][arch] = {"params": params,
                                 "batches": [_t(b) for b in batches]}
        ref[arch] = {"plain": _ref_steps(rcfg, ref_params, batches, False)}
        if arch in REF_HINTS_ARCHS:
            ref[arch]["hints"] = _ref_steps(rcfg, ref_params, batches, True)
    cfg, rcfg = _arch_cfgs("qwen2-1.5b")
    serve_params = bridge.params_from_numpy(jax.tree.map(
        np.asarray, ref_tr.init_params(jax.random.PRNGKey(7), rcfg)),
        device="cpu")
    rng = np.random.default_rng(5)
    inputs["serve"] = {"params": serve_params, "prompts": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32))}
    g = torch.Generator().manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 2, 2, 32), generator=g,
                         dtype=torch.int32)
    inputs["silo"] = {
        "params": serve_params,
        "deltas": {k: torch.randn((2,) + tuple(v.shape), generator=g)
                   for k, v in serve_params.items()},
        "rounds": [{"tokens": toks[t], "labels": toks[t].roll(-1, -1)}
                   for t in range(2)]}
    inputs["store"] = {"template": {"w": torch.zeros(3, 4),
                                    "b": torch.zeros(5)}}
    src, out = str(tmp / "in.pt"), str(tmp / "out.pt")
    torch.save(inputs, src)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="4",
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "torch_sharded_worker.py"), src, out],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=600)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    return inputs, torch.load(out), ref


def _close_steps(got: dict, want: dict, start: dict, update_rtol: float,
                 steps_taken: int = 3):
    """Three AdamW steps against three others from the same ``start``:
    the losses rtol 1e-4, the grad norms rtol 5e-4, every parameter within
    2 lr a step (Adam's bound), and the parameters' change over the steps
    within ``update_rtol`` of the other run's in L2 (the module docstring's
    readings)."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=5e-4)
    _close_update(got["params"], want["params"], start, update_rtol)
    a = np.concatenate([np.asarray(got["params"][k]).ravel() for k in start])
    b = np.concatenate([np.asarray(want["params"][k]).ravel()
                        for k in start])
    assert np.abs(a - b).max() <= steps_taken * 2 * LR


def _update_gap(got: dict, want: dict, start: dict) -> float:
    """``||got - want|| / ||want - start||`` over every leaf."""
    flat = {name: np.concatenate([np.asarray(t[k], np.float64).ravel()
                                  for k in start])
            for name, t in (("got", got), ("want", want), ("start", start))}
    return float(np.linalg.norm(flat["got"] - flat["want"])
                 / np.linalg.norm(flat["want"] - flat["start"]))


def _close_update(got: dict, want: dict, start: dict, rtol: float):
    gap = _update_gap(got, want, start)
    assert gap <= rtol, (gap, rtol)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_steps_match_the_unsharded_port(gloo, arch):
    inputs, out, _ = gloo
    _close_steps(out["train"][arch]["sharded"], out["train"][arch]["solo"],
                 inputs["train"][arch]["params"], update_rtol=2e-2)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_steps_match_the_reference(gloo, arch):
    """Against the reference's steps with its hints (which round the
    same gradients); hymba's hinted reference step raises in fp32, so it
    is held to the reference's unhinted steps at the rounding's own
    effect."""
    inputs, out, ref = gloo
    want = ref[arch].get("hints", ref[arch]["plain"])
    _close_steps(out["train"][arch]["sharded"], want,
                 inputs["train"][arch]["params"],
                 update_rtol=1e-2 if "hints" in ref[arch] else 5e-2)


def test_sharded_steps_round_gradients_as_the_reference_does(gloo):
    """The bf16 rounding of the block outputs' gradients is on: the
    reference's unhinted steps are at least three times as far from its
    hinted ones as the sharded steps are."""
    inputs, out, ref = gloo
    for arch in REF_HINTS_ARCHS:
        start, hinted = inputs["train"][arch]["params"], \
            ref[arch]["hints"]["params"]
        sharded = _update_gap(out["train"][arch]["sharded"]["params"],
                              hinted, start)
        unrounded = _update_gap(ref[arch]["plain"]["params"], hinted, start)
        assert 3 * sharded < unrounded, (arch, sharded, unrounded)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_step_keeps_every_leaf_in_its_layout(gloo, arch):
    """The step hands each parameter back in the layout it was given
    (FSDP over "data", tensor parallel over "model")."""
    inputs, out, _ = gloo
    got = out["train"][arch]["sharded"]
    assert set(got["layout_kept"]) == set(inputs["train"][arch]["params"])
    assert all(got["layout_kept"].values())
    assert got["sharded_leaves"] > 0


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_step_gradients_reach_the_optimizer_in_their_parameters_layout(
        gloo, arch):
    """Every gradient that reaches ``global_norm_scale`` in the three 2 x 2
    steps has its parameter's placements: the backward has already
    reduce-scattered (or all-reduced) it."""
    inputs, out, _ = gloo
    kept = out["train"][arch]["sharded"]["grad_layout_kept"]
    assert set(kept) == set(inputs["train"][arch]["params"])
    assert all(kept.values()), [k for k, v in kept.items() if not v]


def test_sharded_prefill_and_decode_match_the_unsharded_port(gloo):
    _, out, _ = gloo
    got, plain = out["serve"]["sharded"], out["serve"]["plain"]
    np.testing.assert_allclose(got["prefill"].numpy(),
                               plain["prefill"].numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["decode"].numpy(),
                               plain["decode"].numpy(), rtol=1e-4,
                               atol=1e-5)
    # the cache's slots were over "model": the split decode path ran
    assert "Shard(dim=2)" in got["state_layout"]


def test_kernel_masks_over_silo_shards_equal_the_unsharded_masks(gloo):
    _, out, _ = gloo
    masks = out["silo"]["masks"]
    assert sorted(c for c, _, _ in masks) == [0, 0, 1, 1]
    for _, equal, kept in masks:
        assert all(equal.values()), [k for k, v in equal.items() if not v]
        assert sum(kept.values()) > 0


def test_silo_round_wire_bytes_are_the_whole_clients(gloo):
    inputs, out, _ = gloo
    want = out["silo"]["wire_bytes"]
    assert want > 0
    for run in ("silo", "solo"):
        assert out["silo"]["runs"][run]["upload_bytes"] == [want, want]


def test_silo_pod_round_matches_the_unsharded_round(gloo):
    """Two rounds on 2 silos x 2 model ranks against the same two rounds
    on the 1 x 1 mesh (the same hints, so the same gradient rounding):
    loss rtol 1e-4, parameters rtol / atol 1e-3."""
    _, out, _ = gloo
    runs = out["silo"]["runs"]
    np.testing.assert_allclose(runs["silo"]["loss"], runs["solo"]["loss"],
                               rtol=1e-4)
    for k, v in runs["solo"]["params"].items():
        np.testing.assert_allclose(runs["silo"]["params"][k].numpy(),
                                   v.numpy(), rtol=1e-3, atol=1e-3,
                                   err_msg=k)


def test_silo_pod_round_matches_the_plain_round(gloo):
    """Against ``make_fed_round`` (no hints, no gradient rounding): loss
    rtol 1e-4, the parameters' change over the two rounds within 5% in L2
    (the rounding's own effect, module docstring)."""
    inputs, out, _ = gloo
    runs = out["silo"]["runs"]
    np.testing.assert_allclose(runs["silo"]["loss"], runs["plain"]["loss"],
                               rtol=1e-4)
    _close_update(runs["silo"]["params"], runs["plain"]["params"],
                  inputs["silo"]["params"], 5e-2)


@pytest.mark.parametrize("kind", ["dense", "sharded"])
def test_store_over_the_data_axis_matches_its_unsharded_twin(gloo, kind):
    _, out, _ = gloo
    rec = out["store"][kind]
    assert rec["same"]
    mem, plain = rec["memory"], rec["plain_memory"]
    assert mem["residual_bytes_per_device"] * 2 == mem["residual_bytes"]
    assert {k: v for k, v in mem.items()
            if k != "residual_bytes_per_device"}.keys() == plain.keys()


def test_mesh_argument_names_the_reference_axes(gloo):
    _, out, _ = gloo
    assert out["mesh_arg"] == ("data", "model")
