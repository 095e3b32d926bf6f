"""The sharded train step does one rank's share, as the reference's SPMD
step does: traced by ``launch/dryrun.trace_combo`` on fake process groups
(``torch.testing._internal.distributed.fake_pg``), on the CPU.

Each reduced arch's mini train step (8 x 64 tokens, the shape of the
reference's mini dry run) is traced on fake (1, 1), (8, 1) and (2, 4)
("data", "model") meshes:

- On (8, 1) the per-device FLOPs are exactly an eighth of (1, 1)'s, for
  every arch, as the reference's partitioned HLO splits them (hymba-1.5b
  there: 6,232,735,744 of 49,861,885,952 on an Auto-axis mesh).  Before
  the layers gathered their weights over the data axes just before use
  (``hints.gathered``), DTensor moved the rows onto the weights' FSDP
  shards instead, and hymba's SSM projections ran on all 512 rows on
  every rank: 7,105,150,976 FLOPs, not 6,224,347,136.  The MoE archs
  route a group that spans the data ranks: each rank now makes its rows'
  router logits and its share of the expert slots.
- Every gradient that reaches ``global_norm_scale`` has its parameter's
  placements on (8, 1) and (2, 4): the backward reduce-scatters each
  FSDP weight's gradient where it makes it and all-reduces a replicated
  leaf's, before the optimizer sees it.
- A (Partial, Partial) gradient of a replicated leaf costs one
  all-reduce, over the flattened data x model group that ``make_mesh``
  registers for every set of wide dims.
- ``OpStats`` counts no op of DTensor's sharding propagation, nor any op
  on the global batch (``test_op_stats_counts_no_op_on_the_global_batch``
  says at which shape).
"""

import dataclasses

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, op_stats, shardings as sh, steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import hints as hints_lib

MINI = InputShape("mini", 64, 8, "train")
MESHES = ((1, 1), (8, 1), (2, 4))
ARCHS = ("hymba-1.5b",) + tuple(a for a in ARCH_IDS if a != "hymba-1.5b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: with several test workers on one machine, torch's
    intra-op threads only contend.  Restored after the module."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def fake_group():
    """A fake process group of the asked size, destroyed after the test."""
    assert not dist.is_initialized()

    def start(world: int):
        dryrun.init_fake(world)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def _trace(arch: str, optimizer: str = "auto", meshes=MESHES) -> dict:
    """The mini step of ``arch`` on each mesh: the dry run's counts, the
    placements of the gradients that reached ``global_norm_scale``
    ("grads") and those of the parameters ("params"), and the parameter
    and state leaves the step handed back in another layout ("moved")."""
    cfg = get_arch(arch).reduced()
    out = {}
    real = (steps.global_norm_scale, dryrun.OpStats, steps.make_train_step)
    for dims in meshes:
        dryrun.init_fake(dims[0] * dims[1])
        seen, made, moved = {}, [], []

        def check(grads, clip_norm):
            seen.update({k: tuple(g.placements) for k, g in grads.items()})
            return real[0](grads, clip_norm)

        class Kept(real[1]):
            def __init__(self):
                super().__init__()
                made.append(self)

        def make(*args, **kwargs):
            step = real[2](*args, **dict(kwargs, optimizer=optimizer))

            def watched(params, opt_state, batch):
                before = _layouts((params, opt_state))
                out = step(params, opt_state, batch)
                after = _layouts(out[:2])
                moved.extend(k for k in before if after[k] != before[k])
                return out
            watched.optimizer = step.optimizer
            return watched
        steps.global_norm_scale, dryrun.OpStats = check, Kept
        steps.make_train_step = make
        try:
            mesh = make_mesh(dims, ("data", "model"), "cpu")
            want = sh.params_shardings(steps.params_specs(cfg), mesh)
            rec = dryrun.trace_combo(cfg, MINI, mesh)
        finally:
            steps.global_norm_scale, dryrun.OpStats = real[:2]
            steps.make_train_step = real[2]
            dist.destroy_process_group()
        out[dims] = dict(rec, grads=seen, dots=dict(made[0].dot_flops),
                         moved=moved, params={k: tuple(s.placements)
                                              for k, s in want.items()})
    return out


def _layouts(tree, prefix: str = "") -> dict:
    """Each DTensor leaf's placements by its path in ``tree``."""
    if isinstance(tree, DTensor):
        return {prefix: tuple(tree.placements)}
    items = tree.items() if isinstance(tree, dict) else \
        enumerate(tree) if isinstance(tree, (tuple, list)) else ()
    out = {}
    for k, v in items:
        out.update(_layouts(v, f"{prefix}/{k}"))
    return out


@pytest.fixture(scope="module")
def traced():
    """``_trace`` of an arch, once a module."""
    cache = {}

    def get(arch: str) -> dict:
        if arch not in cache:
            cache[arch] = _trace(arch)
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_mini_step_flops_split_exactly_over_eight_data_ranks(traced, arch):
    rec = traced(arch)
    assert rec[(8, 1)]["flops"] * 8 == rec[(1, 1)]["flops"]
    assert rec[(2, 4)]["flops"] < rec[(1, 1)]["flops"]
    assert rec[(1, 1)]["collective_bytes"] == 0


def test_hymba_runs_its_ssm_projections_on_one_ranks_rows(traced):
    """The products of ``ssm._selective_terms`` (``x @ w_bcdt``, (d_inner,
    2 N + dt_rank) = (256, 48)) take a rank's 64 rows on (8, 1), never the
    global batch's 512."""
    rec = traced("hymba-1.5b")
    assert rec[(8, 1)]["flops"] == 6_224_347_136
    assert "mm (512, 256)x(256, 48)" in rec[(1, 1)]["dots"]
    assert "mm (64, 256)x(256, 48)" in rec[(8, 1)]["dots"]
    assert not [n for n in rec[(8, 1)]["dots"]
                if n.startswith(("mm (512, 256)x(256, 48)", "mm (512, 48)"))]


@pytest.mark.parametrize("arch", ARCHS)
def test_every_gradient_reaching_the_optimizer_has_its_parameters_placements(
        traced, arch):
    for dims in ((8, 1), (2, 4)):
        rec = traced(arch)[dims]
        assert rec["grads"].keys() == rec["params"].keys()
        bad = {k: (rec["grads"][k], p) for k, p in rec["params"].items()
               if rec["grads"][k] != p}
        assert not bad, (dims, bad)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_step_hands_back_every_leaf_and_state_in_its_layout(traced,
                                                                 arch):
    """Nothing is moved after the update: the parameters and AdamW's
    moments (every reduced arch's optimizer) leave the step in the
    placements they came in with."""
    for dims in MESHES:
        assert traced(arch)[dims]["moved"] == [], dims


def test_adafactor_keeps_its_factored_moments_in_their_layout():
    """Adafactor (full-width llama4's optimizer) reduces its row and
    column moments, means over a sharded dim, to their state layout
    before it forms the denominator, so the step hands every leaf back in
    its layout, and no product of the two is made at the gradient's
    whole size."""
    rec = _trace("qwen2-1.5b", optimizer="adafactor", meshes=((2, 4),))
    assert rec[(2, 4)]["moved"] == []
    assert rec[(2, 4)]["grads"] == rec[(2, 4)]["params"]


def test_a_partial_norm_scale_gradient_costs_one_all_reduce(fake_group):
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake_group(8)
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    hints = steps.mesh_hints(mesh)
    with FakeTensorMode():
        scale = DTensor.from_local(torch.empty(256), mesh,
                                   [Replicate(), Replicate()],
                                   run_check=False).requires_grad_()
        g = DTensor.from_local(torch.empty(256), mesh, [Partial(), Partial()],
                               run_check=False)
        with op_stats.OpStats() as stats:
            grad, = torch.autograd.grad(hints_lib.grad_layout(hints, scale),
                                        scale, grad_outputs=g)
    assert tuple(grad.placements) == (Replicate(), Replicate())
    assert stats.collective_count == {"all-reduce": 1}
    assert stats.per_collective == {"all-reduce": 2 * 256 * 4}


@pytest.mark.parametrize("dims, names, flat", [
    ((2, 4), ("data", "model"), ["data_model"]),
    ((2, 2, 2), ("pod", "data", "model"),
     ["pod_data", "pod_model", "data_model", "pod_data_model"]),
    ((8, 1), ("data", "model"), [])])
def test_make_mesh_flattens_every_set_of_wide_dims(fake_group, dims, names,
                                                   flat):
    fake_group(8)
    mesh = make_mesh(dims, names, "cpu")
    made = mesh._get_root_mesh()._flatten_mapping
    assert sorted(made) == sorted(flat)
    for name in flat:
        size = 1
        for part in name.split("_"):
            size *= mesh.shape[names.index(part)]
        assert made[name].size() == size


def test_op_stats_counts_no_op_on_the_global_batch(fake_group, monkeypatch):
    """hymba-1.5b's train step at the smallest shape that shows DTensor's
    propagation stand-ins: 2 rows of 40 tokens on a (2, 1) mesh, the
    reduced config cut to its first two layers (one full, one sliding).
    A stand-in has the global shape, which differs from a rank's only
    where the data axes split the batch, so two data ranks of one row;
    40 tokens make the 80 global positions no width of the model (256,
    512, 48, 16, 32).  ``softplus_backward`` has no DTensor rule and is
    propagated through its decomposition on (2, 40, 256) stand-ins, which
    frame names of the tensor-meta path did not recognise.  Every op that
    is counted (nor its backward: the loss, the zero states) has a leading
    dim of the rank's one row and no dim of the 80 positions."""
    cfg = get_arch("hymba-1.5b").reduced()
    cfg = dataclasses.replace(cfg, layer_pattern=cfg.layer_pattern[:2],
                              num_layers=2)
    B, T = 2, 40
    seen = []

    class Recording(op_stats.OpStats):
        def _track(self, func, out):
            seen.extend((str(func), tuple(t.shape))
                        for t in op_stats._tensors(out))
            return super()._track(func, out)
    monkeypatch.setattr(dryrun, "OpStats", Recording)
    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding \
        .cache_clear()
    fake_group(2)
    mesh = make_mesh((2, 1), ("data", "model"), "cpu")
    rec = dryrun.trace_combo(cfg, InputShape("tiny", T, B, "train"), mesh)
    assert rec["propagation_ops"] > 0 and len(seen) > 1000
    whole = [(f, s) for f, s in seen
             if (len(s) >= 2 and s[0] == B) or B * T in s]
    assert not whole, whole[:10]


def test_op_stats_refuses_a_propagator_without_its_entry_points(monkeypatch):
    monkeypatch.setattr(op_stats, "_PROPAGATION",
                        op_stats._PROPAGATION + ("no_such_entry_point",))
    with pytest.raises(ImportError, match="no_such_entry_point"):
        op_stats.OpStats().__enter__()
