"""The port's dry run (``launch/dryrun.py``, ``launch/op_stats.py``) on the
CPU, and the sharded layer's 1 x 1 mesh bit for bit.

- The reduced qwen2-1.5b train step (8 x 64 tokens), traced on fake
  process groups of 1, 8 and 8 ranks ((1, 1), (8, 1) and (2, 4) meshes):
  the (1, 1) count is within 2% of the reference's (``hlo.analyze`` of
  the same step compiled on an Auto-axis ``jax.sharding.Mesh`` in a
  subprocess); (2, 4) moves collective bytes; on every mesh the ops of
  DTensor's shape propagation were seen and left out.  The exact split
  over eight data ranks, every arch's, and the gradients' layouts are
  ``tests/test_torch_grad_layout.py``'s.
- One full-width combo, qwen2-1.5b x train_4k on the 16 x 16 mesh,
  written as its JSON.
- ``OpStats`` counts what one rank runs: a DTensor product's local FLOPs
  (a ``FlopCounterMode`` around the same op counts the global product),
  collectives by the reference's convention, a kernel custom op as one op
  with its bound's bytes; ``param_counts`` and ``model_flops`` equal the
  reference's.
- A 1 x 1 gloo mesh at world size 1 (one process): two AdamW steps of
  reduced qwen2-1.5b and rwkv6-1.6b in their configs' dtypes, round 1 of
  the silo pod round (4 clients, kernel masking), a prefill and eight
  decode steps: every loss, parameter, keep bit and logit bit for bit the
  unsharded run's (the card's ``sharded_path`` at reduced width).
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_arch, get_shape
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, op_stats
from repro_torch.launch.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = InputShape("mini", 64, 8, "train")

REF_MINI = """
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.configs import get_arch
from repro.configs.base import InputShape
from repro.launch import shardings as sh, steps as steps_lib, hlo as hlo_lib
mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                         ("data", "model"))
cfg = get_arch("qwen2-1.5b").reduced()
shape = InputShape("mini", 64, 8, "train")
hints = steps_lib.mesh_hints(mesh)
pspecs = steps_lib.params_specs(cfg, "float32")
psh = sh.params_shardings(pspecs, mesh)
step = steps_lib.make_train_step(cfg, hints=hints)
opt = jax.eval_shape(step.optimizer.init, pspecs)
osh = sh.params_shardings_like(opt, psh, mesh)
batch = steps_lib.batch_specs(cfg, shape)
bsh = sh.batch_shardings(batch, mesh)
fn = jax.jit(step, in_shardings=(psh, osh, bsh),
             out_shardings=(psh, osh, None))
with mesh:
    compiled = fn.lower(pspecs, opt, batch).compile()
print(json.dumps({"flops": hlo_lib.analyze(compiled.as_text()).flops}))
"""


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


@pytest.fixture(scope="module")
def mini_counts():
    """The mini step traced on the three fake meshes."""
    cfg = get_arch("qwen2-1.5b").reduced()
    out = {}
    for dims in ((1, 1), (8, 1), (2, 4)):
        dryrun.init_fake(dims[0] * dims[1])
        try:
            mesh = make_mesh(dims, ("data", "model"), "cpu")
            out[dims] = dryrun.trace_combo(cfg, MINI, mesh)
        finally:
            dist.destroy_process_group()
    return out


def test_mini_step_flops_match_the_reference_hlo_count(mini_counts):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_MINI], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])["flops"]
    got = mini_counts[(1, 1)]["flops"]
    assert abs(got - ref) <= 0.02 * ref, (got, ref)


def test_op_stats_sees_dtensor_shape_propagation(mini_counts):
    """The ops DTensor's sharding propagation runs on global stand-ins are
    recognised (and left out of the counts) on every mesh: were their
    frames never seen, the 1/8 split above would hold by luck only."""
    for dims, rec in mini_counts.items():
        assert rec["propagation_ops"] > 0, dims


def test_mini_step_on_two_by_four_moves_collective_bytes(mini_counts):
    rec = mini_counts[(2, 4)]
    assert rec["collective_bytes"] > 0
    assert set(rec["per_collective"]) <= {"all-gather", "all-reduce",
                                          "reduce-scatter", "all-to-all",
                                          "collective-permute"}
    assert rec["flops"] < mini_counts[(1, 1)]["flops"]
    assert rec["peak_bytes"] > 0 and rec["param_bytes"] > 0


def test_full_width_combo_writes_its_record(tmp_path):
    try:
        rec = dryrun.run_combo("qwen2-1.5b", "train_4k", multi_pod=False,
                               out_dir=str(tmp_path))
    finally:
        dist.destroy_process_group()
    saved = json.loads((tmp_path / "qwen2-1.5b__train_4k__sp.json")
                       .read_text())
    assert saved["chips"] == rec["chips"] == 256
    assert saved["mesh"] == {"data": 16, "model": 16}
    per = saved["per_device"]
    assert per["flops"] > saved["roofline"]["model_flops_per_device"] > 0
    assert per["collective_bytes"] > 0
    mem = saved["memory"]
    assert mem["per_device_bytes"] == (mem["param_bytes"] + mem["opt_bytes"]
                                       + mem["state_bytes"]
                                       + mem["peak_live_bytes"])
    assert mem["fits_hbm"]
    assert saved["optimizer"] == "adamw"
    assert "fake process group" in saved["source"]
    rows = dryrun.table(str(tmp_path), str(tmp_path)).splitlines()
    assert len(rows) == 3 and rows[2].startswith("| `qwen2-1.5b` | train_4k")


def test_op_stats_counts_a_sharded_product_per_device(fake_group):
    """The trap: ``FlopCounterMode`` around a DTensor product counts the
    global product; ``OpStats`` counts the local one."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode
    fake_group(8)
    mesh = make_mesh((8,), ("model",), "cpu")
    with FakeTensorMode():
        a = distribute_tensor(torch.empty(256, 1024), mesh, [Replicate()])
        b = distribute_tensor(torch.empty(1024, 2048), mesh, [Shard(1)])
        with FlopCounterMode(display=False) as global_count:
            a @ b
        with op_stats.OpStats() as stats:
            c = a @ b
            c.redistribute(mesh, [Replicate()])
    assert global_count.get_total_flops() == 2 * 256 * 1024 * 2048
    assert stats.flops == 2 * 256 * 1024 * 2048 / 8
    # all-gather: its output's bytes
    assert stats.per_collective == {"all-gather": 256 * 2048 * 4}


def test_op_stats_counts_all_reduce_twice_and_kernels_once(fake_group):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Partial, Replicate, DTensor

    from repro_torch.kernels import wkv6
    fake_group(4)
    mesh = make_mesh((4,), ("model",), "cpu")
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(64, 32), mesh, [Partial()],
                               run_check=False)
        B, T, H, D = 2, 128, 4, 32
        r = torch.empty(B, T, H, D)
        u, s0 = torch.empty(H, D), torch.empty(B, H, D, D)
        with op_stats.OpStats() as stats:
            x.redistribute(mesh, [Replicate()])
            y, sT = wkv6.wkv6(r, r, r, r, u, s0)
    assert stats.per_collective == {"all-reduce": 2 * 64 * 32 * 4}
    assert tuple(y.shape) == (B, T, H, D) and tuple(sT.shape) == \
        (B, H, D, D)
    assert stats.kernel_calls == {"wkv6_forward": 1}
    want = op_stats.kernel_work("wkv6_forward", (r,))
    assert stats.kernel_bytes == want["bytes"] == \
        4 * (5 * B * T * H * D + 2 * B * H * D * D + H * D)
    assert stats.flops == 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_match_the_reference(arch):
    saved = os.environ.get("XLA_FLAGS")
    os.environ.setdefault("XLA_FLAGS", "")     # keep its device count as is
    try:
        from repro.configs import get_arch as ref_get_arch
        from repro.configs import get_shape as ref_get_shape
        from repro.launch import dryrun as ref_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
    assert dryrun.param_counts(get_arch(arch)) == \
        ref_dryrun.param_counts(ref_get_arch(arch))
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert dryrun.model_flops(get_arch(arch), get_shape(shape)) == \
            ref_dryrun.model_flops(ref_get_arch(arch), ref_get_shape(shape))


def test_dryrun_cli_takes_the_references_flags_but_save_hlo():
    args = dryrun.parser().parse_args(
        ["--arch", "qwen2-1.5b", "--shape", "train_4k", "--all",
         "--multi-pod", "--fed", "--no-fsdp", "--no-remat", "--out", "x"])
    assert vars(args) == {"arch": "qwen2-1.5b", "shape": "train_4k",
                          "all": True, "multi_pod": True, "fed": True,
                          "no_fsdp": True, "no_remat": True, "out": "x",
                          "table": None}
    with pytest.raises(SystemExit):
        dryrun.parser().parse_args(["--save-hlo"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("one") / "out.pt")
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="1", RANK="0",
               LOCAL_RANK="0", OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, os.path.join(
        ROOT, "tests", "torch_sharded_worker.py"), "--one", out], env=env,
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    return torch.load(out)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-1.6b"])
def test_one_by_one_mesh_train_steps_are_the_plain_steps(one_rank, arch):
    assert one_rank[arch]["log_equal"]
    assert one_rank[arch]["params_differing"] == []


def test_one_by_one_silo_round_is_the_plain_round(one_rank):
    assert one_rank["pod"]["keep_bits_equal"]
    assert one_rank["pod"]["params_differing"] == []


def test_one_by_one_serving_is_the_plain_serving(one_rank):
    assert len(one_rank["serve_equal"]) == 9
    assert all(one_rank["serve_equal"])
