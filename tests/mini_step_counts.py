"""Per-device counts of the reduced mini train step (8 x 64 tokens), the
port beside the reference, on (1, 1), (8, 1) and (2, 4) ("data", "model")
meshes: FLOPs and collective bytes by family.

The port's come from ``launch/dryrun.trace_combo`` on a fake process
group of 1 or 8 ranks; the reference's from ``hlo.analyze`` of the same
step compiled by XLA on an Auto-axis ``jax.sharding.Mesh`` of 8 host CPU
devices (a subprocess, as ``tests/test_torch_dryrun.py`` compiles it),
with the reference's ``collective_bytes_bf16comm`` beside its total: the
CPU emitter widens bf16 collectives to fp32, and that figure counts
fp32 model-path collectives at half.  Counts, not times; no card.

  PYTHONPATH=src python tests/mini_step_counts.py [ARCH ...]

prints one markdown row a (arch, mesh); the default archs are
qwen2-1.5b and hymba-1.5b (about 4 minutes on one CPU core).
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

MESHES = ((1, 1), (8, 1), (2, 4))

REF = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.configs import get_arch
from repro.configs.base import InputShape
from repro.launch import shardings as sh, steps as steps_lib, hlo as hlo_lib
cfg = get_arch(sys.argv[1]).reduced()
out = {}
for dims in json.loads(sys.argv[2]):
    n = dims[0] * dims[1]
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(dims),
                             ("data", "model"))
    pspecs = steps_lib.params_specs(cfg, "float32")
    psh = sh.params_shardings(pspecs, mesh)
    step = steps_lib.make_train_step(cfg, hints=steps_lib.mesh_hints(mesh))
    opt = jax.eval_shape(step.optimizer.init, pspecs)
    osh = sh.params_shardings_like(opt, psh, mesh)
    batch = steps_lib.batch_specs(cfg, InputShape("mini", 64, 8, "train"))
    bsh = sh.batch_shardings(batch, mesh)
    fn = jax.jit(step, in_shardings=(psh, osh, bsh),
                 out_shardings=(psh, osh, None))
    with mesh:
        st = hlo_lib.analyze(fn.lower(pspecs, opt, batch).compile().as_text())
    out["%dx%d" % tuple(dims)] = {
        "flops": st.flops, "per_collective": st.per_collective,
        "collective_bytes": st.collective_bytes,
        "bf16comm": st.collective_bytes_bf16comm}
print(json.dumps(out))
"""


def port_counts(arch: str) -> dict:
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    cfg = get_arch(arch).reduced()
    out = {}
    for dims in MESHES:
        dryrun.init_fake(dims[0] * dims[1])
        try:
            mesh = make_mesh(dims, ("data", "model"), "cpu")
            rec = dryrun.trace_combo(cfg, InputShape("mini", 64, 8, "train"),
                                     mesh)
        finally:
            dist.destroy_process_group()
        out["%dx%d" % dims] = rec
    return out


def ref_counts(arch: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", REF, arch,
                          json.dumps([list(d) for d in MESHES])],
                         env=env, capture_output=True, text=True, cwd=ROOT)
    if run.returncode:
        raise SystemExit(run.stderr[-3000:])
    return json.loads(run.stdout.strip().splitlines()[-1])


def _families(per: dict) -> str:
    return ", ".join(f"{k} {int(v):,}" for k, v in sorted(per.items())) \
        or "none"


def main(archs) -> None:
    print("| arch | mesh | port FLOPs | port collective bytes | by family "
          "| reference FLOPs | reference bytes (bf16comm) | by family |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    for arch in archs:
        port, ref = port_counts(arch), ref_counts(arch)
        for key in ("%dx%d" % d for d in MESHES):
            p, r = port[key], ref[key]
            print(f"| `{arch}` | {key.replace('x', ' x ')} | "
                  f"{int(p['flops']):,} | {int(p['collective_bytes']):,} | "
                  f"{_families(p['per_collective'])} | {int(r['flops']):,} | "
                  f"{int(r['collective_bytes']):,} "
                  f"({int(r['bf16comm']):,}) | "
                  f"{_families(r['per_collective'])} |", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["qwen2-1.5b", "hymba-1.5b"])
