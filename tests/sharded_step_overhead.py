"""What the sharded layer adds to a train step on one card: qwen2-1.5b at
full width, AdamW at 3e-4, 1 x 4096 tokens a step, the plain
``make_train_step`` against the same step with ``mesh_hints`` on DTensor
parameters, optimizer state and batches on a 1 x 1 ("data", "model")
mesh over NCCL at world size 1.  One rank moves nothing, so the
difference is host work.  Not a tier-1 test: a standalone script for a
CUDA card.

    PYTHONPATH=src python tests/sharded_step_overhead.py [--steps N] \\
        [--passes P]

Each pass runs the two sides in the order plain, sharded, sharded, plain,
every run from the same weights: one warm-up step, then ``--steps`` timed
steps, each timed on the wall clock between two device synchronisations.
Prints one JSON line: the card, every step's seconds by run, each run's
median timed step, and per pass the mean of the sharded runs' medians
less the mean of the plain runs'.
"""

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def run(label: str, cfg, params0: dict, batches: list, mesh) -> list:
    """One run of ``label`` ("plain" or "sharded"): the seconds of each of
    its steps, the warm-up first."""
    import torch

    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps
    hints = steps.mesh_hints(mesh) if label == "sharded" else None
    step = steps.make_train_step(cfg, learning_rate=3e-4, hints=hints)
    params = dict(params0)
    opt = step.optimizer.init(params)
    feed = batches
    if hints is not None:
        psh = sh.params_shardings(params, mesh)
        params = sh.distribute_tree(params, psh)
        opt = sh.distribute_tree(opt,
                                 sh.params_shardings_like(opt, psh, mesh))
        feed = [sh.distribute_tree(b, sh.batch_shardings(b, mesh))
                for b in batches]
    seconds = []
    for b in feed:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, b)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    del params, opt
    torch.cuda.empty_cache()
    return seconds


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3,
                    help="timed steps a run, after one warm-up step")
    ap.add_argument("--passes", type=int, default=2,
                    help="passes of plain, sharded, sharded, plain")
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tr
    cfg = get_arch("qwen2-1.5b")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        params0 = tr.init_params(torch.Generator(device="cuda")
                                 .manual_seed(0), cfg, device="cuda")
        batches = [{k: v.cuda() for k, v in b.items()} for b in
                   train.synth_batches(cfg, 1, 4096, args.steps + 1)]
        runs, gaps = [], []
        for p in range(args.passes):
            medians = {"plain": [], "sharded": []}
            for label in ("plain", "sharded", "sharded", "plain"):
                seconds = run(label, cfg, params0, batches, mesh)
                median = statistics.median(seconds[1:])
                medians[label].append(median)
                runs.append({"pass": p, "side": label, "step_s": seconds,
                             "median_timed_s": median})
            gaps.append(statistics.mean(medians["sharded"])
                        - statistics.mean(medians["plain"]))
    finally:
        dist.destroy_process_group()
    print(json.dumps({"card": _card(), "torch": torch.__version__,
                      "arch": cfg.name, "tokens_per_step": 4096,
                      "timed_steps": args.steps, "runs": runs,
                      "sharded_minus_plain_s": gaps}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
