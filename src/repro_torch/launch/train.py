"""Training driver of the port (counterpart of ``repro/launch/train.py``).

Two modes:
* ``--mode standard``  -- plain LM training: ``make_train_step`` (AdamW by
  the "auto" rule, gradients clipped to norm 1, fp32 master weights cast
  once a step to the compute dtype).
* ``--mode federated`` -- the paper's technique on the model zoo: federated
  rounds with dynamic sampling and selective masking
  (``launch/fedtrain.py``).  Under ``torchrun`` the round is the cohort
  form on ``torch.distributed`` (NCCL on the card, gloo on the CPU), each
  rank running its share of the clients.

On the CPU, with a reduced architecture:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --device cpu --steps 10 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
      --reduced --device cpu --mode federated --rounds 5 --clients 4 \\
      --gamma 0.2 --beta 0.1

(the second is the reference's own federated command).  On the card the
same commands without ``--device`` (and without ``--reduced`` for the full
width, e.g. ``--arch rwkv6-1.6b --mode federated --clients 4 --gamma 0.5
--beta 0.1 --batch 1 --seq 4096``); the cohort form with ``torchrun
--nproc_per_node 1 -m repro_torch.launch.train ... --mode federated``.
Every arch of the port trains on both devices: rwkv6-1.6b's wkv6 and
hymba-1.5b's ssm_scan run their backward kernels on the card.

Sharded standard training (``--mesh DxM`` or ``PxDxM``) runs under
``torchrun`` with as many ranks as the mesh has, NCCL on cards, gloo on
the CPU:

  torchrun --nproc_per_node 4 -m repro_torch.launch.train --arch \
      qwen2-1.5b --reduced --device cpu --mesh 2x2 --steps 3 --batch 4

The parameters, optimizer state and batches are laid out as the
reference's ``run_standard`` lays them out (``launch/shardings.py``:
FSDP over "data", tensor parallel over "model") and the step runs with
``mesh_hints``.  Each rank draws the whole model from the seed and keeps
its shards, so a model must fit one device to start.  A federated run
under ``torchrun`` takes a mesh naming as many devices as there are
ranks.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Optional

import torch

from repro_torch.bridge import unflatten_tree
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.core.sampling import (DynamicSampling, StaticSampling,
                                       participation_mask)
from repro_torch.data.synthetic import markov_text
from repro_torch.device import resolve_device
from repro_torch.launch import shardings as sh
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.fedtrain import (FedPodConfig, make_cohort_fed_round,
                                         make_fed_round)
from repro_torch.models import transformer as tr

__all__ = ["make_mesh_arg", "synth_batches", "run_standard",
           "run_federated", "main"]


def make_mesh_arg(spec: str, device_type: Optional[str] = None):
    """The ``DeviceMesh`` of a ``--mesh`` string: "M" -> ("model",), "DxM"
    -> ("data", "model"), "PxDxM" -> ("pod", "data", "model"), over the
    default process group's ranks."""
    from repro_torch.launch.mesh import make_mesh
    dims = tuple(int(x) for x in spec.split("x"))
    names = {1: ("model",), 2: ("data", "model"),
             3: ("pod", "data", "model")}[len(dims)]
    return make_mesh(dims, names, device_type)


def synth_batches(cfg, batch: int, seq: int, steps: int, seed: int = 0):
    """``steps`` batches ``{"tokens", "labels"}`` of (batch, seq) int32
    (CPU tensors) cut from one Markov text over ``min(vocab, 512)``
    tokens, labels shifted by one, as the reference's."""
    data = markov_text(num_train=(batch * seq + 1) * steps + 1,
                       vocab_size=min(cfg.vocab_size, 512), seed=seed)
    toks = torch.from_numpy(data.train_tokens)
    out = []
    for i in range(steps):
        w = toks[i * batch * seq:(i + 1) * batch * seq + 1]
        x = w[:-1].reshape(batch, seq) % cfg.vocab_size
        y = w[1:].reshape(batch, seq) % cfg.vocab_size
        out.append({"tokens": x, "labels": y})
    return out


def _mesh_devices(spec: str) -> int:
    return math.prod(int(d) for d in spec.split("x"))


def _init(args, cfg, device):
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return tr.init_params(gen, cfg, device=device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _init_distributed(device):
    """The default process group from ``torchrun``'s environment (NCCL on
    a card, gloo on the CPU) and this rank's device."""
    import torch.distributed as dist
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    return device


def run_standard(args, cfg, device):
    """``args.steps`` training steps; prints one line a step.  Under
    ``torchrun`` the step is sharded over ``--mesh``."""
    distributed = "WORLD_SIZE" in os.environ
    if not distributed and _mesh_devices(args.mesh) != 1:
        raise ValueError(f"--mesh {args.mesh}: a sharded run starts under "
                         f"torchrun with one rank a device")
    mesh = None
    if distributed:
        device = _init_distributed(device)
        mesh = make_mesh_arg(args.mesh, device.type)
    hints = steps_lib.mesh_hints(mesh)
    step = steps_lib.make_train_step(cfg, learning_rate=args.lr, hints=hints)
    params = _init(args, cfg, device)
    opt_state = step.optimizer.init(params)
    batches = synth_batches(cfg, args.batch, args.seq, args.steps, args.seed)
    if mesh is not None:
        psh = sh.params_shardings(params, mesh)
        params = sh.distribute_tree(params, psh)
        opt_state = sh.distribute_tree(
            opt_state, sh.params_shardings_like(opt_state, psh, mesh))
        bsh = sh.batch_shardings(batches[0], mesh)
    for i, b in enumerate(batches):
        b = {k: v.to(device) for k, v in b.items()}
        if mesh is not None:
            b = sh.distribute_tree(b, bsh)
        t0 = time.time()
        params, opt_state, m = step(params, opt_state, b)
        print(f"step {i}: loss={float(sh.whole(m['loss'])):.4f} "
              f"gnorm={float(sh.whole(m['grad_norm'])):.3f} "
              f"dt={time.time() - t0:.2f}s", flush=True)
    if mesh is not None:
        params = {k: sh.whole(v) for k, v in params.items()}
    if args.ckpt and (mesh is None or torch.distributed.get_rank() == 0):
        save_checkpoint(args.ckpt, args.steps, unflatten_tree(params))
    if distributed:
        torch.distributed.destroy_process_group()
    return params


def run_federated(args, cfg, device):
    """``args.rounds`` pod rounds; prints one line a round.  Under
    ``torchrun`` (``WORLD_SIZE`` set) the cohort form runs over the
    process group, with the whole fleet as the cohort."""
    C = args.clients
    fed_cfg = FedPodConfig(num_clients=C, local_steps=args.local_steps,
                           learning_rate=args.lr, gamma=args.gamma,
                           masking=args.masking)
    schedule = (DynamicSampling(initial_rate=args.init_rate, beta=args.beta)
                if args.beta > 0
                else StaticSampling(initial_rate=args.init_rate))
    distributed = "WORLD_SIZE" in os.environ
    if distributed:
        import torch.distributed as dist
        device = _init_distributed(device)
        world = dist.get_world_size()
        cohort = make_cohort_fed_round(cfg, fed_cfg, cohort_size=C)
    else:
        world = 1
        full = make_fed_round(cfg, fed_cfg)
    if _mesh_devices(args.mesh) != world:
        raise ValueError(f"--mesh {args.mesh} names {_mesh_devices(args.mesh)}"
                         f" devices; this run has {world}")

    params = _init(args, cfg, device)
    data = synth_batches(cfg, C * args.batch, args.seq,
                         args.local_steps * args.rounds, args.seed)
    n_samples = torch.ones((C,), dtype=torch.float32)
    gen = torch.Generator().manual_seed(args.seed + 1)
    for t in range(1, args.rounds + 1):
        part = participation_mask(torch.rand(C, generator=gen), schedule, t,
                                  C)
        sl = data[(t - 1) * args.local_steps: t * args.local_steps]
        S = len(sl)
        batches = {
            name: torch.stack([b[name] for b in sl], 0)
            .reshape(S, C, args.batch, args.seq).transpose(0, 1)
            for name in ("tokens", "labels")}
        t0 = time.time()
        if distributed:
            params, m = cohort(params, batches, n_samples, range(C), part,
                               key=(args.seed + 1, t))
        else:
            params, m = full(params, batches, n_samples, part,
                             key=(args.seed + 1, t))
        _sync(device)
        print(f"round {t}: sampled={int(m['num_sampled'])}/{C} "
              f"loss={float(m['mean_loss']):.4f} "
              f"transport={float(m['num_sampled']) * fed_cfg.gamma:.2f} "
              f"model-units dt={time.time() - t0:.2f}s", flush=True)
    if args.ckpt and (not distributed or torch.distributed.get_rank() == 0):
        save_checkpoint(args.ckpt, args.rounds, unflatten_tree(params))
    if distributed:
        torch.distributed.destroy_process_group()
    return params


def main(argv=None) -> None:
    """Parse the reference's flags (plus ``--device``) and run a mode."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", default="standard",
                    choices=["standard", "federated"])
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--gamma", type=float, default=0.1)
    ap.add_argument("--beta", type=float, default=0.0)
    ap.add_argument("--init-rate", type=float, default=1.0)
    ap.add_argument("--masking", default="selective",
                    choices=["selective", "random", "none"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.mode == "standard":
        run_standard(args, cfg, device)
    else:
        run_federated(args, cfg, device)


if __name__ == "__main__":
    main()
