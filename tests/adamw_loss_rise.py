"""Classify the loss that rises under AdamW at full width: the reference's
``make_train_step`` and the port's, both on the CPU, for a few AdamW steps
at 3e-4 on qwen2-1.5b at full width, from one init (the reference's
``init_params(PRNGKey(0))``, carried across by ``bridge``), on batches of
1 x T tokens of ``launch.train``'s Markov text: one batch repeated every
step, or a fresh one each step.  Not a tier-1 test: a standalone script.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/adamw_loss_rise.py \\
        [--layers N] [--tokens T] [--steps S] [--lr LR] [--batches one|fresh]

``--layers`` cuts the depth (default: the config's 28); every width, the
vocabulary and the compute dtype stay the config's.  Each package runs in
a process of its own, one after the other, so the two AdamW states never
share the memory: at 28 layers each takes about 25 GB for its parameters,
moments and gradients, and at 2 layers about 5 GB.

Prints one JSON line: each package's loss and gradient norm per step, the
largest relative difference of the losses, and whether each package's
loss rose over the steps.  If the reference's loss rises as the port's
does, the rise belongs to the recipe (the learning rate on random
weights), not to the port.
"""

import argparse
import dataclasses
import json
import subprocess
import sys

import numpy as np


def _config(layers: int):
    from repro.configs import get_arch as ref_get_arch
    from repro_torch.configs import get_arch
    rcfg, cfg = ref_get_arch("qwen2-1.5b"), get_arch("qwen2-1.5b")
    if layers:
        rcfg = dataclasses.replace(rcfg, num_layers=layers)
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return rcfg, cfg


def _batches(cfg, args) -> list:
    """Each step's batch of 1 x T tokens, numpy: ``launch.train``'s Markov
    text (its ``synth_batches``, as the card's training phase feeds it),
    the first batch every step with ``--batches one``, a fresh one each
    step with ``--batches fresh``."""
    from repro_torch.launch import train
    out = train.synth_batches(cfg, 1, args.tokens, args.steps, seed=0)
    out = [{k: v.numpy() for k, v in b.items()} for b in out]
    return [out[0]] * args.steps if args.batches == "one" else out


def _init(rcfg):
    """The reference's init, as numpy."""
    import jax
    from repro.models import transformer as ref_tr
    return jax.tree.map(np.asarray, ref_tr.init_params(
        jax.random.PRNGKey(0), rcfg))


def run_reference(args) -> list:
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as ref_steps
    rcfg, _ = _config(args.layers)
    params = jax.tree.map(jnp.asarray, _init(rcfg))
    step_fn = ref_steps.make_train_step(rcfg, learning_rate=args.lr)
    state = step_fn.optimizer.init(params)
    step = jax.jit(step_fn)
    log = []
    for batch in _batches(_config(args.layers)[1], args):
        params, state, m = step(params, state, batch)
        log.append([float(m["loss"]), float(m["grad_norm"])])
    return log


def run_port(args) -> list:
    import torch
    from repro_torch import bridge
    from repro_torch.launch import steps
    rcfg, cfg = _config(args.layers)
    params = bridge.params_from_numpy(_init(rcfg), device="cpu")
    step = steps.make_train_step(cfg, learning_rate=args.lr)
    state = step.optimizer.init(params)
    log = []
    for batch in _batches(cfg, args):
        batch = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
        params, state, m = step(params, state, batch)
        log.append([float(m["loss"]), float(m["grad_norm"])])
    return log


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="depth (default: the config's 28)")
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--batches", choices=("one", "fresh"), default="one",
                    help="one batch every step, or a fresh one each step")
    ap.add_argument("--only", choices=("reference", "port"), default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.only:
        run = run_reference if args.only == "reference" else run_port
        print(json.dumps(run(args)))
        return
    logs = {}
    for which in ("reference", "port"):
        out = subprocess.run(
            [sys.executable, __file__, "--only", which, "--layers",
             str(args.layers), "--tokens", str(args.tokens), "--steps",
             str(args.steps), "--lr", str(args.lr), "--batches",
             args.batches],
            capture_output=True, text=True, check=True)
        logs[which] = json.loads(out.stdout.strip().splitlines()[-1])
    ref, port = ([s[0] for s in logs[w]] for w in ("reference", "port"))
    print(json.dumps({
        "arch": "qwen2-1.5b", "layers": args.layers or 28,
        "tokens": args.tokens, "steps": args.steps, "lr": args.lr,
        "batches": args.batches,
        "reference_loss": ref, "port_loss": port,
        "reference_grad_norm": [s[1] for s in logs["reference"]],
        "port_grad_norm": [s[1] for s in logs["port"]],
        "max_loss_rel_diff": max(abs(a - b) / abs(b)
                                 for a, b in zip(port, ref)),
        "reference_rose": ref[-1] > ref[0], "port_rose": port[-1] > port[0],
    }))


if __name__ == "__main__":
    main()
