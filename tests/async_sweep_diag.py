"""Where card and CPU part in one async round: ``async-flaky`` with
corrupt_rate 0.1 on LeNet-28, M = 32, under fig5's kernel masking and under
random masking (gamma 0.5), the same participant scores and event seeds on
both devices.  Before each round two CPU servers take the card's parameters
and store state: ``cpu`` runs its own cohort sweep, ``fed`` is handed the
card's.  Prints one JSON line a round: per leaf the parameter difference
from the card (largest, the leaf's largest magnitude, norm-relative) for
both, the largest per-client loss difference of the two sweeps, and per leaf
of the uploads the entries kept on one device only (``flips``) and the
largest difference elsewhere relative to the client row's largest entry.
Not a tier-1 test: a standalone script for the card.

    PYTHONPATH=src python tests/async_sweep_diag.py [ROUNDS]
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.core import strategy  # noqa: E402


def upload_diffs(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Card rows ``a`` against CPU rows ``b`` of one stacked upload leaf."""
    a2, b2 = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    flips = (a2 != 0) ^ (b2 != 0)
    rowmax = b2.abs().max(1, keepdim=True).values.clamp_min(1e-30)
    rel = ((a2 - b2).abs() / rowmax)[~flips]
    return {"flips": int(flips.sum()),
            "rel_to_row_max": float(rel.max()) if rel.numel() else 0.0}


def main(rounds: int) -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    from repro_torch.kernels import build
    build.library()
    print(cs.gpu_line(), flush=True)
    base = strategy.get("async-flaky")
    chaos = base.replace(async_cfg=dataclasses.replace(base.async_cfg,
                                                       corrupt_rate=0.1))
    rng = np.random.default_rng(11)
    draws = {t: rng.random(cs.MAIN_M).astype(np.float32)
             for t in range(1, rounds + 1)}
    for label, st in (("kernel", cs.kernel_masking(chaos)),
                      ("random", chaos.with_masking(
                          strategy.MaskPolicy.random(0.5)))):
        runs = {}
        for name, device in (("card", "cuda"), ("cpu", "cpu"),
                             ("fed", "cpu")):
            server, batches, ns, _ = cs.lenet_server(
                st, cs.MAIN_M, 28, cs.MAIN_M * 8 * cs.MAIN_BATCH,
                cs.MAIN_BATCH, device, engine="async",
                scores=lambda t, m: draws[t], event_seed=lambda t: [t, 2026])
            runs[name] = (server, batches, ns)
        sweeps = {}

        def record(key):
            def wrap(compute):
                def run(*args):
                    res = compute(*args)
                    sweeps[key] = cs.host_copy(res)
                    return res
                return run
            return wrap

        def feed(compute):
            return lambda *args: cs.host_copy(sweeps["card"])

        cs.tap_sweep(runs["card"][0], record("card"))
        cs.tap_sweep(runs["cpu"][0], record("cpu"))
        cs.tap_sweep(runs["fed"][0], feed)
        gpu = runs["card"][0]
        for t in range(1, rounds + 1):
            for name in ("cpu", "fed"):
                runs[name][0].params = {k: v.detach().cpu().clone()
                                        for k, v in gpu.params.items()}
                runs[name][0].store.load_state(gpu.store.state())
            for server, batches, ns in runs.values():
                with cs.deterministic_cudnn():
                    server.run(batches, ns, 1)
            line = {"masking": label, "round": t}
            for name in ("cpu", "fed"):
                line[f"params_{name}"] = {
                    k: [float((v.cpu() - w).abs().max()),
                        float(w.abs().max()),
                        float((v.cpu() - w).norm() / w.norm())]
                    for k, v in gpu.params.items()
                    for w in (runs[name][0].params[k],)}
            la, lb = sweeps["card"]["losses"], sweeps["cpu"]["losses"]
            line["loss_rel_max"] = float(((la - lb).abs() / lb.abs()).max())
            line["uploads"] = {
                k: upload_diffs(v, sweeps["cpu"]["uploads"][k])
                for k, v in sweeps["card"]["uploads"].items()}
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 6)
