"""Batched serving demo on the PyTorch port: prompts fed through decode
steps with KV caches, then sampled tokens, on a reduced arch (the port's
counterpart of ``examples/serve_demo.py``).

  PYTHONPATH=src python examples/serve_demo_torch.py --arch gemma2-2b --gen 24

It runs on the card; ``--device cpu`` runs it on the CPU.
"""

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as tr


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    gen = torch.Generator(device=device).manual_seed(0)
    params = tr.init_params(gen, cfg, cfg.param_dtype_serve, device=device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)

    t0 = time.perf_counter()
    toks = generate(cfg, params, prompts, args.gen,
                    args.prompt_len + args.gen + 1, args.temperature)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name}: generated {tuple(toks.shape)} tokens on "
          f"{device} in {dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s)")
    print("sample:", toks[0, :10].tolist())


if __name__ == "__main__":
    main()
