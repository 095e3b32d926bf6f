"""Batched serving entry point (counterpart of ``repro/launch/serve.py``): feed
a batch of prompts through decode steps, then decode tokens greedily or by
temperature.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu

Without ``--device`` it runs on ``cuda`` and raises when there is no card.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tr

__all__ = ["sample_tokens", "generate", "main"]


def sample_tokens(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0) -> torch.Tensor:
    """logits (B, 1, V) -> next tokens (B, 1) int32: the argmax, or a draw
    from softmax(logits / temperature) with ``generator`` (on the logits'
    device)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draws = torch.multinomial(flat, 1, generator=generator)
    return draws.reshape(probs.shape[:-1]).to(torch.int32)


def generate(cfg, params, prompts: torch.Tensor, gen_len: int, max_seq: int,
             temperature: float = 0.0, seed: int = 0) -> torch.Tensor:
    """prompts: (B, P) int.  Returns (B, gen_len) int32 tokens.

    As the reference does, the prompt goes through decode steps one token
    at a time (simple and exact: no blocked prefill carries state), then
    ``gen_len`` tokens are sampled, each fed back.  Temperature sampling
    draws from a ``torch.Generator`` seeded ``seed`` on the prompts'
    device."""
    B, P = prompts.shape
    device = prompts.device
    state = tr.init_decode_state(cfg, B, max_seq, device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    params = tr.layer_view(params, cfg)
    with torch.no_grad():
        logits = None
        for i in range(P):
            logits, state = tr.decode_step(params, cfg, state,
                                           prompts[:, i:i + 1])
        out = [sample_tokens(logits, generator, temperature)]
        for _ in range(gen_len - 1):
            logits, state = tr.decode_step(params, cfg, state, out[-1])
            out.append(sample_tokens(logits, generator, temperature))
    return torch.cat(out, dim=-1)


def main(argv=None) -> None:
    """The command-line demo: init, generate, print the throughput."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = tr.init_params(gen, cfg, cfg.param_dtype_serve, device=device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)

    t0 = time.perf_counter()
    toks = generate(cfg, params, prompts, args.gen,
                    args.prompt_len + args.gen + 1, args.temperature,
                    args.seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_gen = args.batch * args.gen
    print(f"generated {tuple(toks.shape)} on {device} in {dt:.2f}s "
          f"({n_gen / dt:.1f} tok/s batch throughput)")
    print(toks[0, :12].tolist())


if __name__ == "__main__":
    main()
