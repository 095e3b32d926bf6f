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
    """logits (B, 1, V) -> next tokens (B, 1) int32 (audio: (B, 1, K, V)
    -> (B, 1, K)): the argmax, or a draw from softmax(logits /
    temperature) with ``generator`` (on the logits' device)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draws = torch.multinomial(flat, 1, generator=generator)
    return draws.reshape(probs.shape[:-1]).to(torch.int32)


def generate(cfg, params, prompts: torch.Tensor, gen_len: int, max_seq: int,
             temperature: float = 0.0, seed: int = 0) -> torch.Tensor:
    """prompts: (B, P) int, or (B, K, P) codebook grids for audio.  Returns
    (B, gen_len) int32 tokens, or (B, K, gen_len).

    As the reference does, the prompt goes through decode steps one token
    at a time (simple and exact: no blocked prefill carries state), then
    ``gen_len`` tokens are sampled, each fed back; an audio draw (B, 1, K)
    is fed back as (B, K, 1).  Temperature sampling draws from a
    ``torch.Generator`` seeded ``seed`` on the prompts' device.

    There is no ``prefix_embeds`` argument: the reference's ``generate``
    takes one and never reads it, so a VLM served through it never sees
    its image (ROADMAP Queue 3).  Here a vision config decodes its text
    tokens alone, as the reference's does, and says so by its signature."""
    audio = tr.is_audio(cfg)
    B, P = prompts.shape[0], prompts.shape[-1]
    device = prompts.device
    state = tr.init_decode_state(cfg, B, max_seq, device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    params = tr.layer_view(params, cfg)
    with torch.no_grad():
        logits = None
        for i in range(P):
            logits, state = tr.decode_step(params, cfg, state,
                                           prompts[..., i:i + 1])
        out = []
        for i in range(gen_len):
            if i:
                logits, state = tr.decode_step(params, cfg, state, out[-1])
            tok = sample_tokens(logits, generator, temperature)
            out.append(tok.transpose(1, 2) if audio else tok)
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
    shape = (args.batch, args.prompt_len)
    if tr.is_audio(cfg):
        shape = (args.batch, cfg.num_codebooks, args.prompt_len)
    prompts = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                            device=device)

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
    print(toks[0, ..., :12].tolist())


if __name__ == "__main__":
    main()
