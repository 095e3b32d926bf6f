"""Federated training of a reduced qwen2-family LM on the PyTorch port with
dynamic sampling and selective masking: the paper's technique applied to a
transformer through the pod round (``launch/fedtrain.py``; the port's
counterpart of ``examples/federated_lm.py``).

  PYTHONPATH=src python examples/federated_lm_torch.py --rounds 20

The default reduced qwen2-1.5b (1 layer, d 256) over 8 clients x 25 rounds
x 2 local steps is 400 client SGD steps.  It runs on the card;
``--device cpu`` runs it on the CPU.  Participants are drawn from a torch
generator seeded 1, so the sampled clients are not the reference
example's (its draws come from a JAX key); m_t is the same.
"""

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.core import strategy
from repro_torch.core.sampling import DynamicSampling, participation_mask
from repro_torch.core.strategy import MaskPolicy
from repro_torch.data.synthetic import markov_text
from repro_torch.device import resolve_device
from repro_torch.launch.fedtrain import FedPodConfig, make_fed_round
from repro_torch.models import transformer as tr


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=25)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--gamma", type=float, default=0.2)
    ap.add_argument("--beta", type=float, default=0.05)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    C, S = args.clients, args.local_steps
    # The pod round collapses to one strategy record: the "fig5" preset
    # (dynamic sampling, selective masking, the sparse COO wire)
    # specialised to the command line's beta, gamma and learning rate.
    strat = strategy.get(
        "fig5",
        sampling=DynamicSampling(initial_rate=1.0, beta=args.beta),
        masking=MaskPolicy.selective(args.gamma),
        learning_rate=args.lr)
    schedule = strat.sampling
    fed_cfg = FedPodConfig.from_strategy(strat, num_clients=C, local_steps=S)
    fed_round = make_fed_round(cfg, fed_cfg)

    data = markov_text(num_train=C * args.rounds * S * args.batch * args.seq
                       + args.seq, vocab_size=min(cfg.vocab_size, 512),
                       seed=0)
    params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                            device=device)
    n_samples = torch.ones(C)
    gen = torch.Generator().manual_seed(1)

    ev = torch.from_numpy(
        data.test_tokens[: 16 * args.seq + 1].astype("int64"))
    ev_x = (ev[:-1].reshape(16, args.seq) % cfg.vocab_size).to(device)
    ev_y = (ev[1:].reshape(16, args.seq) % cfg.vocab_size).to(device)

    def eval_ppl(p) -> float:
        with torch.no_grad():
            logits, _ = tr.forward(p, cfg, ev_x)
            return float(torch.exp(tr.cross_entropy(logits, ev_y)))

    toks = torch.from_numpy(data.train_tokens.astype("int64"))
    per_round = C * S * args.batch * args.seq
    total_transport = 0.0
    for t in range(1, args.rounds + 1):
        part = participation_mask(torch.rand(C, generator=gen), schedule, t,
                                  C)
        w = toks[(t - 1) * per_round: t * per_round + 1]
        x = w[:-1].reshape(C, S, args.batch, args.seq) % cfg.vocab_size
        y = w[1:].reshape(C, S, args.batch, args.seq) % cfg.vocab_size
        t0 = time.perf_counter()
        params, m = fed_round(params, {"tokens": x, "labels": y}, n_samples,
                              part, key=(1, t))
        total_transport += float(m["num_sampled"]) * fed_cfg.gamma
        if device.type == "cuda":
            torch.cuda.synchronize()
        if t % 5 == 0 or t == 1:
            print(f"round {t:3d}: sampled={int(m['num_sampled'])}/{C} "
                  f"loss={float(m['mean_loss']):.3f} "
                  f"eval_ppl={eval_ppl(params):.1f} "
                  f"transport={total_transport:.1f}u "
                  f"dt={time.perf_counter() - t0:.2f}s", flush=True)
    print(f"done: total transport {total_transport:.1f} full-model units "
          f"(dense-static would be {args.rounds * C * 1.0:.0f})")


if __name__ == "__main__":
    main()
