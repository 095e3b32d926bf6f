"""Quickstart on the PyTorch port: the paper's two techniques through the
strategy API (the port's counterpart of ``examples/quickstart.py``).

A federated scenario is one object: ``strategy.get(name)`` returns a
``FedStrategy`` of sampling schedule, mask policy, wire codec and
aggregation rule, and ``FederatedServer.from_strategy`` runs it.  This
trains LeNet on a synthetic MNIST stand-in under five presets and prints
the accuracy-against-transport trade-off the paper is about, with
transport as the codec's exact wire bytes.

  PYTHONPATH=src python examples/quickstart_torch.py

It runs on the card; ``--device cpu`` runs it on the CPU.
"""

import argparse

import torch

from repro_torch.core import strategy
from repro_torch.core.server import FederatedServer
from repro_torch.core.strategy import MaskPolicy
from repro_torch.data.partition import iid_partition_images
from repro_torch.data.synthetic import class_gaussian_images
from repro_torch.device import resolve_device
from repro_torch.models.paper_models import (classifier_accuracy,
                                             classifier_loss, init_lenet,
                                             lenet_forward)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--image-size", type=int, default=12)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    M, img = args.clients, args.image_size
    data = class_gaussian_images(num_train=M * 128, num_test=512,
                                 image_size=img, noise=0.6, seed=0)
    xs, ys, n = iid_partition_images(data.train_x, data.train_y, M, 16,
                                     seed=0)
    eval_data = (torch.as_tensor(data.test_x, device=device),
                 torch.as_tensor(data.test_y, device=device))
    loss_fn = classifier_loss(lenet_forward)
    eval_fn = classifier_accuracy(lenet_forward)

    # Registry presets and field overrides: the paper's operating point
    # (Fig. 5) is dynamic sampling and selective top-k masking combined.
    settings = {
        "dense-baseline (static)": strategy.get("dense-baseline"),
        "fig3: dynamic sampling": strategy.get("fig3"),
        "fig4: selective g=0.1": strategy.get("fig4"),
        "fig5 @ g=0.1 (paper)": strategy.get(
            "fig5", masking=MaskPolicy.selective(0.1)),
        "fig5-int8 wire": strategy.get("fig5-int8"),
    }

    print(f"{'strategy':26s} {'accuracy':>9s} {'transport':>10s} "
          f"{'wire MB':>8s}  codec")
    for name, strat in settings.items():
        params = init_lenet(torch.Generator().manual_seed(0), img,
                            device=device)
        server = FederatedServer.from_strategy(
            strat, loss_fn, params, M, eval_fn=eval_fn, device=device)
        server.run((xs, ys), n, args.rounds, eval_every=args.rounds,
                   eval_data=eval_data)
        s = server.summary()
        print(f"{name:26s} {s['final_eval']:9.3f} "
              f"{s['transport_units']:10.2f} "
              f"{s['transport_bytes'] / 1e6:8.2f}  {s['codec']}")


if __name__ == "__main__":
    main()
