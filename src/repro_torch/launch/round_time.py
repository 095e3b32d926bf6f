"""Round times of one preset in a fresh process (``fig5`` unless
``--preset`` names another): LeNet-28, M = 32 clients, 8 rounds, selective
masking on the kernel backend where the preset masks; each round's
``wall_s`` and ``compile_s``, and round 1's ``wall_s`` against the median of
the later rounds'.  A preset with a hetero fleet also reports the simulated
clock (``sim_total_s``) and the lost uploads.

    PYTHONPATH=src python -m repro_torch.launch.round_time --device cpu
    PYTHONPATH=src python -m repro_torch.launch.round_time --preset noniid-dyn

Prints one JSON line.  On a card the kernel library's ``nvcc`` build (or
the load of a library already built) lands in round 1's ``compile_s``,
and so do the scan form's CUDA-graph warm-up and capture, which take
eager PyTorch's first-call setup (cuDNN and cuBLAS handles, the first
``vmap``) with them; each round's ``wall_s`` is its segment's mean
(``FederatedServer``'s ``scan_rounds``).  Without ``--device`` it runs on
``cuda`` and raises when there is no card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics

import torch

from repro_torch.core import strategy
from repro_torch.core.server import FederatedServer
from repro_torch.data.partition import iid_partition_images
from repro_torch.data.synthetic import class_gaussian_images
from repro_torch.models import paper_models as pm

__all__ = ["round_times", "main"]


def round_times(device=None, clients: int = 32, rounds: int = 8,
                batch: int = 32, image_size: int = 28,
                preset: str = "fig5") -> dict:
    """Run one preset's path once; per-round ``wall_s``, ``compile_s`` and
    cohort buckets, and round 1 against the median of the others."""
    ds = class_gaussian_images(num_train=clients * 8 * batch,
                               image_size=image_size, seed=0)
    xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, clients, batch,
                                      seed=0)
    st = strategy.get(preset)
    if st.masking.mode == "selective":
        st = st.with_masking(dataclasses.replace(st.masking,
                                                 backend="kernel"))
    server = FederatedServer.from_strategy(
        st, pm.classifier_loss(pm.lenet_forward),
        pm.init_lenet(torch.Generator().manual_seed(0),
                      image_size=image_size, device=device),
        clients, seed=0, device=device)
    server.run((xs, ys), ns, rounds)
    walls = [r.wall_s for r in server.history]
    later = statistics.median(walls[1:]) if len(walls) > 1 else float("nan")
    summ = server.summary()
    fleet = ({"sim_total_s": summ["sim_total_s"],
              "dropped_uploads": summ["dropped_uploads"]}
             if "hetero" in summ else {})
    return {"device": summ["device"],
            "device_name": (torch.cuda.get_device_name(server.device)
                            if server.device.type == "cuda" else "cpu"),
            "buckets": [r.cohort_size for r in server.history],
            "wall_s": walls,
            "compile_s": [r.compile_s for r in server.history],
            "first_round_s": walls[0], "later_median_s": later,
            "first_over_later": walls[0] / later,
            "summary_compile_s": summ["compile_s"],
            "steady_wall_s": summ["steady_wall_s"], **fleet}


def main(argv=None) -> None:
    """Command-line entry point."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--preset", default="fig5", choices=strategy.names(),
                    help="the strategy preset to time (default fig5)")
    args = ap.parse_args(argv)
    print(json.dumps(round_times(args.device, preset=args.preset)))


if __name__ == "__main__":
    main()
