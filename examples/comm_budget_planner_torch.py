"""Communication-budget planner on the PyTorch port (paper Eq. 6 in
reverse; the port's counterpart of ``examples/comm_budget_planner.py``,
whose table it prints byte for byte): given a transport budget in
full-model-upload units, how many federated rounds each sampling schedule
and masking rate affords, and what one upload means at each of the ten
archs' full sizes.

  PYTHONPATH=src python examples/comm_budget_planner_torch.py --budget 100

The archs' parameters are ``meta`` tensors: nothing is allocated, so it
needs no card.
"""

import argparse

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.compression import pytree_payload_bytes
from repro_torch.core.sampling import (DynamicSampling, StaticSampling,
                                       cumulative_transport,
                                       rounds_for_budget)
from repro_torch.launch import steps as steps_lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=float, default=100.0,
                    help="transport budget in full-model-upload units")
    ap.add_argument("--clients", type=int, default=16)
    args = ap.parse_args(argv)

    print(f"budget = {args.budget} full-model uploads, "
          f"M = {args.clients} clients\n")
    print(f"{'schedule':22s} {'gamma':>6s} {'rounds':>7s} {'cost/round':>11s}")
    for name, sched in [
            ("static C=1.0", StaticSampling(initial_rate=1.0)),
            ("static C=0.5", StaticSampling(initial_rate=0.5)),
            ("dynamic b=0.01", DynamicSampling(initial_rate=1.0, beta=0.01)),
            ("dynamic b=0.1", DynamicSampling(initial_rate=1.0, beta=0.1))]:
        for gamma in (1.0, 0.1):
            r = rounds_for_budget(sched, gamma, args.clients, args.budget)
            per = cumulative_transport(sched, gamma, max(r, 1),
                                       args.clients) / max(r, 1)
            print(f"{name:22s} {gamma:6.2f} {r:7d} {per:11.2f}")

    print("\nwhat one full-model upload means per assigned arch "
          "(fp32 dense vs gamma=0.1 selective+bitmap):")
    for a in ARCH_IDS:
        specs = steps_lib.params_specs(get_arch(a))
        stats = pytree_payload_bytes(specs, gamma=0.1)
        print(f"  {a:28s} dense {stats.dense_bytes / 1e9:8.2f} GB   "
              f"masked {stats.sparse_bytes / 1e9:8.2f} GB "
              f"({stats.ratio:.2%})")


if __name__ == "__main__":
    main()
