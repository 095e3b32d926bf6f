"""Run the three one-device-operation card tests' traced sessions many
times in one process and tally each session's records: the kernel's, the
two marker fills' and any other.  Not a tier-1 test: a standalone script
for the card.

    PYTHONPATH=src python tests/profile_count_loop.py [RUNS]
"""

import collections
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_cuda as T  # noqa: E402
from repro_torch.kernels import topk_mask as tk  # noqa: E402


def main(runs: int) -> None:
    dev = torch.device("cuda")
    x = torch.randn(147_456, device=dev)
    t = torch.tensor(0.5, device=dev)
    calls = {"exponent_hist_kernel": lambda: tk.exponent_histogram(x),
             "count_ge_kernel": lambda: tk.count_ge(x, t),
             "apply_threshold_kernel": lambda: tk.apply_threshold(x, t)}
    out = {}
    for kernel, call in calls.items():
        tally = collections.Counter()
        fails = 0
        for i in range(runs):
            prof = T._profiled_calls(call, dev)
            recs = T._device_records(prof)
            ours = sum(kernel in r[0] for r in recs)
            marks = sum(T.MARKER in r[0] for r in recs)
            tally[(ours, marks, len(recs) - ours - marks)] += 1
            try:
                T._assert_one_kernel_record_a_call(prof, kernel, 10)
            except AssertionError as e:
                fails += 1
                print("FAIL", kernel, i, str(e)[:2000], flush=True)
        out[kernel] = {"failures": fails,
                       "sessions (kernel, markers, other records)":
                       {str(k): v for k, v in tally.items()}}
    print({"runs": runs, **out}, flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20)
