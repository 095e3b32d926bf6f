"""Count the keep-bit flips between the reference's and the port's 20-round
``fig5`` runs with kernel masking (LeNet-12, M = 8, the port fed the
reference's participant scores), on the CPU.  Not a tier-1 test: a
standalone script that classifies the 20-round drift.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/drift_flips.py [ROUNDS]

Each round it records both packages' pre-mask cohort deltas and masked
outputs and prints, as one JSON line: the entries whose keep bit differs,
how many of them lie within 4 ulps of a threshold, the first few flips'
distances from each run's per-segment tau in ulps of that tau (tau as the
port's kernels compute it on each run's delta), and how many entries
differ when the port masks the reference's own delta (``same_input``).
"""

import collections
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from repro.core import strategy as jst  # noqa: E402
from repro.core.server import FederatedServer as JaxServer  # noqa: E402
from repro.data.partition import iid_partition_images  # noqa: E402
from repro.data.synthetic import class_gaussian_images  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import paper_models as jpm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import strategy as tst  # noqa: E402
from repro_torch.core.server import FederatedServer  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import paper_models as tpm  # noqa: E402
from test_torch_slice import reference_scores  # noqa: E402

M, BATCH = 8, 16


def record_runs(rounds: int):
    """Both servers' runs; the reference's masking records one client at a
    time (it runs under vmap), the port's one cohort a round."""
    ref_log, port_log = [], []
    real_j, real_t = jops.topk_mask_pytree, tops.topk_mask_stacked

    def rec_j(tree, gamma, **kw):
        out = real_j(tree, gamma, **kw)
        jax.debug.callback(lambda a, b: ref_log.append((a, b)), tree, out,
                           ordered=True)
        return out

    def rec_t(tree, gamma, **kw):
        out = real_t(tree, gamma, **kw)
        port_log.append(({k: v.clone().numpy() for k, v in tree.items()},
                         {k: v.clone().numpy() for k, v in out.items()}))
        return out

    jops.topk_mask_pytree, tops.topk_mask_stacked = rec_j, rec_t
    ds = class_gaussian_images(num_train=512, image_size=12, seed=0)
    xs, ys, ns = iid_partition_images(ds.train_x, ds.train_y, M, BATCH,
                                      seed=0)
    p0 = jpm.init_lenet(jax.random.PRNGKey(0), image_size=12)
    ref = JaxServer.from_strategy(
        jst.get("fig5", masking=jst.MaskPolicy.selective(0.5,
                                                         backend="kernel")),
        jpm.classifier_loss(jpm.lenet_forward), p0, M, seed=0,
        scan_rounds=False)
    ref.run((jnp.asarray(xs), jnp.asarray(ys)), ns, rounds)
    jax.effects_barrier()
    port = FederatedServer.from_strategy(
        tst.get("fig5", masking=tst.MaskPolicy.selective(0.5,
                                                         backend="kernel")),
        tpm.classifier_loss(tpm.lenet_forward),
        bridge.params_from_numpy(jax.device_get(p0), device="cpu"), M,
        device="cpu", scores=reference_scores)
    port.run((xs, ys), ns, rounds)
    jops.topk_mask_pytree, tops.topk_mask_stacked = real_j, real_t
    ref_rows = [tuple({k: np.asarray(v) for k, v in
                       bridge.flatten_tree(tree).items()} for tree in entry)
                for entry in ref_log]
    return ref_rows, port_log, ref, port


def segment_taus(tree: dict) -> dict:
    """Per (client, leaf) tau as the port's kernel masking computes it."""
    kept = []
    real = tops._refine_taus

    def rec(*args, **kw):
        tau = real(*args, **kw)
        kept.append(tau.clone())
        return tau

    tops._refine_taus = rec
    stacked = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in tree.items()}
    tops.topk_mask_stacked(stacked, 0.5)
    tops._refine_taus = real
    names, _, _, _, clients = tops._packed_cohort(stacked, 256)
    tau = kept[0].numpy().reshape(clients, len(names))
    return {n: tau[:, i] for i, n in enumerate(names)}


def main(rounds: int) -> None:
    ref_rows, port_log, ref, port = record_runs(rounds)
    pos = 0
    for t, (pd, pm) in enumerate(port_log, 1):
        C = next(iter(pd.values())).shape[0]
        chunk = ref_rows[pos:pos + C]
        pos += C
        rd = {k: np.stack([c[0][k] for c in chunk]) for k in pd}
        rm = {k: np.stack([c[1][k] for c in chunk]) for k in pd}
        tp, tr = segment_taus(pd), segment_taus(rd)
        flips, near, first = 0, 0, []
        for k in tp:
            xp, xr = pd[k].reshape(C, -1), rd[k].reshape(C, -1)
            kp, kr = pm[k].reshape(C, -1) != 0, rm[k].reshape(C, -1) != 0
            for c in range(C):
                for e in np.flatnonzero(kp[c] != kr[c]):
                    up = np.spacing(np.float32(tp[k][c]))
                    ur = np.spacing(np.float32(tr[k][c]))
                    dp = float((abs(np.float32(xp[c, e])) - tp[k][c]) / up)
                    dr = float((abs(np.float32(xr[c, e])) - tr[k][c]) / ur)
                    flips += 1
                    near += min(abs(dp), abs(dr)) <= 4
                    if len(first) < 4:
                        first.append({"leaf": k, "port_ulps": dp,
                                      "ref_ulps": dr,
                                      "delta_apart_ulps": float(
                                          abs(xp[c, e] - xr[c, e]) / up)})
        same = tops.topk_mask_stacked(
            {k: torch.from_numpy(v.copy()) for k, v in rd.items()}, 0.5)
        same_input = sum(int(((same[k].numpy() != 0) != (rm[k] != 0)).sum())
                         for k in rd)
        print(json.dumps(collections.OrderedDict(
            round=t, clients=C, flips=flips, within_4_ulps_of_tau=near,
            same_input=same_input, first_flips=first)), flush=True)
    print(json.dumps({"loss_ref": [r.mean_loss for r in ref.history],
                      "loss_port": [r.mean_loss for r in port.history]}))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20)
