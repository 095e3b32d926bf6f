"""Multi-pod dry run (counterpart of ``repro/launch/dryrun.py``): every
(arch x input shape) on the production mesh, traced one step with no card
and no memory, with per-device FLOPs, collective bytes and memory.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k [--multi-pod] [--fed] [--out results/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Where the reference lowers and compiles each step with XLA on 512
placeholder devices, this runs the port's own step once as rank 0 of a
256- or 512-rank fake process group
(``torch.testing._internal.distributed.fake_pg``), under
``FakeTensorMode``: the parameters, optimizer state, batch and decode
state are DTensors laid out by ``launch/shardings.py``, the step takes
``steps.mesh_hints``, DTensor issues its collectives to the fake backend
(which moves nothing) and every local op runs on fake tensors (which hold
no data).  ``launch/op_stats.OpStats`` counts what rank 0 runs.  Ranks are
symmetric, so rank 0's counts are every device's.

Per combo one JSON file: the per-device parameter, optimizer-state and
peak live bytes against the card's 80 GB, FLOPs, the eager HBM traffic
model, collective bytes by family, the hand-written kernels' bytes and
calls, and the roofline terms on the H100 SXM data sheet's rates
(``launch/mesh.py``).  Every figure is a count from the fake process
group, not a time measured on a card.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_arch, get_shape,
                                 supports_shape)
from repro_torch.launch import shardings as sh
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, NVLINK_BW,
                                     PEAK_FLOPS_BF16, make_production_mesh,
                                     num_chips)
from repro_torch.launch.op_stats import OpStats

__all__ = ["init_fake", "param_counts", "model_flops", "trace_combo",
           "roofline_record", "run_combo", "parser", "main"]


def init_fake(world_size: int) -> None:
    """Rank 0 of a fake process group of ``world_size`` ranks (destroying
    a default group of another size first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


# ---------------------------------------------------------------------------
# analytic model FLOPs: 6 N D to train, 2 N D to infer; MoE counts N_active
# ---------------------------------------------------------------------------
def param_counts(cfg) -> dict:
    """Total, routed-expert and active parameter counts (meta tensors)."""
    total = routed = 0
    for name, leaf in steps_lib.params_specs(cfg).items():
        n = leaf.numel()
        total += n
        if ".moe." in f".{name}" and name.rsplit(".", 1)[-1] in \
                ("wi", "wg", "wo"):
            routed += n
    active = total - routed
    if cfg.moe_experts:
        active += routed * cfg.moe_topk / cfg.moe_experts
    return {"total": total, "routed": routed, "active": int(active)}


def model_flops(cfg, shape) -> float:
    """6 N_active tokens (train), 2 N_active tokens (prefill), 2 N_active
    a sequence (decode: one token each)."""
    n_active = param_counts(cfg)["active"]
    tokens = shape.global_batch * (1 if shape.mode == "decode"
                                   else shape.seq_len)
    return (6.0 if shape.mode == "train" else 2.0) * n_active * tokens


# ---------------------------------------------------------------------------
# one traced step
# ---------------------------------------------------------------------------
def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    total = 0

    def walk(x):
        nonlocal total
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
    walk(tree)
    return total


def _fake_like(tree):
    """Empty tensors of the meta tree's shapes (fake under the mode)."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype)
    if isinstance(tree, dict):
        return {k: _fake_like(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_fake_like(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_fake_like(v) for v in tree)
    return tree


def trace_combo(cfg, shape, mesh, *, fed: bool = False, fsdp: bool = True,
                remat: bool = True, hints=None) -> dict:
    """Trace one step of ``cfg`` at ``shape`` on ``mesh`` under
    ``FakeTensorMode``; returns the counts and the per-device bytes of
    parameters and optimizer state."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    meta = {}
    with FakeTensorMode(allow_non_fake_inputs=True):
        if fed:
            return _trace_fed(cfg, shape, mesh)
        hints = hints if hints is not None else steps_lib.mesh_hints(mesh)
        dtype = cfg.param_dtype_train if shape.mode == "train" else \
            cfg.param_dtype_serve
        specs = steps_lib.params_specs(cfg, dtype)
        psh = sh.params_shardings(specs, mesh, fsdp=fsdp)
        params = sh.distribute_tree(_fake_like(specs), psh)
        batch = _fake_like(steps_lib.batch_specs(cfg, shape))
        batch = {k: (v.random_(0, 2) if not v.is_floating_point() else v)
                 for k, v in batch.items()}
        batch = sh.distribute_tree(batch, sh.batch_shardings(batch, mesh))
        meta["param_bytes"] = _local_bytes(params)
        meta["opt_bytes"] = 0
        if shape.mode == "train":
            step = steps_lib.make_train_step(cfg, remat=remat, hints=hints)
            opt_specs = step.optimizer.init(specs)
            opt = sh.distribute_tree(_fake_like(opt_specs),
                                     sh.params_shardings_like(opt_specs, psh,
                                                              mesh))
            meta["opt_bytes"] = _local_bytes(opt)
            meta["optimizer"] = "adafactor" if "v" in opt else "adamw"
            with OpStats() as stats:
                step(params, opt, batch)
        elif shape.mode == "prefill":
            step = steps_lib.make_prefill_step(cfg, hints=hints)
            with OpStats() as stats:
                step(params, batch)
        else:
            state = _fake_like(steps_lib.decode_state_specs(cfg, shape))
            state = sh.distribute_tree(
                state, sh.decode_state_shardings(state, mesh))
            meta["state_bytes"] = _local_bytes(state)
            step = steps_lib.make_serve_step(cfg, hints=hints)
            with OpStats() as stats:
                step(params, state, batch)
    return {**meta, **stats.summary()}


def _trace_fed(cfg, shape, mesh) -> dict:
    """One silo-sharded pod round (``fedtrain.make_silo_fed_round``) in
    ``lower_fed_round``'s layout: one client a silo, ``b = B / C`` rows a
    local step, the bisection mask, a dense upload."""

    from repro_torch.launch import fedtrain
    client_axis, _ = fedtrain.fed_layout(mesh)
    C = mesh.shape[mesh.mesh_dim_names.index(client_axis)]
    fed_cfg = fedtrain.FedPodConfig(num_clients=C)
    dtype = fedtrain.silo_param_dtype(cfg, mesh)
    specs = steps_lib.params_specs(cfg, dtype)
    params = sh.distribute_tree(_fake_like(specs),
                                fedtrain.silo_shardings(specs, mesh))
    B, T = shape.global_batch, shape.seq_len
    b = max(B // C, 1)
    tok_shape = (C, fed_cfg.local_steps, b) + (
        (cfg.num_codebooks, T) if cfg.modality == "audio_stub"
        and cfg.num_codebooks > 1 else (T,))
    toks = torch.zeros(tok_shape, dtype=torch.int32)
    batches = {"tokens": toks, "labels": toks}
    if cfg.modality == "vision_stub":
        batches["prefix_embeds"] = torch.empty(
            (C, fed_cfg.local_steps, b, cfg.num_prefix_embeddings,
             cfg.d_model), dtype=torch.bfloat16)
    round_fn = fedtrain.make_silo_fed_round(
        cfg, fed_cfg, mesh)
    meta = {"param_bytes": _local_bytes(params), "opt_bytes": 0,
            "param_dtype": dtype, "clients": C}
    with OpStats() as stats:
        round_fn(params, batches, [1.0] * C, [1.0] * C)
    return {**meta, **stats.summary()}


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------
def roofline_record(arch_id: str, shape_name: str, counts: dict, mesh, *,
                    fed: bool = False) -> dict:
    """The per-device counts with the H100 roofline terms: compute at
    989 TFLOP/s bf16, memory at 3.35 TB/s (the eager traffic model plus
    the kernels' bytes), collectives at 450 GB/s NVLink."""
    cfg = get_arch(arch_id)
    shape = get_shape(shape_name)
    chips = num_chips(mesh)
    terms = {"compute_s": counts["flops"] / PEAK_FLOPS_BF16,
             "memory_s": (counts["hbm_bytes"] + counts["kernel_bytes"])
             / HBM_BW,
             "collective_s": counts["collective_bytes"] / NVLINK_BW}
    mf = model_flops(cfg, shape)
    pc = param_counts(cfg)
    per_device = (counts["param_bytes"] + counts["opt_bytes"]
                  + counts.get("state_bytes", 0) + counts["peak_bytes"])
    return {
        "arch": arch_id, "shape": shape_name, "mode": shape.mode,
        "fed": fed, "chips": chips,
        "mesh": dict(zip(mesh.mesh_dim_names,
                         [int(s) for s in mesh.shape])),
        "source": "fake process group under FakeTensorMode (counts, not "
                  "card times)",
        "params_total": pc["total"], "params_active": pc["active"],
        "memory": {
            "param_bytes": counts["param_bytes"],
            "opt_bytes": counts["opt_bytes"],
            "state_bytes": counts.get("state_bytes", 0),
            "peak_live_bytes": counts["peak_bytes"],
            "per_device_bytes": per_device,
            "fits_hbm": bool(per_device <= HBM_BYTES),
        },
        "per_device": {k: counts[k] for k in (
            "flops", "hbm_bytes", "collective_bytes", "per_collective",
            "collective_count", "kernel_bytes", "kernel_flops",
            "kernel_calls")},
        "roofline": {
            **terms, "dominant": max(terms, key=terms.get),
            "model_flops_global": mf,
            "model_flops_per_device": mf / chips,
            "useful_flop_fraction": (mf / chips) / max(counts["flops"], 1.0),
        },
        "top_dots": counts["top_dots"],
        **{k: counts[k] for k in ("optimizer", "param_dtype", "clients")
           if k in counts},
    }


def run_combo(arch_id: str, shape_name: str, *, multi_pod: bool,
              fed: bool = False, out_dir: str = "results/dryrun_torch",
              fsdp: bool = True, remat: bool = True) -> dict:
    """Trace one combo on the production mesh and write its JSON."""
    cfg = get_arch(arch_id)
    shape = get_shape(shape_name)
    if not supports_shape(cfg, shape):
        raise ValueError(f"{arch_id} skips {shape_name}")
    t0 = time.time()
    init_fake(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    counts = trace_combo(cfg, shape, mesh, fed=fed, fsdp=fsdp, remat=remat)
    rec = roofline_record(arch_id, shape_name, counts, mesh, fed=fed)
    rec["trace_s"] = time.time() - t0
    rec["multi_pod"] = multi_pod
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch_id}__{shape_name}__{'mp' if multi_pod else 'sp'}" + \
        ("__fed" if fed else "")
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def table(single: str, multi: str) -> str:
    """A markdown table of the records under ``single`` (16 x 16) and
    ``multi`` (2 x 16 x 16), one row an (arch, shape): per device, GB of
    parameters and optimizer state, of the peak live tensors, whether the
    sum fits 80 GB, TFLOPs, and GB all-gathered / all-reduced /
    reduce-scattered (the reference's byte conventions)."""
    def load(folder):
        out = {}
        for name in sorted(os.listdir(folder)):
            if name.endswith(".json") and "__fed" not in name:
                with open(os.path.join(folder, name)) as f:
                    rec = json.load(f)
                out[(rec["arch"], rec["shape"])] = rec
        return out

    def cells(rec):
        if rec is None:
            return ["", "", "", "", ""]
        m, d = rec["memory"], rec["per_device"]
        c = d["per_collective"]
        coll = " / ".join(f"{c.get(k, 0) / 1e9:.3g}" for k in
                          ("all-gather", "all-reduce", "reduce-scatter"))
        return [f"{(m['param_bytes'] + m['opt_bytes'] + m['state_bytes']) / 1e9:.3g}",
                f"{m['peak_live_bytes'] / 1e9:.3g}",
                "yes" if m["fits_hbm"] else "no",
                f"{d['flops'] / 1e12:.4g}", coll]

    sp, mp = load(single), load(multi)
    head = ["arch", "shape"] + [f"{w} {c}" for w in ("256:", "512:") for c in
                                ("state GB", "peak GB", "fits",
                                 "TFLOP", "AG / AR / RS GB")]
    lines = ["| " + " | ".join(head) + " |",
             "|" + " --- |" * len(head)]
    for key in sorted(set(sp) | set(mp),
                      key=lambda k: (ARCH_IDS.index(k[0]),
                                     list(INPUT_SHAPES).index(k[1]))):
        lines.append("| " + " | ".join(
            [f"`{key[0]}`", key[1]] + cells(sp.get(key)) + cells(mp.get(key)))
            + " |")
    return "\n".join(lines)


def parser() -> argparse.ArgumentParser:
    """The reference's command line, without ``--save-hlo``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fed", action="store_true",
                    help="trace the silo-sharded pod round instead of the "
                         "standard step")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--table", nargs=2, metavar=("SINGLE", "MULTI"),
                    help="print the markdown table of two --out folders "
                         "(16 x 16 and 2 x 16 x 16) and exit")
    return ap


def main(argv: Optional[list] = None) -> None:
    """Trace the asked combos; exits nonzero if any failed."""
    args = parser().parse_args(argv)
    if args.table:
        print(table(*args.table))
        return
    torch.set_num_threads(1)

    if args.all:
        combos = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES
                  if supports_shape(get_arch(a), get_shape(s))]
    else:
        combos = [(args.arch, args.shape)]
    failures = []
    for a, s in combos:
        try:
            rec = run_combo(a, s, multi_pod=args.multi_pod, fed=args.fed,
                            out_dir=args.out, fsdp=not args.no_fsdp,
                            remat=not args.no_remat)
            r, m = rec["roofline"], rec["memory"]
            print(f"OK  {a:28s} {s:12s} chips={rec['chips']} "
                  f"flops={rec['per_device']['flops']:.4g} "
                  f"coll={rec['per_device']['collective_bytes']:.4g}B "
                  f"compute={r['compute_s']:.4f}s "
                  f"memory={r['memory_s']:.4f}s "
                  f"coll={r['collective_s']:.4f}s dom={r['dominant']} "
                  f"bytes={m['per_device_bytes'] / 1e9:.2f}GB "
                  f"fits={m['fits_hbm']} trace={rec['trace_s']:.0f}s",
                  flush=True)
        except Exception as e:  # noqa: BLE001 - report and continue
            failures.append((a, s, repr(e)))
            print(f"FAIL {a} {s}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")


if __name__ == "__main__":
    main()
