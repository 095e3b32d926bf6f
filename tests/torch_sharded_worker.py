"""One rank of the sharded checks of ``tests/test_torch_sharding.py``.

Run as four processes (``RANK``, ``WORLD_SIZE=4``, ``MASTER_ADDR``,
``MASTER_PORT`` set) on gloo, on a 2 x 2 ("data", "model") mesh:

  python tests/torch_sharded_worker.py inputs.pt outputs.pt

``inputs.pt`` holds the parameters and batches the test made with numpy;
rank 0 writes every result to ``outputs.pt``: the sharded runs' values
gathered whole, beside the unsharded port's on the same inputs (rank 0
alone on a 1 x 1 mesh, with the same hints; the plain round too).

  python tests/torch_sharded_worker.py --one outputs.pt

(``WORLD_SIZE=1``) runs the 1 x 1 mesh's bit-for-bit checks of
``tests/test_torch_dryrun.py`` instead.
"""

import dataclasses
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import strategy  # noqa: E402
from repro_torch.core.client_store import make_store  # noqa: E402
from repro_torch.launch import fedtrain as ft  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.train import make_mesh_arg  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402


def whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def arch_cfg(arch: str):
    """The fp32 reduced config of ``arch`` the test uses (hymba cut to its
    first two layers, one full and one sliding)."""
    cfg = dataclasses.replace(get_arch(arch).reduced(),
                              compute_dtype="float32",
                              param_dtype_serve="float32")
    if arch == "hymba-1.5b":
        cfg = dataclasses.replace(cfg, layer_pattern=cfg.layer_pattern[:2],
                                  num_layers=2)
    return cfg


def train(arch: str, case: dict, mesh, lr: float, solo) -> dict:
    """Three AdamW steps sharded over ``mesh`` and, on rank 0, on the
    unsharded 1 x 1 mesh ``solo``: both with ``mesh_hints``, so both
    round the block outputs' gradients to bf16."""
    out = {"sharded": train_on(arch, case, mesh, lr)}
    if solo is not None:
        out["solo"] = train_on(arch, case, solo, lr)
    return out


def train_on(arch: str, case: dict, mesh, lr: float) -> dict:
    """Three steps on ``mesh``; "grad_layout_kept": per leaf, whether every
    gradient that reached ``global_norm_scale`` had its parameter's
    placements."""
    cfg = arch_cfg(arch)
    step = steps.make_train_step(cfg, learning_rate=lr,
                                 hints=steps.mesh_hints(mesh))
    params = {k: v.clone() for k, v in case["params"].items()}
    opt = step.optimizer.init(params)
    psh = sh.params_shardings(params, mesh)
    params = sh.distribute_tree(params, psh)
    opt = sh.distribute_tree(opt, sh.params_shardings_like(opt, psh, mesh))
    losses, norms = [], []
    grad_kept = dict.fromkeys(params, True)
    real = steps.global_norm_scale

    def check(grads, clip_norm):
        for k, g in grads.items():
            grad_kept[k] &= tuple(g.placements) == tuple(psh[k].placements)
        return real(grads, clip_norm)
    steps.global_norm_scale = check
    try:
        for b in case["batches"]:
            b = sh.distribute_tree(b, sh.batch_shardings(b, mesh))
            params, opt, m = step(params, opt, b)
            losses.append(float(whole(m["loss"])))
            norms.append(float(whole(m["grad_norm"])))
    finally:
        steps.global_norm_scale = real
    kept = {k: tuple(v.placements) == tuple(psh[k].placements)
            for k, v in params.items()}
    split = sum(any(p.is_shard() for p in v.placements)
                for v in params.values())
    return {"loss": losses, "grad_norm": norms,
            "params": {k: whole(v) for k, v in params.items()},
            "layout_kept": kept, "grad_layout_kept": grad_kept,
            "sharded_leaves": split}


def serve(case: dict, mesh):
    """A sharded prefill and decode of reduced qwen2-1.5b: the prompt fed
    token by token into a 64-slot cache (slots over "model"), then the
    prefill's last logits; rank 0 repeats both unsharded."""
    cfg = arch_cfg("qwen2-1.5b")
    prompts = case["prompts"]
    B, P = prompts.shape
    hints = steps.mesh_hints(mesh)

    def run(params, hints):
        prefill = steps.make_prefill_step(cfg, hints=hints)
        serve_step = steps.make_serve_step(cfg, hints=hints)
        state = tr.init_decode_state(cfg, B, 64, device="cpu")
        batch = {"tokens": prompts}
        if hints is not None:
            psh = sh.params_shardings(params, mesh)
            params = sh.distribute_tree(params, psh)
            state = sh.distribute_tree(
                state, sh.decode_state_shardings(state, mesh))
            batch = sh.distribute_tree(batch,
                                       sh.batch_shardings(batch, mesh))
        view = tr.layer_view(params, cfg)
        steps_out = []
        for i in range(P):
            tok = {"tokens": prompts[:, i:i + 1].contiguous()}
            if hints is not None:
                tok = sh.distribute_tree(tok, sh.batch_shardings(tok, mesh))
            logits, state = serve_step(view, state, tok)
            steps_out.append(whole(logits))
        return {"prefill": whole(prefill(params, batch)),
                "decode": torch.stack(steps_out),
                "state_layout": str(state.caches[0].k.placements)
                if hints is not None else ""}

    out = {"sharded": run(dict(case["params"]), hints)}
    if dist.get_rank() == 0:
        out["plain"] = run(dict(case["params"]), None)
    return out


def silo(case: dict, mesh, solo):
    """The kernel-route masks of a delta tree over 2 silos x 2 model ranks
    against the unsharded ``mask_deltas``; the wire bytes; two silo pod
    rounds against the same rounds on the 1 x 1 mesh ``solo`` (one silo,
    both clients in turn) and against ``make_fed_round``."""
    cfg = arch_cfg("qwen2-1.5b")
    params = case["params"]
    st = strategy.get("fig5", masking=strategy.MaskPolicy.selective(
        0.5, backend="kernel"))
    fed = dataclasses.replace(
        ft.FedPodConfig.from_strategy(st, num_clients=2, local_steps=2),
        learning_rate=0.05)
    client = mesh.get_local_rank("data")
    shard = ft.silo_shardings(params, mesh)
    silo_mesh = ft.silo_mesh(mesh)
    deltas = case["deltas"]
    plain = ft.mask_deltas(deltas, fed)
    mine = {k: sh.distribute(v[client], shard[k])[None]
            for k, v in deltas.items()}
    masked = ft.mask_deltas(mine, fed, group=silo_mesh)
    equal = {k: bool(torch.equal(whole(masked[k][0]), plain[k][client]))
             for k in deltas}
    kept = {k: int((whole(masked[k][0]) != 0).sum()) for k in deltas}
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, (client, equal, kept))

    meshes = {"silo": mesh}
    if solo is not None:
        meshes["solo"] = solo
    runs = {label: silo_rounds(cfg, fed, params, case["rounds"], m)
            for label, m in meshes.items()}
    if solo is not None:
        plain_round = ft.make_fed_round(cfg, fed)
        p_plain, losses = dict(params), []
        for t, b in enumerate(case["rounds"]):
            p_plain, mp = plain_round(p_plain, b, torch.ones(2),
                                      torch.ones(2), key=(1, t + 1))
            losses.append(float(mp["mean_loss"]))
        runs["plain"] = {"loss": losses, "params": p_plain}
    return {"masks": gathered, "runs": runs,
            "wire_bytes": fed.codec.wire_bytes(params),
            "layouts": {k: str(v.placements) for k, v in shard.items()}}


def silo_rounds(cfg, fed, params: dict, rounds: list, mesh) -> dict:
    """``make_silo_fed_round`` on ``mesh`` for the given rounds: the mean
    losses, the upload bytes and the parameters gathered whole."""
    silo_round = ft.make_silo_fed_round(cfg, fed, mesh)
    p = sh.distribute_tree(dict(params), ft.silo_shardings(params, mesh))
    losses, uploads = [], []
    for t, b in enumerate(rounds):
        p, m = silo_round(p, b, torch.ones(2), [1.0, 1.0], key=(1, t + 1))
        losses.append(float(m["mean_loss"]))
        uploads.append(m["upload_bytes"])
    return {"loss": losses, "upload_bytes": uploads,
            "params": {k: whole(v) for k, v in p.items()}}


def store(case: dict, mesh):
    """Both store backends, sharded over the data axis, against unsharded
    twins under the same gathers and scatters."""
    template = case["template"]
    out = {}
    for kind in ("dense", "sharded"):
        kw = {"retention": 6} if kind == "sharded" else {}
        a = make_store(kind, 10, template, track_norms=True, **kw)
        b = make_store(kind, 10, template, track_norms=True, **kw)
        a.shard_over(mesh)
        same = True
        g = torch.Generator().manual_seed(3)
        for r in range(1, 5):
            ids = torch.randperm(10, generator=g)[:4].numpy()
            rows = {k: torch.randn((4,) + tuple(v.shape), generator=g)
                    for k, v in template.items()}
            commit = [1.0, 0.0, 1.0, 1.0]
            a.scatter(ids, rows, commit, r)
            b.scatter(ids, rows, commit, r)
            a.update_norms(ids, torch.arange(4.0) + r)
            b.update_norms(ids, torch.arange(4.0) + r)
            everyone = list(range(10))
            ga, gb = a.gather(everyone), b.gather(everyone)
            same &= all(torch.equal(ga[k], gb[k]) for k in template)
            same &= bool(torch.equal(a.norms, b.norms))
        sa = a.state()
        same &= all(torch.equal(sa["slots" if kind == "sharded" else
                                   "residuals"][k],
                                b.state()["slots" if kind == "sharded" else
                                          "residuals"][k])
                    for k in template)
        out[kind] = {"same": same, "memory": a.memory_bytes(),
                     "plain_memory": b.memory_bytes()}
    return out


def one_rank(outputs: str) -> None:
    """World size 1, a 1 x 1 mesh: the sharded steps against the plain
    ones bit for bit (the card's ``sharded_path`` at reduced width):
    two AdamW steps of reduced qwen2-1.5b and rwkv6-1.6b in their
    configs' dtypes, round 1 of the silo pod round (4 clients, kernel
    masking) and a prefill and decode."""
    dist.init_process_group("gloo")
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    out = {}
    for arch in ("qwen2-1.5b", "rwkv6-1.6b"):
        cfg = get_arch(arch).reduced()
        params = tr.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
        g = torch.Generator().manual_seed(1)
        batches = []
        for _ in range(2):
            toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
            batches.append({"tokens": toks, "labels": toks.roll(-1, -1)})
        runs = {}
        for hints in (None, steps.mesh_hints(mesh)):
            step = steps.make_train_step(cfg, hints=hints)
            p = dict(params)
            opt = step.optimizer.init(p)
            feed = batches
            if hints is not None:
                psh = sh.params_shardings(p, mesh)
                p = sh.distribute_tree(p, psh)
                opt = sh.distribute_tree(
                    opt, sh.params_shardings_like(opt, psh, mesh))
                feed = [sh.distribute_tree(b, sh.batch_shardings(b, mesh))
                        for b in batches]
            log = []
            for b in feed:
                p, opt, m = step(p, opt, b)
                log.append((float(whole(m["loss"])),
                            float(whole(m["grad_norm"]))))
            runs["plain" if hints is None else "sharded"] = (
                log, {k: whole(v) for k, v in p.items()})
        out[arch] = {
            "log_equal": runs["plain"][0] == runs["sharded"][0],
            "params_differing": [k for k in params if not torch.equal(
                runs["plain"][1][k], runs["sharded"][1][k])]}

    cfg = get_arch("qwen2-1.5b").reduced()
    params = tr.init_params(torch.Generator().manual_seed(2), cfg,
                            device="cpu")
    st = strategy.get("fig5", masking=strategy.MaskPolicy.selective(
        0.5, backend="kernel"))
    fed = ft.FedPodConfig.from_strategy(st, num_clients=4, local_steps=2)
    toks = torch.randint(0, cfg.vocab_size, (4, 2, 1, 64),
                         generator=torch.Generator().manual_seed(3))
    batch = {"tokens": toks, "labels": toks.roll(-1, -1)}
    bits = {}

    def observe(label):
        def hook(client, delta, masked):
            bits.setdefault(label, {})[client] = torch.cat(
                [whole(v).ne(0).reshape(-1) for v in masked.values()])
        return hook

    part = torch.tensor([1.0, 0.0, 1.0, 1.0])
    new_plain, _ = ft.make_fed_round(cfg, fed, observe=observe("plain"))(
        dict(params), batch, torch.ones(4), part, key=(1, 1))
    silo_round = ft.make_silo_fed_round(cfg, fed, mesh,
                                        observe=observe("silo"))
    new_silo, _ = silo_round(
        sh.distribute_tree(dict(params), ft.silo_shardings(params, mesh)),
        batch, torch.ones(4), part.tolist(), key=(1, 1))
    out["pod"] = {
        "keep_bits_equal": all(torch.equal(bits["plain"][c], bits["silo"][c])
                               for c in range(4)),
        "params_differing": [k for k in params if not torch.equal(
            new_plain[k], whole(new_silo[k]))]}

    serve_cfg = get_arch("qwen2-1.5b").reduced()
    params = tr.init_params(torch.Generator().manual_seed(4), serve_cfg,
                            serve_cfg.param_dtype_serve, device="cpu")
    prompts = torch.randint(0, serve_cfg.vocab_size, (2, 16),
                            generator=torch.Generator().manual_seed(5),
                            dtype=torch.int32)
    logits = {}
    for hints in (None, steps.mesh_hints(mesh)):
        prefill = steps.make_prefill_step(serve_cfg, hints=hints)
        serve_step = steps.make_serve_step(serve_cfg, hints=hints)
        state = tr.init_decode_state(serve_cfg, 2, 64, device="cpu")
        w, batch = params, {"tokens": prompts}
        if hints is not None:
            w = sh.distribute_tree(dict(params),
                                   sh.params_shardings(params, mesh))
            state = sh.distribute_tree(
                state, sh.decode_state_shardings(state, mesh))
            batch = sh.distribute_tree(batch,
                                       sh.batch_shardings(batch, mesh))
        got = [whole(prefill(w, batch))]
        view = tr.layer_view(w, serve_cfg)
        for i in range(8):
            tok = {"tokens": prompts[:, i:i + 1].contiguous()}
            if hints is not None:
                tok = sh.distribute_tree(tok, sh.batch_shardings(tok, mesh))
            step_logits, state = serve_step(view, state, tok)
            got.append(whole(step_logits))
        logits["plain" if hints is None else "sharded"] = got
    out["serve_equal"] = [bool(torch.equal(a, b)) for a, b in
                          zip(logits["plain"], logits["sharded"])]
    torch.save(out, outputs)
    dist.destroy_process_group()


def solo_mesh():
    """A 1 x 1 ("data", "model") mesh of rank 0 alone (None on the other
    ranks, which only join the group's creation)."""
    from torch.distributed.device_mesh import DeviceMesh
    group = dist.new_group([0])
    if dist.get_rank() != 0:
        return None
    return DeviceMesh.from_group([group, group], "cpu",
                                 mesh=torch.tensor([[0]]),
                                 mesh_dim_names=("data", "model"))


def main(inputs: str, outputs: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    case = torch.load(inputs)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    solo = solo_mesh()
    out = {"train": {arch: train(arch, c, mesh, case["lr"], solo)
                     for arch, c in case["train"].items()},
           "serve": serve(case["serve"], mesh),
           "silo": silo(case["silo"], mesh, solo),
           "store": store(case["store"], mesh),
           "mesh_arg": make_mesh_arg("2x2", "cpu").mesh_dim_names}
    if dist.get_rank() == 0:
        torch.save(out, outputs)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    if sys.argv[1] == "--one":
        one_rank(sys.argv[2])
    else:
        main(sys.argv[1], sys.argv[2])
