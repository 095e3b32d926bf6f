"""The backward kernels' rolled dlogw loops, checked on the card.

    PYTHONPATH=src python -m repro_torch.kernels.sanitize_backward \\
        [--tools memcheck,racecheck,synccheck] [--timeout S] [--json PATH]

``wkv6_bwd_grad_kernel`` (``csrc/wkv6_backward.cu``) keeps its two dlogw
loops rolled (``#pragma unroll 1``).  This script builds
``csrc/wkv6_backward.cu`` and ``csrc/ssm_scan.cu`` into a library of their
own with ``build.NVCC_FLAGS``, once a variant:

- ``committed``: as in the repository;
- ``unrolled``: both dlogw loops fully unrolled (``#pragma unroll``);
- ``unrolled_first``: the first of them only.

Each variant runs in a fresh process, twice in turns (committed,
unrolled, unrolled_first, then the reverse), through the wrappers
(``wkv6_backward``; ``ssm_scan._forward(..., checkpoints=True)`` and
``ssm_scan_backward``) on the same seeded inputs: small shapes, the grid
edges (T = 1, a step past a chunk, B = 2, D = 32 and 64), the strongest
decay (logw = -e^4) and the training shapes (1, 4096, 32, 64) and (1,
4096, 1600, 16), each case three times.  Every process prints one JSON
line a case: a SHA-256 of the gradients' bytes, whether they are finite,
or the CUDA error; and the training shapes' time a call (CUDA events,
median of 20).  The summary says whether every run of every variant gave
the committed kernel's bits.  ``--tools`` runs the committed and unrolled
variants again under each ``compute-sanitizer`` tool named, with
``PYTORCH_NO_CUDA_MEMORY_CACHING=1`` so that every tensor is an
allocation of its own.  Nothing here runs on the main path.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch.kernels import build

SOURCES = ("wkv6_backward.cu", "ssm_scan.cu")
NAMES = ("wkv6_backward_launch", "wkv6_backward_config", "ssm_scan_launch",
         "ssm_scan_checkpoint_launch", "ssm_scan_backward_launch",
         "ssm_scan_backward_config")
ROLLED = "#pragma unroll 1\n"
VARIANTS = ("committed", "unrolled", "unrolled_first")
WKV6_TRAIN = (1, 4096, 32, 64)
SSM_TRAIN = (1, 4096, 1600, 16)
# (kernel, shape, strongest decay)
CASES = [("wkv6", (1, 64, 1, 32), False), ("wkv6", (1, 64, 1, 64), False),
         ("wkv6", (2, 1, 2, 32), False), ("wkv6", (2, 1, 2, 64), False),
         ("wkv6", (2, 65, 4, 32), False), ("wkv6", (2, 65, 4, 64), False),
         ("wkv6", (2, 100, 4, 64), False), ("wkv6", (1, 200, 2, 64), True),
         ("wkv6", (2, 130, 2, 32), True), ("wkv6", WKV6_TRAIN, False),
         ("ssm_scan", (2, 1, 40, 16), False),
         ("ssm_scan", (2, 17, 40, 16), False),
         ("ssm_scan", (2, 65, 40, 16), False),
         ("ssm_scan", SSM_TRAIN, False)]
REPS = 3


def _source(variant: str, csrc: Path, name: str) -> str:
    text = (csrc / name).read_text()
    if variant == "committed" or name != "wkv6_backward.cu":
        return text
    if text.count(ROLLED) != 2:
        raise RuntimeError(f"expected the two rolled dlogw loops in {name}, "
                           f"found {text.count(ROLLED)}")
    count = 2 if variant == "unrolled" else 1
    return text.replace(ROLLED, "#pragma unroll\n", count)


def build_variant(variant: str, out: Path) -> dict:
    """One library of the two sources; its path and the gradients kernel's
    registers and spill bytes (``-Xptxas -v``)."""
    csrc = Path(build.__file__).resolve().parent / "csrc"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    srcs = []
    for name in SOURCES:
        src = out / name
        src.write_text(_source(variant, csrc, name))
        srcs.append(src)
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-c", "-o",
                               str(s.with_suffix(".o")), str(s)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s in srcs]
    logs = []
    for src, proc in zip(srcs, procs):
        logs.append(proc.communicate()[0])
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{logs[-1][-4000:]}")
    lib = out / f"lib_{variant}.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-shared", "-o", str(lib),
                    *(str(s.with_suffix(".o")) for s in srcs)], check=True,
                   capture_output=True)
    return {"lib": str(lib), "grad_kernel": _ptxas(logs[0])}


def _ptxas(log: str) -> list:
    """Registers, stack and spills of each wkv6_bwd_grad_kernel
    instantiation, from the ``-Xptxas -v`` log."""
    out, name = [], ""
    for line in log.splitlines():
        if "Compiling entry" in line or "Function properties" in line:
            name = line
        elif "wkv6_bwd_grad_kernel" in name:
            nums = re.findall(r"(\d+) (bytes spill stores|bytes spill loads"
                              r"|registers|bytes stack frame)", line)
            if nums:
                out.append({k: int(v) for v, k in nums})
    return out


def child(lib_path: str) -> int:
    """Every case through the wrappers on ``lib_path``, REPS times."""
    import torch
    from repro_torch.kernels import ssm_scan as ssk
    from repro_torch.kernels import wkv6 as wk
    lib = build.load(Path(lib_path), names=NAMES)
    wk._library = ssk._library = lambda: lib

    def inputs(kernel, shape, strong, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)

        def randn(*s):
            return torch.randn(s, generator=gen, device="cuda")
        if kernel == "wkv6":
            B, T, H, D = shape
            r, k, v = (0.5 * randn(B, T, H, D) for _ in range(3))
            logw = (torch.full((B, T, H, D), -math.exp(4.0),
                               device="cuda") if strong
                    else -torch.exp(randn(B, T, H, D) - 1.0))
            return (r, k, v, logw, randn(H, D), randn(B, H, D, D),
                    randn(B, T, H, D), randn(B, H, D, D)), {}
        B, T, d, N = shape
        x = [torch.sigmoid(randn(B, T, d, N)), randn(B, T, d, N),
             randn(B, T, N), randn(B, d, N)]
        hk = ssk._forward(*x, checkpoints=True)[2]
        return (*x, randn(B, T, d), randn(B, d, N)), {"hk": hk}

    for i, (kernel, shape, strong) in enumerate(CASES):
        fn = wk.wkv6_backward if kernel == "wkv6" else ssk.ssm_scan_backward
        rec = {"case": kernel, "shape": list(shape), "strong": strong}
        try:
            args, kw = inputs(kernel, shape, strong, seed=i)
            digests = []
            for _ in range(REPS):
                grads = fn(*args, **kw)
                torch.cuda.synchronize()
                h = hashlib.sha256()
                for g in grads:
                    h.update(g.cpu().numpy().tobytes())
                digests.append(h.hexdigest()[:16])
            rec.update(sha256=digests[0], reps_equal=len(set(digests)) == 1,
                       finite=all(bool(g.isfinite().all()) for g in grads))
            if shape in (WKV6_TRAIN, SSM_TRAIN):
                times = []
                for _ in range(20):
                    start, end = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(2))
                    start.record()
                    fn(*args, **kw)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                rec["wrapper_ms"] = statistics.median(times)
        except RuntimeError as exc:     # a launch's error or a fault
            rec["error"] = str(exc).splitlines()[0][:200]
        print(json.dumps(rec), flush=True)
        if "error" in rec:
            return 1
    return 0


def _sanitizer() -> str:
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/compute-sanitizer")
    if default.exists():
        return str(default)
    raise RuntimeError("compute-sanitizer not found in the CUDA toolkit")


def run(variant: str, tool, lib: str, timeout: float) -> dict:
    """One fresh process of ``variant``, under ``tool`` or none."""
    cmd = [sys.executable, "-m", "repro_torch.kernels.sanitize_backward",
           "--child", lib]
    env = dict(os.environ)
    if tool:
        cmd = [_sanitizer(), "--tool", tool, "--error-exitcode", "9",
               "--print-limit", "20", *cmd]
        env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
    t0 = time.perf_counter()
    # A session of its own, so that a run past its time is ended with the
    # process the sanitizer started.
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            start_new_session=True)
    try:
        out = proc.communicate(timeout=timeout)[0]
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out = proc.communicate()[0]
        rc = "timeout"
    lines = out.splitlines()
    return {"variant": variant, "tool": tool or "none", "rc": rc,
            "s": round(time.perf_counter() - t0, 1),
            "cases": [json.loads(ln) for ln in lines
                      if ln.startswith('{"case"')],
            "sanitizer": [ln for ln in lines if ln.startswith("=========")
                          ][:12],
            "tail": lines[-4:] if rc != 0 else []}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tools", default="",
                    help="compute-sanitizer tools, comma-separated")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a process may take")
    ap.add_argument("--json", help="write every run's record here")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child)
    out = build.build_dir() / "sanitize"
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(
            lambda v: build_variant(v, out / v), VARIANTS)))
    print(json.dumps({"phase": "build", **{
        v: b["grad_kernel"] for v, b in built.items()}}), flush=True)
    plan = [(v, None) for v in VARIANTS + VARIANTS[::-1]]
    plan += [(v, t) for t in filter(None, args.tools.split(","))
             for v in VARIANTS[:2]]
    records = []
    for variant, tool in plan:
        rec = run(variant, tool, built[variant]["lib"], args.timeout)
        records.append(rec)
        print(json.dumps({"phase": "run", **rec}), flush=True)
    want = {(c["case"], tuple(c["shape"]), c["strong"]): c.get("sha256")
            for c in records[0]["cases"]}
    plain = [r for r in records if r["tool"] == "none"]
    summary = {
        "every_run_ended": all(r["rc"] == 0 for r in plain),
        "cases_a_run": [len(r["cases"]) for r in plain],
        "bits_equal_committed": all(
            c.get("sha256") == want.get((c["case"], tuple(c["shape"]),
                                         c["strong"]))
            and c.get("reps_equal") for r in plain for c in r["cases"]),
        "finite": all(c.get("finite") for r in plain for c in r["cases"]),
        "training_wrapper_ms": [
            {"variant": r["variant"], **{
                c["case"]: c["wrapper_ms"] for c in r["cases"]
                if "wrapper_ms" in c}} for r in plain]}
    print(json.dumps({"phase": "summary", **summary}), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"build": built, "runs": records, "summary": summary}, indent=1))
    shutil.rmtree(out, ignore_errors=True)
    return 0 if summary["every_run_ended"] else 1


if __name__ == "__main__":
    sys.exit(main())
