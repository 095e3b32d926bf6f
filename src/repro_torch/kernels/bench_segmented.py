"""The fused wire path's two kernels, ``segmented_stats`` and
``segmented_encode``, built from ``csrc/segmented.cu`` and from other
sources, side by side on the card.

    PYTHONPATH=src python -m repro_torch.kernels.bench_segmented \\
        [--source NAME=PATH ...] [--sass] [--json PATH]

Builds ``csrc/segmented.cu`` (as ``built-in``) and each ``--source`` (for
instance the parent commit's ``segmented.cu``, or an edited copy; their C
launchers must be the same), every ``nvcc`` started together.  For each
build it prints the stats kernel's and both encode kernels' registers and
spills (``-Xptxas -v``; with ``--sass``, each local-memory instruction in
their SASS with its context), checks stats and encode (int8 and fp32)
bitwise against their plain versions on the main path's buffer (the
cohort-packed LeNet-28 delta of 32 clients: 3392 rows, 128 segments), on
2^26 elements in 64 segments and on the wire edge inputs, and times them on
the first two: back to back on rotating copies (CUDA events) and by the
profiler's time a launch, beside the profiler's time of ``torch.amax`` over
the same buffer (one read of it).  The builds are timed in turns, twice.
Inputs and timers are those of ``kernels/measure.py``, which
``chip_smoke.py`` uses too.  Exits 1 if a build failed or disagreed.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels import measure
from repro_torch.kernels import segmented as seg
from repro_torch.kernels.packing import SEG_LANE

EDGE_ROWS = (1, 3, 5, 4095, 33 * 1024 + 5)
# The stats kernel and the two instances of the encode kernel.
KINDS = ("stats", "int8", "fp32")
SYMBOLS = {"stats": "seg_stats_kernel", "int8": "seg_encode_kernel",
           "fp32": "seg_encode_kernel"}


def _build(name: str, source: Path, out_dir: Path):
    out = out_dir / f"libseg_{name}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
           str(source)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _print_local_memory(lib: Path, context: int = 6) -> None:
    """Each STL/LDL (spill) of the wire kernels in the SASS, with the
    instructions around it."""
    sass = subprocess.run(
        [str(Path(build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
        capture_output=True, text=True, check=True, timeout=300).stdout
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0]
        if "seg_stats" not in name and "seg_encode" not in name:
            continue
        lines = [ln.strip() for ln in part.splitlines() if "/*" in ln]
        hits = [i for i, ln in enumerate(lines)
                if re.search(r"\b(STL|LDL)\b", ln)]
        print(f"-- {name}: {len(lines)} lines, {len(hits)} STL/LDL")
        for i in hits:
            for ln in lines[max(0, i - context):i + context + 1]:
                print("   ", ln[:110])
            print("    ..")


def _outputs(kind: str, x2d, num_segments: int) -> tuple:
    """Zeroed outputs of one stats or encode launch on ``x2d``: (hist,
    amax) for "stats", (codes or values, bitmap, kept) for "int8" and
    "fp32"."""
    dev = x2d.device
    if kind == "stats":
        return (torch.zeros((num_segments, seg.SEG_NBINS), dtype=torch.int32,
                            device=dev),
                torch.zeros((num_segments, 1), device=dev))
    dtype = torch.int8 if kind == "int8" else torch.float32
    return (torch.zeros(x2d.shape, dtype=dtype, device=dev),
            torch.zeros((x2d.shape[0], SEG_LANE // 8), dtype=torch.uint8,
                        device=dev),
            torch.zeros((num_segments, 1), dtype=torch.int32, device=dev))


def _launcher(lib, kind: str, x2d, seg_ids, taus, scales, outs):
    """A call of ``lib``'s stats or encode C launcher on the current stream
    into ``outs`` (:func:`_outputs`), every pointer taken once; the call
    returns the launcher's error code.  It counts no launch."""
    rows, S = x2d.shape[0], taus.numel()
    stream = torch.cuda.current_stream().cuda_stream
    x, ids = x2d.data_ptr(), seg_ids.data_ptr()
    ptrs = [t.data_ptr() for t in outs]
    if kind == "stats":
        return lambda: lib.seg_stats_launch(x, ids, rows, S, *ptrs, stream)
    t = taus.data_ptr()
    sc = scales.data_ptr() if kind == "int8" else None
    return lambda: lib.seg_encode_launch(x, ids, t, sc, rows, S, *ptrs,
                                         stream)


def _plain(kind, x2d, seg_ids, taus, scales):
    if kind == "stats":
        return seg.segmented_stats_plain(x2d, seg_ids, taus.numel())
    return seg.segmented_encode_plain(x2d, seg_ids, taus,
                                      scales if kind == "int8" else None)


def _agrees(lib, inputs) -> dict:
    """Each kind's one launch on fresh outputs, bitwise against its plain
    version."""
    x2d, S = inputs[0], inputs[2].numel()
    agree = {}
    for kind in KINDS:
        outs = _outputs(kind, x2d, S)
        rc = _launcher(lib, kind, *inputs, outs)()
        if rc:
            raise RuntimeError(f"{kind} launch returned cudaError {rc}")
        agree[kind] = all(measure.bitwise(g, w) for g, w in
                          zip(outs, _plain(kind, *inputs)))
    return agree


def main(argv=None) -> int:
    """Build, check and time; 1 if a build failed or disagreed."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--source", action="append", default=[],
                        help="NAME=PATH of another segmented.cu to time")
    parser.add_argument("--sass", action="store_true",
                        help="print each wire kernel's local-memory "
                             "instructions (cuobjdump) with their context")
    parser.add_argument("--json", help="also write the result here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    out_dir = build.build_dir() / "bench_segmented"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {"built-in": Path(build.__file__).resolve().parent / "csrc"
               / "segmented.cu"}
    for item in args.source:
        name, path = item.split("=", 1)
        sources[name] = Path(path)
    jobs = {name: _build(name, path, out_dir)
            for name, path in sources.items()}
    libs, result = {}, {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), "builds": {}}
    for name, (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"FAIL: nvcc failed on {name}:\n{log[-4000:]}", flush=True)
            result["builds"][name] = {"nvcc": proc.returncode}
            continue
        libs[name] = build.load(path, ("seg_stats_launch",
                                       "seg_encode_launch"))
        result["builds"][name] = {"resources": measure.wire_resources(log)}
        print(name, json.dumps(result["builds"][name]), flush=True)
        if args.sass:
            _print_local_memory(path)
    dev = torch.device("cuda")
    shapes = {}
    for label, (x2d, ids, k) in (
            ("path", measure.lenet_cohort_buffer(seed=1)),
            ("2^26", measure.large_buffer(seed=2))):
        _, tau, scales = measure.taus_for(x2d, ids, k, k.numel())
        shapes[label] = (x2d, ids, tau, scales)
    edges = {f"edges_{r}": measure.wire_edge_inputs(r, seed=r)
             for r in EDGE_ROWS}
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    for label, cpu in {**shapes, **edges}.items():
        inputs = tuple(t.to(dev) for t in cpu)
        for name, lib in libs.items():
            agree = _agrees(lib, inputs)
            result["builds"][name].setdefault("bitwise", {})[label] = agree
            if not all(agree.values()):
                print(f"FAIL: {name} disagrees with the plain versions on "
                      f"{label}: {agree}", flush=True)
        if label not in shapes:
            continue
        x2d, S = inputs[0], inputs[2].numel()
        copies = max(2, -(-4 * l2 // x2d.nbytes))
        xs = [x2d] + [x2d.clone() for _ in range(copies - 1)]
        # torch.amax's device time a call: every record of its trace (the
        # reduction may take more than one kernel).
        amax = measure.device_ms([lambda x=x: torch.amax(x) for x in xs], "")
        result.setdefault("amax_read_ms", {})[label] = (
            amax["device_ms"] * amax["kernel_records"] / amax["calls"])
        for turn in range(2):
            for name, lib in libs.items():
                for kind in KINDS:
                    fns = [_launcher(
                        lib, kind, x, *inputs[1:],
                        _outputs(kind, x, S)) for x in xs]
                    rec = {"ms": measure.cuda_loop_ms(fns),
                           **measure.device_ms(fns, SYMBOLS[kind])}
                    result["builds"][name].setdefault(label, {}).setdefault(
                        kind, []).append(rec)
                    print(label, turn, name, kind, json.dumps(rec),
                          flush=True)
        del inputs, xs
        torch.cuda.empty_cache()
    print(json.dumps(result))
    if args.json:
        Path(args.json).write_text(json.dumps(result, indent=1))
    bad = [name for name, rec in result["builds"].items()
           if "nvcc" in rec
           or not all(all(a.values()) for a in rec["bitwise"].values())]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
