"""The segmented sweeps ``segmented_histogram``, ``segmented_stats`` and
``segmented_encode``, and the per-array ``exponent_histogram`` and
``apply_threshold``, built from ``csrc/segmented.cu`` and
``csrc/topk_mask.cu`` and from other sources, side by side on the card.

    PYTHONPATH=src python -m repro_torch.kernels.bench_segmented \\
        [--source NAME=PATH ...] [--topk-source NAME=PATH ...] [--sass] \\
        [--json PATH]

Builds ``csrc/segmented.cu`` and ``csrc/topk_mask.cu`` (each as
``built-in``), each ``--source`` (another ``segmented.cu``: for instance
the parent commit's, or an edited copy) and each ``--topk-source`` (another
``topk_mask.cu``), every ``nvcc`` started together; the C launchers of a
source must be those of the file it stands in for.

For each ``segmented.cu`` build it prints the histogram, stats and both
encode kernels' registers and spills (``-Xptxas -v``; with ``--sass``, each
local-memory instruction in their SASS with its context), checks the four
bitwise against their plain versions on the main path's buffer (the
cohort-packed LeNet-28 delta of 32 clients: 3392 rows, 128 segments), on
2^26 elements in 64 segments and on the wire edge inputs, and times them on
the first two: back to back on rotating copies (CUDA events) and by the
profiler's time a launch, beside the profiler's time of ``torch.amax`` over
the same buffer (one read of it).

For each ``topk_mask.cu`` build it prints the histogram and apply kernels'
registers and spills and the apply kernels' global loads and stores by
width in the SASS (``cuobjdump``), and checks ``exponent_histogram`` and
``apply_threshold`` bitwise against their plain versions on edge values at
the largest VGG leaf's size (147,456), on 2^20 edge values, on 2^26
normals, on 2^26 values in [1, 2) (every element in one bin) and on views
of the first two that start 1-3 elements in, at lengths 0, 1, 3, 5, 4095
and the rest; apply at tau in {0, 2^-100, median, max} of the finite |x|,
into an output at x's offset from a 16-byte boundary (as the wrapper
allocates it).  It times the histogram at the leaf's size and on both 2^26
inputs as above, and apply at the leaf's size (also on copies that start
one element in, and into one output for every call) and on the 2^26
normals, in turns with ``hardshrink(x, nextafter(tau, 0))`` on the same
buffers and outputs; each with the trace's device records a call (one a
call when the launcher puts nothing but the kernel on the stream).

The builds are timed in turns, twice.  Inputs and timers are those of
``kernels/measure.py``, which ``chip_smoke.py`` uses too.  Exits 1 if a
build failed or disagreed.
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
from repro_torch.kernels import topk_mask as tk
from repro_torch.kernels.packing import SEG_LANE

EDGE_ROWS = (1, 3, 5, 4095, 33 * 1024 + 5)
# The histogram and stats kernels and the two instances of the encode
# kernel.
KINDS = ("hist", "stats", "int8", "fp32")
SYMBOLS = {"hist": "seg_hist_kernel", "stats": "seg_stats_kernel",
           "int8": "seg_encode_kernel", "fp32": "seg_encode_kernel"}
TOPK_SYMBOL = "exponent_hist_kernel"
APPLY_SYMBOL = "apply_threshold_kernel"
LEAF = 147_456                   # the largest VGG leaf, 3 x 3 x 128 x 128
VIEW_LENGTHS = (0, 1, 3, 5, 4095)
CSRC = Path(build.__file__).resolve().parent / "csrc"


def _build(name: str, source: Path, out_dir: Path):
    out = out_dir / f"lib{source.stem}_{name}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
           str(source)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _print_local_memory(lib: Path, context: int = 6) -> None:
    """Each STL/LDL (spill) of the sweep kernels in the SASS, with the
    instructions around it."""
    sass = subprocess.run(
        [str(Path(build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
        capture_output=True, text=True, check=True, timeout=300).stdout
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0]
        if not any(k in name for k in ("seg_hist", "seg_stats", "seg_encode",
                                       "exponent_hist", "apply_threshold")):
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
    """Zeroed outputs of one launch on ``x2d``: (hist,) for "hist", (hist,
    amax) for "stats", (codes or values, bitmap, kept) for "int8" and
    "fp32"."""
    dev = x2d.device
    hist = torch.zeros((num_segments, seg.SEG_NBINS), dtype=torch.int32,
                       device=dev)
    if kind == "hist":
        return (hist,)
    if kind == "stats":
        return hist, torch.zeros((num_segments, 1), device=dev)
    dtype = torch.int8 if kind == "int8" else torch.float32
    return (torch.zeros(x2d.shape, dtype=dtype, device=dev),
            torch.zeros((x2d.shape[0], SEG_LANE // 8), dtype=torch.uint8,
                        device=dev),
            torch.zeros((num_segments, 1), dtype=torch.int32, device=dev))


def _launcher(lib, kind: str, x2d, seg_ids, taus, scales, outs):
    """A call of ``lib``'s histogram, stats or encode C launcher on the
    current stream into ``outs`` (:func:`_outputs`), every pointer taken
    once; the call returns the launcher's error code.  It counts no
    launch."""
    rows, S = x2d.shape[0], taus.numel()
    stream = torch.cuda.current_stream().cuda_stream
    x, ids = x2d.data_ptr(), seg_ids.data_ptr()
    ptrs = [t.data_ptr() for t in outs]
    if kind == "hist":
        return lambda: lib.seg_histogram_launch(x, ids, rows, S, *ptrs,
                                                stream)
    if kind == "stats":
        return lambda: lib.seg_stats_launch(x, ids, rows, S, *ptrs, stream)
    t = taus.data_ptr()
    sc = scales.data_ptr() if kind == "int8" else None
    return lambda: lib.seg_encode_launch(x, ids, t, sc, rows, S, *ptrs,
                                         stream)


def _plain(kind, x2d, seg_ids, taus, scales) -> tuple:
    if kind == "hist":
        return (seg.segmented_histogram_plain(x2d, seg_ids, taus.numel()),)
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


def _hist_launcher(lib, x, out):
    """A call of ``lib``'s per-array histogram C launcher on ``x`` into
    ``out`` ((128,) int32, not zeroed), returning its error code."""
    stream = torch.cuda.current_stream().cuda_stream
    p, n, o = x.data_ptr(), x.numel(), out.data_ptr()
    return lambda: lib.topk_histogram_launch(p, n, o, stream)


def _apply_launcher(lib, x, tau, out):
    """A call of ``lib``'s apply C launcher on ``x`` at ``tau`` into
    ``out``, returning its error code."""
    stream = torch.cuda.current_stream().cuda_stream
    p, n, t, o = x.data_ptr(), x.numel(), tau.data_ptr(), out.data_ptr()
    return lambda: lib.topk_apply_launch(p, n, t, o, stream)


def _apply_taus(x) -> list:
    """0, 2^-100, the median and the largest finite |x|, as 0-d tensors on
    x's device."""
    finite = x[torch.isfinite(x)].abs()
    values = [0.0, 2.0 ** -100]
    if finite.numel():
        values += [float(finite.median()), float(finite.max())]
    return [torch.tensor(v, device=x.device) for v in values]


def _topk_agrees(lib, x, views: bool) -> dict:
    """``exponent_histogram`` and ``apply_threshold`` of ``lib`` bitwise
    against their plain versions on ``x`` ("all") and, with ``views``, on
    views of it that start 1-3 elements in ("offset:length"); apply at
    each of :func:`_apply_taus`, into an output at x's offset from a
    16-byte boundary (as the wrapper allocates it)."""
    cases = {"all": x}
    if views:
        for offset in (1, 2, 3):
            rest = x.numel() - offset
            for n in sorted({min(m, rest) for m in (*VIEW_LENGTHS, rest)}):
                cases[f"{offset}:{n}"] = x[offset:offset + n]
    taus = _apply_taus(x)
    agree = {}
    for label, v in cases.items():
        out = torch.full((tk.NBINS,), -1, dtype=torch.int32, device=x.device)
        rc = _hist_launcher(lib, v, out)()
        if rc:
            raise RuntimeError(f"histogram launch returned cudaError {rc}")
        agree[label] = bool(torch.equal(out, tk.exponent_histogram_plain(v)))
        out, ok = tk._empty_congruent(v), True
        for tau in taus:
            out.fill_(float("nan"))
            rc = _apply_launcher(lib, v, tau, out)()
            if rc:
                raise RuntimeError(f"apply launch returned cudaError {rc}")
            ok &= measure.bitwise(out, tk.apply_threshold_plain(v, tau))
        agree[f"apply {label}"] = ok
    return agree


def _rotating(x) -> list:
    """``x`` and clones of it, over four times the L2 cache in all."""
    l2 = torch.cuda.get_device_properties(x.device).L2_cache_size
    copies = max(2, -(-4 * l2 // x.nbytes))
    return [x] + [x.clone() for _ in range(copies - 1)]


def _bench_segmented(libs: dict, result: dict) -> dict:
    """Checks and times of the ``segmented.cu`` builds into ``result``;
    returns ``torch.amax``'s device time a call by shape."""
    dev = torch.device("cuda")
    amax_ms = {}
    shapes = {}
    for label, (x2d, ids, k) in (
            ("path", measure.lenet_cohort_buffer(seed=1)),
            ("2^26", measure.large_buffer(seed=2))):
        _, tau, scales = measure.taus_for(x2d, ids, k, k.numel())
        shapes[label] = (x2d, ids, tau, scales)
    edges = {f"edges_{r}": measure.wire_edge_inputs(r, seed=r)
             for r in EDGE_ROWS}
    for label, cpu in {**shapes, **edges}.items():
        inputs = tuple(t.to(dev) for t in cpu)
        for name, lib in libs.items():
            agree = _agrees(lib, inputs)
            result[name].setdefault("bitwise", {})[label] = agree
            if not all(agree.values()):
                print(f"FAIL: {name} disagrees with the plain versions on "
                      f"{label}: {agree}", flush=True)
        if label not in shapes:
            continue
        x2d, S = inputs[0], inputs[2].numel()
        xs = _rotating(x2d)
        # torch.amax's device time a call: every record of its trace (the
        # reduction may take more than one kernel).
        amax = measure.device_ms([lambda x=x: torch.amax(x) for x in xs], "")
        amax_ms[label] = (amax["device_ms"] * amax["kernel_records"]
                          / amax["calls"])
        for turn in range(2):
            for name, lib in libs.items():
                for kind in KINDS:
                    fns = [_launcher(
                        lib, kind, x, *inputs[1:],
                        _outputs(kind, x, S)) for x in xs]
                    rec = {"ms": measure.cuda_loop_ms(fns),
                           **measure.device_ms(fns, SYMBOLS[kind])}
                    result[name].setdefault(label, {}).setdefault(
                        kind, []).append(rec)
                    print(label, turn, name, kind, json.dumps(rec),
                          flush=True)
        del inputs, xs
        torch.cuda.empty_cache()
    return amax_ms


def _shifted_copies(x, offset: int) -> list:
    """Copies of ``x`` (over four times the L2 cache in all), each a view
    that starts ``offset`` elements into a fresh buffer."""
    out = []
    for c in _rotating(x):
        buf = torch.empty(c.numel() + 4, device=c.device)
        view = buf[offset:offset + c.numel()]
        view.copy_(c)
        out.append(view)
    return out


def _discard(fn, *args):
    """A call of ``fn(*args)`` that returns None (the timers read a
    returned value as a launcher's error code)."""
    def call():
        fn(*args)
    return call


def _time(fns, symbol: str) -> dict:
    """Back to back (CUDA events) and the profiler's time a record."""
    return {"ms": measure.cuda_loop_ms(fns), **measure.device_ms(fns, symbol)}


def _bench_topk(libs: dict, result: dict) -> dict:
    """Checks and times of the ``topk_mask.cu`` builds into ``result``;
    returns ``hardshrink``'s times by case."""
    dev = torch.device("cuda")
    yardstick = {}
    gen = torch.Generator().manual_seed(6)
    inputs = {"leaf": measure.edge_vector(LEAF, seed=5),
              "edges_2^20": measure.edge_vector(1 << 20, seed=4),
              "2^26": measure.large_vector(seed=3),
              # Every element in one bin: the most equal bins a warp meets.
              "2^26_one_octave": 1.0 + torch.rand(1 << 26, generator=gen)}
    for label, cpu in inputs.items():
        x = cpu.to(dev)
        for name, lib in libs.items():
            agree = _topk_agrees(lib, x, views=not label.startswith("2^26"))
            result[name].setdefault("bitwise", {})[label] = agree
            if not all(agree.values()):
                bad = [k for k, ok in agree.items() if not ok]
                print(f"FAIL: {name} disagrees with the plain version on "
                      f"{label}: {bad}", flush=True)
        if label == "edges_2^20":
            continue
        xs = _rotating(x)
        outs = [torch.empty(tk.NBINS, dtype=torch.int32, device=dev)
                for _ in xs]
        for turn in range(2):
            for name, lib in libs.items():
                rec = _time([_hist_launcher(lib, v, o)
                             for v, o in zip(xs, outs)], TOPK_SYMBOL)
                result[name].setdefault(label, []).append(rec)
                print(label, turn, name, "exponent_hist", json.dumps(rec),
                      flush=True)
        if label in ("leaf", "2^26"):
            _bench_apply(libs, result, yardstick, label, x)
        del x, xs
        torch.cuda.empty_cache()
    return yardstick


def _hardshrink_into(x, lam, out):
    torch.ops.aten.hardshrink.out(x, lam, out=out)


def _bench_apply(libs: dict, result: dict, yardstick: dict, label: str,
                 x) -> None:
    """``apply_threshold`` of each build at tau = median |x|, in turns with
    ``hardshrink(x, nextafter(tau, 0))`` on the same buffers (its device
    time a call: every record of its trace): on ``x`` and, at the leaf, on
    copies that start one element in, into outputs at the same offset (as
    the wrapper allocates them; hardshrink into the same outputs), and on
    the leaf's copies into one output that every call rewrites (hardshrink
    into the block the caching allocator hands it, which is one block
    too).  Which lines of the output the L2 holds moves
    a leaf's time by a quarter, so each comparison keeps one regime."""
    tau = torch.tensor(float(x.abs().nan_to_num().median()), device=x.device)
    lam = float(torch.nextafter(tau.cpu(), torch.zeros(())))
    cases = {label: (_rotating(x), tk._empty_congruent)}
    if label == "leaf":
        cases["leaf_one_output"] = (cases["leaf"][0], None)
        cases["leaf_offset1"] = (_shifted_copies(x, 1), tk._empty_congruent)
    for case, (xs, make_out) in cases.items():
        # One output for every call, as the caching allocator hands the
        # wrapper (and hardshrink) the block the last call freed.
        outs = ([make_out(v) for v in xs] if make_out else
                [torch.empty_like(x)] * len(xs))
        for turn in range(2):
            for name, lib in libs.items():
                rec = _time([_apply_launcher(lib, v, tau, o)
                             for v, o in zip(xs, outs)], APPLY_SYMBOL)
                rec["records_per_call"] = (rec["device_records"]
                                           / rec["kernel_records"])
                result[name].setdefault(f"apply {case}", []).append(rec)
                print(case, turn, name, "apply", json.dumps(rec), flush=True)
            if make_out is None:
                calls = [_discard(torch.nn.functional.hardshrink, v, lam)
                         for v in xs]
            else:
                calls = [_discard(_hardshrink_into, v, lam, o)
                         for v, o in zip(xs, outs)]
            dev = measure.device_ms(calls, "")
            rec = {"ms": measure.cuda_loop_ms(calls),
                   "device_ms": dev["device_ms"] * dev["kernel_records"]
                   / dev["calls"], "records_per_call":
                   dev["device_records"] / dev["calls"]}
            yardstick.setdefault(case, []).append(rec)
            print(case, turn, "hardshrink", json.dumps(rec), flush=True)
        del xs, outs


def _apply_sass(lib: Path) -> dict:
    """Per apply kernel of ``lib``, its global loads and stores in the SASS
    by width (``LDG.E.128``, ``STG.E``, ...)."""
    sass = subprocess.run(
        [str(Path(build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
        capture_output=True, text=True, check=True, timeout=300).stdout
    found = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        if "apply_threshold" not in name:
            continue
        ops = re.findall(r"\b((?:LDG|STG)\.E[.\w]*)", part)
        found[name] = {op: ops.count(op) for op in sorted(set(ops))}
    return found


def _named(items, default: Path) -> dict:
    sources = {"built-in": default}
    for item in items:
        name, path = item.split("=", 1)
        sources[name] = Path(path)
    return sources


def main(argv=None) -> int:
    """Build, check and time; 1 if a build failed or disagreed."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--source", action="append", default=[],
                        help="NAME=PATH of another segmented.cu to time")
    parser.add_argument("--topk-source", action="append", default=[],
                        help="NAME=PATH of another topk_mask.cu to time")
    parser.add_argument("--sass", action="store_true",
                        help="print each sweep kernel's local-memory "
                             "instructions (cuobjdump) with their context")
    parser.add_argument("--json", help="also write the result here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    out_dir = build.build_dir() / "bench_segmented"
    out_dir.mkdir(parents=True, exist_ok=True)
    groups = {"builds": (_named(args.source, CSRC / "segmented.cu"),
                         ("seg_histogram_launch", "seg_stats_launch",
                          "seg_encode_launch")),
              "topk_builds": (_named(args.topk_source, CSRC / "topk_mask.cu"),
                              ("topk_histogram_launch",
                               "topk_apply_launch"))}
    jobs = {(group, name): _build(f"{group}_{name}", path, out_dir)
            for group, (sources, _) in groups.items()
            for name, path in sources.items()}
    result = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(),
        "builds": {}, "topk_builds": {}}
    libs = {"builds": {}, "topk_builds": {}}
    for (group, name), (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"FAIL: nvcc failed on {name}:\n{log[-4000:]}", flush=True)
            result[group][name] = {"nvcc": proc.returncode}
            continue
        libs[group][name] = build.load(path, groups[group][1])
        result[group][name] = {"resources": measure.wire_resources(log)}
        if group == "topk_builds":
            result[group][name]["apply_sass"] = _apply_sass(path)
        print(group, name, json.dumps(result[group][name]), flush=True)
        if args.sass:
            _print_local_memory(path)
    result["amax_read_ms"] = _bench_segmented(libs["builds"],
                                              result["builds"])
    result["hardshrink"] = _bench_topk(libs["topk_builds"],
                                       result["topk_builds"])
    print(json.dumps(result))
    if args.json:
        Path(args.json).write_text(json.dumps(result, indent=1))
    bad = [name for group in ("builds", "topk_builds")
           for name, rec in result[group].items()
           if "nvcc" in rec
           or not all(all(a.values()) for a in rec["bitwise"].values())]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
