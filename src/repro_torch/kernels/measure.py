"""Inputs, comparisons and device timers for checking and timing the
port's segmented and per-array CUDA kernels on the card.

``chip_smoke.py``, ``kernels/bench_segmented.py`` and the card tests share
them: the kernels' inputs (the main path's cohort-packed LeNet-28 delta,
one 2^26-element buffer, edge inputs for the wire sweeps, and flat vectors
for the per-array kernels), the taus and int8 scales the masking and wire
paths make of them, a bitwise comparison, two timers (CUDA events around
calls issued back to back; the profiler's time a launch) and the sweep
kernels' resources in an ``-Xptxas -v`` log.  Nothing here runs on the
main path, and nothing here touches the card when it is imported.
"""

from __future__ import annotations

import math
import re
import statistics

import torch

from repro_torch.core.compression import int8_scales
from repro_torch.kernels import packing as pk
from repro_torch.kernels import segmented as seg
from repro_torch.kernels.packing import SEG_LANE

__all__ = ["CLIENTS", "SPECIALS", "lenet_cohort_buffer", "large_buffer",
           "taus_for", "wire_edge_inputs", "edge_vector", "large_vector",
           "bitwise", "cuda_loop_ms", "device_ms", "wire_resources"]

CLIENTS = 32                     # the main path's cohort
# Values at the wire kernels' edges: NaN, +-inf, -0.0, subnormals, the
# lowest bin edge 2^-96 and its neighbours, the largest finite magnitudes,
# and halves that round to even (and past 127) at a scale of 1.
SPECIALS = (float("nan"), float("inf"), float("-inf"), -0.0, 0.0, 1e-45,
            -(2.0 ** -127), 2.0 ** -96, -(2.0 ** -96),
            math.nextafter(2.0 ** -96, 0.0), math.nextafter(2.0 ** -96, 1.0),
            3e38, -1e-12, 0.5, -2.5, 126.5, -127.5)


def lenet_cohort_buffer(seed: int):
    """The main path's mask input ``(x2d, seg_ids, k)``: :data:`CLIENTS`
    clients' LeNet-28 delta leaves that reach the kernels (conv2.w, fc1.w,
    fc2.w, out.w), packed cohort-major, with zeros, negatives, tiny
    (< 2^-96) and huge (> 2^28) entries; ``k`` keeps half of each leaf."""
    gen = torch.Generator().manual_seed(seed)
    shapes = [(5, 5, 6, 16), (784, 120), (120, 84), (84, 10)]
    leaves = []
    for shape in shapes:
        x = 1e-3 * torch.randn((CLIENTS,) + shape, generator=gen)
        flat = x.view(CLIENTS, -1)
        flat[:, ::97] = 0.0
        flat[:, 1::211] = 1e-31
        flat[:, 2::1009] = 3e8
        leaves.append(x)
    spec = pk.build_pack_spec([leaf[0] for leaf in leaves])
    x2d = pk.pack_stacked(leaves, spec)
    k = torch.tensor([max(1, round(0.5 * ls.size)) for ls in spec.leaves],
                     dtype=torch.int32).repeat(CLIENTS)
    return x2d, spec.seg_ids(CLIENTS), k


def large_buffer(seed: int, num_segments: int = 64):
    """``(x2d, seg_ids, k)``: 2^26 elements in ``num_segments`` equal
    segments of different scales; ``k`` keeps a tenth of each."""
    gen = torch.Generator().manual_seed(seed)
    rows = (1 << 26) // SEG_LANE
    x2d = torch.randn((rows, SEG_LANE), generator=gen)
    scale = torch.logspace(-6, 2, num_segments)
    seg_ids = torch.arange(num_segments, dtype=torch.int32
                           ).repeat_interleave(rows // num_segments)
    x2d *= scale[seg_ids.long()][:, None]
    k = torch.full((num_segments,), rows // num_segments * SEG_LANE // 10,
                   dtype=torch.int32)
    return x2d, seg_ids, k


def taus_for(x2d, seg_ids, k, num_segments):
    """The count, apply and encode kernels' inputs as the masking and wire
    paths make them: 16 geometric candidates per segment, one final tau,
    and the int8 scales from the segment maxima."""
    hist, amax = seg.segmented_stats_plain(x2d, seg_ids, num_segments)
    lo, hi, cnt_lo, cnt_hi = seg.select_thresholds(hist, k)
    cand = seg.candidate_taus(lo, hi, 16, geometric=True)
    counts = seg.segmented_count_plain(x2d, seg_ids, cand)
    lo, hi, cnt_lo, cnt_hi = seg.shrink_brackets(lo, hi, cnt_lo, cnt_hi,
                                                 cand, counts, k)
    tau = torch.where(cnt_hi >= 1, hi, lo)
    return (cand.contiguous(), tau.contiguous(),
            int8_scales(amax[:, 0]).contiguous())


def wire_edge_inputs(rows: int, seed: int):
    """``(x2d, seg_ids, taus, scales)`` on the CPU: ``rows`` rows of
    magnitudes from 1e-5 to 1 with every value of :data:`SPECIALS` spread
    over them; segments of 1 to 7 rows (so they change in the
    middle of a block's rows, and some hold one row), ids S + 1 and -2 on
    some rows after the first; taus from 1e-5 to 0.1 and 2^-96 on every
    fifth segment; scales from 1e-6 to 10 with 1e-12, inf, NaN and 1 among
    them."""
    gen = torch.Generator().manual_seed(seed)
    x2d = torch.randn((rows, SEG_LANE), generator=gen)
    x2d *= 10.0 ** (-5 + 5 * torch.rand((rows, 1), generator=gen))
    flat = x2d.view(-1)
    for i, v in enumerate(SPECIALS):
        flat[i * 7 % 61::61 + i] = v
    lengths = torch.randint(1, 8, (rows,), generator=gen)
    ids = torch.repeat_interleave(torch.arange(rows), lengths)[:rows]
    num_segments = int(ids[-1]) + 1
    ids = ids.to(torch.int32)
    ids[max(1, rows // 3)::11] = num_segments + 1
    ids[max(1, rows // 2)::13] = -2
    taus = 10.0 ** (-5 + 4 * torch.rand((num_segments,), generator=gen))
    taus[::5] = 2.0 ** -96
    scales = 10.0 ** (-6 + 7 * torch.rand((num_segments,), generator=gen))
    scales[1::7] = 1e-12
    scales[2::7] = float("inf")
    scales[3::7] = float("nan")
    scales[4::7] = 1.0
    return x2d, ids, taus.float(), scales.float()


def edge_vector(n: int, seed: int):
    """n fp32 values on the CPU for the per-array kernels: normals at scales
    1e-6..10, zeros and -0.0, values above 2^28 and below 2^-96,
    subnormals, +-inf and NaN."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=gen) * 10.0 ** (
        7 * torch.rand(n, generator=gen) - 6)
    x[::31] = 0.0
    x[1::37] = -0.0
    x[2::41] = 3e8
    x[3::43] = -1e-31
    x[4::47] = 1e-40
    x[5::53] = float("inf")
    x[6::59] = float("-inf")
    x[7::61] = float("nan")
    return x


def large_vector(seed: int):
    """2^26 normals on the CPU in 64 chunks of scales 1e-6..1e2."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(1 << 26, generator=gen).view(64, -1)
    x *= torch.logspace(-6, 2, 64)[:, None]
    return x.reshape(-1)


def bitwise(a, b) -> bool:
    """Whether two tensors are equal bit for bit (fp32 compared as bits, so
    NaN equals NaN and -0.0 differs from +0.0)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def cuda_loop_ms(fns, launches: int = 50, reps: int = 5) -> float:
    """Milliseconds per call of ``launches`` calls issued back to back
    between two CUDA events (median over ``reps``), call i running
    ``fns[i % len(fns)]``: the device time of a kernel whose host-side
    launch is cheaper than its run.  A call that returns a nonzero error
    code raises."""
    for fn in fns[:3]:
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(launches):
            rc = fns[i % len(fns)]()
            if rc:
                raise RuntimeError(f"kernel launch returned cudaError {rc}")
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


SESSIONS = 6     # profiler sessions device_ms tries before it gives up


def device_ms(fns, symbol: str, launches: int = 50,
              events_fallback: bool = False) -> dict:
    """``launches`` calls back to back, as in :func:`cuda_loop_ms`, under
    ``torch.profiler`` (after one call of each of ``fns``, so that the L2
    holds what these calls leave there and not what ran before them, and
    one short session that starts the tracer):
    the traced time per record of the kernel named ``symbol`` (no launch
    gaps, whatever the host's pace), the device records of the trace, the
    kernel's records and the calls made.  A call that puts more than the
    kernel on the stream shows as more records than kernel records.  A
    call that returns a nonzero error code raises.  A session whose trace
    lost every record of the kernel (it happens on the card now and then)
    is run again, SESSIONS at the most (a whole session can come back
    empty, and three in a row have).  When all of them lost it,
    it raises, naming the records the last trace held; or, with
    ``events_fallback``, it returns the time a call between two CUDA
    events (:func:`cuda_loop_ms`, launch gaps included) as ``device_ms``,
    with ``device_source`` "cuda_events" and no record counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def call(i):
        rc = fns[i % len(fns)]()
        if isinstance(rc, int) and rc:
            raise RuntimeError(f"kernel launch returned cudaError {rc}")
    for i in range(len(fns)):
        call(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        call(0)
        torch.cuda.synchronize()
    for _ in range(SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(launches):
                call(i)
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        mine = [e for e in events if symbol in e.name]
        if mine:
            break
    else:
        if events_fallback:
            return {"device_ms": cuda_loop_ms(fns, launches=launches),
                    "device_records": None, "kernel_records": None,
                    "calls": launches, "device_source": "cuda_events",
                    "lost_sessions": SESSIONS}
        seen = sorted({e.name for e in events})
        raise RuntimeError(f"the trace holds no record of {symbol} in "
                           f"{SESSIONS} "
                           f"sessions; the last held {len(events)} device "
                           f"records: {seen[:8]}")
    return {"device_ms": sum(e.time_range.elapsed_us() for e in mine)
            / 1e3 / len(mine),
            "device_records": len(events), "kernel_records": len(mine),
            "calls": launches}


# Each sweep kernel's key in :func:`wire_resources`, by a part of its
# mangled name.
_RESOURCE_KINDS = (("seg_hist_kernel", "hist"), ("seg_stats", "stats"),
                   ("seg_encode_kernelILb1", "int8"),
                   ("seg_encode_kernelILb0", "fp32"),
                   ("exponent_hist_kernel", "exponent_hist"),
                   ("apply_threshold_kernel", "apply"))


def wire_resources(log: str) -> dict:
    """Registers, stack and spills of the histogram, stats and both encode
    kernels of ``segmented.cu`` and of the per-array histogram and apply
    kernels in an ``-Xptxas -v`` log, under "hist", "stats", "int8",
    "fp32", "exponent_hist" and "apply" (those that the log holds)."""
    found = {}
    for m in re.finditer(r"Compiling entry function '(\S*)'(.*?)"
                         r"(?=Compiling entry function|== |\Z)", log, re.S):
        name = m.group(1)
        kind = next((k for part, k in _RESOURCE_KINDS if part in name),
                    None)
        if kind is None:
            continue
        body = m.group(2)
        found[kind] = {key: int(v.group(1)) if v else None
                       for key, v in (
                           ("registers", re.search(r"Used (\d+) registers",
                                                   body)),
                           ("stack_bytes", re.search(
                               r"(\d+) bytes stack frame", body)),
                           ("spill_stores", re.search(
                               r"(\d+) bytes spill stores", body)),
                           ("spill_loads", re.search(
                               r"(\d+) bytes spill loads", body)))}
    return found
