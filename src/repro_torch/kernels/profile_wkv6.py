"""Where the wkv6 kernel's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.profile_wkv6 [--json PATH]

Builds ``csrc/wkv6.cu`` a second time with ``-DWKV6_PROFILE`` (lane 0 of
every warp of block 0 adds ``clock64`` differences between the kernel's
``WKV6_MARK`` points), runs it at rwkv6-1.6b's prefill shape (8, 2048, 32,
64), and prints, per phase, the clocks a chunk took on the slowest warp and
on average over the warps.  The clocks are wall clocks of each warp, so a
phase's count includes the time the warp waited for issue slots that
other warps held.  Beside them it times the kernel (CUDA events, the
production build and the profiled one) and measures two rates the design
leans on: ``mma.sync.m16n8k8`` in TF32 and ``ex2.approx``, in warp
instructions a clock and SM.  Nothing here runs on the main path.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

from repro_torch.kernels import build

SHAPE = (8, 2048, 32, 64)
MARKS = 9
# What each mark closes, for the diagonal-block warps | the other warps.
PHASES = ("issue the next chunk's loads",
          "diagonal pairs | q~ and k~",
          "diagonal writes | barrier of the other warps",
          "- | off-diagonal blocks of A (mma)",
          "q and kc | decay and bonus",
          "block barrier (A, q, kc and the next stage are in)",
          "y tile (mma; the first warps)",
          "next chunk's prefix sums (the first state warps)",
          "state tile (mma; the last warps), barrier, state write")

_BENCH_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void hmma_loop(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b0 = 5u, b1 = 7u;
  float c[4][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]),
                     "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                     "r"(b1));
  }
  float s = 0.0f;
  for (int j = 0; j < 4; ++j) for (int i = 0; i < 4; ++i) s += c[j][i];
  if (s == 12345.0f) out[0] = s;
}
__global__ void ex2_loop(float* out, int iters) {
  float x[8];
  for (int j = 0; j < 8; ++j) x[j] = -0.001f * (threadIdx.x + j);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float y;
      asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x[j]));
      x[j] = y - 1.0f;
    }
  }
  float s = 0.0f;
  for (int j = 0; j < 8; ++j) s += x[j];
  if (s == 12345.0f) out[0] = s;
}
extern "C" int rate_loop(int which, int blocks, int threads, int iters) {
  if (which == 0) hmma_loop<<<blocks, threads>>>(nullptr, iters);
  else ex2_loop<<<blocks, threads>>>(nullptr, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def _nvcc_shared(sources, out: Path, defines=()) -> ctypes.CDLL:
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    cmd = [build._nvcc(), *flags, *defines, "-shared", "-o", str(out),
           *map(str, sources)]
    done = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed ({done.returncode}):\n"
                           f"{done.stderr[-4000:]}")
    return ctypes.CDLL(str(out))


def _events_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_clocks(reps: int = 5) -> dict:
    """Clocks a chunk of each phase at ``SHAPE`` (slowest warp and mean
    over the warps), and the kernel's time in the production and the
    profiled build."""
    import torch
    out_dir = build.build_dir() / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = Path(build.__file__).resolve().parent / "csrc" / "wkv6.cu"
    lib = _nvcc_shared([src], out_dir / "libwkv6_profile.so",
                       ["-DWKV6_PROFILE"])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_launch.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    lib.wkv6_phase_clocks.argtypes = [ptr, i32]
    prod = build.library()
    B, T, H, D = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(9)
    r, k, v = (torch.randn(SHAPE, generator=gen, device="cuda")
               for _ in range(3))
    logw = -torch.exp(torch.empty(SHAPE, device="cuda").uniform_(
        -4.0, 1.0, generator=gen))
    u = 0.1 * torch.randn((H, D), generator=gen, device="cuda")
    s0 = torch.randn((B, H, D, D), generator=gen, device="cuda")
    y, sT = torch.empty_like(r), torch.empty_like(s0)
    stream = torch.cuda.current_stream().cuda_stream
    args = [t.data_ptr() for t in (r, k, v, logw, u, s0, y, sT)] + \
        [B, T, H, D, stream]
    prod_ms = _events_ms(lambda: prod.wkv6_launch(*args), reps)
    lib.wkv6_launch(*args)
    torch.cuda.synchronize()
    lib.wkv6_phase_clocks(None, 1)
    prof_ms = _events_ms(lambda: lib.wkv6_launch(*args), reps)
    clocks = (ctypes.c_ulonglong * (32 * MARKS))()
    lib.wkv6_phase_clocks(ctypes.cast(clocks, ctypes.c_void_p), 0)
    chunks = (reps + 1) * -(-T // 64)       # the warm-up launch counts too
    warps = 512 // 32 if D == 64 else 256 // 32
    per_warp = [[clocks[w * MARKS + m] / chunks for m in range(MARKS)]
                for w in range(warps)]
    phases = [{"phase": name,
               "max_clocks": max(row[m] for row in per_warp),
               "mean_clocks": sum(row[m] for row in per_warp) / warps}
              for m, name in enumerate(PHASES)]
    return {"shape": list(SHAPE), "ms": prod_ms, "profiled_ms": prof_ms,
            "chunk_clocks": sum(per_warp[0]), "phases": phases,
            "per_warp": per_warp}


def rates(iters: int = 20000) -> dict:
    """Warp instructions a clock and SM of TF32 mma.sync and ex2.approx,
    with 16 warps an SM, at the SM clock nvidia-smi reports just after."""
    import torch
    out_dir = build.build_dir() / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "rates.cu"
    src.write_text(_BENCH_SRC)
    lib = _nvcc_shared([src], out_dir / "librates.so")
    lib.rate_loop.argtypes = [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    times = {}
    for which, name in ((0, "mma_m16n8k8_tf32"), (1, "ex2_approx")):
        times[name] = _events_ms(
            lambda: lib.rate_loop(which, sms, 512, iters), 1)
    clock_hz = 1e6 * float(_smi("clocks.sm").split()[0])
    result = {"sm_clock_mhz": clock_hz / 1e6}
    for name, per_iter in (("mma_m16n8k8_tf32", 4), ("ex2_approx", 8)):
        warp_instr = iters * per_iter * 16
        result[name] = warp_instr / (times[name] * 1e-3) / clock_hz
    return result


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", help="also write the result here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    result = {"card": _smi("name,power.limit"), **phase_clocks(),
              "rates": rates()}
    for row in result["phases"]:
        print(f"{row['max_clocks']:9.0f} {row['mean_clocks']:9.0f}  "
              f"{row['phase']}")
    print(json.dumps({k: v for k, v in result.items() if k != "per_warp"}))
    if args.json:
        Path(args.json).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
