// Selective-SSM scan for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py (_ssm_kernel behind
// ssm_scan_tiled), which the port runs once per Hymba layer of a prefill
// (models/ssm.ssm_forward).  Per batch row b, channel c and state lane n:
//
//   h_t[c, n] = a_t[c, n] * h_{t-1}[c, n] + bx_t[c, n]
//   y_t[c]    = sum_n C_t[n] * h_t[c, n]
//
// Layout.  The model's own: a, bx (B, T, d, N), c (B, T, N), h0 and hT
// (B, d, N), y (B, T, d), all fp32 and contiguous.  The TPU kernel wants d on
// its 128-wide lane axis and the wrapper transposes and pads for it; here
// nothing is transposed or padded.
//
// Work split.  One thread per (b, c, n), sequential over T with h in a
// register.  The N lanes of one channel are N neighbouring lanes of a warp
// (N divides 32), so each step's loads of a and bx are one coalesced 128-byte
// line per warp, and y_t[c] is a __shfl_xor_sync butterfly over those N
// lanes, written by lane n = 0.  Blocks of 256 threads hold 256 / N channels;
// the grid is (ceil(d N / 256), B): 800 blocks at Hymba's full width
// (B = 8, d = 1600, N = 16).  Threads past the last channel run the loop on
// zeros so that every shuffle sees its whole group, and store nothing.  The
// loop reads eight steps' inputs before it uses them, so each thread keeps
// eight independent loads in flight.
//
// What bounds it.  Per (t, c, n) it reads a and bx once (8 bytes) and does
// four flops; y, c, h0 and hT add little.  At the serving shape that is
// 3.46 GB, 1.03 ms at 3.35 TB/s, against 0.03 ms of arithmetic: it is bound
// by device-memory bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int N>
__device__ __forceinline__ float group_sum(float p) {
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1) p += __shfl_xor_sync(kFull, p, off);
  return p;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ a, const float* __restrict__ bx,
                const float* __restrict__ c, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ hT, int T, int d) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * kThreads + threadIdx.x;   // channel * N + n
  const int ch = idx / N;
  const int n = idx - ch * N;
  const bool active = ch < d;
  const long long dn = static_cast<long long>(d) * N;
  const float* ap = a + static_cast<long long>(b) * T * dn + idx;
  const float* bp = bx + static_cast<long long>(b) * T * dn + idx;
  const float* cp = c + static_cast<long long>(b) * T * N + n;
  float* yp = y + static_cast<long long>(b) * T * d + ch;
  const bool writer = active && n == 0;
  float h = active ? h0[b * dn + idx] : 0.0f;

  int t = 0;
  for (; t + kUnroll <= T; t += kUnroll) {
    float at[kUnroll], bt[kUnroll], ct[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long tj = t + j;
      at[j] = active ? ap[tj * dn] : 0.0f;
      bt[j] = active ? bp[tj * dn] : 0.0f;
      ct[j] = cp[tj * N];
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      h = at[j] * h + bt[j];
      const float p = group_sum<N>(ct[j] * h);
      if (writer) yp[static_cast<long long>(t + j) * d] = p;
    }
  }
  for (; t < T; ++t) {
    const long long tt = t;
    const float at = active ? ap[tt * dn] : 0.0f;
    const float bt = active ? bp[tt * dn] : 0.0f;
    h = at * h + bt;
    const float p = group_sum<N>(cp[tt * N] * h);
    if (writer) yp[tt * d] = p;
  }
  if (active) hT[b * dn + idx] = h;
}

template <int N>
int launch(const float* a, const float* bx, const float* c, const float* h0,
           float* y, float* hT, int B, int T, int d, cudaStream_t st) {
  const long long threads = static_cast<long long>(d) * N;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  ssm_scan_kernel<N><<<grid, kThreads, 0, st>>>(a, bx, c, h0, y, hT, T, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a, bx: (B, T, d, N); c: (B, T, N); h0, hT: (B, d, N); y: (B, T, d); fp32
// contiguous.  N must divide 32 (the wrapper checks); returns the first CUDA
// error (0 on success), or cudaErrorInvalidValue for another N.
int ssm_scan_launch(const float* a, const float* bx, const float* c,
                    const float* h0, float* y, float* hT, int B, int T, int d,
                    int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || d <= 0) return 0;
  switch (N) {
    case 1: return launch<1>(a, bx, c, h0, y, hT, B, T, d, st);
    case 2: return launch<2>(a, bx, c, h0, y, hT, B, T, d, st);
    case 4: return launch<4>(a, bx, c, h0, y, hT, B, T, d, st);
    case 8: return launch<8>(a, bx, c, h0, y, hT, B, T, d, st);
    case 16: return launch<16>(a, bx, c, h0, y, hT, B, T, d, st);
    case 32: return launch<32>(a, bx, c, h0, y, hT, B, T, d, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
