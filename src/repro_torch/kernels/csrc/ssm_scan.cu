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
//
// Checkpoints.  Under autograd the forward also writes h at the start of
// every chunk of kChunk = 16 steps, h_{16 k}, into a buffer (B, ceil(T /
// 16), d, N) that SsmScanFunction saves for the backward (ssm_scan_kernel's
// kSave; 26.2 MB a layer at Hymba's training shape (1, 4096, 1600, 16),
// 1/32 of the bytes the scan moves).  That variant walks sixteen steps a
// pass (see the kernel).  Without grad (the serving path) the kernel writes
// none.
//
// The backward (ssm_scan_bwd_kernel, behind ssm_scan_backward_launch)
// replaces no TPU kernel: the reference gets this gradient from XLA autodiff
// of src/repro/models/ssm.py:58 (ssm_forward's scan).  It is here because
// the port's model runs the forward above, which autograd cannot see into.
// With g the running adjoint of h, per (b, c, n):
//
//   g <- dhT;  for t = T-1 .. 0:  g += dy_t[c] C_t[n];  dbx_t = g;
//   da_t = g h_{t-1};  dC_t[n] += dy_t[c] h_t[c, n];  g <- a_t g;   dh0 = g
//
// Same thread map as the forward: one thread per (b, c, n), the N lanes of
// a channel in one warp.  h_{t-1} is recomputed, never obtained by dividing
// by a_t (which can underflow to 0): one sweep, chunk by chunk from the
// last, recomputes each chunk's 16 states into registers from the
// forward's checkpoint and walks the chunk backwards, so a and bx are read
// once.  a and bx load into registers two chunks ahead, dy, C and the
// checkpoint one chunk ahead, while the current chunk computes (one chunk
// ahead: 0.765-0.771 ms at Hymba's training shape on the H100, two: 0.750-
// 0.754).  Blocks of 128 threads: 200 at that shape, so every SM has a block
// (256 threads a block left 32 SMs idle at B = 1; 64 threads, 400 blocks,
// took 0.790 ms).  dC_t[n] is a sum over the d channels, which span blocks:
// each warp sums its channels with a shuffle butterfly, each block its warps
// in a fixed order into a partial (B, blocks, T, N), one barrier a chunk,
// and a second kernel adds the partials in block order.  No float atomics,
// so two runs give the same bits.
//
// What bounds the backward: the function reads a, bx (and c, dy, h0, dhT)
// once and writes da, dbx (and dC, dh0) once.  At Hymba's training shape a,
// bx, da and dbx are 419.4 MB each, about 1.68 GB, 0.50 ms at 3.35 TB/s;
// its 8 flops per (t, c, n) take 0.01 ms.  This kernel moves those bytes,
// the checkpoints (26.2 MB) and the partials of dC (52.4 MB, written and
// read): about 1.81 GB, 0.54 ms at 3.35 TB/s.

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

constexpr int kChunk = 16;          // steps between checkpoints

// kSave: also h_{16 k} into hk (B, ceil(T / 16), d, N), the backward's
// checkpoints.
template <int N, bool kSave>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ a, const float* __restrict__ bx,
                const float* __restrict__ c, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ hT,
                float* __restrict__ hk, int T, int d) {
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
  const long long hk0 = static_cast<long long>(b) *
                        ((T + kChunk - 1) / kChunk) * dn + idx;

  int t = 0;
  if constexpr (kSave) {
    // Sixteen steps a pass, their loads issued before the checkpoint is
    // stored.  A conditional store inside the eight-step loop below made
    // the forward 2.3x as slow on the H100 (2.00 against 0.86 ms at (1,
    // 4096, 1600, 16)); sixteen steps' loads in flight make it faster than
    // the loop without checkpoints (0.65 ms).
    for (; t + kChunk <= T; t += kChunk) {
      float at[kChunk], bt[kChunk], ct[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const long long tj = t + j;
        at[j] = active ? ap[tj * dn] : 0.0f;
        bt[j] = active ? bp[tj * dn] : 0.0f;
        ct[j] = cp[tj * N];
      }
      if (active) hk[hk0 + (t / kChunk) * dn] = h;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        h = at[j] * h + bt[j];
        const float p = group_sum<N>(ct[j] * h);
        if (writer) yp[static_cast<long long>(t + j) * d] = p;
      }
    }
  }
  for (; t + kUnroll <= T; t += kUnroll) {
    float at[kUnroll], bt[kUnroll], ct[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long tj = t + j;
      at[j] = active ? ap[tj * dn] : 0.0f;
      bt[j] = active ? bp[tj * dn] : 0.0f;
      ct[j] = cp[tj * N];
    }
    if (kSave && active && t % kChunk == 0) hk[hk0 + (t / kChunk) * dn] = h;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      h = at[j] * h + bt[j];
      const float p = group_sum<N>(ct[j] * h);
      if (writer) yp[static_cast<long long>(t + j) * d] = p;
    }
  }
  for (; t < T; ++t) {
    if (kSave && active && t % kChunk == 0) hk[hk0 + (t / kChunk) * dn] = h;
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
           float* y, float* hT, float* hk, int B, int T, int d,
           cudaStream_t st) {
  const long long threads = static_cast<long long>(d) * N;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                  static_cast<unsigned>(B));
  if (hk == nullptr) {
    ssm_scan_kernel<N, false><<<grid, kThreads, 0, st>>>(a, bx, c, h0, y, hT,
                                                         nullptr, T, d);
  } else {
    ssm_scan_kernel<N, true><<<grid, kThreads, 0, st>>>(a, bx, c, h0, y, hT,
                                                        hk, T, d);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBwdThreads = 128;
constexpr int kWarps = kBwdThreads / 32;

// One chunk's a and bx of a thread, steps t0 .. t0 + 15: a = 1 and bx = 0
// outside [0, T) (h unchanged).  Loads only: the caller uses them a chunk
// later, so they are in flight while the current chunk computes.
__device__ __forceinline__ void fetch_ab(float (&at)[kChunk],
                                         float (&bt)[kChunk],
                                         const float* __restrict__ ap,
                                         const float* __restrict__ bp,
                                         long long dn, int t0, int T,
                                         bool active) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const long long t = t0 + j;
    const bool ok = active && t >= 0 && t < T;
    at[j] = ok ? ap[t * dn] : 1.0f;
    bt[j] = ok ? bp[t * dn] : 0.0f;
  }
}

// The same chunk's dy[t, c] and C[t, n] (zeros outside [0, T)).
__device__ __forceinline__ void fetch_yc(float (&yt)[kChunk],
                                         float (&ct)[kChunk],
                                         const float* __restrict__ dyp,
                                         const float* __restrict__ cp, int d,
                                         int N, int t0, int T, bool active) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const long long t = t0 + j;
    const bool ok = t >= 0 && t < T;
    yt[j] = ok && active ? dyp[t * d] : 0.0f;
    ct[j] = ok ? cp[t * N] : 0.0f;
  }
}

template <int N>
__global__ void __launch_bounds__(kBwdThreads)
ssm_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ bx,
                    const float* __restrict__ c, const float* __restrict__ hk,
                    const float* __restrict__ dy,
                    const float* __restrict__ dhT, float* __restrict__ da,
                    float* __restrict__ dbx, float* __restrict__ dh0,
                    float* __restrict__ dcp, int T, int d) {
  // dC: one partial a warp, in two buffers, so that one barrier a chunk
  // separates a buffer's writes from the last reads of it.
  __shared__ float part[2][kWarps][kChunk][N];
  const int b = blockIdx.y;
  const int idx = blockIdx.x * kBwdThreads + threadIdx.x;  // channel * N + n
  const int ch = idx / N;
  const int n = idx - ch * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool active = ch < d;
  const long long dn = static_cast<long long>(d) * N;
  const int nchunks = (T + kChunk - 1) / kChunk;
  const float* ap = a + static_cast<long long>(b) * T * dn + idx;
  const float* bp = bx + static_cast<long long>(b) * T * dn + idx;
  const float* cp = c + static_cast<long long>(b) * T * N + n;
  const float* dyp = dy + static_cast<long long>(b) * T * d + ch;
  float* dap = da + static_cast<long long>(b) * T * dn + idx;
  float* dbp = dbx + static_cast<long long>(b) * T * dn + idx;
  const float* hkp = hk + static_cast<long long>(b) * nchunks * dn + idx;
  float at[kChunk], bt[kChunk], an[kChunk], bn[kChunk], a2[kChunk], b2[kChunk];

  // The adjoint, chunk by chunk from the last, each chunk's states
  // recomputed from its checkpoint: hs[j] = h_{t0 + j - 1}.  a and bx load
  // two chunks ahead, dy, C and the checkpoint one chunk ahead.
  float g = active ? dhT[b * dn + idx] : 0.0f;
  float* dcb = dcp + (static_cast<long long>(b) * gridDim.x + blockIdx.x) *
                         T * N;
  float yt[kChunk], ct[kChunk], yn[kChunk], cn[kChunk];
  const int tl = (nchunks - 1) * kChunk;
  fetch_ab(at, bt, ap, bp, dn, tl, T, active);
  fetch_ab(an, bn, ap, bp, dn, tl - kChunk, T, active);
  fetch_yc(yt, ct, dyp, cp, d, N, tl, T, active);
  float hk0 = active && nchunks > 0 ? hkp[(nchunks - 1) * dn] : 0.0f;
  for (int k = nchunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    fetch_ab(a2, b2, ap, bp, dn, t0 - 2 * kChunk, T, active);
    fetch_yc(yn, cn, dyp, cp, d, N, t0 - kChunk, T, active);
    const float hkn = active && k > 0 ? hkp[(k - 1) * dn] : 0.0f;
    float hs[kChunk + 1];
    hs[0] = hk0;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) hs[j + 1] = at[j] * hs[j] + bt[j];
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      const long long t = t0 + j;
      if (t < T) {                        // the same t in every thread
        g += yt[j] * ct[j];
        if (active) {
          dbp[t * dn] = g;
          dap[t * dn] = g * hs[j];
        }
        float p = yt[j] * hs[j + 1];
#pragma unroll
        for (int off = N; off < 32; off <<= 1) {
          p += __shfl_xor_sync(kFull, p, off);
        }
        if (lane < N) part[k & 1][warp][j][lane] = p;
        g *= at[j];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * N; i += kBwdThreads) {
      const int j = i / N, m = i - (i / N) * N;
      if (t0 + j < T) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += part[k & 1][w][j][m];
        dcb[static_cast<long long>(t0 + j) * N + m] = sum;
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      at[j] = an[j];
      bt[j] = bn[j];
      an[j] = a2[j];
      bn[j] = b2[j];
      yt[j] = yn[j];
      ct[j] = cn[j];
    }
    hk0 = hkn;
  }
  if (active) dh0[b * dn + idx] = g;
}

// dC[b, t, n] = the blocks' partials in block order.
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_dc_kernel(const float* __restrict__ dcp, float* __restrict__ dc,
                       int blocks, long long tn) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= tn) return;
  const float* p = dcp + static_cast<long long>(blockIdx.y) * blocks * tn + i;
  float sum = 0.0f;
  for (int k = 0; k < blocks; ++k) sum += p[k * tn];
  dc[static_cast<long long>(blockIdx.y) * tn + i] = sum;
}

int bwd_blocks(int d, int N) {
  return static_cast<int>((static_cast<long long>(d) * N + kBwdThreads - 1) /
                          kBwdThreads);
}

template <int N>
int launch_bwd(const float* a, const float* bx, const float* c,
               const float* hk, const float* dy, const float* dhT, float* da,
               float* dbx, float* dc, float* dh0, float* dcp, int B, int T,
               int d, cudaStream_t st) {
  const int blocks = bwd_blocks(d, N);
  ssm_scan_bwd_kernel<N><<<dim3(blocks, B), kBwdThreads, 0, st>>>(
      a, bx, c, hk, dy, dhT, da, dbx, dh0, dcp, T, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tn = static_cast<long long>(T) * N;
  if (tn > 0) {
    const dim3 grid(static_cast<unsigned>((tn + kThreads - 1) / kThreads), B);
    ssm_scan_bwd_dc_kernel<<<grid, kThreads, 0, st>>>(dcp, dc, blocks, tn);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// As ssm_scan_launch, and h_{16 k} into hk (B, ceil(T / 16), d, N) unless
// hk is null.
int ssm_scan_checkpoint_launch(const float* a, const float* bx,
                               const float* c, const float* h0, float* y,
                               float* hT, float* hk, int B, int T, int d,
                               int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || d <= 0) return 0;
  switch (N) {
    case 1: return launch<1>(a, bx, c, h0, y, hT, hk, B, T, d, st);
    case 2: return launch<2>(a, bx, c, h0, y, hT, hk, B, T, d, st);
    case 4: return launch<4>(a, bx, c, h0, y, hT, hk, B, T, d, st);
    case 8: return launch<8>(a, bx, c, h0, y, hT, hk, B, T, d, st);
    case 16: return launch<16>(a, bx, c, h0, y, hT, hk, B, T, d, st);
    case 32: return launch<32>(a, bx, c, h0, y, hT, hk, B, T, d, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a, bx: (B, T, d, N); c: (B, T, N); h0, hT: (B, d, N); y: (B, T, d); fp32
// contiguous.  N must divide 32 (the wrapper checks); returns the first CUDA
// error (0 on success), or cudaErrorInvalidValue for another N.
int ssm_scan_launch(const float* a, const float* bx, const float* c,
                    const float* h0, float* y, float* hT, int B, int T, int d,
                    int N, void* stream) {
  return ssm_scan_checkpoint_launch(a, bx, c, h0, y, hT, nullptr, B, T, d, N,
                                    stream);
}

// The backward: a, bx, c as for ssm_scan_launch; hk (B, chunks, d, N) the
// checkpoints ssm_scan_checkpoint_launch wrote; dy (B, T, d) and dhT (B, d,
// N) the adjoints of y and hT; da, dbx (B, T, d, N), dc (B, T, N) and dh0
// (B, d, N) out.  Scratch: dcp (B, blocks, T, N), with blocks from
// ssm_scan_backward_config.  Returns the first CUDA error (0 on
// success), or cudaErrorInvalidValue for an N that does not divide 32.
int ssm_scan_backward_launch(const float* a, const float* bx, const float* c,
                             const float* hk, const float* dy,
                             const float* dhT, float* da, float* dbx,
                             float* dc, float* dh0, float* dcp, int B, int T,
                             int d, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || d <= 0) return 0;
  switch (N) {
#define SSM_BWD_CASE(n)                                                     \
  case n:                                                                   \
    return launch_bwd<n>(a, bx, c, hk, dy, dhT, da, dbx, dc, dh0, dcp, B, T, \
                         d, st);
    SSM_BWD_CASE(1)
    SSM_BWD_CASE(2)
    SSM_BWD_CASE(4)
    SSM_BWD_CASE(8)
    SSM_BWD_CASE(16)
    SSM_BWD_CASE(32)
#undef SSM_BWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward's scratch shape: blocks per batch row, for its partials of
// dC.
int ssm_scan_backward_config(int d, int N, int* blocks) {
  if (d < 0 || N <= 0 || 32 % N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *blocks = bwd_blocks(d, N);
  return 0;
}

}  // extern "C"
