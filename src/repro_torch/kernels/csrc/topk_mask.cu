// Per-array magnitude-masking kernels for Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes).
//
// Replaces the three TPU kernels of src/repro/kernels/topk_mask.py, which
// ops.topk_mask runs as 1 histogram + `iters` counts + 1 apply per array and
// ops.masked_count as one count:
//   exponent_hist_kernel  <- _hist_kernel  / exponent_histogram
//   count_ge_kernel       <- _count_kernel / count_ge
//   apply_threshold_kernel<- _apply_kernel / apply_threshold
//
// Layout.  x is the flat fp32 vector of n elements; there is no padding to
// the TPU's 256 x 1024 blocks, so every kernel masks its own tail (threads
// past n see no element).  tau is read from device memory, so the
// threshold refinement never leaves the device.
//
// What bounds them.  Each kernel reads every element once (4 bytes); apply
// also writes it once (4 bytes).  The per-element work is an exponent
// extraction or a compare, far below the card's 67 TFLOP/s fp32 rate, so all
// three are bound by device-memory bytes (3.35 TB/s on an H100 SXM).  The
// design keeps everything but the streaming pass on chip:
//   * a grid of about eight 256-thread blocks per SM strides over x with
//     coalesced 4-byte loads; a warp's trip count is warp-uniform, so the
//     warp intrinsics always see all 32 lanes;
//   * the histogram aggregates a warp's equal bins with __match_any_sync
//     into a 128-bin shared histogram and flushes it with one global
//     atomicAdd per nonzero bin per block;
//   * the count takes __popc(__ballot_sync(.)) per warp step, sums the warps
//     of a block in shared memory and adds one global atomicAdd per block.
// Integer atomics are exact, so results are identical whatever order blocks
// run in.  The launchers zero the reduction outputs on the stream first.
//
// Bins.  The reference bins by floor(log2|x|) in fp32, which XLA computes
// inexactly just below (and at some) powers of two.  Here the bin is the
// exponent field itself, clamped: bin = clamp(e + 96, 0, 127) with
// e = field - 127, which is the bin definition of src/repro/kernels/ref.py
// exactly.  A zero exponent field (subnormals) lands in bin 0, inf in bin
// 127; zeros and NaN (|x| > 0 is false) count nowhere.
//
// Apply writes +0.0 for every dropped entry (negatives and NaN included):
// the reference writes x * float(keep), which XLA compiles into that select.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 128;            // NBINS
constexpr int kExpoMin = -96;         // EXPO_MIN
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBlocks = 132 * 8;   // about eight blocks per SM

__device__ __forceinline__ int octave_bin(float v) {
  const float a = fabsf(v);
  if (!(a > 0.0f)) return -1;
  const int e = static_cast<int>((__float_as_uint(a) >> 23) & 0xff) - 127;
  return min(kBins - 1, max(0, e - kExpoMin));
}

// First element of this warp's first step, and the grid's stride.
__device__ __forceinline__ long long warp_base() {
  return static_cast<long long>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
}

__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * kThreads;
}

__global__ void __launch_bounds__(kThreads)
exponent_hist_kernel(const float* __restrict__ x, long long n,
                     int* __restrict__ out) {
  __shared__ int hist[kBins];
  for (int b = threadIdx.x; b < kBins; b += kThreads) hist[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (long long base = warp_base(); base < n; base += grid_stride()) {
    const long long i = base + lane;
    const int j = i < n ? octave_bin(x[i]) : -1;
    const unsigned peers = __match_any_sync(kFull, j);
    if (j >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[j], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += kThreads) {
    const int v = hist[b];
    if (v != 0) atomicAdd(&out[b], v);
  }
}

// NaN never counts (|NaN| >= tau is false); with tau <= 0 every other one
// of the n entries does, and nothing beyond them.
__global__ void __launch_bounds__(kThreads)
count_ge_kernel(const float* __restrict__ x, long long n,
                const float* __restrict__ tau, int* __restrict__ out) {
  __shared__ int warp_counts[kThreads / 32];
  const float t = *tau;
  const int lane = threadIdx.x & 31;
  int acc = 0;                        // the same in every lane of a warp
  for (long long base = warp_base(); base < n; base += grid_stride()) {
    const long long i = base + lane;
    const bool keep = i < n && fabsf(x[i]) >= t;
    acc += __popc(__ballot_sync(kFull, keep));
  }
  if (lane == 0) warp_counts[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_counts[w];
    if (total != 0) atomicAdd(out, total);
  }
}

__global__ void __launch_bounds__(kThreads)
apply_threshold_kernel(const float* __restrict__ x, long long n,
                       const float* __restrict__ tau,
                       float* __restrict__ out) {
  const float t = *tau;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += grid_stride()) {
    const float v = x[i];
    out[i] = fabsf(v) >= t ? v : 0.0f;
  }
}

int blocks_for(long long n) {
  // Four elements per thread at the least, at most kMaxBlocks blocks.
  const long long per_block = 4LL * kThreads;
  const long long blocks = (n + per_block - 1) / per_block;
  return static_cast<int>(blocks < 1 ? 1
                          : blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

extern "C" {

// Each launcher enqueues its work on `stream` and returns the first CUDA
// error (0 on success).  The histogram and count launchers zero their
// output first; the kernels run only for n > 0.
int topk_histogram_launch(const float* x, long long n, int* out,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, kBins * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    exponent_hist_kernel<<<blocks_for(n), kThreads, 0, st>>>(x, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int topk_count_launch(const float* x, long long n, const float* tau,
                      int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    count_ge_kernel<<<blocks_for(n), kThreads, 0, st>>>(x, n, tau, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int topk_apply_launch(const float* x, long long n, const float* tau,
                      float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    apply_threshold_kernel<<<blocks_for(n), kThreads, 0, st>>>(x, n, tau,
                                                               out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
