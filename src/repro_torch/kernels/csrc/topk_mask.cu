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
//     coalesced 4-byte loads (the count: 16-byte loads, its section below);
//     a warp's trip count is warp-uniform, so the warp intrinsics always see
//     all 32 lanes;
//   * the histogram aggregates a warp's equal bins with __match_any_sync
//     into a 128-bin shared histogram and flushes it with one global
//     atomicAdd per nonzero bin per block; its launcher zeroes the output on
//     the stream first;
//   * the count sums each block in registers and shared memory, and the
//     last block to finish sums the blocks (its section below).
// Integer sums are exact, so results are identical whatever order blocks
// run in.
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

#include <map>
#include <mutex>
#include <utility>

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

// Count (count_ge): one device operation a call, the kernel itself.
//   * Loads.  x may start at any 4-byte offset (a view of a larger
//     tensor), so block 0 counts the head before the first 16-byte boundary
//     and the tail after the last whole float4 (under 4 elements each); the
//     body goes as float4 loads, kVecsInFlight of them a thread issued
//     before the first compare.  The grid is one 16-element group a thread
//     up to kMaxBlocks blocks (about one wave), then strides.
//   * Total.  Each block writes its count to its own slot of a scratch
//     array, then __threadfence() and an atomic ticket; the block that draws
//     the last ticket sums the slots, writes `out` and sets the ticket back
//     to 0.  So nothing zeroes `out` first and there is no memset node.
//   * Scratch.  The slots and the ticket belong to the library, one set per
//     (device, stream), made at the first call on that pair.  Calls on one
//     stream run in order, and each leaves the ticket at 0 for the next;
//     calls on two streams use two sets.  The port launches on PyTorch's
//     current stream.
// NaN never counts (|NaN| >= tau is false); with tau <= 0 every other one
// of the n entries does, and nothing beyond them.
constexpr int kVecsInFlight = 4;

__global__ void __launch_bounds__(kThreads)
count_ge_kernel(const float* __restrict__ x, long long n, int head,
                const float* __restrict__ tau, int* __restrict__ partials,
                unsigned* __restrict__ ticket, int* __restrict__ out) {
  __shared__ int warp_counts[kThreads / 32];
  __shared__ bool is_last;
  const float t = *tau;
  const int tid = threadIdx.x;
  const long long vecs = (n - head) / 4;
  int acc = 0;
  if (blockIdx.x == 0) {
    const int tail = static_cast<int>(n - head - 4 * vecs);
    if (tid < head) acc += fabsf(x[tid]) >= t ? 1 : 0;
    if (tid >= 4 && tid < 4 + tail) {
      acc += fabsf(x[head + 4 * vecs + tid - 4]) >= t ? 1 : 0;
    }
  }
  const float4* body = reinterpret_cast<const float4*>(x + head);
  const long long stride =
      static_cast<long long>(gridDim.x) * kThreads * kVecsInFlight;
  for (long long base =
           static_cast<long long>(blockIdx.x) * kThreads * kVecsInFlight + tid;
       base < vecs; base += stride) {
    float4 v[kVecsInFlight];
#pragma unroll
    for (int k = 0; k < kVecsInFlight; ++k) {
      const long long i = base + k * kThreads;
      const float nan = __int_as_float(0x7fc00000);
      v[k] = i < vecs ? body[i] : make_float4(nan, nan, nan, nan);
    }
#pragma unroll
    for (int k = 0; k < kVecsInFlight; ++k) {
      acc += (fabsf(v[k].x) >= t ? 1 : 0) + (fabsf(v[k].y) >= t ? 1 : 0) +
             (fabsf(v[k].z) >= t ? 1 : 0) + (fabsf(v[k].w) >= t ? 1 : 0);
    }
  }
  acc = __reduce_add_sync(kFull, acc);
  if ((tid & 31) == 0) warp_counts[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_counts[w];
    partials[blockIdx.x] = total;
    __threadfence();
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  int sum = 0;
  for (int b = tid; b < gridDim.x; b += kThreads) sum += __ldcg(&partials[b]);
  sum = __reduce_add_sync(kFull, sum);
  if ((tid & 31) == 0) warp_counts[tid >> 5] = sum;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_counts[w];
    *out = total;
    *ticket = 0;
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

// The count's scratch (kMaxBlocks slots, then the ticket) for the current
// device and `stream`, made and zeroed at the first call on that pair.
struct CountScratch {
  int* partials;
  unsigned* ticket;
};

cudaError_t count_scratch(cudaStream_t stream, CountScratch* out) {
  static std::mutex mutex;
  static std::map<std::pair<int, cudaStream_t>, CountScratch> sets;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mutex);
  const auto key = std::make_pair(device, stream);
  const auto found = sets.find(key);
  if (found != sets.end()) {
    *out = found->second;
    return cudaSuccess;
  }
  const size_t bytes = (kMaxBlocks + 1) * sizeof(int);
  void* mem = nullptr;
  err = cudaMalloc(&mem, bytes);
  if (err == cudaSuccess) err = cudaMemset(mem, 0, bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return err;
  CountScratch set{static_cast<int*>(mem),
                   reinterpret_cast<unsigned*>(static_cast<int*>(mem) +
                                               kMaxBlocks)};
  sets.emplace(key, set);
  *out = set;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Each launcher enqueues its work on `stream` and returns the first CUDA
// error (0 on success).  The histogram launcher zeroes its output first;
// the histogram and apply kernels run only for n > 0, the count always
// (it writes `out`, 0 for n = 0).
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
  CountScratch scratch;
  const cudaError_t err = count_scratch(st, &scratch);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long misalign = reinterpret_cast<uintptr_t>(x) & 15;
  const int head = static_cast<int>(
      misalign == 0 ? 0 : (16 - misalign) / 4 < n ? (16 - misalign) / 4 : n);
  const long long groups = ((n - head) / 4 + kThreads * kVecsInFlight - 1) /
                           (kThreads * kVecsInFlight);
  const int grid = static_cast<int>(
      groups < 1 ? 1 : groups > kMaxBlocks ? kMaxBlocks : groups);
  count_ge_kernel<<<grid, kThreads, 0, st>>>(x, n, head, tau,
                                             scratch.partials,
                                             scratch.ticket, out);
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
