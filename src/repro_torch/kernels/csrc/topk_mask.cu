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
//   * all three read x as float4 loads from any 4-byte offset (one ahead,
//     four in flight, or one a thread; their sections below); the
//     histogram and the count on about eight 256-thread blocks per SM at
//     the most, apply (which writes float4s too) on a grid of one float4 a
//     thread;
//   * the histogram counts into a 128-bin shared histogram with one shared
//     atomic an element, the count sums in registers and shared memory;
//   * both total their blocks on the device: each block adds to a scratch
//     that the library owns, and the last block to finish writes `out` and
//     leaves the scratch zeroed.  So each is one device operation a call,
//     with no memset before it.
// Integer sums are exact, so results are identical whatever order blocks
// run in.
//
// Bins.  The reference bins by floor(log2|x|) in fp32, which XLA computes
// inexactly just below (and at some) powers of two.  Here the bin is the
// exponent field itself, clamped: bin = clamp(e + 96, 0, 127) with
// e = field - 127, which is the bin definition of src/repro/kernels/ref.py
// exactly.  A zero exponent field (subnormals) lands in bin 0, inf in bin
// 127; zeros and NaN count nowhere.
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

constexpr unsigned kInfBits = 0x7f800000u;

// The bin of v from the bits b of |v|: -1 for zeros and NaN (b = 0 or b
// above inf's bits; one unsigned range test), else e - EXPO_MIN with e the
// exponent field less 127, clamped to [0, 127], so subnormals land in bin 0
// and inf in bin 127.
__device__ __forceinline__ int octave_bin(float v) {
  const unsigned b = __float_as_uint(v) & 0x7fffffffu;
  const int e = static_cast<int>(b >> 23) - 127;
  const int j = min(kBins - 1, max(0, e - kExpoMin));
  return b - 1u < kInfBits ? j : -1;
}

__device__ __forceinline__ long long grid_stride() {
  return static_cast<long long>(gridDim.x) * kThreads;
}

// The histogram and the count: one device operation a call, the kernel
// itself.
//   * Loads.  x may start at any 4-byte offset (a view of a larger
//     tensor), so block 0 takes the head before the first 16-byte boundary
//     and the tail after the last whole float4 (under 4 elements each); the
//     body goes as float4 loads.  The count issues kVecsInFlight of them a
//     thread before its first compare, on a grid of one 16-element group a
//     thread; the histogram loads one float4 ahead of the one it bins, on a
//     grid of one float4 a thread.  Both grids stop at kMaxBlocks blocks
//     (about one wave) and then stride.  On the H100 the histogram's one
//     ahead took 0.1188 ms at 2^26 elements against 0.1229 for four in
//     flight, and its finer grid 4.1 us at a 147,456-element leaf against
//     5.7 (PERF.md).
//   * Bins.  Each element adds one to its bin of a 128-bin shared histogram
//     with a shared atomic.  A warp's equal bins are not gathered first:
//     with __match_any_sync the histogram took 0.1186 ms at 2^26 against
//     0.0893 without, and without it a warp whose 32 lanes all hit one bin
//     still kept pace with the bytes (0.0891; PERF.md).
//   * Total.  The count writes each block's count to its own slot of a
//     scratch array, the histogram adds each block's nonzero bins to a
//     scratch histogram with global atomics; then __threadfence() and an
//     atomic ticket.  The block that draws the last ticket reads the
//     scratch (__ldcg: from L2, where the atomics and the other blocks'
//     stores are), writes `out`, zeroes what it must and sets the ticket
//     back to 0.  So nothing zeroes `out` first, and for n = 0 the one
//     block writes the zero result.
//   * Scratch.  The slots, the histogram and their tickets belong to the
//     library, one set per (device, stream), made and zeroed at the first
//     call on that pair.  Calls on one stream run in order, and each leaves
//     its scratch zeroed for the next; calls on two streams use two sets.
//     The port launches on PyTorch's current stream.
// NaN never counts (|NaN| >= tau is false); with tau <= 0 every other one
// of the n entries does, and nothing beyond them.
constexpr int kVecsInFlight = 4;

__device__ __forceinline__ void bin_add(float v, int* hist) {
  const int j = octave_bin(v);
  if (j >= 0) atomicAdd(&hist[j], 1);
}

__global__ void __launch_bounds__(kThreads)
exponent_hist_kernel(const float* __restrict__ x, long long n, int head,
                     int* __restrict__ scratch, unsigned* __restrict__ ticket,
                     int* __restrict__ out) {
  __shared__ int hist[kBins];
  __shared__ bool is_last;
  const int tid = threadIdx.x;
  if (tid < kBins) hist[tid] = 0;
  __syncthreads();
  const long long vecs = (n - head) / 4;
  if (blockIdx.x == 0) {
    const int tail = static_cast<int>(n - head - 4 * vecs);
    if (tid < head) bin_add(x[tid], hist);
    if (tid >= 4 && tid < 4 + tail) {
      bin_add(x[head + 4 * vecs + tid - 4], hist);
    }
  }
  const float4* body = reinterpret_cast<const float4*>(x + head);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);   // no bin
  long long i = static_cast<long long>(blockIdx.x) * kThreads + tid;
  float4 next = i < vecs ? body[i] : zero;
  for (; i < vecs; i += grid_stride()) {
    const float4 e = next;
    const long long ahead = i + grid_stride();
    next = ahead < vecs ? body[ahead] : zero;
    bin_add(e.x, hist);
    bin_add(e.y, hist);
    bin_add(e.z, hist);
    bin_add(e.w, hist);
  }
  __syncthreads();
  if (tid < kBins && hist[tid] != 0) atomicAdd(&scratch[tid], hist[tid]);
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (tid < kBins) {
    out[tid] = __ldcg(&scratch[tid]);
    scratch[tid] = 0;
  }
  if (tid == 0) *ticket = 0;
}

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

// Apply: out[i] = |x[i]| >= tau ? x[i] : +0.0f, one device operation a
// call (no scratch; nothing launched for n = 0).
//   * Loads and stores.  One float4 a thread, as PyTorch's own elementwise
//     loop, on a grid that covers x's body (after block 0's head and tail,
//     as in the count) in one pass; each thread issues its head or tail
//     load beside its float4 load, before any compare or store.  On the
//     H100 at 2^26 elements this took 0.1777 ms against 0.188-0.189 for a
//     grid capped at kMaxBlocks with 2 or 4 float4s in flight a thread,
//     and a 4-byte grid-stride loop 0.197-0.200; at the 147,456-element
//     leaf 1 element in, 1.86 us against 1.99 with block 0's head and tail
//     done first.  Blocks of 512 were 0.3% faster than 256 at 2^26 and
//     equal at the leaf; evict-first stores (__stcs) no faster.  The loop
//     stays rolled: unrolled by nvcc it took 1.97 us at the leaf against
//     1.87 (PERF.md).
//   * Output alignment.  The float4 stores need `out` congruent to x mod
//     16 bytes: the port's wrapper allocates n + 3 elements for a view of
//     x that starts off the 16-byte boundary and returns the view at x's
//     offset, and the launcher refuses any other pair.  One element in at
//     the leaf this took 1.86 us against 1.90 for 4-byte stores into an
//     output on the boundary (PERF.md).
constexpr int kApplyThreads = 512;

__global__ void __launch_bounds__(kApplyThreads)
apply_threshold_kernel(const float* __restrict__ x, long long n, int head,
                       const float* __restrict__ tau,
                       float* __restrict__ out) {
  const float t = *tau;
  const int tid = threadIdx.x;
  const long long vecs = (n - head) / 4;
  // Block 0's threads 0..head-1 take the head, 4..4+tail-1 the tail.
  long long edge = -1;
  if (blockIdx.x == 0) {
    const int tail = static_cast<int>(n - head - 4 * vecs);
    if (tid < head) edge = tid;
    if (tid >= 4 && tid < 4 + tail) edge = head + 4 * vecs + tid - 4;
  }
  const float edge_v = edge >= 0 ? x[edge] : 0.0f;
  const float4* body = reinterpret_cast<const float4*>(x + head);
  float* out_body = out + head;
#pragma unroll 1
  for (long long i = static_cast<long long>(blockIdx.x) * kApplyThreads + tid;
       i < vecs; i += static_cast<long long>(gridDim.x) * kApplyThreads) {
    const float4 e = body[i];
    const float4 r = make_float4(fabsf(e.x) >= t ? e.x : 0.0f,
                                 fabsf(e.y) >= t ? e.y : 0.0f,
                                 fabsf(e.z) >= t ? e.z : 0.0f,
                                 fabsf(e.w) >= t ? e.w : 0.0f);
    reinterpret_cast<float4*>(out_body)[i] = r;
  }
  if (edge >= 0) out[edge] = fabsf(edge_v) >= t ? edge_v : 0.0f;
}

// ceil(items / per_block) blocks, at least one and at most kMaxBlocks.
int blocks_for(long long items, long long per_block) {
  const long long blocks = (items + per_block - 1) / per_block;
  return static_cast<int>(blocks < 1 ? 1
                          : blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

// The scratch of the count (kMaxBlocks slots and a ticket) and of the
// histogram (kBins bins and a ticket) for the current device and `stream`,
// made and zeroed at the first call on that pair.
struct Scratch {
  int* partials;
  unsigned* count_ticket;
  int* hist;
  unsigned* hist_ticket;
};

cudaError_t scratch_for(cudaStream_t stream, Scratch* out) {
  static std::mutex mutex;
  static std::map<std::pair<int, cudaStream_t>, Scratch> sets;
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
  const size_t bytes = (kMaxBlocks + 1 + kBins + 1) * sizeof(int);
  void* mem = nullptr;
  err = cudaMalloc(&mem, bytes);
  if (err == cudaSuccess) err = cudaMemset(mem, 0, bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return err;
  int* words = static_cast<int*>(mem);
  Scratch set{words, reinterpret_cast<unsigned*>(words + kMaxBlocks),
              words + kMaxBlocks + 1,
              reinterpret_cast<unsigned*>(words + kMaxBlocks + 1 + kBins)};
  sets.emplace(key, set);
  *out = set;
  return cudaSuccess;
}

// Elements before x's first 16-byte boundary (at most n).
int head_of(const float* x, long long n) {
  const long long misalign = reinterpret_cast<uintptr_t>(x) & 15;
  const long long head = misalign == 0 ? 0 : (16 - misalign) / 4;
  return static_cast<int>(head < n ? head : n);
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns the first CUDA
// error (0 on success).  The histogram and count kernels always run (they
// write `out`: zeros for n = 0), apply only for n > 0, and only into an
// `out` that lies as far past a 16-byte boundary as x (else
// cudaErrorInvalidValue, and nothing runs).
int topk_histogram_launch(const float* x, long long n, int* out,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Scratch scratch;
  const cudaError_t err = scratch_for(st, &scratch);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int head = head_of(x, n);
  const int grid = blocks_for((n - head) / 4, kThreads);
  exponent_hist_kernel<<<grid, kThreads, 0, st>>>(
      x, n, head, scratch.hist, scratch.hist_ticket, out);
  return static_cast<int>(cudaGetLastError());
}

int topk_count_launch(const float* x, long long n, const float* tau,
                      int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Scratch scratch;
  const cudaError_t err = scratch_for(st, &scratch);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int head = head_of(x, n);
  const int grid = blocks_for((n - head) / 4, kThreads * kVecsInFlight);
  count_ge_kernel<<<grid, kThreads, 0, st>>>(
      x, n, head, tau, scratch.partials, scratch.count_ticket, out);
  return static_cast<int>(cudaGetLastError());
}

int topk_apply_launch(const float* x, long long n, const float* tau,
                      float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(out)) &
       15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int head = head_of(x, n);
  const long long vecs = (n - head) / 4;
  const long long blocks = (vecs + kApplyThreads - 1) / kApplyThreads;
  const int grid = static_cast<int>(blocks < 1            ? 1
                                    : blocks > 0x7fffffff ? 0x7fffffff
                                                          : blocks);
  apply_threshold_kernel<<<grid, kApplyThreads, 0, st>>>(x, n, head, tau,
                                                         out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
