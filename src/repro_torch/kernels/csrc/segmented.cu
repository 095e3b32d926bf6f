// Segmented magnitude-masking kernels for Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes).
//
// Replaces the three TPU kernels of src/repro/kernels/segmented.py that the
// selective top-k masking path runs once per round:
//   seg_hist_kernel  <- _seg_hist_kernel  / segmented_histogram
//   seg_count_kernel <- _seg_count_kernel / segmented_count
//   seg_apply_kernel <- _seg_apply_kernel / segmented_apply
//
// Layout.  x is an (R, 1024) fp32 buffer; row r belongs to segment seg[r].
// A row whose id lies outside [0, S) belongs to no segment: it counts
// nowhere and is masked against tau = 0, which is what the TPU kernels'
// one-hot gathers/scatters give such a row.
//
// What bounds them.  Each kernel reads every element once (4 bytes) and the
// apply kernel writes it once more; the per-element work is 1 (apply),
// ~1 (histogram: an exponent extraction) and 16 compares (count), far below
// the card's 67 TFLOP/s fp32 rate.  So all three are bound by device-memory
// bytes (3.35 TB/s on an H100 SXM).  The design therefore keeps everything
// but the single streaming pass on chip:
//   * one block owns a contiguous run of rows (about one wave of blocks in
//     all), reads them with coalesced 4-byte loads and accumulates into
//     shared memory;
//   * warp-aggregated shared atomics (__match_any_sync for the histogram,
//     __ballot_sync per candidate for the counts, __reduce_add_sync for the
//     kept count) keep shared-memory traffic to a few operations per warp;
//   * a block flushes its shared counters to the (S, .) outputs with one
//     global atomicAdd per counter each time its segment changes.  Packed
//     rows are segment-contiguous, so that is a handful of atomics per block.
// Integer atomics are exact and a sum of suffix counts is the suffix count
// of the sum, so the results are bit-identical whatever order blocks run in.
//
// The TPU kernels' one-hot matmul gathers/scatters and VMEM slabs are TPU
// idioms and are not carried over; nothing here needs the rows padded to a
// slab multiple.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 1024;           // SEG_LANE
constexpr int kThreads = 256;
constexpr int kPerThread = kLane / kThreads;
constexpr int kBins = 32;             // SEG_NBINS
constexpr int kExpoMin = -96;         // EXPO_MIN
constexpr int kOctavesPerBin = 4;
constexpr int kCandidates = 16;       // DEFAULT_CANDIDATES
constexpr unsigned kFull = 0xffffffffu;

// Highest suffix bin that |v| reaches: the largest j with
// |v| >= 2^(EXPO_MIN + 4 j), or -1 when there is none.  The compare against
// the lowest edge sends zeros, values below 2^-96 (all subnormals among
// them) and NaN to -1, exactly as the reference's >= compares do; above
// that edge |v| is a normal float (or inf), so its exponent field decides
// every edge exactly.
__device__ __forceinline__ int top_bin(float v) {
  const float a = fabsf(v);
  const float lowest_edge = __int_as_float((kExpoMin + 127) << 23);
  if (!(a >= lowest_edge)) return -1;
  const int e = static_cast<int>((__float_as_uint(a) >> 23) & 0xff) - 127;
  return min(kBins - 1, (e - kExpoMin) / kOctavesPerBin);
}

__device__ __forceinline__ bool in_range(int s, int num_segments) {
  return static_cast<unsigned>(s) < static_cast<unsigned>(num_segments);
}

// Rows [r0, r1) of this block; rows_per_block is chosen so the grid is
// about one wave of 256-thread blocks.
__device__ __forceinline__ void block_rows(int rows, int rows_per_block,
                                           int* r0, int* r1) {
  *r0 = blockIdx.x * rows_per_block;
  *r1 = min(rows, *r0 + rows_per_block);
}

// ---------------------------------------------------------------------------
// Histogram: out[s, j] += #{|x| >= 2^(EXPO_MIN + 4 j)} over segment s's rows.
// ---------------------------------------------------------------------------
__device__ void flush_hist(int* hist, int* out, int s, int num_segments) {
  __syncthreads();
  const int tid = threadIdx.x;
  int suffix = 0;
  if (tid < kBins) {
    for (int i = tid; i < kBins; ++i) suffix += hist[i];
  }
  __syncthreads();
  if (tid < kBins) {
    hist[tid] = 0;
    if (suffix != 0 && in_range(s, num_segments)) {
      atomicAdd(&out[static_cast<size_t>(s) * kBins + tid], suffix);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
seg_hist_kernel(const float* __restrict__ x, const int* __restrict__ seg,
                int rows, int rows_per_block, int num_segments,
                int* __restrict__ out) {
  __shared__ int hist[kBins];
  int r0, r1;
  block_rows(rows, rows_per_block, &r0, &r1);
  if (r0 >= r1) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid < kBins) hist[tid] = 0;
  __syncthreads();
  int cur = seg[r0];
  for (int r = r0; r < r1; ++r) {
    const int s = seg[r];
    if (s != cur) {
      flush_hist(hist, out, cur, num_segments);
      cur = s;
    }
    const float* row = x + static_cast<size_t>(r) * kLane;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int j = top_bin(row[tid + i * kThreads]);
      const unsigned peers = __match_any_sync(kFull, j);
      if (j >= 0 && lane == __ffs(peers) - 1) {
        atomicAdd(&hist[j], __popc(peers));
      }
    }
  }
  flush_hist(hist, out, cur, num_segments);
}

// ---------------------------------------------------------------------------
// Count: out[s, c] += #{|x| >= taus[s, c]} for kCandidates taus per segment.
// Lane c of every warp holds the warp's running count for candidate c.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void load_taus(float* t, const float* taus, int s,
                                          int num_segments) {
  const bool ok = in_range(s, num_segments);
#pragma unroll
  for (int c = 0; c < kCandidates; ++c) {
    t[c] = ok ? taus[static_cast<size_t>(s) * kCandidates + c] : 0.0f;
  }
}

__device__ void flush_count(int* cnt, int* acc, int* out, int s,
                            int num_segments) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (lane < kCandidates && *acc != 0) atomicAdd(&cnt[lane], *acc);
  *acc = 0;
  __syncthreads();
  if (tid < kCandidates) {
    const int v = cnt[tid];
    cnt[tid] = 0;
    if (v != 0 && in_range(s, num_segments)) {
      atomicAdd(&out[static_cast<size_t>(s) * kCandidates + tid], v);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
seg_count_kernel(const float* __restrict__ x, const int* __restrict__ seg,
                 const float* __restrict__ taus, int rows, int rows_per_block,
                 int num_segments, int* __restrict__ out) {
  __shared__ int cnt[kCandidates];
  int r0, r1;
  block_rows(rows, rows_per_block, &r0, &r1);
  if (r0 >= r1) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid < kCandidates) cnt[tid] = 0;
  __syncthreads();
  int cur = seg[r0];
  float t[kCandidates];
  load_taus(t, taus, cur, num_segments);
  int acc = 0;
  for (int r = r0; r < r1; ++r) {
    const int s = seg[r];
    if (s != cur) {
      flush_count(cnt, &acc, out, cur, num_segments);
      cur = s;
      load_taus(t, taus, cur, num_segments);
    }
    const float* row = x + static_cast<size_t>(r) * kLane;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const float a = fabsf(row[tid + i * kThreads]);
#pragma unroll
      for (int c = 0; c < kCandidates; ++c) {
        const int n = __popc(__ballot_sync(kFull, a >= t[c]));
        acc += (lane == c) ? n : 0;
      }
    }
  }
  flush_count(cnt, &acc, out, cur, num_segments);
}

// ---------------------------------------------------------------------------
// Apply: out = |x| >= tau[s] ? x : +0.0; kept[s] += number of kept entries.
// The reference writes x * float(keep), but XLA rewrites that product into a
// select, so what the reference produces is +0.0 for every masked-out entry
// (negatives and NaN included).  The kernel matches that bit for bit.
// ---------------------------------------------------------------------------
__device__ void flush_kept(int* cnt, int* acc, int* kept, int s,
                           int num_segments) {
  const int tid = threadIdx.x;
  const int warp_total = __reduce_add_sync(kFull, *acc);
  if ((tid & 31) == 0 && warp_total != 0) atomicAdd(cnt, warp_total);
  *acc = 0;
  __syncthreads();
  if (tid == 0) {
    const int v = *cnt;
    *cnt = 0;
    if (v != 0 && in_range(s, num_segments)) atomicAdd(&kept[s], v);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
seg_apply_kernel(const float* __restrict__ x, const int* __restrict__ seg,
                 const float* __restrict__ tau, int rows, int rows_per_block,
                 int num_segments, float* __restrict__ out,
                 int* __restrict__ kept) {
  __shared__ int cnt;
  int r0, r1;
  block_rows(rows, rows_per_block, &r0, &r1);
  if (r0 >= r1) return;
  const int tid = threadIdx.x;
  if (tid == 0) cnt = 0;
  __syncthreads();
  int cur = seg[r0];
  float t = in_range(cur, num_segments) ? tau[cur] : 0.0f;
  int acc = 0;
  for (int r = r0; r < r1; ++r) {
    const int s = seg[r];
    if (s != cur) {
      flush_kept(&cnt, &acc, kept, cur, num_segments);
      cur = s;
      t = in_range(cur, num_segments) ? tau[cur] : 0.0f;
    }
    const size_t base = static_cast<size_t>(r) * kLane;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const size_t idx = base + tid + i * kThreads;
      const float v = x[idx];
      const bool keep = fabsf(v) >= t;
      out[idx] = keep ? v : 0.0f;
      acc += keep ? 1 : 0;
    }
  }
  flush_kept(&cnt, &acc, kept, cur, num_segments);
}

int rows_per_block_for(int rows) {
  // About 1024 blocks in all: one wave of 256-thread blocks on 132 SMs.
  const int target_blocks = 1024;
  const int rpb = (rows + target_blocks - 1) / target_blocks;
  return rpb < 1 ? 1 : rpb;
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 on success).  Outputs must be zeroed by the caller.
int seg_histogram_launch(const float* x, const int* seg, int rows,
                         int num_segments, int* out, void* stream) {
  const int rpb = rows_per_block_for(rows);
  const int grid = (rows + rpb - 1) / rpb;
  seg_hist_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, seg, rows, rpb, num_segments, out);
  return static_cast<int>(cudaGetLastError());
}

int seg_count_num_candidates() { return kCandidates; }

int seg_count_launch(const float* x, const int* seg, const float* taus,
                     int rows, int num_segments, int* out, void* stream) {
  const int rpb = rows_per_block_for(rows);
  const int grid = (rows + rpb - 1) / rpb;
  seg_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, seg, taus, rows, rpb, num_segments, out);
  return static_cast<int>(cudaGetLastError());
}

int seg_apply_launch(const float* x, const int* seg, const float* tau,
                     int rows, int num_segments, float* out, int* kept,
                     void* stream) {
  const int rpb = rows_per_block_for(rows);
  const int grid = (rows + rpb - 1) / rpb;
  seg_apply_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, seg, tau, rows, rpb, num_segments, out, kept);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
