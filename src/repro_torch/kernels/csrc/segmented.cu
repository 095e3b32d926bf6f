// Segmented magnitude-masking kernels for Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes).
//
// Replaces the five TPU kernels of src/repro/kernels/segmented.py.  The
// selective top-k masking path runs the first three once per round, the
// fused wire path (FusedSparseCodec) the last two:
//   seg_hist_kernel   <- _seg_hist_kernel   / segmented_histogram
//   seg_count_kernel  <- _seg_count_kernel  / segmented_count
//   seg_apply_kernel  <- _seg_apply_kernel  / segmented_apply
//   seg_stats_kernel  <- _seg_stats_kernel  / segmented_stats
//   seg_encode_kernel <- _seg_encode_kernel / segmented_encode
//
// Layout.  x is an (R, 1024) fp32 buffer; row r belongs to segment seg[r].
// A row whose id lies outside [0, S) belongs to no segment: it counts
// nowhere and is masked against tau = 0, which is what the TPU kernels'
// one-hot gathers/scatters give such a row.
//
// What bounds them.  Each kernel reads every element once (4 bytes); apply
// writes it once more (4 bytes), encode writes 4 bytes (fp32) or 1 byte
// (int8) plus one bitmap bit.  The per-element work is a compare or two, an
// exponent extraction (histogram, stats), a binary search of log2 C
// compares (count) or one IEEE division (int8 encode), far below the card's
// 67 TFLOP/s fp32 rate.  So all five are bound by device-memory bytes (3.35
// TB/s on an H100 SXM).
// The design therefore keeps everything but the single streaming pass on
// chip:
//   * one block owns a contiguous run of rows (about one wave of blocks in
//     all), reads them with coalesced loads (16 bytes a thread: four rows in
//     flight for count, one row ahead for the histogram, stats and encode;
//     4 bytes for apply) and accumulates into shared memory;
//   * shared atomics: one an element for the histogram's bins, and
//     warp-aggregated ones (__reduce_add_sync for the kept count,
//     __reduce_max_sync for the stats max) for the counts and maxima; the
//     count ranks each element among the sorted candidates instead (its
//     section below);
//   * count and apply flush their shared counters to the (S, .) outputs
//     with one global atomicAdd per counter each time the block's segment
//     changes; the histogram, stats and encode keep counters per run of one
//     id and flush them once, at the block's end.  Packed rows are
//     segment-contiguous, so that is a handful of atomics per block.
// Integer atomics are exact and a sum of suffix counts is the suffix count
// of the sum; the stats max is an atomicMax over the bits of |x| as
// unsigned integers, which order non-negative floats (NaN above inf above
// every finite value).  So the results are bit-identical whatever order
// blocks run in.
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
constexpr unsigned kFull = 0xffffffffu;

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
// Count: out[s, c] += #{|x| >= taus[s, c]} for 1 <= C <= 4096 candidates
// per segment, in any order, duplicates included.
//
// An element's counts are fixed by its rank among the segment's candidates,
// so the kernel ranks instead of comparing against all C:
//   * keys.  Everything is compared as a signed int: |x| as its bits, NaN as
//     -1 (below every key); a tau > 0 as its bits (inf 0x7f800000), a tau
//     <= 0 (-0.0 included) as 0 (every non-NaN |x| reaches it), a NaN tau
//     as INT_MAX (none does).  For non-negative floats the bit order is the
//     float order, so key(tau) <= key(|x|) is exactly |x| >= tau.
//   * sort.  When a block meets a segment it loads the C keys into shared
//     memory; unless they are already ascending (one __syncthreads_or) a
//     bitonic sort over the next power of two (INT_MAX padding) orders them
//     with their original columns.  The path's candidates arrive ascending.
//   * rank.  rank(x) = #{sorted keys <= key(|x|)}, a branchless upper bound
//     over the padded keys in ceil(log2 C) + 1 shared-memory compares (5 at
//     C = 16; unrolled up to C = 32).  Each step waits on a shared load, so
//     a thread runs the searches of eight elements (a float4 of two rows of
//     one segment) side by side; four or sixteen were slower at C = 16.
//   * histogram.  Rank 0 counts for no candidate and is dropped; rank C
//     (at or above every candidate) is counted in a register of each
//     thread; ranks in between go to a shared histogram, one shared atomic
//     each.
//   * flush.  When the segment changes, count at sorted position p =
//     #{rank > p}: a block-wide suffix sum of the histogram, exact with
//     ties (no element can rank between two equal keys).  One global
//     atomicAdd per nonzero count puts it in its original column.  The set-up
//     and the flush are not inlined: they run once a segment, and the row
//     loop keeps its registers (no spills).
// What holds it above its bound: the searches' shared loads and atomics at
// large sizes, and the per-segment chain (segment id, its taus, barriers,
// flush) in the path's 4-row blocks, which meet 1-3 segments each.
// Rows go four at a time: each thread issues its four 16-byte loads (one
// float4 of each row) before the first compare.  Packed rows are 1024
// floats, so every row starts on a 16-byte boundary.
// ---------------------------------------------------------------------------
constexpr int kRowsInFlight = 4;
constexpr int kNanKey = -1;
constexpr int kNoKey = 0x7fffffff;

__device__ __forceinline__ int tau_key(float t) {
  if (isnan(t)) return kNoKey;
  return t > 0.0f ? __float_as_int(t) : 0;
}

__device__ __forceinline__ int mag_key(float v) {
  const int a = __float_as_int(v) & 0x7fffffff;
  return a > 0x7f800000 ? kNanKey : a;
}

__device__ __forceinline__ int pow2_at_least(int c) {
  int p = 1;
  while (p < c) p <<= 1;
  return p;
}

// Segment s's keys, ascending, with their columns; true if s is a segment.
__device__ __noinline__ bool load_sorted_keys(int* keys, unsigned short* col,
                                 const float* taus, int s, int num_segments,
                                 int num_cand) {
  if (!in_range(s, num_segments)) return false;
  const int tid = threadIdx.x;
  const int padded = pow2_at_least(num_cand);
  const float* row = taus + static_cast<size_t>(s) * num_cand;
  for (int i = tid; i < padded; i += kThreads) {
    keys[i] = i < num_cand ? tau_key(row[i]) : kNoKey;
    col[i] = static_cast<unsigned short>(i);
  }
  __syncthreads();
  int unsorted = 0;
  for (int i = tid; i + 1 < num_cand; i += kThreads) {
    unsorted |= keys[i] > keys[i + 1];
  }
  if (__syncthreads_or(unsorted)) {
    for (int k = 2; k <= padded; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < padded; i += kThreads) {
          const int l = i ^ j;
          if (l > i) {
            const int a = keys[i], b = keys[l];
            if ((a > b) == ((i & k) == 0)) {
              keys[i] = b;
              keys[l] = a;
              const unsigned short c = col[i];
              col[i] = col[l];
              col[l] = c;
            }
          }
        }
        __syncthreads();
      }
    }
  }
  return true;
}

// Counts of the segment's candidates from the rank histogram (hist[q] for
// ranks q = 1..C; hist[C] takes the threads' rank-C totals `top` first),
// added to out[s, col[p]]; the histogram is left zeroed.
__device__ __noinline__ void flush_ranks(int* hist, int top,
                                         const unsigned short* col,
                                         int* warp_sums, int* out, int s,
                                         bool valid, int num_cand) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_top = __reduce_add_sync(kFull, top);
  if (lane == 0 && warp_top != 0) atomicAdd(&hist[num_cand], warp_top);
  __syncthreads();
  // Thread t owns ranks [q0, q1); suffix sums across threads in reverse.
  const int chunk = (num_cand + kThreads - 1) / kThreads;
  const int q0 = 1 + tid * chunk;
  const int q1 = min(num_cand + 1, q0 + chunk);
  int own = 0;
  for (int q = q0; q < q1; ++q) own += hist[q];
  int suffix = own;                   // sum over lanes >= lane
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_down_sync(kFull, suffix, d);
    if (lane + d < 32) suffix += v;
  }
  if (lane == 0) warp_sums[warp] = suffix;
  __syncthreads();
  int running = suffix - own;
  for (int w = warp + 1; w < kThreads / 32; ++w) running += warp_sums[w];
  for (int q = q1 - 1; q >= q0; --q) {
    running += hist[q];
    hist[q] = 0;
    const int c = col[q - 1];
    if (valid && running != 0 && c < num_cand) {
      atomicAdd(&out[static_cast<size_t>(s) * num_cand + c], running);
    }
  }
  __syncthreads();                    // before keys and col are rewritten
}

// Rank the 4 * kVecs values of v among the sorted keys, interleaved (the
// searches' shared-memory loads overlap), and count them: rank-C ones in
// `top`, ranks in between in the shared histogram.  kLogPadded: log2 of the
// padded key count when it is at most 32 (the search unrolled), else -1.
template <int kLogPadded, int kVecs>
__device__ __forceinline__ void rank_and_count(const float4* v,
                                               const int* keys, int padded,
                                               int num_cand, int* hist,
                                               int& top) {
  constexpr int kN = 4 * kVecs;
  int a[kN], base[kN];
#pragma unroll
  for (int w = 0; w < kVecs; ++w) {
    a[4 * w] = mag_key(v[w].x);
    a[4 * w + 1] = mag_key(v[w].y);
    a[4 * w + 2] = mag_key(v[w].z);
    a[4 * w + 3] = mag_key(v[w].w);
  }
#pragma unroll
  for (int e = 0; e < kN; ++e) base[e] = 0;
  if constexpr (kLogPadded >= 0) {
#pragma unroll
    for (int half = (1 << kLogPadded) >> 1; half > 0; half >>= 1) {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        base[e] += keys[base[e] + half] <= a[e] ? half : 0;
      }
    }
  } else {
    for (int half = padded >> 1; half > 0; half >>= 1) {
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        base[e] += keys[base[e] + half] <= a[e] ? half : 0;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    const int rank = base[e] + (keys[base[e]] <= a[e] ? 1 : 0);
    top += rank == num_cand ? 1 : 0;
    if (rank > 0 && rank < num_cand) atomicAdd(&hist[rank], 1);
  }
}

template <int kLogPadded>
__global__ void __launch_bounds__(kThreads)
seg_count_kernel(const float* __restrict__ x, const int* __restrict__ seg,
                 const float* __restrict__ taus, int rows, int rows_per_block,
                 int num_segments, int num_cand, int* __restrict__ out) {
  extern __shared__ int smem[];
  const int padded =
      kLogPadded >= 0 ? (1 << kLogPadded) : pow2_at_least(num_cand);
  int* keys = smem;                                       // padded
  int* hist = keys + padded;                              // num_cand + 1
  unsigned short* col =
      reinterpret_cast<unsigned short*>(hist + num_cand + 1);  // padded
  __shared__ int warp_sums[kThreads / 32];
  int r0, r1;
  block_rows(rows, rows_per_block, &r0, &r1);
  if (r0 >= r1) return;
  const int tid = threadIdx.x;
  for (int q = tid; q <= num_cand; q += kThreads) hist[q] = 0;
  int cur = seg[r0];
  bool valid = load_sorted_keys(keys, col, taus, cur, num_segments, num_cand);
  int top = 0;                        // this thread's rank-C elements
  for (int g = r0; g < r1; g += kRowsInFlight) {
    float4 v[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      if (g + u < r1) {
        v[u] = reinterpret_cast<const float4*>(
            x + static_cast<size_t>(g + u) * kLane)[tid];
      }
    }
    // Two rows at a time when both are the current segment's; else one by
    // one, flushing at each change of segment.
#pragma unroll
    for (int u = 0; u < kRowsInFlight; u += 2) {
      if (g + u >= r1) continue;
      if (g + u + 1 < r1 && seg[g + u] == cur && seg[g + u + 1] == cur) {
        if (valid) {
          rank_and_count<kLogPadded, 2>(&v[u], keys, padded, num_cand, hist,
                                        top);
        }
        continue;
      }
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        if (g + u + w >= r1) continue;
        const int s = seg[g + u + w];
        if (s != cur) {
          flush_ranks(hist, top, col, warp_sums, out, cur, valid, num_cand);
          top = 0;
          cur = s;
          valid = load_sorted_keys(keys, col, taus, cur, num_segments,
                                   num_cand);
        }
        if (valid) {
          rank_and_count<kLogPadded, 1>(&v[u + w], keys, padded, num_cand,
                                        hist, top);
        }
      }
    }
  }
  flush_ranks(hist, top, col, warp_sums, out, cur, valid, num_cand);
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

// ---------------------------------------------------------------------------
// The wire sweeps: the histogram, and the fused wire path's stats and
// encode.
//
// All three read every element once and do a few operations on it, so all
// are bound by device-memory bytes.  At the path's shape (3392 rows, about
// 4 us of bytes) what costs beside the bytes is work that waits for them:
// a thread that holds all its rows in flight before its first compare does
// all its work after the read (on the H100, four rows in flight took 1.3x
// the time of one row ahead; PERF.md, bench_segmented.py).  So:
//   * a block owns up to kWireRowsMax = 32 rows, about kWireBlocks = 1024
//     blocks in all (4 rows each at the path's shape, 32 at 2^26 elements);
//   * a thread reads a row as one float4 and loads row r + 1 before it
//     works on row r, in at most 32 registers, so eight blocks share an SM;
//   * warp 0 reads the block's segment ids (one a lane) before any row and
//     splits the rows into runs of one id; for encode, each run's first
//     lane loads the run's tau and scale before warp 0's own rows, one load
//     of each per run, not queued behind the rows;
//   * the row loop has no barrier.  Counters live in shared memory per run
//     (histogram: 32 bins of top-bin counts; stats: those and the max;
//     encode: the kept count), so a change of segment only moves the
//     thread to the next run's counters; one barrier at the end, then one
//     global atomic per nonzero counter and run.
// The bins take one shared atomic an element: gathering a warp's equal bins
// with __match_any_sync first took 8% longer for stats at the path's shape
// on the H100 (PERF.md).  The max and the counts are warp-reduced
// (__reduce_max_sync, __reduce_add_sync) when the run changes.
// ---------------------------------------------------------------------------
constexpr int kWireRowsMax = 32;    // rows a block owns at most
constexpr int kWireBlocks = 1024;   // blocks aimed at
constexpr int kWireMinBlocks = 8;   // blocks an SM holds: <= 32 registers

// A block's rows split into runs of one segment id.
struct WireRuns {
  int run_of[kWireRowsMax];    // row -> its run
  int seg[kWireRowsMax];       // run -> segment id
  float tau[kWireRowsMax];     // run -> threshold (0 outside [0, S))
  float scale[kWireRowsMax];   // run -> int8 scale (0 outside [0, S))
  int count;
};

// Warp 0, lane l holding the id of the block's row l (l < n): the runs of
// the block's rows; each run's first lane loads its tau and scale when
// asked.  A row starts a run if it is the block's first or its id differs
// from the row before.
template <bool kTau, bool kScale>
__device__ __forceinline__ void find_runs(int id,
                                          const float* __restrict__ tau,
                                          const float* __restrict__ scale,
                                          int n, int num_segments,
                                          WireRuns& runs) {
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(kFull, id, 1);
  const bool head = lane < n && (lane == 0 || id != prev);
  const unsigned heads = __ballot_sync(kFull, head);
  const int run = __popc(heads & (kFull >> (31 - lane))) - 1;
  if (lane < n) runs.run_of[lane] = run;
  if (head) {
    const bool ok = in_range(id, num_segments);
    runs.seg[run] = id;
    if (kTau) runs.tau[run] = ok ? tau[id] : 0.0f;
    if (kScale) runs.scale[run] = ok ? scale[id] : 0.0f;
  }
  if (lane == 0) runs.count = __popc(heads);
}

// ---------------------------------------------------------------------------
// Histogram: out[s, j] += #{|x| >= 2^(EXPO_MIN + 4 j)} over segment s's rows.
// Stats: the same, plus amax[s] = max |x| over them.
// One body, hist_sweep<kMax>, behind two kernels, seg_hist_kernel and
// seg_stats_kernel, so that the profiler's records and the -Xptxas -v log
// tell them apart.  Bins are counted at each element's top bin and summed
// into suffix form at the flush.  With the max, each thread keeps the
// largest bits of |x| as an unsigned integer in a register (NaN payloads
// order above inf); it goes to the run's shared max once a run
// (__reduce_max_sync, any NaN made the canonical one, one shared atomicMax
// a warp), and to amax[s] once a block (one global atomicMax).  The float
// output starts at 0.0, which is also the max of an empty or all-zero
// segment.
// ---------------------------------------------------------------------------
constexpr unsigned kInfBits = 0x7f800000u;
constexpr unsigned kLowestEdgeBits = (kExpoMin + 127) << 23;   // 2^-96

// Highest suffix bin that |v| reaches, from the bits b of |v|: the largest
// j with |v| >= 2^(EXPO_MIN + 4 j), or -1 when there is none.  The edges
// 2^(-96 + 4 j) have exponent fields 31 + 4 j, so j = (e + 1) / 4 - 8 for
// 2^-96 <= |v| <= inf, and -1 for zeros, smaller magnitudes (subnormals
// among them) and NaN (one unsigned range test), as the reference's >=
// compares give.
__device__ __forceinline__ int top_bin_bits(unsigned b) {
  const int j = static_cast<int>((b + (1u << 23)) >> 25) - 8;
  return b - kLowestEdgeBits <= kInfBits - kLowestEdgeBits ? min(j, kBins - 1)
                                                           : -1;
}

// One element: one to the count of its top bin and, with kMax, the running
// max of |v|'s bits (NaN payloads above inf, made the canonical NaN at the
// flush).
template <bool kMax>
__device__ __forceinline__ void hist_value(float v, int* hist, unsigned& m) {
  const unsigned b = __float_as_uint(v) & 0x7fffffffu;
  if (kMax) m = max(m, b);
  const int j = top_bin_bits(b);
  if (j >= 0) atomicAdd(&hist[j], 1);
}

__device__ __forceinline__ void flush_max(unsigned m, unsigned* amax,
                                          int lane) {
  unsigned warp_max = __reduce_max_sync(kFull, m);
  if (warp_max > kInfBits) warp_max = 0x7fc00000u;   // the canonical NaN
  if (lane == 0 && warp_max != 0) atomicMax(amax, warp_max);
}

template <bool kMax>
__device__ __forceinline__ void hist_sweep(const float* __restrict__ x,
                                           const int* __restrict__ seg,
                                           int rows, int rows_per_block,
                                           int num_segments,
                                           int* __restrict__ out,
                                           unsigned* __restrict__ amax_out) {
  __shared__ WireRuns runs;
  __shared__ int hist[kWireRowsMax * kBins];
  __shared__ unsigned amax_sh[kMax ? kWireRowsMax : 1];
  int r0, r1;
  block_rows(rows, rows_per_block, &r0, &r1);
  if (r0 >= r1) return;
  const int n = r1 - r0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float4* xr =
      reinterpret_cast<const float4*>(x + static_cast<size_t>(r0) * kLane) +
      tid;
  // Warp 0's ids go out first, so they are not queued behind the rows.
  const int id = tid < n ? seg[r0 + tid] : 0;
  float4 next = xr[0];
  if (tid < 32) {
    find_runs<false, false>(id, nullptr, nullptr, n, num_segments, runs);
  }
  for (int i = tid; i < n * kBins; i += kThreads) hist[i] = 0;
  if (kMax && tid < n) amax_sh[tid] = 0;
  __syncthreads();
  unsigned m = 0;
  int cur = 0;
  for (int r = 0; r < n; ++r) {
    const float4 e = next;
    if (r + 1 < n) next = xr[static_cast<size_t>(r + 1) * (kLane / 4)];
    const int run = runs.run_of[r];
    if (kMax && run != cur) {
      flush_max(m, &amax_sh[cur], lane);
      m = 0;
      cur = run;
    }
    int* h = hist + run * kBins;
    hist_value<kMax>(e.x, h, m);
    hist_value<kMax>(e.y, h, m);
    hist_value<kMax>(e.z, h, m);
    hist_value<kMax>(e.w, h, m);
  }
  if (kMax) flush_max(m, &amax_sh[cur], lane);
  __syncthreads();
  // Warp w flushes runs w, w + 8, ...: lane j's suffix count of bin j.
  for (int q = tid >> 5; q < runs.count; q += kThreads / 32) {
    int suffix = hist[q * kBins + lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_down_sync(kFull, suffix, d);
      if (lane + d < 32) suffix += t;
    }
    const int s = runs.seg[q];
    if (!in_range(s, num_segments)) continue;
    if (suffix != 0) {
      atomicAdd(&out[static_cast<size_t>(s) * kBins + lane], suffix);
    }
    if (kMax && lane == 0 && amax_sh[q] != 0) {
      atomicMax(&amax_out[s], amax_sh[q]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kWireMinBlocks)
seg_hist_kernel(const float* __restrict__ x, const int* __restrict__ seg,
                int rows, int rows_per_block, int num_segments,
                int* __restrict__ out) {
  hist_sweep<false>(x, seg, rows, rows_per_block, num_segments, out,
                    nullptr);
}

__global__ void __launch_bounds__(kThreads, kWireMinBlocks)
seg_stats_kernel(const float* __restrict__ x, const int* __restrict__ seg,
                 int rows, int rows_per_block, int num_segments,
                 int* __restrict__ out, unsigned* __restrict__ amax_out) {
  hist_sweep<true>(x, seg, rows, rows_per_block, num_segments, out,
                   amax_out);
}

// ---------------------------------------------------------------------------
// Encode: keep = |x| >= tau[s]; out = keep ? x : +0.0 (fp32), or with scales
// the int8 code of (keep ? x : +0.0) / scale[s]: IEEE division (__fdiv_rn),
// round half to even, clip to [-127, 127], NaN -> 0, which is what XLA's
// round, clip and float-to-int conversion give the reference.  A masked-out
// entry's code is 0 whatever the scale (0 / s is +-0, or NaN for a zero or
// NaN scale), so only kept entries are divided.
// Thread t owns elements 4t .. 4t + 3 of a row: one float4 load, one float4
// (fp32) or 4-byte (int8) store.  Its four keep bits are bits 4 (t % 8) ..
// 4 (t % 8) + 3 of the row's bitmap word t / 8 (bit l = element 32 w + l,
// LSB first); three __shfl_xor_sync ORs gather a word over 8 lanes and one
// lane of the 8 stores it.
// ---------------------------------------------------------------------------
// cvt.rni.s32.f32 rounds half to even, saturates +-inf and gives 0 for NaN,
// so clamping its integer is rint, clip and the cast in one.
__device__ __forceinline__ signed char int8_code(float v) {
  return static_cast<signed char>(max(-127, min(127, __float2int_rn(v))));
}

// The code of a kept entry as a byte; 0 for one masked out.
__device__ __forceinline__ unsigned code_byte(unsigned keep, float v,
                                              float sc) {
  return keep ? static_cast<unsigned char>(int8_code(__fdiv_rn(v, sc))) : 0u;
}

__device__ __forceinline__ void flush_count(int acc, int* cnt, int lane) {
  const int warp_total = __reduce_add_sync(kFull, acc);
  if (lane == 0 && warp_total != 0) atomicAdd(cnt, warp_total);
}

template <bool kQuantize>
__global__ void __launch_bounds__(kThreads, kWireMinBlocks)
seg_encode_kernel(const float* __restrict__ x, const int* __restrict__ seg,
                  const float* __restrict__ tau,
                  const float* __restrict__ scale, int rows,
                  int rows_per_block, int num_segments, void* __restrict__ out,
                  unsigned* __restrict__ bitmap, int* __restrict__ kept) {
  __shared__ WireRuns runs;
  __shared__ int kept_sh[kWireRowsMax];
  int r0, r1;
  block_rows(rows, rows_per_block, &r0, &r1);
  if (r0 >= r1) return;
  const int n = r1 - r0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float4* xr =
      reinterpret_cast<const float4*>(x + static_cast<size_t>(r0) * kLane) +
      tid;
  // Warp 0 reads the ids and then the runs' taus and scales before its own
  // rows, so they are not queued behind the block's rows; the other warps
  // issue their rows at once.
  if (tid < 32) {
    find_runs<true, kQuantize>(tid < n ? seg[r0 + tid] : 0, tau, scale, n,
                               num_segments, runs);
  }
  float4 next = xr[0];
  if (tid < n) kept_sh[tid] = 0;
  __syncthreads();
  int cur = 0;
  float t = runs.tau[0];
  float sc = kQuantize ? runs.scale[0] : 0.0f;
  int acc = 0;
  const int shift = 4 * (lane & 7);
  // Not unrolled: unrolled, fp32 encode took 4% longer at the path's shape
  // on the H100.
#pragma unroll 1
  for (int r = 0; r < n; ++r) {
    const float4 e = next;
    if (r + 1 < n) next = xr[static_cast<size_t>(r + 1) * (kLane / 4)];
    const int run = runs.run_of[r];
    if (run != cur) {
      flush_count(acc, &kept_sh[cur], lane);
      acc = 0;
      cur = run;
      t = runs.tau[run];
      if (kQuantize) sc = runs.scale[run];
    }
    const unsigned bits =
        (fabsf(e.x) >= t ? 1u : 0u) | (fabsf(e.y) >= t ? 2u : 0u) |
        (fabsf(e.z) >= t ? 4u : 0u) | (fabsf(e.w) >= t ? 8u : 0u);
    const size_t row = static_cast<size_t>(r0 + r);
    if (kQuantize) {
      // Four codes, element 4t in the low byte: one 4-byte store.
      reinterpret_cast<unsigned*>(static_cast<signed char*>(out) +
                                  row * kLane)[tid] =
          code_byte(bits & 1u, e.x, sc) | code_byte(bits & 2u, e.y, sc) << 8 |
          code_byte(bits & 4u, e.z, sc) << 16 |
          code_byte(bits & 8u, e.w, sc) << 24;
    } else {
      reinterpret_cast<float4*>(static_cast<float*>(out) + row * kLane)[tid] =
          make_float4(bits & 1u ? e.x : 0.0f, bits & 2u ? e.y : 0.0f,
                      bits & 4u ? e.z : 0.0f, bits & 8u ? e.w : 0.0f);
    }
    unsigned word = bits << shift;
    word |= __shfl_xor_sync(kFull, word, 1);
    word |= __shfl_xor_sync(kFull, word, 2);
    word |= __shfl_xor_sync(kFull, word, 4);
    if ((lane & 7) == 0) bitmap[row * (kLane / 32) + (tid >> 3)] = word;
    acc += __popc(bits);
  }
  flush_count(acc, &kept_sh[cur], lane);
  __syncthreads();
  for (int q = tid; q < runs.count; q += kThreads) {
    const int s = runs.seg[q];
    if (kept_sh[q] != 0 && in_range(s, num_segments)) {
      atomicAdd(&kept[s], kept_sh[q]);
    }
  }
}

int rows_per_block_for(int rows) {
  // About 1024 blocks in all: one wave of 256-thread blocks on 132 SMs.
  const int target_blocks = 1024;
  const int rpb = (rows + target_blocks - 1) / target_blocks;
  return rpb < 1 ? 1 : rpb;
}

int wire_rows_per_block(int rows) {
  // About kWireBlocks blocks, at most kWireRowsMax rows each.
  const int rpb = (rows + kWireBlocks - 1) / kWireBlocks;
  return rpb < 1 ? 1 : (rpb < kWireRowsMax ? rpb : kWireRowsMax);
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 on success).  Outputs must be zeroed by the caller.
int seg_histogram_launch(const float* x, const int* seg, int rows,
                         int num_segments, int* out, void* stream) {
  const int rpb = wire_rows_per_block(rows);
  const int grid = (rows + rpb - 1) / rpb;
  seg_hist_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, seg, rows, rpb, num_segments, out);
  return static_cast<int>(cudaGetLastError());
}

int seg_count_launch(const float* x, const int* seg, const float* taus,
                     int rows, int num_segments, int num_cand, int* out,
                     void* stream) {
  const int rpb = rows_per_block_for(rows);
  const int grid = (rows + rpb - 1) / rpb;
  int padded = 1;
  while (padded < num_cand) padded <<= 1;
  const size_t smem = (padded + num_cand + 1) * sizeof(int) +
                      padded * sizeof(unsigned short);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (padded) {
#define SEG_COUNT_CASE(P, LOG)                                          \
  case P:                                                               \
    seg_count_kernel<LOG><<<grid, kThreads, smem, st>>>(                \
        x, seg, taus, rows, rpb, num_segments, num_cand, out);          \
    break;
    SEG_COUNT_CASE(1, 0)
    SEG_COUNT_CASE(2, 1)
    SEG_COUNT_CASE(4, 2)
    SEG_COUNT_CASE(8, 3)
    SEG_COUNT_CASE(16, 4)
    SEG_COUNT_CASE(32, 5)
#undef SEG_COUNT_CASE
    default:
      seg_count_kernel<-1><<<grid, kThreads, smem, st>>>(
          x, seg, taus, rows, rpb, num_segments, num_cand, out);
  }
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

int seg_stats_launch(const float* x, const int* seg, int rows,
                     int num_segments, int* hist, float* amax, void* stream) {
  const int rpb = wire_rows_per_block(rows);
  const int grid = (rows + rpb - 1) / rpb;
  seg_stats_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, seg, rows, rpb, num_segments, hist,
      reinterpret_cast<unsigned*>(amax));
  return static_cast<int>(cudaGetLastError());
}

// `scale` may be null: then `out` is fp32, else int8.
int seg_encode_launch(const float* x, const int* seg, const float* tau,
                      const float* scale, int rows, int num_segments,
                      void* out, unsigned char* bitmap, int* kept,
                      void* stream) {
  const int rpb = wire_rows_per_block(rows);
  const int grid = (rows + rpb - 1) / rpb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* words = reinterpret_cast<unsigned*>(bitmap);
  if (scale == nullptr) {
    seg_encode_kernel<false><<<grid, kThreads, 0, st>>>(
        x, seg, tau, scale, rows, rpb, num_segments, out, words, kept);
  } else {
    seg_encode_kernel<true><<<grid, kThreads, 0, st>>>(
        x, seg, tau, scale, rows, rpb, num_segments, out, words, kept);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
