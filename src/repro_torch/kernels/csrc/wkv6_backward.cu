// The gradient of the RWKV6 wkv recurrence for Hopper (sm_90a), bound to
// Python through a plain C interface (ctypes).
//
// Replaces no TPU kernel: the reference differentiates
// src/repro/models/rwkv.py:76 (wkv6_chunked) by XLA autodiff.  It is here
// because the port runs the forward on its own kernel (wkv6.cu), which
// autograd cannot see into; kernels/wkv6.py's Wkv6Function calls it.
//
// Per (batch, head), with the forward's notation (wkv6.cu): chunks of L = 64
// steps, cum the inclusive prefix sum of log2(w) = log2e * logw inside a
// chunk, cp_t = cum_{t-1} (0 at t = 0), S and S' the chunk's start and end
// states, dS' the adjoint of S' (dsT for the last chunk), beta_t =
// r_t.u.k_t, delta_t = dy_t.v_t and A[t,s] = sum_i r_t[i] k_s[i]
// 2^{cp_t[i] - cum_s[i]} (s < t):
//
//   dA[t,s] = dy_t . v_s                                             (s < t)
//   dv_s = sum_{t>s} A[t,s] dy_t + beta_s dy_s + (k_s 2^{cum_L - cum_s})^T dS'
//   dr_t = 2^{cp_t} (S dy_t) + sum_{s<t} dA[t,s] k_s 2^{cp_t - cum_s}
//          + delta_t u k_t
//   dk_s = sum_{t>s} dA[t,s] r_t 2^{cp_t - cum_s} + delta_s u r_s
//          + 2^{cum_L - cum_s} (dS' v_s)
//   du  += sum_t delta_t r_t k_t
//   dS   = diag(2^{cum_L}) dS' + sum_t (r_t 2^{cp_t}) dy_t^T
//   P_t = r_t (dr_t - delta_t u k_t),  Q_s = k_s (dk_s - delta_s u r_s),
//   Z = rowsum(dS' * S'),  dlogw_i = sum_{t>i} P_t - sum_{s>=i} Q_s + Z
//
// and ds0 is dS after the first chunk.
//
// Three passes, so that every chunk's gradients run in a block of their own:
//   1. wkv6_bwd_terms_kernel, a block per (b, h, chunk): the chunk's own
//      state terms K = sum_s (k_s 2^{cum_L - cum_s}) v_s^T and G = sum_t
//      (r_t 2^{cp_t}) dy_t^T, two (D x L)(L x D) products, and its decay
//      2^{cum_L};
//   2. wkv6_bwd_scan_kernel, a thread per (b, h, i, e): the serial scans
//      over the chunks, S' = diag(2^{cum_L}) S + K forward from s0 and
//      dS = diag(2^{cum_L}) dS' + G back from dsT, in place in the states
//      buffer (B, H, chunks + 1, D, D) and the adjoint buffer (B, H,
//      chunks, D, D); ds0 is the last dS;
//   3. wkv6_bwd_grad_kernel, a block per (b, h, chunk) over all D value
//      columns: dv, dr, dk and dlogw of the chunk, and its partial of du,
//      which wkv6_bwd_du_kernel adds over batch rows and chunks in a fixed
//      order.  No float atomics: two runs give the same bits.
// At rwkv6-1.6b's training shape (1, 4096, 32, 64) that is 2,048 blocks a
// pass.  The forward kernel (wkv6.cu) is unchanged and saves nothing.
//
// Pair decays.  As in the forward, the chunk is cut into four sub-chunks of
// 16 steps.  For s in sub-chunk m and t in a later one, the pair decay is
// split at the end of s's sub-chunk, b = 16 m + 15:
//
//   2^{cp_t - cum_s} = 2^{cp_t - cum_b} * 2^{cum_b - cum_s}
//
// both factors <= 1.  With K'_s = k_s 2^{cum_b - cum_s} (48 rows) and R_m[t]
// = r_t 2^{cp_t - cum_b} (t past sub-chunk m: 48 + 32 + 16 rows), A's
// off-diagonal blocks are R_m K'^T, dr's pair sum takes sum_m 2^{cp_t -
// cum_b} (dA[t, m] K'_m) and dk's 2^{cum_b - cum_s} (dA[.., s]^T R_m): all
// products.  Only the diagonal 16 x 16 blocks take a per-pair exponent, and
// inside each the lower-left 8 x 8 quarter splits again at the block's step
// 7 (as the forward does), so each takes 42 pair exponents and 14 split
// factors a channel; one thread a (sub-chunk, channel) computes each of them
// once and uses it in A, dr's sum and dk's sum.  A 64-step chunk takes
// 14,336 exponentials in its diagonal blocks at D = 64 and 51,264 for the
// split factors, the epilogues' scales and pass 1: 134 M a call at
// rwkv6-1.6b's training shape (every pair three times, as the sums need
// them, would be 1.56 G).
//
// Numerics.  No exponent is positive: prefix sums added in order, one lane
// a channel, never increase, and every exponent is cum_a - cum_b with a >=
// b.  Nothing overflows for any logw <= 0, the model's clip logw = -e^4
// included; when one factor of a split underflows, so does the exact
// product.  Exponentials are ex2.approx on the log2-scaled sums.
//
// Products on the tensor cores.  dA = dy v^T, A's off-diagonal blocks, dv =
// A^T dy + kd dS', dr's dy S^T and pair blocks, dk's v dS'^T and pair
// blocks, and pass 1's K and G run as mma.sync.m16n8k8 in TF32 with the
// 3xTF32 split of wkv6.cu (a = a_hi + a_lo, three products summed in fp32,
// about fp32 accuracy; plain TF32 keeps about three digits and misses the
// 1e-4 tolerance).  Pass 3's block has 8 D threads (512 at D = 64): per
// chunk, with five block barriers,
//   0. r, k, logw, v, dy into shared memory (rows past T as zeros, which add
//      nothing), u, and A set to zero;
//   1. the prefix sums (one warp a 32 channels), beside them dA's ten lower
//      16 x 16 tiles, beta, and Z from the stored states;
//   2. one warp a (sub-chunk, 32 channels): the diagonal block's pairs into
//      A, dr's and dk's diagonal sums; the other warps: K', R_m, then A's six
//      off-diagonal tiles;
//   3. each warp one 16 x 16 tile of dv, of dr and of dk; S and dS' are read
//      from the state buffers through L1;
//   4. dlogw, a reverse prefix in four sub-chunks at once, and du's partial.
// Shared memory: 201,216 bytes at D = 64 (one block an SM), 124,160 at 32.
//
// What bounds it.  The function reads r, k, v, logw and dy and writes dr,
// dk, dv and dlogw once: at (1, 4096, 32, 64) nine tensors of 33.55 MB,
// about 302 MB, 0.090 ms at 3.35 TB/s (plus s0, dsT, u and their
// gradients, 1.1 MB).  Its operations, counted as the step recurrence
// needs them (14 D^2 a step and head), are 7.6 GFLOP, 0.114 ms at 67
// TFLOP/s fp32: it is bound by operations at that shape, by a little.  This
// design reads the five inputs twice (passes 1 and 3) and writes and reads
// the two state buffers (33.5 MB each) three times: about 0.74 GB, 0.22 ms
// at 3.35 TB/s; its products run on the tensor cores.  On the H100 (700 W)
// the passes take 0.125, 0.084, 0.610 and 0.008 ms at that shape.  The
// gradients pass runs one block an SM (201 KB of shared memory), so
// nothing overlaps its phases' latencies: removing one phase at a time,
// the tile products took 0.23 ms (0.08 of it S and dS' read through L1),
// the diagonal pairs 0.11, the loads 0.10 and phase 1 0.08.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;              // steps a chunk
constexpr int kSub = 16;            // steps a sub-chunk
constexpr int kScanThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Cfg {
  static constexpr int kThreads = 8 * D;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kTilesN = D / 16;           // 16-column tiles a row
  static constexpr int kScanWarps = D / 32;        // prefix sums: 32 lanes
  static constexpr int kDiagWarps = 4 * (D / 32);  // (sub-chunk, 32 channels)
  static constexpr int kOtherWarps = kWarps - kDiagWarps;
  static constexpr int P = D + 4;      // rows of D channels read as rows
  static constexpr int P8 = D + 8;     // rows of D channels read by column
  static constexpr int PA = kL + 8;    // A, read by column
  static constexpr int PdA = kL + 4;   // dA
  static constexpr int kRowsR = 96;    // R_0, R_1, R_2: 48 + 32 + 16 rows
  static constexpr int kRowsK = 48;    // K' of sub-chunks 0..2
  // Pass 3: r k cum v dy DR DK (L x P), dA, A, K', R, u beta Z, 2 x (4 x D).
  static constexpr int kGradFloats = 7 * kL * P + kL * PdA + kL * PA +
                                     kRowsK * P + kRowsR * P8 + D + kL + D +
                                     8 * D;
  static constexpr int kGradBytes = kGradFloats * 4;
  // Pass 1: r k cum v dy (L x P8).
  static constexpr int kTermBytes = 5 * kL * P8 * 4;
  static_assert(kWarps == 4 * kTilesN, "one tile of each gradient a warp");
  static_assert(kOtherWarps > 0, "warps for the off-diagonal work");
};

// Row of R_m's step t (t > 16 m + 15) in the R buffer.
__device__ __forceinline__ int r_row(int m, int t) {
  return (m == 0 ? 0 : (m == 1 ? 48 : 80)) + t - kSub * (m + 1);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo: hi keeps the 10 explicit mantissa bits a TF32 operand has,
// lo = x - hi is exact in fp32 (wkv6.cu).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// A 16 x 16 tile in the accumulator layout of two m16n8 tiles (g = lane / 4,
// q = lane % 4): element [j][2 h + e] is row g + 8 h, column 8 j + 2 q + e.
// The three terms of 3xTF32 go to three accumulators, so no chain of
// products waits on another.
struct Tile {
  float c[2][4], x[2][4], z[2][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) c[j][i] = x[j][i] = z[j][i] = 0.0f;
    }
  }
  __device__ __forceinline__ float get(int j, int i) const {
    return c[j][i] + (x[j][i] + z[j][i]);
  }
  // this += a b, a the m16k8 fragment shared by both column halves.
  __device__ __forceinline__ void mma(const float (&a)[4],
                                      const float (&b)[2][2]) {
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b[j][0], bh0, bl0);
      split_tf32(b[j][1], bh1, bl1);
      mma_tf32(x[j], al, bh0, bh1);
      mma_tf32(c[j], ah, bh0, bh1);
      mma_tf32(z[j], ah, bl0, bl1);
    }
  }
};

// Fragments.  A row-major in x (element (m, k) at x[m ld + k]), tile at (r0,
// k0): rows g, g + 8, columns q, q + 4.
__device__ __forceinline__ void frag_a_rows(float (&a)[4], const float* x,
                                            int ld, int r0, int k0, int g,
                                            int q) {
  const float* p = x + (r0 + g) * ld + k0 + q;
  a[0] = p[0];
  a[1] = p[8 * ld];
  a[2] = p[4];
  a[3] = p[8 * ld + 4];
}

// A stored transposed (element (m, k) at x[k ld + m]).
__device__ __forceinline__ void frag_a_cols(float (&a)[4], const float* x,
                                            int ld, int r0, int k0, int g,
                                            int q) {
  const float* p = x + (k0 + q) * ld + r0 + g;
  a[0] = p[0];
  a[1] = p[8];
  a[2] = p[4 * ld];
  a[3] = p[4 * ld + 8];
}

// B (8 x 16: k0 .. k0 + 7, n0 .. n0 + 15) stored with k as the row (element
// (k, n) at x[k ld + n]).
__device__ __forceinline__ void frag_b_krow(float (&b)[2][2], const float* x,
                                            int ld, int k0, int n0, int g,
                                            int q) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float* p = x + (k0 + q) * ld + n0 + 8 * j + g;
    b[j][0] = p[0];
    b[j][1] = p[4 * ld];
  }
}

// B stored with n as the row (element (k, n) at x[n ld + k]).
__device__ __forceinline__ void frag_b_nrow(float (&b)[2][2], const float* x,
                                            int ld, int k0, int n0, int g,
                                            int q) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float* p = x + (n0 + 8 * j + g) * ld + k0 + q;
    b[j][0] = p[0];
    b[j][1] = p[4];
  }
}

// Rows t0 .. t0 + 63 of a (B, T, H, D) tensor at (b, h) into shared memory
// with row pitch ld, 16 bytes a load; rows outside [0, T) as zeros.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          long long base, long long row,
                                          int t0, int T) {
  constexpr int Q = D / 4;
  for (int x = threadIdx.x; x < kL * Q; x += Cfg<D>::kThreads) {
    const int t = x / Q, c = (x % Q) * 4;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (t0 + t < T) {
      val = *reinterpret_cast<const float4*>(src + base + (t0 + t) * row + c);
    }
    *reinterpret_cast<float4*>(dst + t * ld + c) = val;
  }
}

// In place: cum[t][i] = log2e * sum_{j <= t} logw[j][i], added in order so
// that the sums never increase.  Warps 0 .. D/32 - 1, lane = channel.
template <int D>
__device__ __forceinline__ void prefix_sums(float* cs, int ld, int warp,
                                            int lane) {
  if (warp < D / 32) {
    float* col = cs + 32 * warp + lane;
    float run = 0.0f;
#pragma unroll 16
    for (int t = 0; t < kL; ++t) {
      run += col[t * ld] * kLog2e;
      col[t * ld] = run;
    }
  }
}

// Pass 1: the chunk's K = kd^T v into states[c + 1], G = qe^T dy into
// adj[c], and its decay 2^{cum_L} into dec[c].
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
wkv6_bwd_terms_kernel(const float* __restrict__ r,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ lw,
                      const float* __restrict__ dy, float* __restrict__ states,
                      float* __restrict__ adj, float* __restrict__ dec, int T,
                      int H, int nchunks) {
  using K = Cfg<D>;
  constexpr int P8 = K::P8, NT = K::kTilesN;
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;                    // r, then qe = r 2^{cp}
  float* ks = rs + kL * P8;            // k, then kd = k 2^{cum_L - cum}
  float* cs = ks + kL * P8;            // logw, then cum
  float* vs = cs + kL * P8;
  float* ys = vs + kL * P8;
  const int c = blockIdx.x % nchunks;
  const int bh = blockIdx.x / nchunks;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const long long row = static_cast<long long>(H) * D;
  const long long base = (static_cast<long long>(b) * T * H + h) * D;
  const int t0 = c * kL;
  const long long dd = static_cast<long long>(D) * D;

  load_rows<D>(rs, P8, r, base, row, t0, T);
  load_rows<D>(ks, P8, k, base, row, t0, T);
  load_rows<D>(cs, P8, lw, base, row, t0, T);
  load_rows<D>(vs, P8, v, base, row, t0, T);
  load_rows<D>(ys, P8, dy, base, row, t0, T);
  __syncthreads();
  prefix_sums<D>(cs, P8, warp, lane);
  __syncthreads();
  for (int x = tid; x < kL * D; x += K::kThreads) {
    const int t = x / D, i = x % D;
    const float last = cs[(kL - 1) * P8 + i];
    ks[t * P8 + i] *= ex2(last - cs[t * P8 + i]);
    if (t > 0) rs[t * P8 + i] *= ex2(cs[(t - 1) * P8 + i]);
  }
  for (int i = tid; i < D; i += K::kThreads) {
    dec[(static_cast<long long>(bh) * nchunks + c) * D + i] =
        ex2(cs[(kL - 1) * P8 + i]);
  }
  __syncthreads();
  // K (tasks 0 .. NT^2 - 1) and G (the rest), one 16 x 16 tile a task.
  for (int task = warp; task < 2 * NT * NT; task += K::kWarps) {
    const bool is_g = task >= NT * NT;
    const int tile = task % (NT * NT), tm = tile / NT, tn = tile % NT;
    const float* lhs = is_g ? rs : ks;
    const float* rhs = is_g ? ys : vs;
    Tile acc;
    acc.zero();
#pragma unroll
    for (int k0 = 0; k0 < kL; k0 += 8) {
      float a[4], bb[2][2];
      frag_a_cols(a, lhs, P8, 16 * tm, k0, g, qd);
      frag_b_krow(bb, rhs, P8, k0, 16 * tn, g, qd);
      acc.mma(a, bb);
    }
    float* out = is_g ? adj + (static_cast<long long>(bh) * nchunks + c) * dd
                      : states +
                            (static_cast<long long>(bh) * (nchunks + 1) + c +
                             1) * dd;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 16 * tm + g + 8 * hf, e = 16 * tn + 8 * j + 2 * qd;
        *reinterpret_cast<float2*>(out + i * D + e) =
            make_float2(acc.get(j, 2 * hf), acc.get(j, 2 * hf + 1));
      }
    }
  }
}

// Pass 2: one thread a state entry (b, h, i, e).  states[0] = s0 and
// states[c + 1] = dec[c] * states[c] + K_c (K_c stored there by pass 1);
// adj[c] = dS' of chunk c (dsT for the last), G_c read from there first;
// ds0 the adjoint after chunk 0.  Eight chunks' loads are issued before they
// are used.
__global__ void __launch_bounds__(kScanThreads)
wkv6_bwd_scan_kernel(const float* __restrict__ s0,
                     const float* __restrict__ dsT, float* __restrict__ states,
                     float* __restrict__ adj, const float* __restrict__ dec,
                     float* __restrict__ ds0, long long entries, int D,
                     int nchunks) {
  const long long x = static_cast<long long>(blockIdx.x) * kScanThreads +
                      threadIdx.x;
  if (x >= entries) return;
  const long long dd = static_cast<long long>(D) * D;
  const long long bh = x / dd;
  const int ie = static_cast<int>(x - bh * dd), i = ie / D;
  float* st = states + bh * (nchunks + 1) * dd + ie;
  float* ad = adj + bh * nchunks * dd + ie;
  const float* dc = dec + bh * nchunks * D + i;
  constexpr int kAhead = 8;
  float run = s0[x];
  st[0] = run;
  for (int c0 = 0; c0 < nchunks; c0 += kAhead) {
    float kt[kAhead], dt[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const bool ok = c0 + j < nchunks;
      kt[j] = ok ? st[(c0 + j + 1) * dd] : 0.0f;
      dt[j] = ok ? dc[(c0 + j) * D] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (c0 + j < nchunks) {
        run = dt[j] * run + kt[j];
        st[(c0 + j + 1) * dd] = run;
      }
    }
  }
  float gr = dsT[x];
  for (int c1 = nchunks - 1; c1 >= 0; c1 -= kAhead) {
    float gt[kAhead], dt[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const bool ok = c1 - j >= 0;
      gt[j] = ok ? ad[(c1 - j) * dd] : 0.0f;
      dt[j] = ok ? dc[(c1 - j) * D] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (c1 - j >= 0) {
        ad[(c1 - j) * dd] = gr;
        gr = dt[j] * gr + gt[j];
      }
    }
  }
  ds0[x] = gr;
}

// One transposed reduction step over lanes that differ in bit HALF (the
// constant trip counts keep v in registers).
template <int HALF, int N>
__device__ __forceinline__ void reduce_step(float (&v)[N], int lane) {
  const bool upper = lane & HALF;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float lo = v[j], hi = v[j + HALF];
    const float send = upper ? lo : hi;
    const float keep = upper ? hi : lo;
    v[j] = keep + __shfl_xor_sync(kFull, send, HALF);
  }
}

// Sixteen sums over the warp at once: lanes l and l + 16 end with the sum of
// v[l % 16] over all 32 lanes in v[0].
__device__ __forceinline__ void reduce_scatter16(float (&v)[16], int lane) {
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] += __shfl_xor_sync(kFull, v[j], 16);
  reduce_step<8>(v, lane);
  reduce_step<4>(v, lane);
  reduce_step<2>(v, lane);
  reduce_step<1>(v, lane);
}

// Where the pair p = t (t - 1) / 2 + s (s < t < 16) of a diagonal block sits.
__device__ __forceinline__ int pair_offset(int p, int ld) {
  int t = 1;
  while (t * (t + 1) / 2 <= p) ++t;
  return t * ld + p - t * (t - 1) / 2;
}

// Pass 3: the chunk's dv, dr, dk, dlogw and du partial.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
wkv6_bwd_grad_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ lw,
                     const float* __restrict__ u, const float* __restrict__ dy,
                     const float* __restrict__ states,
                     const float* __restrict__ adj, float* __restrict__ dr,
                     float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dw, float* __restrict__ du_parts,
                     int T, int H, int nchunks) {
  using K = Cfg<D>;
  constexpr int P = K::P, P8 = K::P8, PA = K::PA, PdA = K::PdA;
  constexpr int NT = K::kTilesN;
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;
  float* ks = rs + kL * P;
  float* cs = ks + kL * P;             // logw, then cum
  float* vs = cs + kL * P;
  float* ys = vs + kL * P;
  float* drs = ys + kL * P;            // dr's diagonal pair sums, then P
  float* dks = drs + kL * P;           // dk's diagonal pair sums, then Q
  float* das = dks + kL * P;           // dA (dy v^T, lower tiles)
  float* as = das + kL * PdA;          // A, strictly lower
  float* kps = as + kL * PA;           // K'
  float* rms = kps + K::kRowsK * P;    // R_0, R_1, R_2
  float* us = rms + K::kRowsR * P8;
  float* betas = us + D;
  float* zs = betas + kL;
  float* tots = zs + D;                // dlogw: each sub-chunk's sum
  float* dus = tots + 4 * D;           // du: each sub-chunk's sum

  const int c = blockIdx.x % nchunks;
  const int bh = blockIdx.x / nchunks;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const long long row = static_cast<long long>(H) * D;
  const long long base = (static_cast<long long>(b) * T * H + h) * D;
  const int t0 = c * kL;
  const long long dd = static_cast<long long>(D) * D;
  const float* Sg = states + (static_cast<long long>(bh) * (nchunks + 1) + c) *
                                 dd;             // S; S' = Sg + dd
  const float* dSg = adj + (static_cast<long long>(bh) * nchunks + c) * dd;

  // 0. Inputs.
  load_rows<D>(rs, P, r, base, row, t0, T);
  load_rows<D>(ks, P, k, base, row, t0, T);
  load_rows<D>(cs, P, lw, base, row, t0, T);
  load_rows<D>(vs, P, v, base, row, t0, T);
  load_rows<D>(ys, P, dy, base, row, t0, T);
  for (int x = tid; x < kL * PA; x += K::kThreads) as[x] = 0.0f;
  for (int i = tid; i < D; i += K::kThreads) us[i] = u[h * D + i];
  __syncthreads();

  // 1. Prefix sums; beside them dA's lower tiles, beta and Z.
  if (warp < K::kScanWarps) {
    prefix_sums<D>(cs, P, warp, lane);
  } else {
    const int ow = warp - K::kScanWarps;
    constexpr int nw = K::kWarps - K::kScanWarps;
    for (int tau = ow; tau < 10; tau += nw) {
      int tb = 0;
      while ((tb + 1) * (tb + 2) / 2 <= tau) ++tb;
      const int sb = tau - tb * (tb + 1) / 2;
      Tile acc;
      acc.zero();
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 8) {
        float a[4], bb[2][2];
        frag_a_rows(a, ys, P, 16 * tb, k0, g, qd);
        frag_b_nrow(bb, vs, P, k0, 16 * sb, g, qd);
        acc.mma(a, bb);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = 16 * tb + g + 8 * hf, s = 16 * sb + 8 * j + 2 * qd;
          *reinterpret_cast<float2*>(das + t * PdA + s) =
              make_float2(acc.get(j, 2 * hf), acc.get(j, 2 * hf + 1));
        }
      }
    }
    // beta (rows 0 .. L - 1) and Z (rows L .. L + D - 1), a warp a row.
    for (int rho = ow; rho < kL + D; rho += nw) {
      float p = 0.0f;
      if (rho < kL) {
#pragma unroll
        for (int i = lane; i < D; i += 32) {
          p += rs[rho * P + i] * us[i] * ks[rho * P + i];
        }
      } else {
        const int i = rho - kL;
#pragma unroll
        for (int e = lane; e < D; e += 32) {
          p += dSg[i * D + e] * Sg[dd + i * D + e];
        }
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) p += __shfl_xor_sync(kFull, p, o);
      if (lane == 0) {
        if (rho < kL) {
          betas[rho] = p;
        } else {
          zs[rho - kL] = p;
        }
      }
    }
  }
  __syncthreads();

  // 2. The diagonal blocks' pairs; the split factors and A's off-diagonal
  // tiles.
  if (warp < K::kDiagWarps) {
    const int j = warp % 4, grp = warp / 4, i = 32 * grp + lane;
    float rr[kSub], kk[kSub], cu[kSub];
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      rr[t] = rs[(kSub * j + t) * P + i];
      kk[t] = ks[(kSub * j + t) * P + i];
      cu[t] = cs[(kSub * j + t) * P + i];
    }
    constexpr int kHalf = kSub / 2;
    float kf[kHalf];                   // 2^{cum_7 - cum_s}, s < 8
#pragma unroll
    for (int s = 0; s < kHalf; ++s) {
      kf[s] = s == kHalf - 1 ? 1.0f : ex2(cu[kHalf - 1] - cu[s]);
    }
    const float* dab = das + kSub * j * (PdA + 1);   // the diagonal block
    float* drb = drs + kSub * j * P + i;
    float* dkb = dks + kSub * j * P + i;
    float dks_acc[kSub];
    float vals[16];
    float sums[8];
#pragma unroll
    for (int s = 0; s < kSub; ++s) dks_acc[s] = 0.0f;
    drb[0] = 0.0f;
    // Both loops unroll fully, so every index is a constant and the arrays
    // stay in registers.
#pragma unroll
    for (int t = 1; t < kSub; ++t) {
      const float qf = t <= kHalf ? 1.0f : ex2(cu[t - 1] - cu[kHalf - 1]);
      float dr_acc = 0.0f;
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        if (s < t) {
          const int p = t * (t - 1) / 2 + s;
          float e;
          if (t >= kHalf && s < kHalf) {
            e = qf * kf[s];
          } else {
            e = s == t - 1 ? 1.0f : ex2(cu[t - 1] - cu[s]);
          }
          const float dat = dab[t * PdA + s];
          const float ke = kk[s] * e;
          vals[p & 15] = rr[t] * ke;
          dr_acc += dat * ke;
          dks_acc[s] += dat * rr[t] * e;
          if ((p & 15) == 15) {
            reduce_scatter16(vals, lane);
            sums[p >> 4] = vals[0];
          }
        }
      }
      drb[t * P] = dr_acc;
    }
#pragma unroll
    for (int x = 120 - 112; x < 16; ++x) vals[x] = 0.0f;
    reduce_scatter16(vals, lane);
    sums[7] = vals[0];
#pragma unroll
    for (int s = 0; s < kSub; ++s) dkb[s * P] = dks_acc[s];
    // A's diagonal block: the 120 sums of 32 channels, lane l < 16 holding
    // pair 16 n + l of batch n; the second 32 channels add after the first.
    if (K::kDiagWarps > 4 && grp == 1) named_sync(2 + j, 64);
    float* ab = as + kSub * j * (PA + 1);
    if (lane < 16) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int p = 16 * n + lane;
        if (p < 120) {
          float* dst = ab + pair_offset(p, PA);
          *dst = grp == 0 ? sums[n] : *dst + sums[n];
        }
      }
    }
    if (K::kDiagWarps > 4 && grp == 0) named_arrive(2 + j, 64);
  } else {
    const int etid = tid - 32 * K::kDiagWarps;
    constexpr int kEThreads = 32 * K::kOtherWarps;
    constexpr int D4 = D / 4;
    // K'_s = k_s 2^{cum_b - cum_s}, b = 16 m + 15 the end of s's sub-chunk.
    for (int x = etid; x < K::kRowsK * D4; x += kEThreads) {
      const int s = x / D4, i = (x % D4) * 4;
      const int bnd = (s / kSub) * kSub + kSub - 1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kps[s * P + i + e] = ks[s * P + i + e] *
                             ex2(cs[bnd * P + i + e] - cs[s * P + i + e]);
      }
    }
    // R_m[t] = r_t 2^{cp_t - cum_b}, t past sub-chunk m.
    for (int x = etid; x < K::kRowsR * D4; x += kEThreads) {
      const int rho = x / D4, i = (x % D4) * 4;
      const int m = rho < 48 ? 0 : (rho < 80 ? 1 : 2);
      const int t = rho - (m == 0 ? 0 : (m == 1 ? 48 : 80)) + kSub * (m + 1);
      const int bnd = kSub * m + kSub - 1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        rms[rho * P8 + i + e] =
            rs[t * P + i + e] *
            ex2(cs[(t - 1) * P + i + e] - cs[bnd * P + i + e]);
      }
    }
    named_sync(1, kEThreads);
    // A's off-diagonal tiles (j, m), m < j: R_m's rows of sub-chunk j times
    // K'_m^T.
    const int ew = warp - K::kDiagWarps;
    for (int tau = ew; tau < 6; tau += K::kOtherWarps) {
      const int j = tau < 1 ? 1 : (tau < 3 ? 2 : 3);
      const int m = tau - (j == 1 ? 0 : (j == 2 ? 1 : 3));
      Tile acc;
      acc.zero();
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 8) {
        float a[4], bb[2][2];
        frag_a_rows(a, rms, P8, r_row(m, kSub * j), k0, g, qd);
        frag_b_nrow(bb, kps, P, k0, kSub * m, g, qd);
        acc.mma(a, bb);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = kSub * j + g + 8 * hf;
          const int s = kSub * m + 8 * jj + 2 * qd;
          *reinterpret_cast<float2*>(as + t * PA + s) =
              make_float2(acc.get(jj, 2 * hf), acc.get(jj, 2 * hf + 1));
        }
      }
    }
  }
  __syncthreads();

  // 3. One 16 x 16 tile of dv, dr and dk a warp: rows 16 tm .., columns
  // 16 tn ...
  {
    const int tm = warp / NT, tn = warp % NT;
    const int n0 = 16 * tn;
    // dv = A^T dy + kd dS' + beta dy.
    Tile acc;
    acc.zero();
#pragma unroll
    for (int k0 = 0; k0 < kL; k0 += 8) {
      if (k0 >= 16 * tm) {             // A[t, s] = 0 for t <= s
        float a[4], bb[2][2];
        frag_a_cols(a, as, PA, 16 * tm, k0, g, qd);
        frag_b_krow(bb, ys, P, k0, n0, g, qd);
        acc.mma(a, bb);
      }
    }
    const float* last = cs + (kL - 1) * P;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 8) {
      float a[4], bb[2][2];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int s = 16 * tm + g + 8 * (x & 1), i = k0 + qd + 4 * (x >> 1);
        a[x] = ks[s * P + i] * ex2(last[i] - cs[s * P + i]);
      }
      frag_b_krow(bb, dSg, D, k0, n0, g, qd);
      acc.mma(a, bb);
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int s = 16 * tm + g + 8 * hf, e = n0 + 8 * jj + 2 * qd;
        if (t0 + s < T) {
          const float bt = betas[s];
          *reinterpret_cast<float2*>(dv + base + (t0 + s) * row + e) =
              make_float2(acc.get(jj, 2 * hf) + bt * ys[s * P + e],
                          acc.get(jj, 2 * hf + 1) + bt * ys[s * P + e + 1]);
        }
      }
    }

    // dr = 2^{cp} (dy S^T) + sum_{m < tm} 2^{cp - cum_b} (dA[., m] K'_m)
    // + the diagonal pairs + delta u k; P = r (dr - delta u k).
    float out[2][4];
    acc.zero();
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 8) {
      float a[4], bb[2][2];
      frag_a_rows(a, ys, P, 16 * tm, k0, g, qd);
      frag_b_nrow(bb, Sg, D, k0, n0, g, qd);
      acc.mma(a, bb);
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int t = 16 * tm + g + 8 * (x >> 1), i = n0 + 8 * jj + 2 * qd +
                                                      (x & 1);
        const float f = t > 0 ? ex2(cs[(t - 1) * P + i]) : 1.0f;
        out[jj][x] = f * acc.get(jj, x) + drs[t * P + i];
      }
    }
    for (int m = 0; m < tm; ++m) {
      acc.zero();
#pragma unroll
      for (int k0 = 0; k0 < kSub; k0 += 8) {
        float a[4], bb[2][2];
        frag_a_rows(a, das, PdA, 16 * tm, kSub * m + k0, g, qd);
        frag_b_krow(bb, kps, P, kSub * m + k0, n0, g, qd);
        acc.mma(a, bb);
      }
      const float* cb = cs + (kSub * m + kSub - 1) * P;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int t = 16 * tm + g + 8 * (x >> 1),
                    i = n0 + 8 * jj + 2 * qd + (x & 1);
          out[jj][x] += ex2(cs[(t - 1) * P + i] - cb[i]) * acc.get(jj, x);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = 16 * tm + g + 8 * hf, i = n0 + 8 * jj + 2 * qd;
        const float dl = das[t * PdA + t];
        const float o0 = out[jj][2 * hf], o1 = out[jj][2 * hf + 1];
        drs[t * P + i] = rs[t * P + i] * o0;
        drs[t * P + i + 1] = rs[t * P + i + 1] * o1;
        if (t0 + t < T) {
          *reinterpret_cast<float2*>(dr + base + (t0 + t) * row + i) =
              make_float2(o0 + dl * us[i] * ks[t * P + i],
                          o1 + dl * us[i + 1] * ks[t * P + i + 1]);
        }
      }
    }

    // dk = 2^{cum_L - cum} (v dS'^T) + 2^{cum_b - cum} (dA[later, .]^T R_tm)
    // + the diagonal pairs + delta u r; Q = k (dk - delta u r).
    acc.zero();
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 8) {
      float a[4], bb[2][2];
      frag_a_rows(a, vs, P, 16 * tm, k0, g, qd);
      frag_b_nrow(bb, dSg, D, k0, n0, g, qd);
      acc.mma(a, bb);
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int s = 16 * tm + g + 8 * (x >> 1), i = n0 + 8 * jj + 2 * qd +
                                                      (x & 1);
        out[jj][x] = ex2(last[i] - cs[s * P + i]) * acc.get(jj, x) +
                     dks[s * P + i];
      }
    }
    if (tm < 3) {
      acc.zero();
      for (int k0 = kSub * (tm + 1); k0 < kL; k0 += 8) {
        float a[4], bb[2][2];
        frag_a_cols(a, das, PdA, 16 * tm, k0, g, qd);
        frag_b_krow(bb, rms + r_row(tm, k0) * P8, P8, 0, n0, g, qd);
        acc.mma(a, bb);
      }
      const float* cb = cs + (kSub * tm + kSub - 1) * P;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int s = 16 * tm + g + 8 * (x >> 1),
                    i = n0 + 8 * jj + 2 * qd + (x & 1);
          out[jj][x] += ex2(cb[i] - cs[s * P + i]) * acc.get(jj, x);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int s = 16 * tm + g + 8 * hf, i = n0 + 8 * jj + 2 * qd;
        const float dl = das[s * PdA + s];
        const float o0 = out[jj][2 * hf], o1 = out[jj][2 * hf + 1];
        dks[s * P + i] = ks[s * P + i] * o0;
        dks[s * P + i + 1] = ks[s * P + i + 1] * o1;
        if (t0 + s < T) {
          *reinterpret_cast<float2*>(dk + base + (t0 + s) * row + i) =
              make_float2(o0 + dl * us[i] * rs[s * P + i],
                          o1 + dl * us[i + 1] * rs[s * P + i + 1]);
        }
      }
    }
  }
  __syncthreads();

  // 4. dlogw_t = Z + sum_{t' >= t} (P_{t'+1} - Q_{t'}) (P_L = 0), the four
  // sub-chunks at once; du's partial sum_t delta_t r_t k_t.  The loops are
  // rolled; unrolled, either or both give the same bits in the same time
  // (kernels/sanitize_backward.py checks this on the card).
  if (tid < 4 * D) {
    const int q = tid / D, i = tid % D;
    float tot = 0.0f, dsum = 0.0f;
#pragma unroll 1
    for (int t = kSub * q + kSub - 1; t >= kSub * q; --t) {
      const float pn = t + 1 < kL ? drs[(t + 1) * P + i] : 0.0f;
      tot += pn - dks[t * P + i];
      dsum += das[t * PdA + t] * rs[t * P + i] * ks[t * P + i];
    }
    tots[q * D + i] = tot;
    dus[q * D + i] = dsum;
  }
  __syncthreads();
  if (tid < 4 * D) {
    const int q = tid / D, i = tid % D;
    float acc = zs[i];
    for (int q2 = 3; q2 > q; --q2) acc += tots[q2 * D + i];
#pragma unroll 1
    for (int t = kSub * q + kSub - 1; t >= kSub * q; --t) {
      const float pn = t + 1 < kL ? drs[(t + 1) * P + i] : 0.0f;
      acc += pn - dks[t * P + i];
      if (t0 + t < T) dw[base + (t0 + t) * row + i] = acc;
    }
  }
  if (tid < D) {
    du_parts[(static_cast<long long>(bh) * nchunks + c) * D + tid] =
        ((dus[tid] + dus[D + tid]) + dus[2 * D + tid]) + dus[3 * D + tid];
  }
}

// du[h, i]: the partials of every batch row and chunk, in that order.
__global__ void __launch_bounds__(kScanThreads)
wkv6_bwd_du_kernel(const float* __restrict__ du_parts, float* __restrict__ du,
                   int B, int H, int D, int nchunks) {
  const int x = blockIdx.x * kScanThreads + threadIdx.x;
  if (x >= H * D) return;
  const int h = x / D, i = x % D;
  float sum = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float* p = du_parts +
                     ((static_cast<long long>(b) * H + h) * nchunks) * D + i;
    for (int c = 0; c < nchunks; ++c) sum += p[c * D];
  }
  du[x] = sum;
}

template <int D>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, const float* s0, const float* dy, const float* dsT,
           float* dr, float* dk, float* dv, float* dw, float* du, float* ds0,
           float* states, float* adj, float* dec, float* du_parts, int B,
           int T, int H, cudaStream_t st) {
  using K = Cfg<D>;
  const int nchunks = (T + kL - 1) / kL;
  const unsigned blocks = static_cast<unsigned>(B) * H * nchunks;
  cudaError_t err;
  if (blocks > 0) {
    err = cudaFuncSetAttribute(wkv6_bwd_terms_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               K::kTermBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    wkv6_bwd_terms_kernel<D><<<blocks, K::kThreads, K::kTermBytes, st>>>(
        r, k, v, lw, dy, states, adj, dec, T, H, nchunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long entries = static_cast<long long>(B) * H * D * D;
  wkv6_bwd_scan_kernel<<<static_cast<unsigned>((entries + kScanThreads - 1) /
                                               kScanThreads),
                         kScanThreads, 0, st>>>(s0, dsT, states, adj, dec,
                                                ds0, entries, D, nchunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > 0) {
    err = cudaFuncSetAttribute(wkv6_bwd_grad_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               K::kGradBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    wkv6_bwd_grad_kernel<D><<<blocks, K::kThreads, K::kGradBytes, st>>>(
        r, k, v, lw, u, dy, states, adj, dr, dk, dv, dw, du_parts, T, H,
        nchunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wkv6_bwd_du_kernel<<<(H * D + kScanThreads - 1) / kScanThreads,
                       kScanThreads, 0, st>>>(du_parts, du, B, H, D, nchunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// r, k, v, logw, dy and dr, dk, dv, dlogw: (B, T, H, D), 16-byte aligned; u,
// du: (H, D); s0, dsT, ds0: (B, H, D, D); all fp32 contiguous.  Scratch:
// states (B, H, chunks + 1, D, D), adj (B, H, chunks, D, D), dec and
// du_parts (B, H, chunks, D), with chunks from wkv6_backward_config.  D
// must be 32 or 64 (the wrapper checks); returns the first CUDA error (0 on
// success), or cudaErrorInvalidValue for another D.
int wkv6_backward_launch(const float* r, const float* k, const float* v,
                         const float* lw, const float* u, const float* s0,
                         const float* dy, const float* dsT, float* dr,
                         float* dk, float* dv, float* dw, float* du,
                         float* ds0, float* states, float* adj, float* dec,
                         float* du_parts, int B, int T, int H, int D,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0) return 0;
  if (D == 64) {
    return launch<64>(r, k, v, lw, u, s0, dy, dsT, dr, dk, dv, dw, du, ds0,
                      states, adj, dec, du_parts, B, T, H, st);
  }
  if (D == 32) {
    return launch<32>(r, k, v, lw, u, s0, dy, dsT, dr, dk, dv, dw, du, ds0,
                      states, adj, dec, du_parts, B, T, H, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The scratch shapes' chunk count for T steps at head dim D.  Returns
// cudaErrorInvalidValue for another D.
int wkv6_backward_config(int T, int D, int* chunks) {
  if (T < 0 || (D != 32 && D != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *chunks = (T + kL - 1) / kL;
  return 0;
}

}  // extern "C"
