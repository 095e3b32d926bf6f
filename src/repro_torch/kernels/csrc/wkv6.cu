// RWKV6 ("Finch") wkv recurrence for Hopper (sm_90a), bound to Python through
// a plain C interface (ctypes).
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py:72 (wkv6_tiled, whose
// body is _wkv6_kernel), which ops.wkv6 runs once per RWKV layer of a
// prefill.  Per (batch, head), with a (D, D) fp32 state S:
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//   y_t = r_t^T S_{t-1} + (r_t.u.k_t) v_t
//
// evaluated in chunks of C = 64 steps.  With cum the inclusive prefix sum of
// log2(w) = log2e * logw inside a chunk, cp_t = cum_{t-1} (0 at t = 0), and
// L the chunk's last step:
//
//   y_t = (r_t 2^{cp_t}) S + sum_{s<t} A[t,s] v_s + (r_t.u.k_t) v_t
//   A[t,s] = sum_d r_t[d] k_s[d] 2^{cp_t[d] - cum_s[d]}
//   S'  = diag(2^{cum_L}) S + sum_s (k_s 2^{cum_L - cum_s}) v_s^T
//
// Sub-chunks.  The chunk is cut into four sub-chunks of 16 steps.  For a row
// t of sub-chunk i > 0 and a column s of an earlier sub-chunk, the pair
// decay is split at the boundary b = 16 i - 1:
//
//   2^{cp_t - cum_s} = 2^{cp_t - cum_b} * 2^{cum_b - cum_s}
//
// so A's off-diagonal blocks are products q~_i k~_i^T of (16 x D) by
// (D x 16 i), with q~ = r 2^{cp - cum_b} and k~ = k 2^{cum_b - cum}.  Inside
// each diagonal 16 x 16 block the lower-left 8 x 8 quarter is split the
// same way at the block's step 7, in registers; only the two 8 x 8
// diagonal quarters take a per-pair exponent (21 of their 28 pairs s < t:
// the pair s = t - 1 has exponent exactly 0), and nothing is computed for
// s >= t.  A chunk and block takes 31,744 exponentials instead of 262,144.
//
// Numerics.  No exponent is positive.  The prefix sums are added in order,
// one lane a channel, so the stored sums never increase (each step adds a
// value <= 0 and rounding is monotone); every exponent is a difference
// cum_a - cum_b with a >= b: cp_t - cum_s (s < t), cp_t - cum_b and
// cum_b - cum_s (the split keeps both factors <= 1), cum_L - cum_s, cum_L
// and cp_t.  Nothing overflows for any logw <= 0, including the model's
// clip, logw = -e^4; when one factor of the split underflows, so does the
// exact product.  The TPU kernel's factors e^{cp_t} e^{-cum_s} overflow fp32
// once a channel's decay summed over a chunk goes below about -88.7 (ROADMAP
// Queue 3).  Exponentials are ex2.approx on the log2-scaled sums.
//
// Products on the tensor cores.  q S, A v, kc^T v and the off-diagonal
// q~ k~^T blocks run as mma.sync.m16n8k8 in TF32 with the 3xTF32 split:
// a = a_hi + a_lo with a_hi the top 11 significant bits, a b ~ a_hi b_hi +
// a_hi b_lo + a_lo b_hi in fp32 -- about 2^-20 relative a product -- with
// the terms in separate accumulators so that their chains of products run
// side by side.  Plain TF32 keeps about three digits, and outputs reach
// about 134 at the serving shape.
//
// Grid.  The value columns of S are independent (y[:, e] needs only S[:, e]
// and v[:, e]), so a block owns one (b, h) and a slice of EV = D / 2 value
// columns: B H 2 blocks (512 at the serving shape, one an SM), the two
// slices of a head at adjacent indices so that their reads of r, k and logw
// meet in the L2.  Each block computes A, q and kc itself.  A cluster of
// the two blocks that split that work and wrote each half into both
// through distributed shared memory ran slower on the H100: the blocks then
// wait on each other at two cluster barriers a chunk.  The block's D x EV
// slice of S lives in the accumulator registers of the warps that update
// it, with a copy in shared memory for q S.
//
// Inside a block (512 threads at D = 64, 256 at D = 32), per chunk, with two
// block barriers:
//   1. thread 0 starts the next chunk's r, k and logw as three TMA boxes of
//      64 steps x D on the next stage's mbarrier (steps past T arrive as
//      zeros, so the host never pads T), every thread its piece of the v
//      slice with cp.async;
//   2. warps 0 .. D/8 - 1 each take one diagonal block and 32 channels,
//      lane = channel: 16 rows of r, k, cum in registers, the block's 120
//      pair terms (the split quarter's as products of its two factors),
//      reduced across lanes in four transposed reductions of 32
//      (at D = 64 the second channel half adds onto the first after a named
//      barrier), then q and kc; the other warps form q~ and k~, then the
//      off-diagonal blocks of A on the tensor cores, the bonus r.u.k and
//      the decay 2^{cum_L};
//   3. half the warps take one 16 x 16 tile of y (q S + A v + bonus v)
//      each, the other half one 16 x 16 tile of the state update, whose
//      values stay in their registers from chunk to chunk (two 8-column
//      halves share each A fragment and its split); the first D/32 state
//      warps also take the next chunk's prefix sums.
// Zero rows past T add nothing to A, y's kept rows, kc or cum.
//
// Shared memory: 222,208 bytes at D = 64 (one block an SM), 122,624 at
// D = 32.  Two stages of r, k, cum (64 x D, dense as TMA writes them) and v
// (64 x (EV+8)); q (64 x (D+4)), q~ (48 x (D+4)), k~ (96 x (D+4)), kc
// (64 x (D+8)), A (64 x 68), the S slice (D x (EV+8)), u, the decay and the
// bonus; the padded rows put mma fragments on distinct banks.
//
// What bounds it.  The function reads r, k, v, logw once and writes y once
// (20 bytes per (t, h, d) element) plus s0 and sT: 679.5 MB, 0.2028 ms at
// the full-width serving shape on an H100; its step recurrence's 10.9 GFLOP
// would take 0.163 ms on the fp32 pipes.  This design's own floors are the
// special-function unit (31,744 exponentials a chunk and block at 16 a
// clock an SM: about 2,000 clocks) and the tensor cores (1,296 mma.sync a
// chunk and block: about 2,260 clocks at the 0.57 a clock an SM that
// kernels/profile_wkv6.py measures for m16n8k8 TF32).  With 16 warps an SM
// and a dependent chain in every phase, neither unit is kept busy: the
// issue of the instructions around them and the waits between the phases
// set the pace (PERF.md).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;          // steps per chunk
constexpr int kSub = 16;            // steps per sub-chunk
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// Phase clocks for repro_torch/kernels/profile_wkv6.py, which builds this
// file with -DWKV6_PROFILE: lane 0 of every warp of block 0 adds the clocks
// each phase of a chunk took.  Without the macro the marks compile to
// nothing.
#ifdef WKV6_PROFILE
constexpr int kMarks = 9;
__device__ unsigned long long g_phase_clocks[32 * kMarks];
#define WKV6_MARK_START() long long wkv6_prev = clock64()
#define WKV6_MARK(n)                                                \
  do {                                                              \
    const long long now = clock64();                                \
    if (blockIdx.x == 0 && lane == 0) {                             \
      g_phase_clocks[warp * kMarks + (n)] += now - wkv6_prev;       \
    }                                                               \
    wkv6_prev = now;                                                \
  } while (0)
#else
#define WKV6_MARK_START() do {} while (0)
#define WKV6_MARK(n) do {} while (0)
#endif

template <int D>
struct Cfg {
  static constexpr int EV = D / 2;                 // value columns a block
  static constexpr int kSlices = D / EV;
  static constexpr int kThreads = D == 64 ? 512 : 256;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kGroups = D / 32;           // 32-channel groups
  static constexpr int kDiagWarps = 4 * kGroups;   // (sub-chunk, group)
  static constexpr int kOtherWarps = kWarps - kDiagWarps;
  static constexpr int kTilesN = EV / 16;          // 16-column tiles a row
  static constexpr int kYWarps = 4 * kTilesN;      // one 16 x 16 y tile each
  static constexpr int kStateWarps = (D / 16) * kTilesN;   // one S tile each
  static constexpr int PS = D;                     // stage rows (TMA, dense)
  static constexpr int P = D + 4;                  // rows of D channels
  static constexpr int PV = EV + 8;                // rows of EV columns
  static constexpr int PK = D + 8;                 // kc, read transposed
  static constexpr int PA = kChunk + 4;            // rows of A
  // One stage: r, k, cum (C x PS), v (C x PV).
  static constexpr int kStage = 3 * kChunk * PS + kChunk * PV;
  static constexpr int kQ = kChunk * P;
  static constexpr int kQt = (kChunk - kSub) * P;
  static constexpr int kKt = 96 * P;               // 16 + 32 + 48 rows
  static constexpr int kKc = kChunk * PK;
  static constexpr int kA = kChunk * PA;
  static constexpr int kS = D * PV;
  static constexpr int kFloats =
      2 * kStage + kQ + kQt + kKt + kKc + kA + kS + D + D + kChunk;
  static constexpr int kBytes = kFloats * 4;
  static_assert(kYWarps + kStateWarps <= kWarps, "one tile a warp");
  static_assert(kStateWarps >= D / 32, "the scan runs on state warps");
  static_assert(kChunk % kOtherWarps == 0 && kChunk / kOtherWarps <= 32,
                "bonus: whole rows a warp, one a lane");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x * 2^(a - b), elementwise.
__device__ __forceinline__ float4 scale_ex2(float4 x, float4 a, float4 b) {
  return make_float4(x.x * ex2(a.x - b.x), x.y * ex2(a.y - b.y),
                     x.z * ex2(a.z - b.z), x.w * ex2(a.w - b.w));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// x = hi + lo: hi keeps the 10 explicit mantissa bits a TF32 operand has
// (truncated: one logic op), lo = x - hi is exact in fp32, and the tensor
// core reads lo's top 10 bits.  Each part carries 11 significant bits, so
// hi b_hi + hi b_lo + lo b_hi misses x b by about 2^-20 relative.
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

// Two 16 x 8 tiles side by side that share the A fragment:
// c[j] + x[j] + z[j] += a b_j, with b[j] = {b0, b1} of tile j; the three
// terms of 3xTF32 go to three accumulators, so no chain of products waits
// on another.
__device__ __forceinline__ void mma2_3xtf32(float (&c)[2][4],
                                            float (&x)[2][4],
                                            float (&z)[2][4],
                                            const float (&a)[4],
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

// Fragments of m16n8k8 (g = lane / 4, q = lane % 4).  A row-major in x with
// row stride ld, tile at (r0, k0): rows g, g+8, columns q, q+4.
__device__ __forceinline__ void frag_a_rows(float (&a)[4], const float* x,
                                            int ld, int r0, int k0, int g,
                                            int q) {
  const float* p = x + (r0 + g) * ld + k0 + q;
  a[0] = p[0];
  a[1] = p[8 * ld];
  a[2] = p[4];
  a[3] = p[8 * ld + 4];
}

// A stored transposed (element (m, k) at x[k * ld + m]).
__device__ __forceinline__ void frag_a_cols(float (&a)[4], const float* x,
                                            int ld, int r0, int k0, int g,
                                            int q) {
  const float* p = x + (k0 + q) * ld + r0 + g;
  a[0] = p[0];
  a[1] = p[8];
  a[2] = p[4 * ld];
  a[3] = p[4 * ld + 8];
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = full ? 16 : 0;                     // 0: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// One TMA load of a (64 steps x D channels) box of a (B, T, H, D) tensor,
// counted on bar; steps past T arrive as zeros.
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         int h, int t0, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(0),
         "r"(h), "r"(t0), "r"(b), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// One step of the transposed reduction: lanes that differ in bit HALF swap
// halves of v and add.  Constant trip counts keep v in registers (a
// conditional between two elements of v would be an lvalue with a runtime
// address, and move v to local memory).
template <int HALF>
__device__ __forceinline__ void reduce_step(float (&v)[32], int lane) {
  const bool upper = lane & HALF;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const float lo = v[j], hi = v[j + HALF];
    const float send = upper ? lo : hi;
    const float keep = upper ? hi : lo;
    v[j] = keep + __shfl_xor_sync(kFull, send, HALF);
  }
}

// Transposed reduction: lane l ends with the sum over lanes of v[l] in v[0].
__device__ __forceinline__ void reduce_scatter32(float (&v)[32], int lane) {
  reduce_step<16>(v, lane);
  reduce_step<8>(v, lane);
  reduce_step<4>(v, lane);
  reduce_step<2>(v, lane);
  reduce_step<1>(v, lane);
}

// Prefix sums of log2(w) over a stage's 64 rows, in place, by the warps
// with sw = 0 .. D/32 - 1, lane = channel: each lane walks its channel's
// rows in shared memory.  Adding values <= 0 one after another keeps the
// stored sums non-increasing exactly (a parallel scan rounds each prefix
// differently and needs an exact prefix minimum on top).
template <int D>
__device__ __forceinline__ void scan_chunk(float* cs, int sw, int lane) {
  using K = Cfg<D>;
  if (sw >= 0 && sw < D / 32) {
    float* col = cs + 32 * sw + lane;
    float run = 0.0f;
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      run += col[t * K::PS] * kLog2e;
      col[t * K::PS] = run;
    }
  }
}

// Queue the chunk at t0 into a stage: r, k and logw as one TMA box each
// (issued by thread 0, counted on the stage's mbarrier), the block's v
// slice with cp.async (rows past T zero-filled).
template <int D>
__device__ __forceinline__ void load_chunk(
    float* st, uint64_t* bar, const CUtensorMap* mr, const CUtensorMap* mk,
    const CUtensorMap* mw, const float* __restrict__ v, long long base,
    long long row, int t0, int L, int b, int h, int e0, int tid) {
  using K = Cfg<D>;
  float* rs = st;
  float* ks = rs + kChunk * K::PS;
  float* cs = ks + kChunk * K::PS;
  float* vs = cs + kChunk * K::PS;
  if (tid == 0) {
    // The stage was last read and written through the generic proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(3 * kChunk * D * 4) : "memory");
    tma_load(rs, mr, h, t0, b, bar);
    tma_load(ks, mk, h, t0, b, bar);
    tma_load(cs, mw, h, t0, b, bar);
  }
  constexpr int QV = K::EV / 4;                    // 16-byte pieces a row
  for (int i = tid; i < kChunk * QV; i += K::kThreads) {
    const int t = i / QV, c = (i % QV) * 4;
    const bool ok = t < L;
    const long long g = base + (t0 + (ok ? t : 0)) * row + e0 + c;
    cp_async16(vs + t * K::PV + c, v + g, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
wkv6_kernel(const __grid_constant__ CUtensorMap map_r,
            const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_w,
            const float* __restrict__ v, const float* __restrict__ u,
            const float* __restrict__ s0, float* __restrict__ y,
            float* __restrict__ sT, int T, int H) {
  using K = Cfg<D>;
  constexpr int C = kChunk, P = K::P, PS = K::PS, PV = K::PV, PK = K::PK;
  constexpr int PA = K::PA;
  constexpr int EV = K::EV;
  extern __shared__ __align__(128) float smem[];  // TMA boxes: 128 B
  __shared__ __align__(8) uint64_t bars[2];        // one a stage
  float* stage0 = smem;
  float* q_s = stage0 + 2 * K::kStage;   // r 2^{cp}
  float* qt_s = q_s + K::kQ;             // rows 16..63: r 2^{cp - cum_b}
  float* kt_s = qt_s + K::kQt;           // boundaries 1..3: k 2^{cum_b - cum}
  float* kc_s = kt_s + K::kKt;           // k 2^{cum_L - cum}
  float* a_s = kc_s + K::kKc;            // pair matrix, strictly lower
  float* s_s = a_s + K::kA;              // the block's slice of S
  float* u_s = s_s + K::kS;
  float* dec_s = u_s + D;                // 2^{cum_L}
  float* bonus_s = dec_s + D;            // r_t . u . k_t

  const int slice = blockIdx.x % K::kSlices;
  const int bh = blockIdx.x / K::kSlices;      // b * H + h
  const int b = bh / H, h = bh - (bh / H) * H;
  const int e0 = slice * EV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;
  const long long row = static_cast<long long>(H) * D;   // stride of t
  const long long base = (static_cast<long long>(b) * T * H + h) * D;
  const int nchunks = (T + C - 1) / C;

  for (int i = tid; i < K::kA; i += K::kThreads) a_s[i] = 0.0f;
  for (int i = tid; i < D; i += K::kThreads) u_s[i] = u[h * D + i];
  // The state tile of warp kYWarps + sw: rows d = 16 sm + g (+8), columns
  // e0 + 16 sn + 8 j + 2 qd (+1), j = 0, 1, in the accumulator layout.
  const int sw = warp - K::kYWarps;
  const bool owns_state = sw >= 0 && sw < K::kStateWarps;
  const int sm = sw / K::kTilesN, sn = sw % K::kTilesN;
  float st[2][4] = {};
  const float* s0p = s0 + static_cast<long long>(bh) * D * D;
  if (owns_state) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d0 = 16 * sm + g, e = 16 * sn + 8 * j + 2 * qd;
      const float2 lo =
          *reinterpret_cast<const float2*>(s0p + d0 * D + e0 + e);
      const float2 hi =
          *reinterpret_cast<const float2*>(s0p + (d0 + 8) * D + e0 + e);
      st[j][0] = lo.x; st[j][1] = lo.y; st[j][2] = hi.x; st[j][3] = hi.y;
      s_s[d0 * PV + e] = st[j][0];
      s_s[d0 * PV + e + 1] = st[j][1];
      s_s[(d0 + 8) * PV + e] = st[j][2];
      s_s[(d0 + 8) * PV + e + 1] = st[j][3];
    }
  }
  // Where lane's four pair sums go in a diagonal block: pair p = 32 j +
  // lane is (t, s) with p = t (t - 1) / 2 + s, s < t; -1 past the 120 pairs.
  int pair_at[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = 32 * j + lane;
    int t = 1;
    while (t * (t + 1) / 2 <= p) ++t;
    pair_at[j] = p < 120 ? t * PA + p - t * (t - 1) / 2 : -1;
  }
  if (tid == 0) {
    bar_init(&bars[0]);
    bar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (nchunks > 0) {
    load_chunk<D>(stage0, &bars[0], &map_r, &map_k, &map_w, v, base, row, 0,
                  min(C, T), b, h, e0, tid);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    bar_wait(&bars[0], 0);
    __syncthreads();
    scan_chunk<D>(stage0 + 2 * C * PS, warp, lane);   // any D/32 warps
  }
  __syncthreads();

  for (int c = 0; c < nchunks; ++c) {
    WKV6_MARK_START();
    const int t0 = c * C;
    const int L = min(C, T - t0);
    float* rs = stage0 + (c & 1) * K::kStage;
    float* ks = rs + C * PS;
    float* cs = ks + C * PS;
    float* vs = cs + C * PS;
    if (c + 1 < nchunks) {
      load_chunk<D>(stage0 + ((c + 1) & 1) * K::kStage, &bars[(c + 1) & 1],
                    &map_r, &map_k, &map_w, v, base, row, t0 + C,
                    min(C, T - t0 - C), b, h, e0, tid);
    }
    WKV6_MARK(0);

    if (warp < K::kDiagWarps) {
      // 2a. one diagonal block i and 32 channels, lane = channel.
      const int i = warp % 4, grp = warp / 4;
      const int d = 32 * grp + lane;
      float rr[kSub], kk[kSub], cu[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int t = kSub * i + j;
        rr[j] = rs[t * PS + d];
        kk[j] = ks[t * PS + d];
        cu[j] = cs[t * PS + d];
      }
      // The block's lower-left 8 x 8 quarter splits its decay again, at
      // the block's step 7 (both factors <= 1): kb = k 2^{cum_7 - cum_s}
      // for s < 8 and, row by row, qb = r 2^{cp_t - cum_7} for t >= 8.
      // Only the two 8 x 8 diagonal quarters take a per-pair exponent.
      constexpr int kHalf = kSub / 2;
      float kb[kHalf];
#pragma unroll
      for (int s = 0; s < kHalf; ++s) {
        kb[s] = s == kHalf - 1 ? kk[s] : kk[s] * ex2(cu[kHalf - 1] - cu[s]);
      }
      float sums[4];
      float vals[32];
      // Both loops have constant trip counts, so they unroll fully and
      // every index below is a constant: the arrays stay in registers.
#pragma unroll
      for (int t = 1; t < kSub; ++t) {
        const float qb = t <= kHalf ? rr[t]
                                    : rr[t] * ex2(cu[t - 1] - cu[kHalf - 1]);
#pragma unroll
        for (int s = 0; s < kSub; ++s) {
          if (s < t) {                             // only pairs s < t
            const int p = t * (t - 1) / 2 + s;
            float term;
            if (t >= kHalf && s < kHalf) {
              term = qb * kb[s];
            } else {
              term = rr[t] * kk[s];
              if (s < t - 1) term *= ex2(cu[t - 1] - cu[s]);
            }
            vals[p & 31] = term;
            if ((p & 31) == 31) {
              reduce_scatter32(vals, lane);
              sums[p >> 5] = vals[0];
            }
          }
        }
      }
#pragma unroll
      for (int j = 120 - 96; j < 32; ++j) vals[j] = 0.0f;
      reduce_scatter32(vals, lane);
      sums[3] = vals[0];
      WKV6_MARK(1);
      if (K::kGroups == 2 && grp == 1) named_sync(2 + i, 64);
      float* blk = a_s + kSub * i * (PA + 1);     // the diagonal block
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (pair_at[j] >= 0) {
          float* dst = blk + pair_at[j];
          *dst = grp == 0 ? sums[j] : *dst + sums[j];
        }
      }
      if (K::kGroups == 2 && grp == 0) named_arrive(2 + i, 64);
      WKV6_MARK(2);
      // 2e. q and kc, four channels a thread (these warps finish their
      // pairs before the others finish q~, k~ and the off-diagonal blocks).
      constexpr int D4 = D / 4;
      for (int x = tid; x < C * D4; x += 32 * K::kDiagWarps) {
        const int t = x / D4, d = (x % D4) * 4;
        const float4 cum_l = ld4(cs + (C - 1) * PS + d);
        const float4 rt = ld4(rs + t * PS + d);
        st4(q_s + t * P + d,
            t > 0 ? scale_ex2(rt, ld4(cs + (t - 1) * PS + d),
                              make_float4(0.0f, 0.0f, 0.0f, 0.0f))
                  : rt);
        st4(kc_s + t * PK + d,
            scale_ex2(ld4(ks + t * PS + d), cum_l, ld4(cs + t * PS + d)));
      }
      WKV6_MARK(4);
    } else {
      const int ew = warp - K::kDiagWarps;
      const int etid = tid - 32 * K::kDiagWarps;
      constexpr int kEThreads = 32 * K::kOtherWarps;
      // 2b. q~ (rows 16..63) and k~ (boundaries 1..3), four channels a
      // thread.
      constexpr int D4 = D / 4;
      for (int x = etid; x < (C - kSub) * D4; x += kEThreads) {
        const int t = kSub + x / D4, d = (x % D4) * 4;
        const int bnd = (t / kSub) * kSub - 1;
        st4(qt_s + (t - kSub) * P + d,
            scale_ex2(ld4(rs + t * PS + d), ld4(cs + (t - 1) * PS + d),
                      ld4(cs + bnd * PS + d)));
      }
      for (int x = etid; x < 96 * D4; x += kEThreads) {
        const int rho = x / D4, d = (x % D4) * 4;
        const int i = rho < 16 ? 1 : (rho < 48 ? 2 : 3);
        const int s = rho - 8 * i * (i - 1);
        const int bnd = kSub * i - 1;
        st4(kt_s + rho * P + d,
            scale_ex2(ld4(ks + s * PS + d), ld4(cs + bnd * PS + d),
                      ld4(cs + s * PS + d)));
      }
      WKV6_MARK(1);
      named_sync(1, kEThreads);
      WKV6_MARK(2);
      // 2c. off-diagonal blocks of A: six 16 x 16 tiles.
      for (int tau = ew; tau < 6; tau += K::kOtherWarps) {
        const int i = tau < 1 ? 1 : (tau < 3 ? 2 : 3);
        const int jp = tau - (i == 1 ? 0 : (i == 2 ? 1 : 3));
        const float* kt = kt_s + (8 * i * (i - 1) + 16 * jp + g) * P;
        float acc[2][4] = {}, cross[2][4] = {}, cross2[2][4] = {};
#pragma unroll
        for (int k0 = 0; k0 < D; k0 += 8) {
          float a[4], bk[2][2];
          frag_a_rows(a, qt_s, P, kSub * (i - 1), k0, g, qd);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            bk[j][0] = kt[8 * j * P + k0 + qd];
            bk[j][1] = kt[8 * j * P + k0 + qd + 4];
          }
          mma2_3xtf32(acc, cross, cross2, a, bk);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float* dst = a_s + (kSub * i + g) * PA + 16 * jp + 8 * j + 2 * qd;
          *reinterpret_cast<float2*>(dst) =
              make_float2(acc[j][0] + (cross[j][0] + cross2[j][0]),
                          acc[j][1] + (cross[j][1] + cross2[j][1]));
          *reinterpret_cast<float2*>(dst + 8 * PA) =
              make_float2(acc[j][2] + (cross[j][2] + cross2[j][2]),
                          acc[j][3] + (cross[j][3] + cross2[j][3]));
        }
      }
      WKV6_MARK(3);
      // 2d. the decay and the bonus.
      for (int d = etid; d < D; d += kEThreads) {
        dec_s[d] = ex2(cs[(C - 1) * PS + d]);
      }
      // The warp's rows side by side, so their reductions overlap.
      constexpr int kRows = C / K::kOtherWarps;
      float bonus[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int t = ew + j * K::kOtherWarps;
        bonus[j] = 0.0f;
#pragma unroll
        for (int d0 = 0; d0 < D; d0 += 32) {
          bonus[j] += rs[t * PS + d0 + lane] * u_s[d0 + lane] *
                      ks[t * PS + d0 + lane];
        }
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          bonus[j] += __shfl_xor_sync(kFull, bonus[j], o);
        }
      }
      if (lane < kRows) {
        float mine = bonus[0];
#pragma unroll
        for (int j = 1; j < kRows; ++j) {
          if (lane == j) mine = bonus[j];
        }
        bonus_s[ew + lane * K::kOtherWarps] = mine;
      }
      WKV6_MARK(4);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    if (c + 1 < nchunks) bar_wait(&bars[(c + 1) & 1], ((c + 1) >> 1) & 1);
    __syncthreads();                   // A, q, kc and the next stage are in
    WKV6_MARK(5);

    // 3. y = q S + A v + bonus v on warps 0 .. kYWarps - 1: tile (ym, yn)
    // of 16 rows x 16 columns, one A fragment for two 8-column halves.
    if (warp < K::kYWarps) {
      const int ym = warp / K::kTilesN, yn = warp % K::kTilesN;
      float acc[2][4] = {}, cross[2][4] = {}, cross2[2][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 8) {
        float a[4], bv[2][2];
        frag_a_rows(a, q_s, P, 16 * ym, k0, g, qd);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* bp = s_s + (k0 + qd) * PV + 16 * yn + 8 * j + g;
          bv[j][0] = bp[0];
          bv[j][1] = bp[4 * PV];
        }
        mma2_3xtf32(acc, cross, cross2, a, bv);
      }
#pragma unroll
      for (int k0 = 0; k0 < C; k0 += 8) {
        if (k0 < 16 * (ym + 1)) {      // A is zero past the diagonal block
          float a[4], bv[2][2];
          frag_a_rows(a, a_s, PA, 16 * ym, k0, g, qd);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float* bp = vs + (k0 + qd) * PV + 16 * yn + 8 * j + g;
            bv[j][0] = bp[0];
            bv[j][1] = bp[4 * PV];
          }
          mma2_3xtf32(acc, cross, cross2, a, bv);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 16 * yn + 8 * j + 2 * qd;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = 16 * ym + g + 8 * half;
          if (t < L) {
            const float bt = bonus_s[t];
            const float2 out = make_float2(
                acc[j][2 * half] + (cross[j][2 * half] + cross2[j][2 * half]) +
                    bt * vs[t * PV + e],
                acc[j][2 * half + 1] +
                    (cross[j][2 * half + 1] + cross2[j][2 * half + 1]) +
                    bt * vs[t * PV + e + 1]);
            *reinterpret_cast<float2*>(y + base + (t0 + t) * row + e0 + e) =
                out;
          }
        }
      }
    }
    WKV6_MARK(6);
    // The next chunk's prefix sums on the first state warps, beside the
    // products.  (After the last chunk this scans a spent stage, whose sums
    // nothing reads.)
    scan_chunk<D>(stage0 + ((c + 1) & 1) * K::kStage + 2 * C * PS, sw, lane);
    WKV6_MARK(7);
    // S' = diag(2^{cum_L}) S + kc^T v on the warp's 16 x 16 state tile.
    if (owns_state) {
      const float dlo = dec_s[16 * sm + g], dhi = dec_s[16 * sm + g + 8];
      float cross[2][4] = {}, cross2[2][4] = {};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        st[j][0] *= dlo;
        st[j][1] *= dlo;
        st[j][2] *= dhi;
        st[j][3] *= dhi;
      }
#pragma unroll
      for (int k0 = 0; k0 < C; k0 += 8) {
        float a[4], bv[2][2];
        frag_a_cols(a, kc_s, PK, 16 * sm, k0, g, qd);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* bp = vs + (k0 + qd) * PV + 16 * sn + 8 * j + g;
          bv[j][0] = bp[0];
          bv[j][1] = bp[4 * PV];
        }
        mma2_3xtf32(st, cross, cross2, a, bv);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) st[j][i] += cross[j][i] + cross2[j][i];
      }
    }
    __syncthreads();                   // every read of this chunk is done
    if (owns_state) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d0 = 16 * sm + g, e = 16 * sn + 8 * j + 2 * qd;
        s_s[d0 * PV + e] = st[j][0];
        s_s[d0 * PV + e + 1] = st[j][1];
        s_s[(d0 + 8) * PV + e] = st[j][2];
        s_s[(d0 + 8) * PV + e + 1] = st[j][3];
      }
    }
    WKV6_MARK(8);
  }

  if (owns_state) {
    float* sTp = sT + static_cast<long long>(bh) * D * D;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d0 = 16 * sm + g, e = 16 * sn + 8 * j + 2 * qd;
      *reinterpret_cast<float2*>(sTp + d0 * D + e0 + e) =
          make_float2(st[j][0], st[j][1]);
      *reinterpret_cast<float2*>(sTp + (d0 + 8) * D + e0 + e) =
          make_float2(st[j][2], st[j][3]);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A (B, T, H, D) fp32 tensor as 4-d TMA boxes of 64 steps x D channels of one
// (b, h); steps past T are filled with zeros.
bool make_map(CUtensorMap* map, const float* x, int B, int T, int H, int D) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(D) * 4, static_cast<cuuint64_t>(H) * D * 4,
      static_cast<cuuint64_t>(T) * H * D * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D), 1, kChunk, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<float*>(x), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, const float* s0, float* y, float* sT, int B,
           int T, int H, cudaStream_t st) {
  using K = Cfg<D>;
  CUtensorMap map_r, map_k, map_w;
  if (T > 0 && !(make_map(&map_r, r, B, T, H, D) &&
                 make_map(&map_k, k, B, T, H, D) &&
                 make_map(&map_w, lw, B, T, H, D))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_kernel<D><<<B * H * K::kSlices, K::kThreads, K::kBytes, st>>>(
      map_r, map_k, map_w, v, u, s0, y, sT, T, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// r, k, v, logw, y: (B, T, H, D) fp32 contiguous, 16-byte aligned; u:
// (H, D); s0, sT: (B, H, D, D).  D must be 32 or 64 (the wrapper checks);
// returns the first CUDA error (0 on success), or cudaErrorInvalidValue for
// another D.
int wkv6_launch(const float* r, const float* k, const float* v,
                const float* lw, const float* u, const float* s0, float* y,
                float* sT, int B, int T, int H, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0) return 0;
  if (D == 64) return launch<64>(r, k, v, lw, u, s0, y, sT, B, T, H, st);
  if (D == 32) return launch<32>(r, k, v, lw, u, s0, y, sT, B, T, H, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch shape for head dim D: threads a block, blocks a (b, h) and
// dynamic shared memory a block.  Returns cudaErrorInvalidValue for another
// D.
int wkv6_config(int D, int* threads, int* slices, int* smem_bytes) {
  if (D == 64) {
    *threads = Cfg<64>::kThreads;
    *slices = Cfg<64>::kSlices;
    *smem_bytes = Cfg<64>::kBytes;
    return 0;
  }
  if (D == 32) {
    *threads = Cfg<32>::kThreads;
    *slices = Cfg<32>::kSlices;
    *smem_bytes = Cfg<32>::kBytes;
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef WKV6_PROFILE
// Copy the phase clocks out (32 warps x 9 marks), or set them to 0.
int wkv6_phase_clocks(unsigned long long* out, int reset) {
  if (reset) {
    static const unsigned long long zeros[32 * kMarks] = {};
    return static_cast<int>(
        cudaMemcpyToSymbol(g_phase_clocks, zeros, sizeof(zeros)));
  }
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(g_phase_clocks)));
}
#endif

}  // extern "C"
