// The gradient of the RWKV6 wkv recurrence for Hopper (sm_90a), bound to
// Python through a plain C interface (ctypes).
//
// Replaces no TPU kernel: the reference differentiates
// src/repro/models/rwkv.py:76 (wkv6_chunked) by XLA autodiff.  It is here
// because the port runs the forward on its own kernel (wkv6.cu), which
// autograd cannot see into; kernels/wkv6.py's Wkv6Function calls it.
//
// Per (batch, head), with the forward's notation (wkv6.cu): chunks of L
// steps (here L = 32), cum the inclusive prefix sum of log2(w) = log2e *
// logw inside a chunk, cp_t = cum_{t-1} (0 at t = 0), S and S' the
// chunk's start and end states, dS' the adjoint carried in from the next
// chunk (dsT for the last), beta_t = r_t.u.k_t, delta_t = dy_t.v_t and
// A[t,s] = sum_i r_t[i] k_s[i] 2^{cp_t[i] - cum_s[i]} (s < t):
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
// and ds0 is dS after the first chunk.  Every exponent is a difference
// cum_a - cum_b with a >= b (the sums are added in order, so they never
// increase), so nothing overflows for any logw <= 0, the model's clip
// logw = -e^4 included.  Each pair takes its own exponent (exp2f): no
// factorization that could overflow, at the cost of recomputing it in
// each of the three pair sums (A, dr's and dk's).
//
// Chunk-start states.  The forward saves nothing: this kernel recomputes
// them from s0 in a first sweep over the chunks (S' = diag(2^{cum_L}) S +
// sum_s (k_s 2^{cum_L - cum_s}) v_s^T, 2 L D EV flops a chunk and block)
// into a scratch buffer (B, H, chunks, D, D), and reads them back in the
// reverse sweep (the last chunk's end state stays in registers).
//
// Grid.  Every term above is linear in the value columns of S, dS', v and
// dy, and a column e of dS and of dv needs only column e of dS', dy and v.
// So a block owns one (b, h) and a slice of EV = 16 value columns (D / 16
// blocks a head: 128 at rwkv6-1.6b's training shape (1, 4096, 32, 64),
// where one block a head would fill 32 of the 132 SMs).  dv and ds0 are
// written whole by their slice; a slice's dA, delta, S dy, dS' v and Z are
// partial sums over its columns, so its dr, dk, dlogw and du are partials
// too.  They go to a scratch buffer (3, slices, B, T, H, D) and a second
// kernel adds them in slice order (du also over B): no float atomics, two
// runs give the same bits.  A (which needs every channel, no column) is
// computed by every slice of the head.
//
// Inside a block (512 threads), per chunk of the reverse sweep, with six
// block barriers: Z from the carried dS' and the state the next chunk
// started from; r, k, logw, the v and dy slices and the chunk-start state
// slice into shared memory from registers (rows past T as zeros, which add
// nothing), and the previous chunk's loads issued into those registers, in
// flight while this chunk computes (the state sweep does the same); the
// prefix sums, one thread a channel; 2^{cp}, 2^{cum_L - cum}, 2^{cum_L},
// beta, delta, dA and A; dr (and P), dk (and Q) and dv; the reverse prefix
// for dlogw, du, and the dS update.  Every loop strides one element a
// thread over its (row, channel) or (row, column) grid; shared rows are
// padded by one float so that a warp's accesses fall on distinct banks.
// A first build, which loaded each chunk's inputs where it used them with
// 256 threads a block, waited on those loads and on the shared-memory
// and exponential latencies that too few warps could not hide.
//
// What bounds it.  The function reads r, k, v, logw and dy and writes dr,
// dk, dv and dlogw once: at (1, 4096, 32, 64) nine tensors of 33.55 MB,
// about 302 MB, 0.090 ms at 3.35 TB/s (plus s0, dsT, u and their
// gradients, 1.1 MB).  Its operations, counted as the step recurrence
// needs them (the state update again, 3 D^2 a step and head; the
// adjoint's products G v and G^T k, 2 D^2 each; dlogw's rowsum of G * S
// and dr's S dy, 2 D^2 each; the adjoint's update, 3 D^2), are 14 D^2 a
// step and head, 7.6 GFLOP, 0.114 ms at 67 TFLOP/s fp32: it is bound by
// operations at that shape, by a little.  This kernel does more: the pair
// sums take L (L - 1) / 2 * D exponentials three times a chunk and block,
// every slice of a head recomputes A and the states, and the partials move
// 2 x 3 x slices tensors of the output's size (about 0.8 GB at that
// shape).  It runs on the CUDA cores in fp32 with no tensor-core product
// and no TMA: a simple kernel first.

#include <cuda_runtime.h>

namespace {

constexpr int kL = 32;              // steps a chunk
constexpr int kEV = 16;             // value columns a block
constexpr int kThreads = 512;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kSlices = D / kEV;
  static constexpr int P = D + 1;          // rows of D channels
  static constexpr int PE = kEV + 1;       // rows of EV columns
  static constexpr int PL = kL + 1;        // rows of the (L x L) pair grids
  static constexpr int kRows = kL * P;
  static constexpr int kFloats = 7 * kRows          // r k cum 2^cp kd P Q
                                 + 2 * kL * PE      // v dy
                                 + 2 * D * PE       // S dS
                                 + 2 * kL * PL      // A dA
                                 + 3 * D            // u 2^cum_L Z
                                 + 2 * kL;          // beta delta
  static constexpr int kBytes = kFloats * 4;
  static constexpr int kOwn = D * kEV / kThreads;   // state entries a thread
  static_assert(D % kEV == 0 && (D * kEV) % kThreads == 0, "layout");
  static_assert(D <= kThreads && kL <= kThreads, "one thread a channel");
};

// A thread's share of rows t0 .. t0 + L - 1, columns c0 .. c0 + W - 1 of a
// (B, T, H, D) tensor at (b, h): element j is (t, c) with t W + c = tid +
// kThreads j; rows outside [0, T) as zeros.  fetch_rows issues the loads
// only, so a chunk's loads are all in flight at once (and the next
// chunk's while this one computes); put_rows stores them to shared memory.
template <int W>
struct Share {
  static constexpr int kPer = kL * W / kThreads;
  static_assert((kL * W) % kThreads == 0, "whole rows a pass");
};

template <int W>
__device__ __forceinline__ void fetch_rows(float (&reg)[Share<W>::kPer],
                                           const float* __restrict__ src,
                                           long long base, long long row,
                                           int t0, int T, int c0) {
#pragma unroll
  for (int j = 0; j < Share<W>::kPer; ++j) {
    const int x = threadIdx.x + kThreads * j, t = x / W, c = x % W;
    const bool ok = t0 + t >= 0 && t0 + t < T;
    reg[j] = ok ? src[base + (t0 + t) * row + c0 + c] : 0.0f;
  }
}

template <int W>
__device__ __forceinline__ void put_rows(float* dst, int ld,
                                         const float (&reg)[Share<W>::kPer]) {
#pragma unroll
  for (int j = 0; j < Share<W>::kPer; ++j) {
    const int x = threadIdx.x + kThreads * j, t = x / W, c = x % W;
    dst[t * ld + c] = reg[j];
  }
}

// In place: cum[t][i] = log2e * sum_{j <= t} logw[j][i], added in order so
// that the sums never increase.  One thread a channel.
template <int D>
__device__ __forceinline__ void prefix_sums(float* cs) {
  constexpr int P = Cfg<D>::P;
  if (threadIdx.x < D) {
    float run = 0.0f;
    for (int t = 0; t < kL; ++t) {
      run += cs[t * P + threadIdx.x] * kLog2e;
      cs[t * P + threadIdx.x] = run;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u, const float* __restrict__ s0,
                const float* __restrict__ dy, const float* __restrict__ dsT,
                float* __restrict__ dv, float* __restrict__ ds0,
                float* __restrict__ states, float* __restrict__ parts,
                float* __restrict__ du_parts, int B, int T, int H) {
  using K = Cfg<D>;
  constexpr int P = K::P, PE = K::PE, PL = K::PL, NS = K::kSlices;
  extern __shared__ float smem[];
  float* rs = smem;                    // r
  float* ks = rs + K::kRows;           // k
  float* cs = ks + K::kRows;           // logw, then its prefix sums cum
  float* es = cs + K::kRows;           // 2^{cp}
  float* kd = es + K::kRows;           // 2^{cum_L - cum}; k 2^{..} in sweep 1
  float* ps = kd + K::kRows;           // P
  float* qs = ps + K::kRows;           // Q
  float* vs = qs + K::kRows;           // v slice
  float* ys = vs + kL * PE;            // dy slice
  float* ss = ys + kL * PE;            // S slice
  float* gs = ss + D * PE;             // dS slice (dS' on entry to a chunk)
  float* as = gs + D * PE;             // A
  float* das = as + kL * PL;           // dA
  float* us = das + kL * PL;           // u
  float* dec = us + D;                 // 2^{cum_L}
  float* zs = dec + D;                 // Z
  float* beta = zs + D;
  float* delta = beta + kL;

  const int slice = blockIdx.x % NS;
  const int bh = blockIdx.x / NS;      // b * H + h
  const int b = bh / H, h = bh - (bh / H) * H;
  const int e0 = slice * kEV;
  const int tid = threadIdx.x;
  const long long row = static_cast<long long>(H) * D;       // stride of t
  const long long base = (static_cast<long long>(b) * T * H + h) * D;
  const int nchunks = (T + kL - 1) / kL;
  const long long dd = static_cast<long long>(D) * D;
  float* st_bh = states + static_cast<long long>(bh) * nchunks * dd;
  const float* s0p = s0 + static_cast<long long>(bh) * dd;

  for (int i = tid; i < D; i += kThreads) us[i] = u[h * D + i];

  // 1. The chunk-start states of the block's columns, from s0, to the
  // scratch: entry j of the thread is (i, e) = ((tid + kThreads j) / EV, ..).
  float st[K::kOwn];
#pragma unroll
  for (int j = 0; j < K::kOwn; ++j) {
    const int x = tid + kThreads * j, i = x / kEV, e = x % kEV;
    st[j] = s0p[i * D + e0 + e];
  }
  constexpr int RD = Share<D>::kPer, RE = Share<kEV>::kPer;
  float fk[RD], fw[RD], fv[RE];        // the next chunk's inputs, in flight
  fetch_rows<D>(fk, k, base, row, 0, T, 0);
  fetch_rows<D>(fw, lw, base, row, 0, T, 0);
  fetch_rows<kEV>(fv, v, base, row, 0, T, e0);
  for (int c = 0; c < nchunks; ++c) {
#pragma unroll
    for (int j = 0; j < K::kOwn; ++j) {
      const int x = tid + kThreads * j, i = x / kEV, e = x % kEV;
      st_bh[c * dd + i * D + e0 + e] = st[j];
    }
    put_rows<D>(ks, P, fk);
    put_rows<D>(cs, P, fw);
    put_rows<kEV>(vs, PE, fv);
    __syncthreads();
    const int t1 = (c + 1) * kL;
    fetch_rows<D>(fk, k, base, row, t1, T, 0);
    fetch_rows<D>(fw, lw, base, row, t1, T, 0);
    fetch_rows<kEV>(fv, v, base, row, t1, T, e0);
    prefix_sums<D>(cs);
    __syncthreads();
    for (int x = tid; x < kL * D; x += kThreads) {
      const int t = x / D, i = x % D;
      kd[t * P + i] =
          ks[t * P + i] * exp2f(cs[(kL - 1) * P + i] - cs[t * P + i]);
    }
    for (int i = tid; i < D; i += kThreads) {
      dec[i] = exp2f(cs[(kL - 1) * P + i]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < K::kOwn; ++j) {
      const int x = tid + kThreads * j, i = x / kEV, e = x % kEV;
      float acc = dec[i] * st[j];
      for (int t = 0; t < kL; ++t) acc += kd[t * P + i] * vs[t * PE + e];
      st[j] = acc;
    }
    __syncthreads();
  }

  // 2. The reverse sweep.  Z of the last chunk takes S' = sT (the sweep's
  // last state, st); of every other chunk, the state the chunk after it
  // started from (still in ss when the chunk begins).
  const float* dsTp = dsT + static_cast<long long>(bh) * dd;
#pragma unroll
  for (int j = 0; j < K::kOwn; ++j) {
    const int x = tid + kThreads * j, i = x / kEV, e = x % kEV;
    gs[i * PE + e] = dsTp[i * D + e0 + e];
    ss[i * PE + e] = st[j];
  }
  float du_acc = 0.0f;                 // thread i < D: channel i
  const long long plane = static_cast<long long>(B) * T * row;
  float* dr_part = parts + (0LL * NS + slice) * plane;
  float* dk_part = parts + (1LL * NS + slice) * plane;
  float* dw_part = parts + (2LL * NS + slice) * plane;
  float fr[RD], fy[RE], fs[K::kOwn];
  const int tl = (nchunks - 1) * kL;
  fetch_rows<D>(fr, r, base, row, tl, T, 0);
  fetch_rows<D>(fk, k, base, row, tl, T, 0);
  fetch_rows<D>(fw, lw, base, row, tl, T, 0);
  fetch_rows<kEV>(fv, v, base, row, tl, T, e0);
  fetch_rows<kEV>(fy, dy, base, row, tl, T, e0);
#pragma unroll
  for (int j = 0; j < K::kOwn; ++j) {
    const int x = tid + kThreads * j, i = x / kEV, e = x % kEV;
    fs[j] = nchunks > 0 ? st_bh[(nchunks - 1) * dd + i * D + e0 + e] : 0.0f;
  }
  __syncthreads();
  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * kL;
    for (int i = tid; i < D; i += kThreads) {     // Z: rowsum(dS' * S')
      float z = 0.0f;
      for (int e = 0; e < kEV; ++e) z += gs[i * PE + e] * ss[i * PE + e];
      zs[i] = z;
    }
    __syncthreads();
    put_rows<D>(rs, P, fr);
    put_rows<D>(ks, P, fk);
    put_rows<D>(cs, P, fw);
    put_rows<kEV>(vs, PE, fv);
    put_rows<kEV>(ys, PE, fy);
#pragma unroll
    for (int j = 0; j < K::kOwn; ++j) {
      const int x = tid + kThreads * j, i = x / kEV, e = x % kEV;
      ss[i * PE + e] = fs[j];
    }
    __syncthreads();
    const int tp = t0 - kL;              // the previous chunk, in flight
    fetch_rows<D>(fr, r, base, row, tp, T, 0);
    fetch_rows<D>(fk, k, base, row, tp, T, 0);
    fetch_rows<D>(fw, lw, base, row, tp, T, 0);
    fetch_rows<kEV>(fv, v, base, row, tp, T, e0);
    fetch_rows<kEV>(fy, dy, base, row, tp, T, e0);
#pragma unroll
    for (int j = 0; j < K::kOwn; ++j) {
      const int x = tid + kThreads * j, i = x / kEV, e = x % kEV;
      fs[j] = c > 0 ? st_bh[(c - 1) * dd + i * D + e0 + e] : 0.0f;
    }
    prefix_sums<D>(cs);
    __syncthreads();
    // 2^{cp}, 2^{cum_L - cum}, 2^{cum_L}, beta, delta, dA and A.
    for (int x = tid; x < kL * D; x += kThreads) {
      const int t = x / D, i = x % D;
      const float last = cs[(kL - 1) * P + i];
      es[t * P + i] = t > 0 ? exp2f(cs[(t - 1) * P + i]) : 1.0f;
      kd[t * P + i] = exp2f(last - cs[t * P + i]);
    }
    for (int i = tid; i < D; i += kThreads) {
      dec[i] = exp2f(cs[(kL - 1) * P + i]);
    }
    for (int t = tid; t < kL; t += kThreads) {
      float bt = 0.0f, dt = 0.0f;
      for (int i = 0; i < D; ++i) bt += rs[t * P + i] * us[i] * ks[t * P + i];
      for (int e = 0; e < kEV; ++e) dt += ys[t * PE + e] * vs[t * PE + e];
      beta[t] = bt;
      delta[t] = dt;
    }
    for (int x = tid; x < kL * kL; x += kThreads) {
      const int t = x / kL, s = x % kL;
      float a = 0.0f, da = 0.0f;
      if (s < t) {
        for (int e = 0; e < kEV; ++e) da += ys[t * PE + e] * vs[s * PE + e];
        for (int i = 0; i < D; ++i) {
          a += rs[t * P + i] * ks[s * P + i] *
               exp2f(cs[(t - 1) * P + i] - cs[s * P + i]);
        }
      }
      as[t * PL + s] = a;
      das[t * PL + s] = da;
    }
    __syncthreads();
    // dr and P; dk and Q; dv.
    for (int x = tid; x < kL * D; x += kThreads) {
      const int t = x / D, i = x % D;
      float pair = 0.0f, sdy = 0.0f;
      for (int s = 0; s < t; ++s) {
        pair += das[t * PL + s] * ks[s * P + i] *
                exp2f(cs[(t - 1) * P + i] - cs[s * P + i]);
      }
      for (int e = 0; e < kEV; ++e) sdy += ss[i * PE + e] * ys[t * PE + e];
      const float part = es[t * P + i] * sdy + pair;
      ps[t * P + i] = rs[t * P + i] * part;
      if (t0 + t < T) {
        dr_part[base + (t0 + t) * row + i] =
            part + delta[t] * us[i] * ks[t * P + i];
      }
    }
    for (int x = tid; x < kL * D; x += kThreads) {
      const int s = x / D, i = x % D;
      float pair = 0.0f, gv = 0.0f;
      for (int t = s + 1; t < kL; ++t) {
        pair += das[t * PL + s] * rs[t * P + i] *
                exp2f(cs[(t - 1) * P + i] - cs[s * P + i]);
      }
      for (int e = 0; e < kEV; ++e) gv += gs[i * PE + e] * vs[s * PE + e];
      const float part = pair + kd[s * P + i] * gv;
      qs[s * P + i] = ks[s * P + i] * part;
      if (t0 + s < T) {
        dk_part[base + (t0 + s) * row + i] =
            part + delta[s] * us[i] * rs[s * P + i];
      }
    }
    for (int x = tid; x < kL * kEV; x += kThreads) {
      const int s = x / kEV, e = x % kEV;
      float acc = beta[s] * ys[s * PE + e];
      for (int t = s + 1; t < kL; ++t) acc += as[t * PL + s] * ys[t * PE + e];
      for (int i = 0; i < D; ++i) {
        acc += ks[s * P + i] * kd[s * P + i] * gs[i * PE + e];
      }
      if (t0 + s < T) dv[base + (t0 + s) * row + e0 + e] = acc;
    }
    __syncthreads();
    // dlogw as a reverse prefix, du, and dS' -> dS.
    if (tid < D) {
      const int i = tid;
      float acc = zs[i];
      for (int j = kL - 1; j >= 0; --j) {
        if (j + 1 < kL) acc += ps[(j + 1) * P + i];
        acc -= qs[j * P + i];
        if (t0 + j < T) dw_part[base + (t0 + j) * row + i] = acc;
        du_acc += delta[j] * rs[j * P + i] * ks[j * P + i];
      }
    }
    for (int x = tid; x < D * kEV; x += kThreads) {
      const int i = x / kEV, e = x % kEV;
      float acc = dec[i] * gs[i * PE + e];
      for (int t = 0; t < kL; ++t) {
        acc += rs[t * P + i] * es[t * P + i] * ys[t * PE + e];
      }
      gs[i * PE + e] = acc;
    }
    __syncthreads();
  }
  float* ds0p = ds0 + static_cast<long long>(bh) * dd;
  for (int x = tid; x < D * kEV; x += kThreads) {
    const int i = x / kEV, e = x % kEV;
    ds0p[i * D + e0 + e] = gs[i * PE + e];
  }
  if (tid < D) {
    du_parts[(static_cast<long long>(slice) * B * H + bh) * D + tid] = du_acc;
  }
}

// dr, dk, dlogw: the slices' partials added in slice order.
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_sum_kernel(const float* __restrict__ parts, float* __restrict__ dr,
                    float* __restrict__ dk, float* __restrict__ dw, int slices,
                    long long n) {
  const long long x = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (x >= n) return;
  float* outs[3] = {dr, dk, dw};
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    const float* p = parts + static_cast<long long>(w) * slices * n + x;
    float sum = 0.0f;
    for (int s = 0; s < slices; ++s) sum += p[s * n];
    outs[w][x] = sum;
  }
}

// du[h, i]: the partials of every batch row and slice, in that order.
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_du_kernel(const float* __restrict__ du_parts, float* __restrict__ du,
                   int slices, int B, int hd) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= hd) return;
  float sum = 0.0f;
  for (int b = 0; b < B; ++b) {
    for (int s = 0; s < slices; ++s) {
      sum += du_parts[(static_cast<long long>(s) * B + b) * hd + x];
    }
  }
  du[x] = sum;
}

template <int D>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, const float* s0, const float* dy, const float* dsT,
           float* dr, float* dk, float* dv, float* dw, float* du, float* ds0,
           float* states, float* parts, float* du_parts, int B, int T, int H,
           cudaStream_t st) {
  using K = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      K::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_kernel<D><<<B * H * K::kSlices, kThreads, K::kBytes, st>>>(
      r, k, v, lw, u, s0, dy, dsT, dv, ds0, states, parts, du_parts, B, T, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = static_cast<long long>(B) * T * H * D;
  if (n > 0) {
    wkv6_bwd_sum_kernel<<<static_cast<unsigned>((n + kThreads - 1) /
                                                kThreads),
                          kThreads, 0, st>>>(parts, dr, dk, dw, K::kSlices, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wkv6_bwd_du_kernel<<<(H * D + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      du_parts, du, K::kSlices, B, H * D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// r, k, v, logw, dy and dr, dk, dv, dlogw: (B, T, H, D); u, du: (H, D); s0,
// dsT, ds0: (B, H, D, D); all fp32 contiguous.  Scratch: states (B, H,
// chunks, D, D), parts (3, slices, B, T, H, D) and du_parts (slices, B, H,
// D), with slices and chunks from wkv6_backward_config.  D must be 32 or
// 64 (the wrapper checks); returns the first CUDA error (0 on success), or
// cudaErrorInvalidValue for another D.
int wkv6_backward_launch(const float* r, const float* k, const float* v,
                         const float* lw, const float* u, const float* s0,
                         const float* dy, const float* dsT, float* dr,
                         float* dk, float* dv, float* dw, float* du,
                         float* ds0, float* states, float* parts,
                         float* du_parts, int B, int T, int H, int D,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0) return 0;
  if (D == 64) {
    return launch<64>(r, k, v, lw, u, s0, dy, dsT, dr, dk, dv, dw, du, ds0,
                      states, parts, du_parts, B, T, H, st);
  }
  if (D == 32) {
    return launch<32>(r, k, v, lw, u, s0, dy, dsT, dr, dk, dv, dw, du, ds0,
                      states, parts, du_parts, B, T, H, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The scratch shapes for head dim D and T steps: value-column slices a head
// and chunks.  Returns cudaErrorInvalidValue for another D.
int wkv6_backward_config(int T, int D, int* slices, int* chunks) {
  if (T < 0 || (D != 32 && D != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *slices = D / kEV;
  *chunks = (T + kL - 1) / kL;
  return 0;
}

}  // extern "C"
