// RWKV6 ("Finch") wkv recurrence for Hopper (sm_90a), bound to Python through
// a plain C interface (ctypes).
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py (_wkv6_kernel behind
// wkv6_tiled), which ops.wkv6 runs once per RWKV layer of a prefill.  Per
// (batch, head), with a (D, D) fp32 state S:
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,   y_t = r_t^T S_{t-1} + (r_t.u.k_t) v_t
//
// evaluated in chunks of C = 64 steps.  With cum the inclusive prefix sum of
// logw inside a chunk and cp its exclusive one (cp_t = cum_{t-1}):
//
//   y_t = (r_t e^{cp_t}) S + sum_{s<t} A[t,s] v_s + (r_t.u.k_t) v_t
//   A[t,s] = sum_d r_t[d] k_s[d] exp(cp_t[d] - cum_s[d])
//   S'  = diag(e^{cum_L}) S + sum_s (k_s e^{cum_L - cum_s}) v_s^T
//
// Numerics.  The TPU kernel factors the pair decay into e^{cp_t} e^{-cum_s};
// e^{-cum_s} overflows fp32 once a channel's decay summed over the chunk goes
// below about -88.7, and the product is then inf * 0 = NaN.  Here every
// exponent is a difference cp_t - cum_s (s < t) or cum_L - cum_s, a sum of
// log decays, so it is <= 0 up to rounding and nothing overflows for any
// logw the model can produce.  cp_t is read as cum_{t-1}, the same fp32
// value, so the adjacent pair's exponent is exactly 0.  The price is C^2 D/2
// exponentials per chunk instead of 2 C D.
//
// Work split.  One block of 256 threads per (b, h) walks the chunks in
// order; S stays in shared memory for the whole sequence.  A chunk's r, k, v
// and the prefix sums sit in shared memory (rows padded to D + 1 floats so
// the pair loop reads distinct banks); the last chunk runs L < C steps by a
// trip count, so the host never pads T.  Shared memory: 99,840 bytes at
// D = 64 (two blocks per SM), 54,656 at D = 32.
//
// What bounds it.  It reads r, k, v, logw once and writes y once (20 bytes
// per (t, h, d) element) plus s0 and sT: 0.2 ms at the full-width serving
// shape on an H100.  The function needs less arithmetic than that moves
// (the step recurrence's 5 D^2 operations per token and head, 0.16 ms at
// 67 TFLOP/s fp32), so its least time is set by the bytes.  This kernel
// does more: 8 C D^2 per chunk and head for the three products plus the
// C^2 D / 2 pair decays (an exp, a subtract and two multiplies each),
// about 0.25 ms, so it is bound by its own operations, the exponentials
// most of all.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;
constexpr int kThreads = 256;
static_assert(kChunk * 4 == kThreads, "pair loop: 4 threads per row");

template <int D>
constexpr int smem_floats() {
  // r, k (then k * carry decay), cum: C x (D + 1); v: C x D;
  // A: C x (C + 1); S: D x D; u: D; diag: C.
  return 3 * kChunk * (D + 1) + kChunk * D + kChunk * (kChunk + 1) + D * D +
         D + kChunk;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ lw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sT, int T, int H) {
  constexpr int C = kChunk;
  constexpr int P = D + 1;              // padded row stride
  constexpr int PA = C + 1;             // row stride of A
  constexpr int kRows = kThreads / D;   // rows per pass in the y and S steps
  extern __shared__ float smem[];
  float* rs = smem;                     // r, then r * e^{cp}
  float* ks = rs + C * P;               // k, then k * e^{cum_L - cum}
  float* cus = ks + C * P;              // inclusive prefix of logw
  float* vs = cus + C * P;
  float* as = vs + C * D;
  float* ss = as + C * PA;
  float* us = ss + D * D;
  float* dg = us + D;

  const int bh = blockIdx.x;            // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int tid = threadIdx.x;
  const long long row = static_cast<long long>(H) * D;   // stride of t
  const long long base = (static_cast<long long>(b) * T * H + h) * D;

  for (int i = tid; i < D; i += kThreads) us[i] = u[h * D + i];
  const float* s0p = s0 + static_cast<long long>(bh) * D * D;
  for (int i = tid; i < D * D; i += kThreads) ss[i] = s0p[i];

  for (int t0 = 0; t0 < T; t0 += C) {
    const int L = min(C, T - t0);
    const long long g0 = base + static_cast<long long>(t0) * row;
    __syncthreads();                    // the previous chunk is done
    for (int i = tid; i < L * D; i += kThreads) {
      const int t = i / D, d = i - (i / D) * D;
      const long long g = g0 + t * row + d;
      rs[t * P + d] = r[g];
      ks[t * P + d] = k[g];
      vs[t * D + d] = v[g];
    }
    if (tid < D) {                      // prefix sums, one channel a thread
      float run = 0.0f;
      for (int t = 0; t < L; ++t) {
        run += lw[g0 + t * row + tid];
        cus[t * P + tid] = run;
      }
    }
    __syncthreads();
    if (tid >= D && tid - D < L) {      // bonus term r_t . u . k_t
      const int t = tid - D;
      float acc = 0.0f;
      for (int d = 0; d < D; ++d) acc += rs[t * P + d] * us[d] * ks[t * P + d];
      dg[t] = acc;
    }
    {                                   // pair matrix, strictly lower
      const int t = tid >> 2, sg = tid & 3;
      float acc[C / 4];
#pragma unroll
      for (int j = 0; j < C / 4; ++j) acc[j] = 0.0f;
      if (t < L) {
        for (int d = 0; d < D; ++d) {
          const float rt = rs[t * P + d];
          const float ct = t > 0 ? cus[(t - 1) * P + d] : 0.0f;
#pragma unroll
          for (int j = 0; j < C / 4; ++j) {
            const int s = sg + 4 * j;
            acc[j] += rt * ks[s * P + d] * expf(ct - cus[s * P + d]);
          }
        }
      }
      // s >= t (and rows past L) hold garbage or inf; the select drops them.
#pragma unroll
      for (int j = 0; j < C / 4; ++j) {
        const int s = sg + 4 * j;
        as[t * PA + s] = s < t ? acc[j] : 0.0f;
      }
    }
    __syncthreads();
    for (int i = tid; i < L * D; i += kThreads) {   // q = r * e^{cp}
      const int t = i / D, d = i - (i / D) * D;
      const float ct = t > 0 ? cus[(t - 1) * P + d] : 0.0f;
      rs[t * P + d] *= expf(ct);
    }
    __syncthreads();
    {                                   // y, D columns x kRows rows a pass
      const int e = tid % D;
      for (int t = tid / D; t < L; t += kRows) {
        float acc = dg[t] * vs[t * D + e];
        for (int d = 0; d < D; ++d) acc += rs[t * P + d] * ss[d * D + e];
        for (int s = 0; s < t; ++s) acc += as[t * PA + s] * vs[s * D + e];
        y[g0 + t * row + e] = acc;
      }
    }
    __syncthreads();
    for (int i = tid; i < L * D; i += kThreads) {   // carry decay into k
      const int s = i / D, d = i - (i / D) * D;
      ks[s * P + d] *= expf(cus[(L - 1) * P + d] - cus[s * P + d]);
    }
    __syncthreads();
    {                                   // S' = diag(e^{cum_L}) S + kc^T v
      const int e = tid % D;
      for (int d = tid / D; d < D; d += kRows) {
        float acc = expf(cus[(L - 1) * P + d]) * ss[d * D + e];
        for (int s = 0; s < L; ++s) acc += ks[s * P + d] * vs[s * D + e];
        ss[d * D + e] = acc;
      }
    }
  }
  __syncthreads();
  float* sTp = sT + static_cast<long long>(bh) * D * D;
  for (int i = tid; i < D * D; i += kThreads) sTp[i] = ss[i];
}

template <int D>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, const float* s0, float* y, float* sT, int B,
           int T, int H, cudaStream_t st) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_kernel<D><<<B * H, kThreads, bytes, st>>>(r, k, v, lw, u, s0, y, sT,
                                                T, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// r, k, v, logw, y: (B, T, H, D) fp32 contiguous; u: (H, D); s0, sT:
// (B, H, D, D).  D must be 32 or 64 (the wrapper checks); returns the first
// CUDA error (0 on success), or cudaErrorInvalidValue for another D.
int wkv6_launch(const float* r, const float* k, const float* v,
                const float* lw, const float* u, const float* s0, float* y,
                float* sT, int B, int T, int H, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0) return 0;
  if (D == 64) return launch<64>(r, k, v, lw, u, s0, y, sT, B, T, H, st);
  if (D == 32) return launch<32>(r, k, v, lw, u, s0, y, sT, B, T, H, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
