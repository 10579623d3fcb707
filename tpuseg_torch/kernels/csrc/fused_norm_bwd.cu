// Backward of the fused GroupNorm (+ per-channel affine, + optional ReLU) on
// channels-last (N, V, C) maps: fp32 statistics and gradients of gamma and
// beta, dx in the input's dtype.
//
// Replaces the JAX backward of tpuseg/kernels/fused_norm.py
// `fused_group_norm_relu_vjp` (a recompute through `_gn_relu_reference`).
// Python wrapper and design note: tpuseg_torch/kernels/fused_norm.py.
//
// With xh = (x - mean) * rstd per (n, group), the forward's pre-activation
// v = (x - mean) * (rstd gamma[c]) + beta[c] and gh = g * [v > 0] (g itself
// without ReLU):
//   dbeta[c]  = sum_{n,v} gh          dgamma[c] = sum_{n,v} gh * xh
//   dx = rstd * (gamma[c] * gh - A[n,grp] - xh * B[n,grp]),
//   A = mean over the group of gamma * gh, B = mean of gamma * gh * xh.
// xh is recomputed from x and the forward's saved (mean, rstd); the
// normalized map is never stored.  Two launches on one stream, over blocks
// (chunk, n) with the forward's thread layout (a thread owns VE channels
// and every R-th row of the chunk, csrc/fused_norm.cu):
//  1. gn_bwd_partial_kernel: fp32 sums of gh and gh * xh per element, added
//     per channel over the block's row slots in a fixed order (a few lanes
//     per channel, then a butterfly); one (sum gh, sum gh * xh) per
//     (n, chunk, channel).
//  2. gn_bwd_apply_kernel: each block first merges its sample's partials
//     in float64 in one fixed order (column_sums), forms A and B per
//     group, and the first block also merges every sample's for dgamma
//     and dbeta; then one elementwise pass reads x and g and writes dx.  Its blocks take the
//     chunks in reverse, so that the first read what pass 1 read last,
//     still in L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "fused_norm.cuh"

namespace {

using namespace tpuseg;
using namespace tpuseg::gn;

// each of the thread's VE channels' (mean, rstd, gamma, beta)
template <int VE>
struct ChannelStats {
  float mean[VE], rstd[VE], gamma[VE], beta[VE];

  __device__ __forceinline__ void load(const float* stats, const float* gamma_g,
                                       const float* beta_g, int n, int c0, int cg, int G) {
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const int c = c0 + e;
      const float2 s = reinterpret_cast<const float2*>(stats)[(size_t)n * G + c / cg];
      mean[e] = s.x;
      rstd[e] = s.y;
      gamma[e] = __ldg(gamma_g + c);
      beta[e] = __ldg(beta_g + c);
    }
  }
};

template <typename T, int VE>
__global__ void __launch_bounds__(max_threads(VE))
    gn_bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                          const float* __restrict__ stats, const float* __restrict__ gamma,
                          const float* __restrict__ beta, float* __restrict__ partial,
                          long long V, int C, int G, int rows_per_chunk, int n_chunks,
                          int relu) {
  extern __shared__ float2 red[];  // [R][C]: each element's (sum gh, sum gh xh)
  const int chunk = blockIdx.x;
  const int n = blockIdx.y;
  const int nvec = C / VE;
  const int R = blockDim.x / nvec;
  const int v = threadIdx.x % nvec;
  const int r0 = threadIdx.x / nvec;
  ChannelStats<VE> cs;
  cs.load(stats, gamma, beta, n, v * VE, C / G, G);
  const long long v0 = (long long)chunk * rows_per_chunk;
  const long long v1 = v0 + rows_per_chunk < V ? v0 + rows_per_chunk : V;
  const size_t base = (size_t)n * (size_t)V * C + v * VE;

  float s1[VE], s2[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) s1[e] = s2[e] = 0.f;
  auto add = [&](const float (&xv)[VE], const float (&gv)[VE]) {
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const float d = xv[e] - cs.mean[e];
      const float g =
          relu && !(fmaf(d, cs.rstd[e] * cs.gamma[e], cs.beta[e]) > 0.f) ? 0.f : gv[e];
      s1[e] += g;
      s2[e] = fmaf(g, d * cs.rstd[e], s2[e]);
    }
  };
  long long row = v0 + r0;
  for (; row + (U - 1) * (long long)R < v1; row += U * (long long)R) {
    float xv[U][VE], gv[U][VE];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      load_vec_f<T, VE>(x + base + (row + u * R) * C, xv[u]);
      load_vec_f<T, VE>(gy + base + (row + u * R) * C, gv[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) add(xv[u], gv[u]);
  }
  for (; row < v1; row += R) {
    float xv[VE], gv[VE];
    load_vec_f<T, VE>(x + base + row * C, xv);
    load_vec_f<T, VE>(gy + base + row * C, gv);
    add(xv, gv);
  }
#pragma unroll
  for (int e = 0; e < VE; ++e) red[r0 * C + v * VE + e] = make_float2(s1[e], s2[e]);
  __syncthreads();
  // L lanes per channel strided over the row slots, then summed within
  // the L lanes (as the apply pass merges the chunks)
  const int lane = threadIdx.x & 31, full = (blockDim.x >> 5) * 32;
  int L = 32;
  while (L > 1 && L * C > full) L >>= 1;
  const int sub = lane & (L - 1);
  if (threadIdx.x < full) {
    for (int base = 0; base < C; base += full / L) {
      const int c = base + threadIdx.x / L;
      float a = 0.f, b = 0.f;
      if (c < C)
        for (int rr = sub; rr < R; rr += L) {
          const float2 q = red[rr * C + c];
          a += q.x;
          b += q.y;
        }
      a = lane_group_sum(a, L);
      b = lane_group_sum(b, L);
      if (c < C && sub == 0)
        reinterpret_cast<float2*>(partial)[((size_t)n * n_chunks + chunk) * C + c] =
            make_float2(a, b);
    }
  }
}

template <typename T, int VE>
__global__ void __launch_bounds__(max_threads(VE))
    gn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                        const float* __restrict__ stats, const float* __restrict__ partial,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        T* __restrict__ dx, float* __restrict__ dgamma,
                        float* __restrict__ dbeta, int N, long long V, int C, int G,
                        int rows_per_chunk, int n_chunks, int relu) {
  // [blockDim.x] double2 for column_sums, then [C] double2: the sample's
  // (sum gh, sum gh xh) per channel, then [G] double2: A, B per group
  extern __shared__ double2 sm2[];
  double2* csum = sm2 + blockDim.x;
  double2* coef = csum + C;
  const int chunk = gridDim.x - 1 - blockIdx.x;  // last chunks of pass 1 first
  const int n = blockIdx.y;
  const int cg = C / G;
  const float2* part = reinterpret_cast<const float2*>(partial);
  if (blockIdx.x == 0 && n == 0) {  // dbeta, dgamma over every sample: the first block
    column_sums(part, (long long)N * n_chunks, C, sm2, csum);
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      dbeta[c] = (float)csum[c].x;
      dgamma[c] = (float)csum[c].y;
    }
    __syncthreads();
  }
  column_sums(part + (size_t)n * n_chunks * C, n_chunks, C, sm2, csum);
  const double inv_count = 1.0 / ((double)V * cg);
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    double a = 0.0, b = 0.0;
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      const double gm = __ldg(gamma + c);
      a += gm * csum[c].x;
      b += gm * csum[c].y;
    }
    coef[g] = make_double2(a * inv_count, b * inv_count);
  }
  __syncthreads();

  const int nvec = C / VE;
  const int R = blockDim.x / nvec;
  const int v = threadIdx.x % nvec;
  const int r0 = threadIdx.x / nvec;
  ChannelStats<VE> cs;
  cs.load(stats, gamma, beta, n, v * VE, cg, G);
  float ca[VE], cb[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) {
    const double2 ab = coef[(v * VE + e) / cg];
    ca[e] = (float)ab.x;
    cb[e] = (float)ab.y;
  }
  const long long v0 = (long long)chunk * rows_per_chunk;
  const long long v1 = v0 + rows_per_chunk < V ? v0 + rows_per_chunk : V;
  const size_t base = (size_t)n * (size_t)V * C + v * VE;
  // dx over xv in place
  auto grad = [&](float (&xv)[VE], const float (&gv)[VE]) {
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const float d = xv[e] - cs.mean[e];
      const float g =
          relu && !(fmaf(d, cs.rstd[e] * cs.gamma[e], cs.beta[e]) > 0.f) ? 0.f : gv[e];
      const float xh = d * cs.rstd[e];
      xv[e] = cs.rstd[e] * (cs.gamma[e] * g - ca[e] - xh * cb[e]);
    }
  };
  long long row = v0 + r0;
  for (; row + (U - 1) * (long long)R < v1; row += U * (long long)R) {
    float xv[U][VE], gv[U][VE];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      load_vec_f<T, VE>(x + base + (row + u * R) * C, xv[u]);
      load_vec_f<T, VE>(gy + base + (row + u * R) * C, gv[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      grad(xv[u], gv[u]);
      store_vec_f<T, VE>(dx + base + (row + u * R) * C, xv[u]);
    }
  }
  for (; row < v1; row += R) {
    float xv[VE], gv[VE];
    load_vec_f<T, VE>(x + base + row * C, xv);
    load_vec_f<T, VE>(gy + base + row * C, gv);
    grad(xv, gv);
    store_vec_f<T, VE>(dx + base + row * C, xv);
  }
}

template <typename T, int VE>
int launch(const T* x, const T* gy, const float* stats, const float* gamma, const float* beta,
           T* dx, float* dgamma, float* dbeta, float* partial, int n, long long v, int c,
           int groups, int rows_per_chunk, int n_chunks, int relu, cudaStream_t s) {
  const int threads = block_threads(c / VE);
  const int r = threads / (c / VE);
  const dim3 grid(n_chunks, n);
  gn_bwd_partial_kernel<T, VE><<<grid, threads, (size_t)r * c * sizeof(float2), s>>>(
      x, gy, stats, gamma, beta, partial, v, c, groups, rows_per_chunk, n_chunks, relu);
  gn_bwd_apply_kernel<T, VE><<<grid, threads, (threads + c + groups) * sizeof(double2),
                               s>>>(x, gy, stats, partial, gamma, beta, dx, dgamma, dbeta, n,
                                    v, c, groups, rows_per_chunk, n_chunks, relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int ve, const void* x, const void* gy, const float* stats, const float* gamma,
             const float* beta, void* dx, float* dgamma, float* dbeta, float* partial, int n,
             long long v, int c, int groups, int rows_per_chunk, int n_chunks, int relu,
             cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gy);
  T* dp = static_cast<T*>(dx);
  switch (ve) {
    case 1: return launch<T, 1>(xp, gp, stats, gamma, beta, dp, dgamma, dbeta, partial, n, v,
                                c, groups, rows_per_chunk, n_chunks, relu, s);
    case 2: return launch<T, 2>(xp, gp, stats, gamma, beta, dp, dgamma, dbeta, partial, n, v,
                                c, groups, rows_per_chunk, n_chunks, relu, s);
    case 4: return launch<T, 4>(xp, gp, stats, gamma, beta, dp, dgamma, dbeta, partial, n, v,
                                c, groups, rows_per_chunk, n_chunks, relu, s);
    default: return launch<T, 16 / sizeof(T)>(xp, gp, stats, gamma, beta, dp, dgamma, dbeta,
                                              partial, n, v, c, groups, rows_per_chunk,
                                              n_chunks, relu, s);
  }
}

}  // namespace

// x, gy, dx (n, v, c) contiguous of `dtype`, aligned to `ve` elements (ve
// divides c); stats (n, groups, 2) fp32 as the forward wrote it (mean,
// rstd); gamma, beta, dgamma, dbeta (c,) fp32; partial (n, n_chunks, c, 2)
// fp32 scratch.  Returns cudaGetLastError() after the launches.
extern "C" int tpuseg_group_norm_relu_bwd(const void* x, const void* gy, const void* stats,
                                          const void* gamma, const void* beta, void* dx,
                                          void* dgamma, void* dbeta, void* partial, int n,
                                          long long v, int c, int groups, int rows_per_chunk,
                                          int n_chunks, int relu, int ve, int dtype,
                                          void* stream) {
  const int es = dtype == kFloat32 ? 4 : 2;
  if (!valid_args(x, dx, n, v, c, groups, rows_per_chunk, n_chunks, ve, dtype) ||
      reinterpret_cast<uintptr_t>(gy) % ((uintptr_t)ve * es) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  float* pa = static_cast<float*>(partial);
  if (dtype == kFloat32)
    return dispatch<float>(ve, x, gy, st, ga, be, dx, dg, db, pa, n, v, c, groups,
                           rows_per_chunk, n_chunks, relu, s);
  return dispatch<__nv_bfloat16>(ve, x, gy, st, ga, be, dx, dg, db, pa, n, v, c, groups,
                                 rows_per_chunk, n_chunks, relu, s);
}
