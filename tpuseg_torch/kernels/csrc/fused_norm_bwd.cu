// Backward of the fused GroupNorm (+ per-channel affine, + optional ReLU) on
// channels-last (N, V, C) maps: fp32 statistics and gradients of gamma and
// beta, dx in the input's dtype.
//
// Replaces the JAX backward of tpuseg/kernels/fused_norm.py
// `fused_group_norm_relu_vjp` (a recompute through `_gn_relu_reference`).
// Python wrapper and design note: tpuseg_torch/kernels/fused_norm.py.
//
// With xh = (x - mean) * rstd per (n, group), the forward's pre-activation
// v = xh * gamma[c] + beta[c] and gh = g * [v > 0] (g itself without ReLU):
//   dbeta[c]  = sum_{n,v} gh          dgamma[c] = sum_{n,v} gh * xh
//   dx = rstd * (gamma[c] * gh - A[n,grp] - xh * B[n,grp]),
//   A = mean over the group of gamma * gh, B = mean of gamma * gh * xh.
// xh is recomputed from x and the forward's saved (mean, rstd); the
// normalized map is never stored.  Three launches on one stream:
//  1. gn_bwd_partial_kernel: block (chunk, n) sums gh and gh * xh per
//     channel over `rows_per_chunk` rows (thread t owns channel t % C and
//     every R-th row, as in the forward's partial pass) and writes one
//     (sum gh, sum gh * xh) pair per (n, chunk, channel).
//  2. gn_bwd_finalize_kernel: block g merges the chunks of its channels in
//     fp64, writes dgamma / dbeta of those channels and A, B per (n, g).
//  3. gn_bwd_apply_kernel: one elementwise pass reading x and g, writing dx.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int FINALIZE_THREADS = 256;
constexpr int APPLY_THREADS = 256;
constexpr int MAX_C = 1024;

template <typename T>
__global__ void gn_bwd_partial_kernel(const T* __restrict__ x,
                                      const T* __restrict__ gy,
                                      const float* __restrict__ stats,
                                      const float* __restrict__ gamma,
                                      const float* __restrict__ beta,
                                      float* __restrict__ partial, long long V,
                                      int C, int G, int rows_per_chunk,
                                      int n_chunks, int relu) {
  extern __shared__ float sm[];  // 2 * blockDim.x: sum gh, sum gh * xh
  const int chunk = blockIdx.x;
  const int n = blockIdx.y;
  const int R = blockDim.x / C;
  const int c = threadIdx.x % C;
  const int r0 = threadIdx.x / C;
  const size_t st = ((size_t)n * G + c / (C / G)) * 2;
  const float mean = stats[st];
  const float rstd = stats[st + 1];
  const float ga = gamma[c];
  const float scale = rstd * ga;  // the forward's expression for v
  const float be = beta[c];
  const long long v0 = (long long)chunk * rows_per_chunk;
  const long long v1 = v0 + rows_per_chunk < V ? v0 + rows_per_chunk : V;
  const size_t base = (size_t)n * (size_t)V * C;

  float s1 = 0.f, s2 = 0.f;
  if (r0 < R) {
    for (long long v = v0 + r0; v < v1; v += R) {
      const size_t e = base + v * C + c;
      const float xv = tpuseg::to_float(x[e]);
      float gv = tpuseg::to_float(gy[e]);
      if (relu && !((xv - mean) * scale + be > 0.f)) gv = 0.f;
      s1 += gv;
      s2 += gv * ((xv - mean) * rstd);
    }
  }
  const int bd = blockDim.x;
  sm[threadIdx.x] = s1;
  sm[bd + threadIdx.x] = s2;
  __syncthreads();
  for (int cc = threadIdx.x; cc < C; cc += bd) {
    float a = 0.f, b = 0.f;
    for (int rr = 0; rr < R; ++rr) {
      a += sm[rr * C + cc];
      b += sm[bd + rr * C + cc];
    }
    float* p = partial + (((size_t)n * n_chunks + chunk) * C + cc) * 2;
    p[0] = a;
    p[1] = b;
  }
}

__global__ void __launch_bounds__(FINALIZE_THREADS)
    gn_bwd_finalize_kernel(const float* __restrict__ partial,
                           const float* __restrict__ gamma,
                           float* __restrict__ coef,
                           float* __restrict__ dgamma,
                           float* __restrict__ dbeta, int N, int n_chunks,
                           int C, int G, double inv_count) {
  __shared__ double sa[FINALIZE_THREADS], sb[FINALIZE_THREADS];
  const int g = blockIdx.x;
  const int cg = C / G;
  const int t = threadIdx.x;
  for (int n = 0; n < N; ++n) {
    double A = 0.0, B = 0.0;  // thread 0's running sums over the group
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      double a = 0.0, b = 0.0;
      for (int k = t; k < n_chunks; k += FINALIZE_THREADS) {
        const float* p = partial + (((size_t)n * n_chunks + k) * C + c) * 2;
        a += p[0];
        b += p[1];
      }
      sa[t] = a;
      sb[t] = b;
      __syncthreads();
      for (int s = FINALIZE_THREADS / 2; s > 0; s >>= 1) {
        if (t < s) {
          sa[t] += sa[t + s];
          sb[t] += sb[t + s];
        }
        __syncthreads();
      }
      if (t == 0) {
        const double gm = gamma[c];
        A += gm * sa[0];
        B += gm * sb[0];
        // channel c belongs to this block only: accumulate over n in place
        dbeta[c] = n == 0 ? (float)sa[0] : dbeta[c] + (float)sa[0];
        dgamma[c] = n == 0 ? (float)sb[0] : dgamma[c] + (float)sb[0];
      }
      __syncthreads();  // sa/sb are rewritten by the next channel
    }
    if (t == 0) {
      coef[((size_t)n * G + g) * 2] = (float)(A * inv_count);
      coef[((size_t)n * G + g) * 2 + 1] = (float)(B * inv_count);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(APPLY_THREADS)
    gn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                        const float* __restrict__ stats,
                        const float* __restrict__ coef,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, T* __restrict__ dx,
                        long long total, long long VC, int C, int cg, int G,
                        int relu) {
  const long long stride = (long long)gridDim.x * APPLY_THREADS;
  for (long long e = (long long)blockIdx.x * APPLY_THREADS + threadIdx.x;
       e < total; e += stride) {
    const int c = (int)(e % C);
    const long long n = e / VC;
    const size_t s = ((size_t)n * G + c / cg) * 2;
    const float mean = __ldg(stats + s);
    const float rstd = __ldg(stats + s + 1);
    const float ga = __ldg(gamma + c);
    const float xv = tpuseg::to_float(x[e]);
    float gv = tpuseg::to_float(gy[e]);
    if (relu && !((xv - mean) * (rstd * ga) + __ldg(beta + c) > 0.f)) gv = 0.f;
    const float xh = (xv - mean) * rstd;
    tpuseg::store_float(
        dx + e, rstd * (ga * gv - __ldg(coef + s) - xh * __ldg(coef + s + 1)));
  }
}

template <typename T>
int launch(const T* x, const T* gy, const float* stats, const float* gamma,
           const float* beta, T* dx, float* dgamma, float* dbeta,
           float* partial, float* coef, int n, long long v, int c, int groups,
           int rows_per_chunk, int n_chunks, int relu, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int R = c >= 256 ? 1 : 256 / c;
  const int threads = c * R;
  gn_bwd_partial_kernel<T><<<dim3(n_chunks, n), threads,
                             2 * threads * sizeof(float), s>>>(
      x, gy, stats, gamma, beta, partial, v, c, groups, rows_per_chunk,
      n_chunks, relu);
  const double inv_count = 1.0 / ((double)v * (c / groups));
  gn_bwd_finalize_kernel<<<groups, FINALIZE_THREADS, 0, s>>>(
      partial, gamma, coef, dgamma, dbeta, n, n_chunks, c, groups, inv_count);
  const long long total = (long long)n * v * c;
  const long long want = (total + APPLY_THREADS - 1) / APPLY_THREADS;
  const long long most = 16LL * sms;
  const int blocks = (int)(want < most ? want : most);
  gn_bwd_apply_kernel<T><<<blocks, APPLY_THREADS, 0, s>>>(
      x, gy, stats, coef, gamma, beta, dx, total, v * c, c, c / groups, groups,
      relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, gy, dx (n, v, c) contiguous of `dtype`; stats (n, groups, 2) fp32 as
// the forward wrote it (mean, rstd); gamma, beta, dgamma, dbeta (c,) fp32;
// partial (n, n_chunks, c, 2) and coef (n, groups, 2) fp32 scratch.
// Returns cudaGetLastError() after the launches.
extern "C" int tpuseg_group_norm_relu_bwd(
    const void* x, const void* gy, const void* stats, const void* gamma,
    const void* beta, void* dx, void* dgamma, void* dbeta, void* partial,
    void* coef, int n, long long v, int c, int groups, int rows_per_chunk,
    int n_chunks, int relu, int dtype, void* stream) {
  if (n < 1 || v < 1 || c < 1 || c > MAX_C || groups < 1 ||
      groups > 65535 || c % groups != 0 || rows_per_chunk < 1 ||
      n_chunks < 1 || n_chunks > 2147483647 || n > 65535 ||
      (long long)n_chunks * rows_per_chunk < v)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  float* pa = static_cast<float*>(partial);
  float* co = static_cast<float*>(coef);
  if (dtype == tpuseg::kFloat32)
    return launch<float>(static_cast<const float*>(x),
                         static_cast<const float*>(gy), st, ga, be,
                         static_cast<float*>(dx), dg, db, pa, co, n, v, c,
                         groups, rows_per_chunk, n_chunks, relu, s);
  if (dtype == tpuseg::kBFloat16)
    return launch<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(gy), st, ga, be,
        static_cast<__nv_bfloat16*>(dx), dg, db, pa, co, n, v, c, groups,
        rows_per_chunk, n_chunks, relu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
