// Fused GroupNorm (+ per-channel affine, + optional ReLU) on channels-last
// (N, V, C) maps: fp32 statistics, output in the input's dtype.
//
// Replaces the Pallas kernels tpuseg/kernels/fused_norm.py
// `fused_group_norm_relu_pallas` (`_stats_kernel`, `_apply_kernel`).
// Python wrapper and design note: tpuseg_torch/kernels/fused_norm.py.
//
// Two launches on one stream, both over blocks (chunk, n) of
// `rows_per_chunk` rows of sample n.  A thread owns one vector of VE
// consecutive channels (16 bytes where C allows, else 8, 4 or one element:
// VE divides C, so no vector crosses a row) and every R-th row, R = the
// block's threads / (C / VE): the block reads R whole rows per step, and a
// thread's channels, groups and affine are fixed, with no division per
// element.
//  1. gn_partial_kernel: per element, fp32 sums of d = x - shift and d^2,
//     shift the sample's first value of the group (x[n, 0, g C/G]), so
//     that the sums do not cancel for a large mean; the block adds its
//     threads' sums per group in a fixed order (one warp per group, lanes
//     strided, then a butterfly) and writes one (sum d, sum d^2) per
//     (n, chunk, group).
//  2. gn_apply_kernel: each block first merges its sample's partials in
//     float64 in one fixed order (column_sums: all threads read the
//     partials coalesced, then each group's sums are added in order), so
//     that every block, and the statistics
//     that chunk 0's block writes for the backward, agree to the bit), then
//     y = (x - mean) * (rstd * gamma[c]) + beta[c], max(y, 0), one vector
//     read and one written per step.  Its blocks take the chunks in
//     reverse, so that the first read what pass 1 read last, still in L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "fused_norm.cuh"

namespace {

using namespace tpuseg;
using namespace tpuseg::gn;

template <typename T, int VE>
__global__ void __launch_bounds__(max_threads(VE))
    gn_partial_kernel(const T* __restrict__ x, float* __restrict__ partial, long long V,
                      int C, int G, int rows_per_chunk, int n_chunks) {
  extern __shared__ float2 red[];  // [R][C]: each element's (sum d, sum d^2)
  const int chunk = blockIdx.x;
  const int n = blockIdx.y;
  const int nvec = C / VE;
  const int R = blockDim.x / nvec;
  const int v = threadIdx.x % nvec;
  const int r0 = threadIdx.x / nvec;
  const int cg = C / G;
  const T* xs = x + (size_t)n * (size_t)V * C;
  float shift[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) shift[e] = to_float(xs[(v * VE + e) / cg * cg]);
  const long long v0 = (long long)chunk * rows_per_chunk;
  const long long v1 = v0 + rows_per_chunk < V ? v0 + rows_per_chunk : V;

  float s1[VE], s2[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) s1[e] = s2[e] = 0.f;
  auto add = [&](const float (&val)[VE]) {
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const float d = val[e] - shift[e];
      s1[e] += d;
      s2[e] = fmaf(d, d, s2[e]);
    }
  };
  long long row = v0 + r0;
  for (; row + (U - 1) * (long long)R < v1; row += U * (long long)R) {
    float val[U][VE];
#pragma unroll
    for (int u = 0; u < U; ++u) load_vec_f<T, VE>(xs + (row + u * R) * C + v * VE, val[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) add(val[u]);
  }
  for (; row < v1; row += R) {
    float val[VE];
    load_vec_f<T, VE>(xs + row * C + v * VE, val);
    add(val);
  }
#pragma unroll
  for (int e = 0; e < VE; ++e) red[r0 * C + v * VE + e] = make_float2(s1[e], s2[e]);
  __syncthreads();
  // group g: entries rr * C + g cg .. + cg of every row slot rr
  // full warps only: a block of whole rows may end in a partial one
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int g = warp; warp < nwarps && g < G; g += nwarps) {
    float a = 0.f, b = 0.f;
    for (int i = lane; i < R * cg; i += 32) {
      const float2 q = red[(i / cg) * C + g * cg + i % cg];
      a += q.x;
      b += q.y;
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0)
      reinterpret_cast<float2*>(partial)[((size_t)n * n_chunks + chunk) * G + g] =
          make_float2(a, b);
  }
}

template <typename T, int VE>
__global__ void __launch_bounds__(max_threads(VE))
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    T* __restrict__ y, float* __restrict__ stats, long long V, int C, int G,
                    int rows_per_chunk, int n_chunks, float eps, int relu) {
  // [blockDim.x] double2 for column_sums, then [G] double2: the sample's
  // (sum d, sum d^2) per group, then [G] float2: each group's (mean, rstd)
  extern __shared__ double2 sm2[];
  double2* gsum = sm2 + blockDim.x;
  float2* mr = reinterpret_cast<float2*>(gsum + G);
  const int chunk = gridDim.x - 1 - blockIdx.x;  // last chunks of pass 1 first
  const int n = blockIdx.y;
  const int cg = C / G;
  const T* xs = x + (size_t)n * (size_t)V * C;
  column_sums(reinterpret_cast<const float2*>(partial) + (size_t)n * n_chunks * G, n_chunks,
              G, sm2, gsum);
  const double count = (double)V * cg;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const double m1 = gsum[g].x / count;
    const double var = fmax(gsum[g].y / count - m1 * m1, 0.0);
    const float2 s = make_float2((float)((double)to_float(xs[g * cg]) + m1),
                                 (float)(1.0 / sqrt(var + (double)eps)));
    mr[g] = s;
    if (chunk == 0) reinterpret_cast<float2*>(stats)[(size_t)n * G + g] = s;
  }
  __syncthreads();

  const int nvec = C / VE;
  const int R = blockDim.x / nvec;
  const int v = threadIdx.x % nvec;
  const int r0 = threadIdx.x / nvec;
  float mean[VE], scale[VE], bias[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) {
    const int c = v * VE + e;
    const float2 s = mr[c / cg];
    mean[e] = s.x;
    scale[e] = s.y * __ldg(gamma + c);
    bias[e] = __ldg(beta + c);
  }
  const long long v0 = (long long)chunk * rows_per_chunk;
  const long long v1 = v0 + rows_per_chunk < V ? v0 + rows_per_chunk : V;
  T* ys = y + (size_t)n * (size_t)V * C;
  auto apply = [&](float (&val)[VE]) {
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const float o = fmaf(val[e] - mean[e], scale[e], bias[e]);
      val[e] = relu ? fmaxf(o, 0.f) : o;
    }
  };
  long long row = v0 + r0;
  for (; row + (U - 1) * (long long)R < v1; row += U * (long long)R) {
    float val[U][VE];
#pragma unroll
    for (int u = 0; u < U; ++u) load_vec_f<T, VE>(xs + (row + u * R) * C + v * VE, val[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      apply(val[u]);
      store_vec_f<T, VE>(ys + (row + u * R) * C + v * VE, val[u]);
    }
  }
  for (; row < v1; row += R) {
    float val[VE];
    load_vec_f<T, VE>(xs + row * C + v * VE, val);
    apply(val);
    store_vec_f<T, VE>(ys + row * C + v * VE, val);
  }
}

template <typename T, int VE>
int launch(const T* x, const float* gamma, const float* beta, T* y, float* partial,
           float* stats, int n, long long v, int c, int groups, int rows_per_chunk,
           int n_chunks, float eps, int relu, cudaStream_t s) {
  const int threads = block_threads(c / VE);
  const dim3 grid(n_chunks, n);
  const int r = threads / (c / VE);
  gn_partial_kernel<T, VE><<<grid, threads, (size_t)r * c * sizeof(float2), s>>>(
      x, partial, v, c, groups, rows_per_chunk, n_chunks);
  gn_apply_kernel<T, VE><<<grid, threads,
                           (threads + groups) * sizeof(double2) + groups * sizeof(float2), s>>>(
      x, partial, gamma, beta, y, stats, v, c, groups, rows_per_chunk, n_chunks, eps, relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int ve, const void* x, const float* gamma, const float* beta, void* y,
             float* partial, float* stats, int n, long long v, int c, int groups,
             int rows_per_chunk, int n_chunks, float eps, int relu, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  switch (ve) {
    case 1: return launch<T, 1>(xp, gamma, beta, yp, partial, stats, n, v, c, groups,
                                rows_per_chunk, n_chunks, eps, relu, s);
    case 2: return launch<T, 2>(xp, gamma, beta, yp, partial, stats, n, v, c, groups,
                                rows_per_chunk, n_chunks, eps, relu, s);
    case 4: return launch<T, 4>(xp, gamma, beta, yp, partial, stats, n, v, c, groups,
                                rows_per_chunk, n_chunks, eps, relu, s);
    default: return launch<T, 16 / sizeof(T)>(xp, gamma, beta, yp, partial, stats, n, v, c,
                                              groups, rows_per_chunk, n_chunks, eps, relu, s);
  }
}

}  // namespace

// x, y (n, v, c) contiguous of `dtype`, both aligned to `ve` elements (1, 2,
// 4, or 16 bytes' worth; ve divides c); gamma, beta (c,) fp32; partial
// (n, n_chunks, groups, 2) fp32 scratch; stats (n, groups, 2) fp32, where
// each (sample, group)'s mean and rstd are written for the backward.
// Returns cudaGetLastError() after the launches.
extern "C" int tpuseg_group_norm_relu(const void* x, const void* gamma, const void* beta,
                                      void* y, void* partial, void* stats, int n, long long v,
                                      int c, int groups, int rows_per_chunk, int n_chunks,
                                      float eps, int relu, int ve, int dtype, void* stream) {
  if (!valid_args(x, y, n, v, c, groups, rows_per_chunk, n_chunks, ve, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* pa = static_cast<float*>(partial);
  float* st = static_cast<float*>(stats);
  if (dtype == kFloat32)
    return dispatch<float>(ve, x, ga, be, y, pa, st, n, v, c, groups, rows_per_chunk,
                           n_chunks, eps, relu, s);
  return dispatch<__nv_bfloat16>(ve, x, ga, be, y, pa, st, n, v, c, groups, rows_per_chunk,
                                 n_chunks, eps, relu, s);
}
