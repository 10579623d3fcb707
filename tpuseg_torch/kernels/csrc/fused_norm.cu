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
//
// Split across ranks (a z-sharded map, one shard a rank): the same two
// kernels as two entry points, tpuseg_group_norm_partial (pass 1) and
// tpuseg_group_norm_apply (pass 2), with the caller's all-gather of every
// rank's partials and shifts between them.  Each rank shifted its sums by
// its own first value of the group, so pass 2 merges rank r's partials in
// float64 in the fixed order above and moves them onto rank 0's shift
// (the sample's first value of the whole map): with delta = shift_r -
// shift_0 and n_r = V C/G, sum d += s1_r + n_r delta and sum d^2 += s2_r +
// 2 delta s1_r + n_r delta^2, ranks in order.  On one rank delta is 0 and
// the statistics are the fused call's to the bit.
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

// partial: (world, N, n_chunks, G, 2), every rank's pass-1 partials;
// shifts: (world, N, G), each rank's shift per (sample, group), or null
// with world 1 (the fused call: the shift is read from x)
template <typename T, int VE>
__global__ void __launch_bounds__(max_threads(VE))
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                    const float* __restrict__ shifts, int world,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    T* __restrict__ y, float* __restrict__ stats, long long V, int C, int G,
                    int rows_per_chunk, int n_chunks, float eps, int relu) {
  // [blockDim.x] double2 for column_sums, then [G] double2: a rank's
  // (sum d, sum d^2) per group, then [G] double2: the ranks' merged sums,
  // then [G] float2: each group's (mean, rstd)
  extern __shared__ double2 sm2[];
  double2* gsum = sm2 + blockDim.x;
  double2* msum = gsum + G;
  float2* mr = reinterpret_cast<float2*>(msum + G);
  const int chunk = gridDim.x - 1 - blockIdx.x;  // last chunks of pass 1 first
  const int n = blockIdx.y;
  const int N = gridDim.y;
  const int cg = C / G;
  const T* xs = x + (size_t)n * (size_t)V * C;
  const double rank_count = (double)V * cg;
  for (int r = 0; r < world; ++r) {
    column_sums(reinterpret_cast<const float2*>(partial) + ((size_t)r * N + n) * n_chunks * G,
                n_chunks, G, sm2, gsum);
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      if (r == 0) {
        msum[g] = gsum[g];
      } else {
        const double dl = (double)shifts[((size_t)r * N + n) * G + g] - (double)shifts[(size_t)n * G + g];
        msum[g].x += gsum[g].x + rank_count * dl;
        msum[g].y += gsum[g].y + 2.0 * dl * gsum[g].x + rank_count * dl * dl;
      }
    }
    __syncthreads();
  }
  const double count = rank_count * world;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const double m1 = msum[g].x / count;
    const double var = fmax(msum[g].y / count - m1 * m1, 0.0);
    const double shift = shifts ? (double)shifts[(size_t)n * G + g] : (double)to_float(xs[g * cg]);
    const float2 s = make_float2((float)(shift + m1), (float)(1.0 / sqrt(var + (double)eps)));
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

// which passes a launch runs: both (the fused call), pass 1 or pass 2
enum Passes { kBoth = 0, kPartial = 1, kApply = 2 };

template <typename T, int VE>
int launch(const T* x, const float* gamma, const float* beta, T* y, float* partial,
           const float* shifts, int world, float* stats, int n, long long v, int c, int groups,
           int rows_per_chunk, int n_chunks, float eps, int relu, int passes, cudaStream_t s) {
  const int threads = block_threads(c / VE);
  const dim3 grid(n_chunks, n);
  const int r = threads / (c / VE);
  if (passes != kApply)
    gn_partial_kernel<T, VE><<<grid, threads, (size_t)r * c * sizeof(float2), s>>>(
        x, partial, v, c, groups, rows_per_chunk, n_chunks);
  if (passes != kPartial)
    gn_apply_kernel<T, VE><<<grid, threads,
                             (threads + 2 * groups) * sizeof(double2) + groups * sizeof(float2),
                             s>>>(x, partial, shifts, world, gamma, beta, y, stats, v, c, groups,
                                  rows_per_chunk, n_chunks, eps, relu);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int ve, const void* x, const float* gamma, const float* beta, void* y,
             float* partial, const float* shifts, int world, float* stats, int n, long long v,
             int c, int groups, int rows_per_chunk, int n_chunks, float eps, int relu,
             int passes, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  switch (ve) {
    case 1: return launch<T, 1>(xp, gamma, beta, yp, partial, shifts, world, stats, n, v, c,
                                groups, rows_per_chunk, n_chunks, eps, relu, passes, s);
    case 2: return launch<T, 2>(xp, gamma, beta, yp, partial, shifts, world, stats, n, v, c,
                                groups, rows_per_chunk, n_chunks, eps, relu, passes, s);
    case 4: return launch<T, 4>(xp, gamma, beta, yp, partial, shifts, world, stats, n, v, c,
                                groups, rows_per_chunk, n_chunks, eps, relu, passes, s);
    default: return launch<T, 16 / sizeof(T)>(xp, gamma, beta, yp, partial, shifts, world,
                                              stats, n, v, c, groups, rows_per_chunk, n_chunks,
                                              eps, relu, passes, s);
  }
}

int run(const void* x, const void* gamma, const void* beta, void* y, void* partial,
        const void* shifts, int world, void* stats, int n, long long v, int c, int groups,
        int rows_per_chunk, int n_chunks, float eps, int relu, int ve, int dtype, int passes,
        void* stream) {
  if (!valid_args(x, y ? y : x, n, v, c, groups, rows_per_chunk, n_chunks, ve, dtype) ||
      world < 1 || (passes == kApply && world > 1 && shifts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* pa = static_cast<float*>(partial);
  const float* sh = static_cast<const float*>(shifts);
  float* st = static_cast<float*>(stats);
  if (dtype == kFloat32)
    return dispatch<float>(ve, x, ga, be, y, pa, sh, world, st, n, v, c, groups,
                           rows_per_chunk, n_chunks, eps, relu, passes, s);
  return dispatch<__nv_bfloat16>(ve, x, ga, be, y, pa, sh, world, st, n, v, c, groups,
                                 rows_per_chunk, n_chunks, eps, relu, passes, s);
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
  return run(x, gamma, beta, y, partial, nullptr, 1, stats, n, v, c, groups, rows_per_chunk,
             n_chunks, eps, relu, ve, dtype, kBoth, stream);
}

// Pass 1 of a split call: partial (n, n_chunks, groups, 2) fp32, this
// rank's shifted sums, as tpuseg_group_norm_relu's pass 1 writes them.
extern "C" int tpuseg_group_norm_partial(const void* x, void* partial, int n, long long v,
                                         int c, int groups, int rows_per_chunk, int n_chunks,
                                         int ve, int dtype, void* stream) {
  return run(x, nullptr, nullptr, nullptr, partial, nullptr, 1, nullptr, n, v, c, groups,
             rows_per_chunk, n_chunks, 0.f, 0, ve, dtype, kPartial, stream);
}

// Pass 2 of a split call over `world` ranks of equal shards (n, v, c):
// partial (world, n, n_chunks, groups, 2) fp32, every rank's pass-1
// partials in rank order; shifts (world, n, groups) fp32, each rank's
// x[n, 0, g c/groups]; the rest as tpuseg_group_norm_relu's.  Every rank
// merges the same numbers in the same order, so all write the same stats.
extern "C" int tpuseg_group_norm_apply(const void* x, const void* partial, const void* shifts,
                                       int world, const void* gamma, const void* beta, void* y,
                                       void* stats, int n, long long v, int c, int groups,
                                       int rows_per_chunk, int n_chunks, float eps, int relu,
                                       int ve, int dtype, void* stream) {
  return run(x, gamma, beta, y, const_cast<void*>(partial), shifts, world, stats, n, v, c,
             groups, rows_per_chunk, n_chunks, eps, relu, ve, dtype, kApply, stream);
}
