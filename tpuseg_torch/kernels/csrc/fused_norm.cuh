// What the forward and backward GroupNorm(+ReLU) kernels share
// (csrc/fused_norm.cu, csrc/fused_norm_bwd.cu): vector loads and stores of
// VE channels, the block shape, a deterministic warp sum and the argument
// checks of the entry points.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace tpuseg {
namespace gn {

constexpr int MAX_C = 1024;
constexpr int U = 4;  // rows a thread loads before it uses any: loads in flight

// threads a block of VE-channel vectors may have: whole rows of up to
// MAX_C / VE vectors, or about 256 (block_threads)
__host__ __device__ constexpr int max_threads(int ve) { return ve <= 2 ? 1024 : 256; }

template <int BYTES>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = uint32_t; };
template <>
struct Raw<2> { using type = uint16_t; };

// VE consecutive elements at p (aligned to VE elements) as floats, in one load
template <typename T, int VE>
__device__ __forceinline__ void load_vec_f(const T* p, float (&v)[VE]) {
  using R = typename Raw<VE * sizeof(T)>::type;
  alignas(16) T t[VE];
  *reinterpret_cast<R*>(t) = *reinterpret_cast<const R*>(p);
#pragma unroll
  for (int e = 0; e < VE; ++e) v[e] = to_float(t[e]);
}

// VE floats rounded to T, stored at p in one store
template <typename T, int VE>
__device__ __forceinline__ void store_vec_f(T* p, const float (&v)[VE]) {
  using R = typename Raw<VE * sizeof(T)>::type;
  alignas(16) T t[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) store_float(t + e, v[e]);
  *reinterpret_cast<R*>(p) = *reinterpret_cast<const R*>(t);
}

// the sum of v over the warp, the same in every lane, in a fixed order
template <typename F>
__device__ __forceinline__ F warp_sum(F v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum of v over each aligned group of `width` lanes (a power of two),
// the same in every lane of the group, in a fixed order
template <typename F>
__device__ __forceinline__ F lane_group_sum(F v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[w] = the sum over rows k < K of m[k][w] (a row-major K x W float2
// matrix in global memory), in float64, in a fixed order: thread t adds
// column t % W over rows t / W, + P, ... (P = threads / W: consecutive
// threads read consecutive addresses), then thread w adds its column's P
// sums in order.  Columns past the block's threads are summed a thread
// each.  red: blockDim.x double2 of shared memory.  Every thread of the
// block calls it; out is ready after the call.
__device__ __forceinline__ void column_sums(const float2* __restrict__ m, long long K, int W,
                                            double2* red, double2* out) {
  const int t = threadIdx.x, T = blockDim.x;
  if (W <= T) {
    const int P = T / W;
    double a = 0.0, b = 0.0;
    if (t < P * W)
#pragma unroll 8
      for (long long k = t / W; k < K; k += P) {
        const float2 q = m[k * W + t % W];
        a += q.x;
        b += q.y;
      }
    red[t] = make_double2(a, b);
    __syncthreads();
    if (t < W) {
      double sa = 0.0, sb = 0.0;
      for (int s = 0; s < P; ++s) {
        sa += red[s * W + t].x;
        sb += red[s * W + t].y;
      }
      out[t] = make_double2(sa, sb);
    }
  } else {
    for (int w = t; w < W; w += T) {
      double a = 0.0, b = 0.0;
#pragma unroll 8
      for (long long k = 0; k < K; ++k) {
        const float2 q = m[k * W + w];
        a += q.x;
        b += q.y;
      }
      out[w] = make_double2(a, b);
    }
  }
  __syncthreads();
}

// threads of a block for rows of nvec vectors: whole rows, about 256
__host__ inline int block_threads(int nvec) {
  return nvec >= 256 ? nvec : nvec * (256 / nvec);
}

__host__ inline bool valid_args(const void* x, const void* y, int n, long long v, int c,
                                int groups, int rows_per_chunk, int n_chunks, int ve,
                                int dtype) {
  const int es = dtype == kFloat32 ? 4 : 2;
  const uintptr_t align = (uintptr_t)ve * es;
  return (dtype == kFloat32 || dtype == kBFloat16) && n >= 1 && n <= 65535 && v >= 1 &&
         c >= 1 && c <= MAX_C && groups >= 1 && c % groups == 0 && rows_per_chunk >= 1 &&
         n_chunks >= 1 && n_chunks <= 2147483647 &&
         (long long)n_chunks * rows_per_chunk >= v && (ve == 1 || ve == 2 || ve == 4 || ve == 8) &&
         ve * es <= 16 && c % ve == 0 && reinterpret_cast<uintptr_t>(x) % align == 0 &&
         reinterpret_cast<uintptr_t>(y) % align == 0;
}

}  // namespace gn
}  // namespace tpuseg
