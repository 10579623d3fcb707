// The int8 route's activation quantizer as two launches: one scale over
// one or two float maps (the parts of a concat), and the int8 maps.
//
//   a_scale = max(max |x|, 1e-12) / 127                 (IEEE division)
//   xq      = clip(rint(x / a_scale), -127, 127)         (rint: half to even)
//
// exactly as kernels/conv_int8.py `quantize_activation_plain` (JAX's
// `_Int8Conv`).  Pass 1 reads each part once with 16-byte loads (f32 or
// bf16 as they are), reduces a block's max |x| and folds it into one
// device word by atomicMax on the bits of a non-negative float (which
// order as the floats do, a positive NaN above +inf).  Pass 2 reads the
// word, computes a_scale, writes it (block 0) and the int8 maps.  Nothing
// returns to the host.
//
// A map holding a NaN or an inf quantizes as on the CPU and in JAX: the
// max keeps a NaN (fmaxf would drop it) and the scale keeps it (as
// torch.clamp_min), so a_scale is NaN (a NaN) or inf (an inf, no NaN), and
// a NaN quotient (every x / NaN, inf / inf) maps to 0, as XLA's convert
// and PyTorch's CPU cast do: the int8 map is all zeros, and the conv's
// output NaN at every voxel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace tpuseg;

constexpr int kThreads = 256;

// max(a, b), a NaN where either is one (the canonical positive NaN)
__device__ __forceinline__ float max_keep_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

template <typename T>
__device__ __forceinline__ float part_absmax(const T* x, long long n) {
  constexpr int V = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nv = reinterpret_cast<uintptr_t>(x) % 16 == 0 ? n / V : 0;
  float m = 0.f;
  for (long long i = tid; i < nv; i += stride) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < V; ++j) m = max_keep_nan(m, fabsf(to_float(e[j])));
  }
  for (long long i = nv * V + tid; i < n; i += stride)
    m = max_keep_nan(m, fabsf(to_float(x[i])));
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    absmax_kernel(const T* a, long long na, const T* b, long long nb, unsigned int* amax) {
  __shared__ float red[kThreads / 32];
  float m = part_absmax(a, na);
  if (b != nullptr) m = max_keep_nan(m, part_absmax(b, nb));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max_keep_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kThreads / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) m = max_keep_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) atomicMax(amax, __float_as_uint(m));
  }
}

__device__ __forceinline__ int8_t quant(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s));
  if (r != r) return 0;  // a NaN quotient
  return (int8_t)(int)fminf(fmaxf(r, -127.f), 127.f);
}

template <typename T>
__device__ __forceinline__ void part_quantize(const T* x, int8_t* q, long long n, float s) {
  constexpr int V = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool aligned =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % V == 0;
  const long long nv = aligned ? n / V : 0;
  for (long long i = tid; i < nv; i += stride) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const T* e = reinterpret_cast<const T*>(&u);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < V; ++j)
      w[j / 4] |= (uint32_t)(uint8_t)quant(to_float(e[j]), s) << (8 * (j % 4));
    if constexpr (V == 4)
      *reinterpret_cast<uint32_t*>(q + i * V) = w[0];
    else
      *reinterpret_cast<uint2*>(q + i * V) = make_uint2(w[0], w[1]);
  }
  for (long long i = nv * V + tid; i < n; i += stride) q[i] = quant(to_float(x[i]), s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const T* a, int8_t* qa, long long na, const T* b, int8_t* qb, long long nb,
                    const unsigned int* amax, float* scale) {
  const float m = __uint_as_float(*amax);
  const float s = __fdiv_rn(m != m ? m : fmaxf(m, 1e-12f), 127.0f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale = s;
  part_quantize(a, qa, na, s);
  if (b != nullptr) part_quantize(b, qb, nb, s);
}

template <typename T>
int launch(const void* a, void* qa, long long na, const void* b, void* qb, long long nb,
           void* amax, void* scale, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long vecs = (na + nb) / (16 / sizeof(T)) + 1;
  const int grid = (int)max(1LL, min((long long)sms * 8, (vecs + kThreads - 1) / kThreads));
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return (int)err;
  absmax_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), na, static_cast<const T*>(b), nb,
      static_cast<unsigned int*>(amax));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  quantize_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<int8_t*>(qa), na, static_cast<const T*>(b),
      static_cast<int8_t*>(qb), nb, static_cast<const unsigned int*>(amax),
      static_cast<float*>(scale));
  return (int)cudaGetLastError();
}

}  // namespace

// a (na elements) and, unless b is null, b (nb): contiguous float32
// (dtype 0) or bfloat16 (1) maps; qa, qb their int8 maps; amax one 4-byte
// device word of scratch; scale the 0-d float32 a_scale.  Returns
// cudaGetLastError() after the two launches.
extern "C" int tpuseg_quantize_int8(const void* a, void* qa, long long na, const void* b,
                                    void* qb, long long nb, void* amax, void* scale,
                                    int dtype, void* stream) {
  if (a == nullptr || na < 0 || nb < 0 || (b == nullptr) != (nb == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch<float>(a, qa, na, b, qb, nb, amax, scale, s);
    case kBFloat16: return launch<__nv_bfloat16>(a, qa, na, b, qb, nb, amax, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
