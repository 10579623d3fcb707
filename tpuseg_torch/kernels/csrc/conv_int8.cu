// W8A8 int8 convolution for Hopper: an implicit GEMM on int8 mma.sync.
//
// y[m, o] = cast(float(acc[m, o]) * scale[o] (+ bias[o])),
// acc[m, o] = sum_k A[m, k] * W[o, k]   (exact, int32)
//
// m runs over the output voxels (n, od, oh, ow) of a channels-last map, k
// over the taps and input channels (td, th, tw, ci) with ci fastest, o
// over the output channels.  A is never written out: each 16-byte piece
// of an A row is 16 consecutive input channels of one tap at one voxel,
// copied from the int8 NDHWC input by cp.async (zero-filled where the tap
// falls in the padding), so the input channels must be a multiple of 16
// (the wrapper pads them).  W is the packed weight (cout_pad, k_pad),
// k-contiguous and zero beyond K and Cout.
//
// A block of 128 threads (4 warps) computes a BM x BN tile of y through a
// 3-stage cp.async ring of k32 slices; each warp a WM x WN sub-tile as
// (WM/16) x (WN/8) mma.sync.m16n8k32 s8 products.  The A and B slices
// sit in shared memory as rows of 32 bytes at a stride of 48, so the
// 32-bit fragment loads of a warp (8 rows x 4 words) hit 32 banks.
//
// The epilogue rounds as the JAX reference does: float(acc) (nearest),
// times scale[o] = a_scale * w_scale[o] (rounded once, made by the
// caller), then bias_mode 1 adds the bias in fp32 before the cast to the
// output dtype, bias_mode 2 casts the product and the bias to the output
// dtype first and adds those (the packed nets' `conv + bias` in the
// activation dtype).  __fmul_rn / __fadd_rn keep the compiler from
// fusing the multiply and the add.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 3;
constexpr int kBK = 32;        // bytes of k per slice (one mma k32)
constexpr int kRowBytes = 48;  // shared row stride: 32 data + 16 pad

struct Int8ConvParams {
  int n, d, h, w, cin;       // input (cin a multiple of 16)
  int od, oh, ow, cout;      // output
  int kd, kh, kw;            // taps
  int sd, sh, sw;            // strides
  int pd, ph, pw;            // low padding (the high padding is implied)
  int k, k_pad;              // taps * cin, rounded up to 32
  int bias_mode;             // 0 none, 1 in fp32, 2 in the output dtype
};

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int BM, int BN, int WM, int WN, typename OutT>
__global__ void __launch_bounds__(kThreads)
    conv_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     OutT* __restrict__ y, Int8ConvParams p) {
  static_assert((BM / WM) * (BN / WN) == kThreads / 32, "4 warps per block");
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int A_CHUNKS = BM * 2 / kThreads;  // 16-byte pieces per thread
  static_assert(A_CHUNKS * kThreads == BM * 2, "BM");

  __shared__ __align__(16) int8_t sa[kStages][BM * kRowBytes];
  __shared__ __align__(16) int8_t sb[kStages][BN * kRowBytes];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long m_total = (long long)p.n * p.od * p.oh * p.ow;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int half = tid & 1;  // which 16 bytes of a 32-byte A row this thread copies

  // the output voxels of this thread's A rows: row = (tid >> 1) + i * 64
  long long base[A_CHUNKS];
  int iz[A_CHUNKS], iy[A_CHUNKS], ix[A_CHUNKS];
  bool live[A_CHUNKS];
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    const long long m = m0 + (tid >> 1) + i * (kThreads / 2);
    live[i] = m < m_total;
    const long long mm = live[i] ? m : 0;
    const int ox = (int)(mm % p.ow);
    const long long r1 = mm / p.ow;
    const int oy = (int)(r1 % p.oh);
    const long long r2 = r1 / p.oh;
    const int oz = (int)(r2 % p.od);
    const long long nn = r2 / p.od;
    iz[i] = oz * p.sd - p.pd;
    iy[i] = oy * p.sh - p.ph;
    ix[i] = ox * p.sw - p.pw;
    base[i] = nn * p.d;
  }

  auto load_slice = [&](int slot, int kt) {
    // A: tap and channel of this thread's 16 bytes
    const int kk = kt * kBK + half * 16;
    const bool k_ok = kk < p.k;
    int tz = 0, ty = 0, tx = 0, ci = 0;
    if (k_ok) {
      const int tap = kk / p.cin;
      ci = kk - tap * p.cin;
      tz = tap / (p.kh * p.kw);
      const int rem = tap - tz * p.kh * p.kw;
      ty = rem / p.kw;
      tx = rem - ty * p.kw;
    }
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int row = (tid >> 1) + i * (kThreads / 2);
      const int z = iz[i] + tz, yy = iy[i] + ty, xx = ix[i] + tx;
      const bool ok = k_ok && live[i] && z >= 0 && z < p.d && yy >= 0 && yy < p.h &&
                      xx >= 0 && xx < p.w;
      const int8_t* src = x;
      if (ok) src = x + (((base[i] + z) * p.h + yy) * p.w + xx) * (long long)p.cin + ci;
      tpuseg::cp_async_zfill<16>(&sa[slot][row * kRowBytes + half * 16], src, ok);
    }
    // B: BN rows of the packed weight, 32 bytes each
    for (int c = tid; c < BN * 2; c += kThreads) {
      const int row = c >> 1, hb = c & 1;
      const int8_t* src = wp + (long long)(n0 + row) * p.k_pad + kt * kBK + hb * 16;
      tpuseg::cp_async_zfill<16>(&sb[slot][row * kRowBytes + hb * 16], src, true);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int wm0 = (warp / (BN / WN)) * WM, wn0 = (warp % (BN / WN)) * WN;
  const int kt_total = p.k_pad / kBK;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_total) load_slice(s, s);
    tpuseg::cp_async_commit();
  }

  for (int kt = 0; kt < kt_total; ++kt) {
    tpuseg::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < kt_total) load_slice(next % kStages, next);
    tpuseg::cp_async_commit();

    const int8_t* a_s = sa[kt % kStages];
    const int8_t* b_s = sb[kt % kStages];
    uint32_t af[MT][4], bf[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int8_t* r0 = a_s + (wm0 + i * 16 + g) * kRowBytes + t4 * 4;
      const int8_t* r8 = r0 + 8 * kRowBytes;
      af[i][0] = *reinterpret_cast<const uint32_t*>(r0);
      af[i][1] = *reinterpret_cast<const uint32_t*>(r8);
      af[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      af[i][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int8_t* r = b_s + (wn0 + j * 8 + g) * kRowBytes + t4 * 4;
      bf[j][0] = *reinterpret_cast<const uint32_t*>(r);
      bf[j][1] = *reinterpret_cast<const uint32_t*>(r + 16);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_s8_16832(acc[i][j], af[i], bf[j]);
  }
  tpuseg::cp_async_wait<0>();

  // epilogue: rows g and g + 8 of each m16 tile, columns 2 t4 + {0, 1}
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const long long m = m0 + wm0 + i * 16 + g + hr * 8;
      if (m >= m_total) continue;
      OutT* yrow = y + m * p.cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int o = n0 + wn0 + j * 8 + t4 * 2 + c;
          if (o >= p.cout) continue;
          float v = __fmul_rn(__int2float_rn(acc[i][j][hr * 2 + c]), scale[o]);
          if (p.bias_mode == 1) {
            v = __fadd_rn(v, bias[o]);
          } else if (p.bias_mode == 2) {
            v = __fadd_rn(round_to<OutT>(v), round_to<OutT>(bias[o]));
          }
          yrow[o] = from_float<OutT>(v);
        }
      }
    }
  }
}

template <int BM, int BN, int WM, int WN, typename OutT>
int launch(const void* x, const void* wp, const void* scale, const void* bias, void* y,
           const Int8ConvParams& p, cudaStream_t stream) {
  const long long m_total = (long long)p.n * p.od * p.oh * p.ow;
  const dim3 grid((unsigned)((m_total + BM - 1) / BM), (unsigned)((p.cout + BN - 1) / BN));
  conv_int8_kernel<BM, BN, WM, WN, OutT><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wp),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<OutT*>(y), p);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_bn(int bn, const void* x, const void* wp, const void* scale, const void* bias,
              void* y, const Int8ConvParams& p, cudaStream_t stream) {
  switch (bn) {
    case 16: return launch<128, 16, 32, 16, OutT>(x, wp, scale, bias, y, p, stream);
    case 32: return launch<128, 32, 64, 16, OutT>(x, wp, scale, bias, y, p, stream);
    case 64: return launch<128, 64, 64, 32, OutT>(x, wp, scale, bias, y, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (n, d, h, w, cin) int8 NDHWC, cin % 16 == 0; wp (cout_pad, k_pad) int8
// with cout_pad a multiple of bn; scale (cout,) fp32; bias (cout,) fp32 or
// null (bias_mode 0); y (n, od, oh, ow, cout) of out_dtype (0 fp32, 1
// bf16).  bn is 16, 32 or 64.
extern "C" int tpuseg_conv_int8(const void* x, const void* wp, const void* scale,
                                const void* bias, void* y, int n, int d, int h, int w,
                                int cin, int od, int oh, int ow, int cout, int kd, int kh,
                                int kw, int sd, int sh, int sw, int pd, int ph, int pw,
                                int k_pad, int bn, int bias_mode, int out_dtype,
                                void* stream) {
  if (cin % 16 != 0 || k_pad % kBK != 0) return (int)cudaErrorInvalidValue;
  Int8ConvParams p{n, d, h, w, cin, od, oh, ow, cout, kd, kh, kw, sd, sh, sw,
                   pd, ph, pw, kd * kh * kw * cin, k_pad, bias_mode};
  if (p.k > k_pad) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return launch_bn<float>(bn, x, wp, scale, bias, y, p, s);
    case 1: return launch_bn<__nv_bfloat16>(bn, x, wp, scale, bias, y, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
