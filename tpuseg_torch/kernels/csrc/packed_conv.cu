// Structured space-to-depth packed k3 conv: the SAME coarse 3x3x3 conv of
// one or two delta-major packed NDHWC tensors with a 1/8-dense kernel,
// paying only the structural multiply-adds, fp32 accumulation, optional
// bias and ReLU.
//
// Replaces the Pallas kernel tpuseg/kernels/packed_conv.py
// `packed_conv3d_structured`.  Python wrapper and design note:
// tpuseg_torch/kernels/packed_conv.py.
//
// An implicit GEMM on CUDA cores: out[p, o] = sum_k A[p, k] * Wk[k, o] over
// the output positions p (n, z, y, x flattened) and the structural rows k.
// Row k of Wk is one valid (tap, input channel) pair of one part; `rows[k]`
// encodes that part, tap and channel, so A[p, k] is a read of the part at
// p shifted by the tap (zero outside the volume).  A block owns BM
// consecutive positions and BN output channels.  Per step of KC rows it
// gathers the A tile into shared memory ([k][p], 8 consecutive rows of one
// position per 8 lanes, so that the gather reads 8 consecutive channels and
// the transposed store hits 32 banks) and copies the KC x BN weight tile,
// then every thread accumulates an 8 x 8 (positions x channels) register
// tile from two float4 of each, split in halves 64 apart so that a
// quarter-warp's float4 reads are 128 consecutive bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 128;        // output positions per block
constexpr int BN = 128;        // output channels per block
constexpr int KC = 32;         // structural rows per step
constexpr int THREADS = 256;   // 16 x 16 threads of 8 x 8 outputs
constexpr int AS = BM + 4;     // A tile row stride: 16-byte rows
constexpr int MAX_C8 = 1 << 16;

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) packed_conv_kernel(
    const T* __restrict__ xa, const T* __restrict__ xb, int c8a, int c8b,
    const int* __restrict__ rows, const float* __restrict__ wk,
    const float* __restrict__ bias, T* __restrict__ y, int D, int H, int W,
    long long npos, int K, int n_pad, int f8, int relu) {
  __shared__ __align__(16) float As[KC][AS];
  __shared__ __align__(16) float Bs[KC][BN];
  __shared__ int4 pos[BM];  // (n * D, z, y, x) of each position of the block
  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;

  for (int m = tid; m < BM; m += THREADS) {
    const long long p = p0 + m;
    int4 q = make_int4(0, -4, 0, 0);  // z = -4: every tap falls outside
    if (p < npos) {
      long long t = p / W;
      q.w = (int)(p - t * W);
      const long long t2 = t / H;
      q.z = (int)(t - t2 * H);
      const long long n = t2 / D;
      q.y = (int)(t2 - n * D);
      q.x = (int)(n * D);
    }
    pos[m] = q;
  }

  const int klo = tid & 7;    // gather: row within a group of 8
  const int mg = tid >> 3;    // gather: first position, then + 32 j
  const int tm = tid >> 4;    // compute: positions tm*4.. and 64+tm*4..
  const int tn = tid & 15;    // compute: channels tn*4.. and 64+tn*4..

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();  // pos is written; the previous step's tiles are used
#pragma unroll
    for (int kh = 0; kh < KC / 8; ++kh) {
      const int kr = kh * 8 + klo;
      const int code = __ldg(rows + k0 + kr);
      const int ch = code & 0xffff;
      const int tap = (code >> 16) & 0xff;
      const bool second = (code >> 24) != 0;
      const T* src = second ? xb : xa;
      const int c8 = second ? c8b : c8a;
      const int dz = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dx = tap % 3 - 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = mg + 32 * j;
        const int4 q = pos[m];
        const int zi = q.y + dz, yi = q.z + dy, xi = q.w + dx;
        float v = 0.f;
        if (zi >= 0 && zi < D && yi >= 0 && yi < H && xi >= 0 && xi < W)
          v = tpuseg::to_float(
              src[(((long long)(q.x + zi) * H + yi) * W + xi) * c8 + ch]);
        As[kr][m] = v;
      }
    }
#pragma unroll
    for (int i = tid; i < KC * BN / 4; i += THREADS) {
      const int r = i / (BN / 4);
      const int c = (i - r * (BN / 4)) * 4;
      *reinterpret_cast<float4*>(&Bs[r][c]) = __ldg(
          reinterpret_cast<const float4*>(wk + (size_t)(k0 + r) * n_pad + o0 + c));
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][tm * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + tm * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tn * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tn * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long p = p0 + (i < 4 ? tm * 4 + i : 64 + tm * 4 + i - 4);
    if (p >= npos) continue;
    T* dst = y + p * f8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = o0 + (j < 4 ? tn * 4 + j : 64 + tn * 4 + j - 4);
      if (o >= f8) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[o];
      if (relu) v = fmaxf(v, 0.f);
      tpuseg::store_float(dst + o, v);
    }
  }
}

}  // namespace

// xa (n, d, h, w, c8a) and, when c8b > 0, xb (n, d, h, w, c8b) contiguous,
// of `dtype`; rows (k,) int32 and wk (k, n_pad) fp32 contiguous, wk 16-byte
// aligned, k a multiple of 32 and n_pad of 128; bias (f8,) fp32 or null;
// y (n, d, h, w, f8).  Returns cudaGetLastError() after the launch.
extern "C" int tpuseg_packed_conv3d(const void* xa, const void* xb, int c8a,
                                    int c8b, const void* rows, const void* wk,
                                    const void* bias, void* y, int n, int d,
                                    int h, int w, int k, int n_pad, int f8,
                                    int relu, int dtype, void* stream) {
  const long long npos = (long long)n * d * h * w;
  const long long blocks = (npos + BM - 1) / BM;
  if (n < 1 || d < 1 || h < 1 || w < 1 || c8a < 1 || c8a > MAX_C8 ||
      c8b < 0 || c8b > MAX_C8 || (c8b > 0) != (xb != nullptr) || k < KC ||
      k % KC != 0 || n_pad % BN != 0 || f8 < 1 || f8 > n_pad ||
      n_pad / BN > 65535 || blocks > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(wk) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)blocks, n_pad / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows);
  const float* wp = static_cast<const float*>(wk);
  const float* bp = static_cast<const float*>(bias);
  if (dtype == tpuseg::kFloat32) {
    packed_conv_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(xa), static_cast<const float*>(xb), c8a, c8b,
        r, wp, bp, static_cast<float*>(y), d, h, w, npos, k, n_pad, f8, relu);
  } else if (dtype == tpuseg::kBFloat16) {
    packed_conv_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(xa),
        static_cast<const __nv_bfloat16*>(xb), c8a, c8b, r, wp, bp,
        static_cast<__nv_bfloat16*>(y), d, h, w, npos, k, n_pad, f8, relu);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
