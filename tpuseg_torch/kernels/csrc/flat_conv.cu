// Flat channels-last conv probe (K6): rows of a (N, D+2, S, C) input, S =
// (H+2)*WS voxel rows, each row carrying its three dz planes' channels
// (3C), times w2 (3C, 9*COUT) in bf16 on the tensor cores with fp32
// accumulation; then out[s, co] = sum_{dy,dx} Y[s + dy*WS + dx,
// (dy*3+dx)*COUT + co] over the SV = H*WS output rows.  Rows at or past S
// read as zero.
//
// Replaces the Pallas probes benchmarks/kmicro3_r2.py `run_pre` (the 3C
// rows read from a prebuilt xcat (N, D, S, 3C)) and `run_cat` (the rows
// built from the three dz-shifted planes inside the kernel).  Python
// wrapper and design note: tpuseg_torch/kernels/flat_conv.py.
//
// One block owns TM = 112 output rows of one (n, d) plane.  It stages the
// 3C x 144 weight and the TM + 2*WS + 16 input rows its outputs read in
// shared memory (16-byte loads, zero past S), then for each dy computes the
// dy group's 48 columns of Y on the 128 rows that start dy*WS further down
// (8 warps, one m16 tile each, 6 n8 tiles, m16n8k16 bf16 mma.sync from
// ldmatrix fragments), parks them in shared memory as fp32 and adds each
// output row's three dx terms into registers.  Y is so computed only on
// the rows the assembly reads (plus 16 of tile padding), instead of on the
// TPU chunk's whole ROWS + HALO window.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace tpuseg;  // ldmatrix / mma helpers (common.cuh)
using bf16 = __nv_bfloat16;

constexpr int COUT = 16;          // output channels (the probe's)
constexpr int TM = 112;           // output rows per block
constexpr int GM = TM + 16;       // Y rows per dy group: 8 m16 tiles
constexpr int THREADS = 256;      // 8 warps
constexpr int NY = 9 * COUT;      // Y columns
constexpr int NG = 3 * COUT;      // Y columns of one dy group (dx, co)
constexpr int WST = NY + 8;       // weight row stride: 304 B
constexpr int YS = NG + 4;        // Y tile row stride, floats

template <bool PRE>
__global__ void __launch_bounds__(THREADS) flat_conv_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w2,
    bf16* __restrict__ out, int D, int S, int SV, int C, int WS) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = 3 * C;
  const int KS = K + 8;  // input row stride: ldmatrix rows in 8 bank groups
  const int R = GM + 2 * WS;
  bf16* Wsm = reinterpret_cast<bf16*>(smem);
  bf16* Xs = Wsm + K * WST;
  float* Ys = reinterpret_cast<float*>(Xs + R * KS);

  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * TM;
  const int n = blockIdx.y / D, d = blockIdx.y - n * D;

  for (int i = tid; i < K * (NY / 8); i += THREADS) {
    const int r = i / (NY / 8), c = (i - r * (NY / 8)) * 8;
    *reinterpret_cast<uint4*>(Wsm + r * WST + c) =
        __ldg(reinterpret_cast<const uint4*>(w2 + (size_t)r * NY + c));
  }
  const int kc = K / 8;
  for (int i = tid; i < R * kc; i += THREADS) {
    const int r = i / kc, q = i - r * kc;
    const int s = s0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (s < S) {
      const bf16* src;
      if (PRE) {
        src = x + (((size_t)n * D + d) * S + s) * K + q * 8;
      } else {
        const int dz = (q * 8) / C, c = q * 8 - dz * C;
        src = x + (((size_t)n * (D + 2) + d + dz) * S + s) * C + c;
      }
      v = __ldg(reinterpret_cast<const uint4*>(src));
    }
    *reinterpret_cast<uint4*>(Xs + r * KS + q * 8) = v;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  // assembly: thread tid < 2 TM owns output row tid / 2, channels
  // (tid % 2) * 8 .. + 8
  const int orow = tid >> 1, ohalf = tid & 1;
  float o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = 0.f;

  for (int dy = 0; dy < 3; ++dy) {
    float acc[6][4];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    const bf16* arow = Xs + (dy * WS + warp * 16 + (lane & 15)) * KS + (lane >> 4) * 8;
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, arow + k0);
#pragma unroll
      for (int np = 0; np < 3; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Wsm + (k0 + (lane & 15)) * WST + dy * NG + np * 16 + (lane >> 4) * 8);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_bf16_16816(acc[2 * np], a, b0);
        mma_bf16_16816(acc[2 * np + 1], a, b1);
      }
    }
    const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
    for (int nt = 0; nt < 6; ++nt) {
      float* y = Ys + (warp * 16 + g) * YS + nt * 8 + c2;
      y[0] = acc[nt][0];
      y[1] = acc[nt][1];
      y[8 * YS] = acc[nt][2];
      y[8 * YS + 1] = acc[nt][3];
    }
    __syncthreads();
    if (tid < 2 * TM) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* y = Ys + (orow + dx) * YS + dx * COUT + ohalf * 8;
        const float4 u = *reinterpret_cast<const float4*>(y);
        const float4 w = *reinterpret_cast<const float4*>(y + 4);
        o[0] += u.x; o[1] += u.y; o[2] += u.z; o[3] += u.w;
        o[4] += w.x; o[5] += w.y; o[6] += w.z; o[7] += w.w;
      }
    }
    __syncthreads();  // the next dy group overwrites Ys
  }
  const int s = s0 + orow;
  if (tid < 2 * TM && s < SV)
    *reinterpret_cast<uint4*>(out + (((size_t)n * D + d) * SV + s) * COUT + ohalf * 8) =
        pack_bf16x8(o);
}

}  // namespace

// pre: x is xcat (n, d, s, 3c); else x is xflat (n, d + 2, s, c).  w2
// (3c, 144) and out (n, d, sv, 16) bf16; all contiguous and 16-byte
// aligned; c a multiple of 16, sv + 2 ws <= s.  Returns cudaGetLastError()
// after the launch.
extern "C" int tpuseg_flat_conv(const void* x, const void* w2, void* out,
                                int n, int d, int s, int sv, int c, int ws,
                                int pre, void* stream) {
  if (n < 1 || d < 1 || c < 16 || c % 16 || ws < 1 || sv < 1 ||
      sv + 2 * ws > s || (long long)n * d > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w2) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)3 * c * WST * 2 + (size_t)(GM + 2 * ws) * (3 * c + 8) * 2 +
                      (size_t)GM * YS * 4;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = pre ? flat_conv_kernel<true> : flat_conv_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sv + TM - 1) / TM, n * d);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w2),
      static_cast<bf16*>(out), d, s, sv, c, ws);
  return static_cast<int>(cudaGetLastError());
}
