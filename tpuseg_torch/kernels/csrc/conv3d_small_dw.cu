// Weight gradient of the stride-1 SAME 3x3x3 conv on NDHWC for small channel
// counts (the backward of csrc/conv3d_small.cu), fp32 accumulation:
//   dw[dz, dy, dx, ci, co] = sum_{n,z,y,x} xpad[n, z+dz-1, y+dy-1, x+dx-1, ci]
//                                          * g[n, z, y, x, co]
// with xpad zero outside the volume.  dw is (27, cin, cout) fp32 (DHWIO).
//
// Replaces the XLA conv VJP that tpuseg/kernels/conv3d.py
// `conv3d_small_vjp` falls back to.  Python wrapper and design note:
// tpuseg_torch/kernels/conv3d.py.
//
// A split-V reduction in two launches:
//  1. conv3d_dw_partial_kernel: the output rows (n, z, y) times the x
//     segments of width tw form "row groups"; block (chunk, part) walks a
//     contiguous range of them.  Per row group it stages in shared memory
//     the 9 input rows (dz, dy) the row touches, (tw + 2) x cin_pad each as
//     [row][x][ci], and the row's gradient, tw x cout_pad as [x][co].  Each
//     thread owns one tap (dz, dy, dx), CIT input and COT output channels
//     and keeps that CIT x COT tile of dw in registers across the whole
//     range: per position it reads one float4 of x and two of g and does 32
//     FMAs.  The taps x channel tiles are split over the blocks of grid.y
//     when they outnumber the threads.  At the end each thread writes its
//     tile to partial[chunk] (every chunk writes all of dw once).
//  2. conv3d_dw_reduce_kernel: dw[i] = sum over chunks of partial[.][i] in
//     fp64, in a fixed order (deterministic).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int CIT = 4;        // input channels per thread tile
constexpr int COT = 8;        // output channels per thread tile
constexpr int THREADS = 256;  // threads per block
constexpr int MAX_C = 64;
constexpr int SMEM_FLOATS = 12 * 1024;  // 48 KB: staged x rows and g row
constexpr int REDUCE_THREADS = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) conv3d_dw_partial_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    float* __restrict__ partial, int D, int H, int W, int cin, int cout,
    int cin_pad, int cout_pad, int tw, int n_seg, long long n_groups,
    long long groups_per_chunk) {
  __shared__ __align__(16) float sm[SMEM_FLOATS];
  const int tw2 = tw + 2;
  float* xs = sm;                       // [9][tw2][cin_pad]
  float* gs = sm + 9 * tw2 * cin_pad;   // [tw][cout_pad]
  const int ncog = cout_pad / COT;
  const int ncig = cin_pad / CIT;
  const int tile = blockIdx.y * THREADS + threadIdx.x;
  const bool active = tile < 27 * ncig * ncog;
  const int cog = tile % ncog;
  const int cig = (tile / ncog) % ncig;
  const int tap = tile / (ncog * ncig);  // 9 dz + 3 dy + dx
  const int dxo = tap % 3;

  float acc[CIT][COT];
#pragma unroll
  for (int i = 0; i < CIT; ++i)
#pragma unroll
    for (int k = 0; k < COT; ++k) acc[i][k] = 0.f;

  const long long r0 = (long long)blockIdx.x * groups_per_chunk;
  const long long r1 =
      r0 + groups_per_chunk < n_groups ? r0 + groups_per_chunk : n_groups;
  const int cinv = cin_pad / VEC;
  const int x_items = 9 * tw2 * cinv;
  const int g_items = tw * cout_pad;
  for (long long rg = r0; rg < r1; ++rg) {
    const int seg = (int)(rg % n_seg);
    const long long row = rg / n_seg;  // (n * D + z) * H + y
    const int y = (int)(row % H);
    const long long nz = row / H;      // n * D + z
    const int z = (int)(nz % D);
    const long long n = nz / D;
    const int x0 = seg * tw;
    __syncthreads();  // every thread is done with the previous row group
    for (int i = threadIdx.x; i < x_items; i += THREADS) {
      const int r = i / (tw2 * cinv);  // dz * 3 + dy
      const int rem = i - r * tw2 * cinv;
      const int lx = rem / cinv;
      const int ci = (rem - lx * cinv) * VEC;
      const int zi = z + r / 3 - 1;
      const int yi = y + r % 3 - 1;
      const int xi = x0 + lx - 1;
      float v[VEC];
      if (zi >= 0 && zi < D && yi >= 0 && yi < H && xi >= 0 && xi < W &&
          ci < cin) {
        tpuseg::load_vec<VEC>(
            x + ((((size_t)n * D + zi) * H + yi) * (size_t)W + xi) * cin + ci,
            v);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = 0.f;
      }
      float* dst = xs + (r * tw2 + lx) * cin_pad + ci;
#pragma unroll
      for (int k = 0; k < VEC; ++k) dst[k] = v[k];
    }
    const size_t g_row = (size_t)row * W;
    for (int i = threadIdx.x; i < g_items; i += THREADS) {
      const int lx = i / cout_pad;
      const int co = i - lx * cout_pad;
      const int xo = x0 + lx;
      gs[i] = xo < W && co < cout
                  ? tpuseg::to_float(g[(g_row + xo) * cout + co])
                  : 0.f;
    }
    __syncthreads();
    if (active) {
      const float* xr = xs + ((tap / 3) * tw2 + dxo) * cin_pad + cig * CIT;
      const float* gr = gs + cog * COT;
      const int npos = W - x0 < tw ? W - x0 : tw;
#pragma unroll 2
      for (int p = 0; p < npos; ++p) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + p * cin_pad);
        const float4 ga = *reinterpret_cast<const float4*>(gr + p * cout_pad);
        const float4 gb = *reinterpret_cast<const float4*>(gr + p * cout_pad + 4);
        const float xa[CIT] = {xv.x, xv.y, xv.z, xv.w};
        const float gv[COT] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
        for (int i = 0; i < CIT; ++i)
#pragma unroll
          for (int k = 0; k < COT; ++k) acc[i][k] = fmaf(xa[i], gv[k], acc[i][k]);
      }
    }
  }
  if (!active) return;
  float* out = partial + ((size_t)blockIdx.x * 27 + tap) * cin * cout;
#pragma unroll
  for (int i = 0; i < CIT; ++i) {
    const int ci = cig * CIT + i;
    if (ci >= cin) break;
#pragma unroll
    for (int k = 0; k < COT; ++k) {
      const int co = cog * COT + k;
      if (co < cout) out[ci * cout + co] = acc[i][k];
    }
  }
}

__global__ void __launch_bounds__(REDUCE_THREADS) conv3d_dw_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ dw, int n_chunks,
    int m) {
  const int i = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= m) return;
  double s = 0.0;
  for (int k = 0; k < n_chunks; ++k) s += partial[(size_t)k * m + i];
  dw[i] = static_cast<float>(s);
}

template <typename T>
void launch_partial(const T* x, const T* g, float* partial, dim3 grid,
                    bool vec4, int d, int h, int w, int cin, int cout,
                    int cin_pad, int cout_pad, int tw, int n_seg,
                    long long n_groups, long long per_chunk, cudaStream_t s) {
  if (vec4)
    conv3d_dw_partial_kernel<T, 4><<<grid, THREADS, 0, s>>>(
        x, g, partial, d, h, w, cin, cout, cin_pad, cout_pad, tw, n_seg,
        n_groups, per_chunk);
  else
    conv3d_dw_partial_kernel<T, 1><<<grid, THREADS, 0, s>>>(
        x, g, partial, d, h, w, cin, cout, cin_pad, cout_pad, tw, n_seg,
        n_groups, per_chunk);
}

}  // namespace

// x (n, d, h, w, cin) and g (n, d, h, w, cout) contiguous, of `dtype`;
// partial (n_chunks, 27, cin, cout) fp32 scratch; dw (27, cin, cout) fp32.
// tw: x segment width, with 9 * (tw + 2) * cin_pad + tw * cout_pad staged
// floats fitting SMEM_FLOATS (cin_pad = cin rounded up to 4, cout_pad = cout
// rounded up to 8).  Returns cudaGetLastError() after the launches.
extern "C" int tpuseg_conv3d_small_dw(const void* x, const void* g,
                                      void* partial, void* dw, int n, int d,
                                      int h, int w, int cin, int cout, int tw,
                                      int n_chunks, int dtype, void* stream) {
  const int cin_pad = (cin + CIT - 1) / CIT * CIT;
  const int cout_pad = (cout + COT - 1) / COT * COT;
  if (cin < 1 || cin > MAX_C || cout < 1 || cout > MAX_C || tw < 1 ||
      9 * (tw + 2) * cin_pad + tw * cout_pad > SMEM_FLOATS || n < 1 ||
      d < 1 || h < 1 || w < 1 || n_chunks < 1 || n_chunks > 2147483647)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_seg = (w + tw - 1) / tw;
  const long long n_groups = (long long)n * d * h * n_seg;
  const long long per_chunk = (n_groups + n_chunks - 1) / n_chunks;
  const int tiles = 27 * (cin_pad / CIT) * (cout_pad / COT);
  const dim3 grid(n_chunks, (tiles + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(partial);
  const bool vec4 = cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (dtype == tpuseg::kFloat32)
    launch_partial<float>(static_cast<const float*>(x),
                          static_cast<const float*>(g), pa, grid, vec4, d, h,
                          w, cin, cout, cin_pad, cout_pad, tw, n_seg, n_groups,
                          per_chunk, s);
  else if (dtype == tpuseg::kBFloat16)
    launch_partial<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(x),
                                  static_cast<const __nv_bfloat16*>(g), pa,
                                  grid, vec4, d, h, w, cin, cout, cin_pad,
                                  cout_pad, tw, n_seg, n_groups, per_chunk, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = 27 * cin * cout;
  conv3d_dw_reduce_kernel<<<(m + REDUCE_THREADS - 1) / REDUCE_THREADS,
                            REDUCE_THREADS, 0, s>>>(pa, static_cast<float*>(dw),
                                                    n_chunks, m);
  return static_cast<int>(cudaGetLastError());
}
