// Direct stride-1 SAME 3x3x3 conv on NDHWC for small channel counts
// (8 <= Cin <= 64, 2 <= Cout <= 64), no bias, fp32 accumulation.
//
// Replaces the Pallas kernel tpuseg/kernels/conv3d.py `conv3d_small`.
// Python wrapper and design note: tpuseg_torch/kernels/conv3d.py.
//
// One block computes TY output rows y0..y0+TY-1 of one (sample, depth z)
// plane, over `tw` consecutive x positions and all Cout channels.  For each
// of the 3 dz taps it stages the TY + 2 input rows of that plane that the
// block's receptive field touches, (tw + 2) x Cin each, in shared memory
// (zero outside the volume, transposed to [row][ci][x] so that threads read
// neighbouring banks), loading 4 channels per thread and instruction where
// Cin allows.  Every thread then accumulates an XT x CO register
// tile (XT consecutive x positions of one output row times CO consecutive
// output channels) over the 3 dy and 3 dx taps and the Cin input channels.
// Each staged row serves up to 3 output rows of the block.  Weights are
// read through the read-only cache as float4 from a (27, Cin, cout_pad)
// fp32 array, packed once per layer weight on the Python side; cout_pad
// rounds Cout up to a multiple of CO with zeros.  A tiny kernel launched first prefetches
// that array into L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int XT = 4;         // output x positions per thread
constexpr int CO = 8;         // output channels per thread
constexpr int TY = 4;         // output rows per block
constexpr int MAX_CIN = 64;
constexpr int MAX_TW = 64;    // output x positions per block
constexpr int SMEM_FLOATS = 12 * 1024;  // 48 KB of staged input rows
constexpr int MAX_THREADS = TY * (MAX_TW / XT) * (64 / CO);

template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_THREADS) conv3d_small_kernel(
    const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
    int D, int H, int W, int cin, int cout, int cout_pad, int tw) {
  __shared__ float tile[SMEM_FLOATS];
  const int tw2 = tw + 2;
  const int row_stride = cin * tw2;
  const int x0 = blockIdx.x * tw;
  const int y0 = blockIdx.y * TY;
  const int n = blockIdx.z / D;
  const int zc = blockIdx.z - n * D;
  const int ncg = cout_pad / CO;
  const int nxq = tw / XT;
  const int g = threadIdx.x % ncg;                  // output-channel group
  const int xl = ((threadIdx.x / ncg) % nxq) * XT;  // first x, block-local
  const int ty = threadIdx.x / (ncg * nxq);          // output row, block-local

  float acc[XT][CO];
#pragma unroll
  for (int j = 0; j < XT; ++j)
#pragma unroll
    for (int k = 0; k < CO; ++k) acc[j][k] = 0.f;

  for (int dz = 0; dz < 3; ++dz) {
    const int zi = zc + dz - 1;
    const bool z_ok = zi >= 0 && zi < D;
    __syncthreads();  // every thread is done with the previous plane
    // one item = VEC consecutive channels of one (row, x) position
    const int cinv = cin / VEC;
    const int per_row = tw2 * cinv;
    const int items = (TY + 2) * per_row;
#pragma unroll 4
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int row = i / per_row;
      const int rem = i - row * per_row;
      const int lx = rem / cinv;
      const int ci = (rem - lx * cinv) * VEC;
      const int yi = y0 + row - 1;
      const int gx = x0 + lx - 1;
      float v[VEC];
      if (z_ok && yi >= 0 && yi < H && gx >= 0 && gx < W) {
        tpuseg::load_vec<VEC>(
            x + ((((size_t)n * D + zi) * H + yi) * (size_t)W + gx) * cin + ci, v);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = 0.f;
      }
      float* dst = tile + row * row_stride + ci * tw2 + lx;
#pragma unroll
      for (int k = 0; k < VEC; ++k) dst[k * tw2] = v[k];
    }
    __syncthreads();
    // tap (dz, dy, dx) is row (9 dz + 3 dy + dx) of w
    const float* wz = w + (size_t)dz * 9 * cin * cout_pad + g * CO;
#pragma unroll 2
    for (int ci = 0; ci < cin; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* src = tile + (ty + dy) * row_stride + ci * tw2 + xl;
        float in[XT + 2];
#pragma unroll
        for (int j = 0; j < XT + 2; ++j) in[j] = src[j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4* wp = reinterpret_cast<const float4*>(
              wz + ((size_t)(dy * 3 + dx) * cin + ci) * cout_pad);
          const float4 a = __ldg(wp);
          const float4 b = __ldg(wp + 1);
          const float wv[CO] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int j = 0; j < XT; ++j)
#pragma unroll
            for (int k = 0; k < CO; ++k)
              acc[j][k] = fmaf(in[j + dx], wv[k], acc[j][k]);
        }
      }
    }
  }
  const int yo = y0 + ty;
  if (yo >= H) return;
  const size_t out_row = (((size_t)n * D + zc) * H + yo) * (size_t)W;
#pragma unroll
  for (int j = 0; j < XT; ++j) {
    const int gx = x0 + xl + j;
    if (gx >= W) break;
    T* dst = y + (out_row + gx) * cout;
#pragma unroll
    for (int k = 0; k < CO; ++k) {
      const int co = g * CO + k;
      if (co < cout) tpuseg::store_float(dst + co, acc[j][k]);
    }
  }
}

// Pulls the packed weight into L2 ahead of the conv, one 128-byte line per
// thread.  Every block of the conv reads all of it from its first
// instructions, and a weight packed long before the launch has left L2 (a
// forward moves more activation bytes than L2 holds between two uses), so
// the first wave would wait on one miss after another as it walks the
// channels.  The lines end at most 127 bytes past the array, inside the
// caching allocator's 512-byte granule.
__global__ void prefetch_l2_kernel(const char* __restrict__ p, int lines) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < lines)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + (size_t)i * 128));
}

}  // namespace

// x (n, d, h, w, cin) and y (n, d, h, w, cout) contiguous, of `dtype`
// (float32 only: bf16 convs run csrc/conv3d_small_tc.cu);
// w_packed (27, cin, cout_pad) fp32 contiguous and 16-byte aligned;
// tw a multiple of 4 with (TY + 2) * (tw + 2) * cin staged floats fitting
// SMEM_FLOATS.  Returns cudaGetLastError() after the launch.
extern "C" int tpuseg_conv3d_small(const void* x, const void* w_packed, void* y,
                                   int n, int d, int h, int w, int cin,
                                   int cout, int cout_pad, int tw, int dtype,
                                   void* stream) {
  if (cin < 1 || cin > MAX_CIN || cout < 1 || cout > cout_pad ||
      cout_pad % CO != 0 || cout_pad > 64 || tw < XT || tw > MAX_TW ||
      tw % XT != 0 || (TY + 2) * (tw + 2) * cin > SMEM_FLOATS || n < 1 ||
      d < 1 || h < 1 || w < 1 || (long long)n * d > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + tw - 1) / tw, (h + TY - 1) / TY, n * d);
  const int threads = TY * (tw / XT) * (cout_pad / CO);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w_packed);
  const bool vec4 = cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int lines = (27 * cin * cout_pad * (int)sizeof(float) + 127) / 128;
  prefetch_l2_kernel<<<(lines + 255) / 256, 256, 0, s>>>(
      static_cast<const char*>(w_packed), lines);
  if (dtype == tpuseg::kFloat32) {
    const float* xf = static_cast<const float*>(x);
    float* yf = static_cast<float*>(y);
    if (vec4)
      conv3d_small_kernel<float, 4><<<grid, threads, 0, s>>>(
          xf, wp, yf, d, h, w, cin, cout, cout_pad, tw);
    else
      conv3d_small_kernel<float, 1><<<grid, threads, 0, s>>>(
          xf, wp, yf, d, h, w, cin, cout, cout_pad, tw);
  } else {  // bf16 runs on the tensor cores: csrc/conv3d_small_tc.cu
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
