// Slab-layout conv GEMM probes (K4, K5): per output plane d, Y = Wm @ A in
// bf16 on the tensor cores with fp32 accumulation, A built from the z
// slabs d .. d+2 of a (N, D+2, C, LFULL) input with the dy taps as lane
// offsets dy*WP, then an epilogue that keeps Y's first COUT rows or adds
// the three dx row groups with lane shifts of 0, 1, 2 (mod LV).
//
// Replaces the Pallas probes benchmarks/kmicro_r2.py `make`/`run` (K4) and
// benchmarks/kmicro2_r2.py `variant`/`run` (K5).  Python wrapper and design
// note: tpuseg_torch/kernels/slab_conv.py.
//
// One block owns BN = 128 output lanes of one plane (or of `fuse`
// consecutive planes, which share its staged weight) and all M rows of Y.
// The weight (M x Kp) is staged in shared memory once per block; per plane
// the Kp x (BN + 8) A tile is staged with 16-byte loads (lane columns taken
// mod LV, rows past the built K zero), then warps of 48 rows x 32 lanes run
// m16n8k16 bf16 mma.sync from ldmatrix fragments (A tile through .trans,
// since it is [k][lane] in memory).  The 8 extra lanes feed the `full`
// epilogue's shifts across the tile edge.  The fp32 tile goes through
// shared memory to 16-byte bf16 stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace tpuseg;  // ldmatrix / mma helpers (common.cuh)
using bf16 = __nv_bfloat16;

constexpr int COUT = 16;       // output channels (the probe's)
constexpr int BN = 128;        // output lanes per block
constexpr int BS = BN + 8;     // A tile row: + 8 lanes for the shifts; 272 B
constexpr int CHUNKS = BS / 8; // 16-byte chunks per A tile row
constexpr int YS = BS + 4;     // Y tile row stride, floats

// A builds and epilogues (tpuseg_torch/kernels/slab_conv.py KINDS)
constexpr int kDotOnly = 0;  // A = the block's first slab, 9 times; y[:COUT]
constexpr int kSlab = 1;     // A = 3 dz x 3 dy slab slices; y[:COUT]
constexpr int kSlabDy0 = 2;  // A = 3 dz slabs at dy = 0; y[:COUT]
constexpr int kFull = 3;     // kSlab's A; y0 + y1 shifted 1 + y2 shifted 2

template <int MODE, int WARPS_M>
__global__ void __launch_bounds__(128 * WARPS_M) slab_conv_kernel(
    const bf16* __restrict__ xf, const bf16* __restrict__ wm,
    bf16* __restrict__ out, int D, int C, int lfull, int lv, int wp, int kp,
    int bd, int fuse) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int M = 48 * WARPS_M;
  const int wst = kp + 8;  // weight row stride: ldmatrix rows in 8 bank groups
  bf16* Ws = reinterpret_cast<bf16*>(smem);
  bf16* Bs = Ws + M * wst;
  float* Ys = reinterpret_cast<float*>(Bs + kp * BS);

  const int tid = threadIdx.x;
  const int nthreads = 128 * WARPS_M;
  const int krows = (MODE == kSlabDy0 ? 3 : 9) * C;
  const int l0 = blockIdx.x * BN;
  const int groups = D / fuse;
  const int n = blockIdx.y / groups;
  const int d0 = (blockIdx.y - n * groups) * fuse;

  for (int i = tid; i < M * (kp / 8); i += nthreads) {
    const int r = i / (kp / 8), c = (i - r * (kp / 8)) * 8;
    *reinterpret_cast<uint4*>(Ws + r * wst + c) =
        __ldg(reinterpret_cast<const uint4*>(wm + (size_t)r * kp + c));
  }
  for (int i = tid; i < (kp - krows) * CHUNKS; i += nthreads) {  // K padding
    const int r = krows + i / CHUNKS, q = i % CHUNKS;
    *reinterpret_cast<uint4*>(Bs + r * BS + q * 8) = make_uint4(0, 0, 0, 0);
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int wn = warp & 3, wmi = warp >> 2;

  for (int p = 0; p < fuse; ++p) {
    const int d = d0 + p;
    for (int i = tid; i < krows * CHUNKS; i += nthreads) {
      const int k = i / CHUNKS, q = i - k * CHUNKS;
      int z, off, ci;
      if (MODE == kDotOnly) {
        ci = k % C;
        z = (d / bd) * bd;
        off = 0;
      } else if (MODE == kSlabDy0) {
        const int t = k / C;
        ci = k - t * C;
        z = d + t;
        off = 0;
      } else {
        const int t = k / C;  // dz * 3 + dy
        ci = k - t * C;
        z = d + t / 3;
        off = (t % 3) * wp;
      }
      const int col = (l0 + q * 8) % lv;
      const bf16* src = xf + (((size_t)n * (D + 2) + z) * C + ci) * lfull + off + col;
      *reinterpret_cast<uint4*>(Bs + k * BS + q * 8) =
          __ldg(reinterpret_cast<const uint4*>(src));
    }
    __syncthreads();

    float acc[3][4][4];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    float accx[4] = {0.f, 0.f, 0.f, 0.f};  // kFull: the 8 extra lanes of y1 / y2
    const bool extra = MODE == kFull && (wn == 1 || wn == 2);

    for (int k0 = 0; k0 < kp; k0 += 16) {
      uint32_t a[3][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 3; ++mt)
        ldmatrix_x4(a[mt], Ws + (wmi * 48 + mt * 16 + (lane & 15)) * wst + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Bs + (k0 + (lane & 15)) * BS + wn * 32 + np * 16 + (lane >> 4) * 8);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 3; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(acc[mt][nt], a[mt], b[nt]);
      if (extra) {
        uint32_t bx[2];
        ldmatrix_x2_trans(bx, Bs + (k0 + (lane & 15)) * BS + BN);
        mma_bf16_16816(accx, wn == 1 ? a[1] : a[2], bx);
      }
    }

    // the rows the epilogue reads (warp row 0): y[:COUT], and for kFull the
    // dx = 1, 2 groups too
    if (wmi == 0) {
      const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
      for (int mt = 0; mt < (MODE == kFull ? 3 : 1); ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float* y = Ys + (mt * 16 + g) * YS + wn * 32 + nt * 8 + c2;
          y[0] = acc[mt][nt][0];
          y[1] = acc[mt][nt][1];
          y[8 * YS] = acc[mt][nt][2];
          y[8 * YS + 1] = acc[mt][nt][3];
        }
      if (extra) {
        float* y = Ys + (wn * 16 + g) * YS + BN + c2;
        y[0] = accx[0];
        y[1] = accx[1];
        y[8 * YS] = accx[2];
        y[8 * YS + 1] = accx[3];
      }
    }
    __syncthreads();

    for (int i = tid; i < COUT * (BN / 8); i += nthreads) {
      const int co = i / (BN / 8), q = i % (BN / 8);
      const int l = l0 + q * 8;
      if (l >= lv) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = Ys[co * YS + q * 8 + j];
        if (MODE == kFull)
          v[j] += Ys[(COUT + co) * YS + q * 8 + j + 1] + Ys[(2 * COUT + co) * YS + q * 8 + j + 2];
      }
      *reinterpret_cast<uint4*>(out + (((size_t)n * D + d) * COUT + co) * lv + l) =
          pack_bf16x8(v);
    }
    // the next plane's A tile is staged after every warp's mma of this one
    // (the barrier above) and its Y tile written after this epilogue
    // (the barrier after staging)
  }
}

template <int MODE, int WARPS_M>
int launch(const void* xf, const void* wm, void* out, int n, int d, int c,
           int lfull, int lv, int wp, int kp, int bd, int fuse, cudaStream_t s) {
  const int rows = MODE == kFull ? 3 * COUT : COUT;
  const size_t smem = (size_t)48 * WARPS_M * (kp + 8) * 2 + (size_t)kp * BS * 2 +
                      (size_t)rows * YS * 4;
  auto kern = slab_conv_kernel<MODE, WARPS_M>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lv + BN - 1) / BN, n * d / fuse);
  kern<<<grid, 128 * WARPS_M, smem, s>>>(
      static_cast<const bf16*>(xf), static_cast<const bf16*>(wm),
      static_cast<bf16*>(out), d, c, lfull, lv, wp, kp, bd, fuse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xf (n, d + 2, c, lfull) and wm (m, kp) bf16 contiguous, 16-byte aligned;
// out (n, d, 16, lv) bf16.  mode: 0 dot_only, 1 slab, 2 slab at dy = 0,
// 3 full; m = 48, or 144 for modes 0-2; kp a multiple of 16 at least the
// built K (9c, or 3c for mode 2), c, lfull, lv and wp multiples of 8,
// lv + 2 wp <= lfull; planes of one block: fuse, dividing d; mode 0 reads
// slab (d / bd) * bd, bd dividing d.  Returns cudaGetLastError() after the
// launch.
extern "C" int tpuseg_slab_conv(const void* xf, const void* wm, void* out,
                                int n, int d, int c, int lfull, int lv, int wp,
                                int m, int kp, int mode, int bd, int fuse,
                                void* stream) {
  const int krows = (mode == kSlabDy0 ? 3 : 9) * c;
  if (n < 1 || d < 1 || c < 8 || c % 8 || lv < 8 || lv % 8 || wp % 8 ||
      lfull % 8 || lv + 2 * wp > lfull || kp % 16 || kp < krows ||
      mode < kDotOnly || mode > kFull || (m != 48 && (m != 144 || mode == kFull)) ||
      fuse < 1 || d % fuse || bd < 1 || (mode == kDotOnly && d % bd) ||
      (long long)n * d / fuse > 65535 ||
      reinterpret_cast<uintptr_t>(xf) % 16 || reinterpret_cast<uintptr_t>(wm) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TPUSEG_SLAB(MODE, WM) \
  return launch<MODE, WM>(xf, wm, out, n, d, c, lfull, lv, wp, kp, bd, fuse, s)
  if (m == 48) {
    switch (mode) {
      case kDotOnly: TPUSEG_SLAB(kDotOnly, 1);
      case kSlab: TPUSEG_SLAB(kSlab, 1);
      case kSlabDy0: TPUSEG_SLAB(kSlabDy0, 1);
      default: TPUSEG_SLAB(kFull, 1);
    }
  }
  switch (mode) {
    case kDotOnly: TPUSEG_SLAB(kDotOnly, 3);
    case kSlab: TPUSEG_SLAB(kSlab, 3);
    default: TPUSEG_SLAB(kSlabDy0, 3);
  }
#undef TPUSEG_SLAB
}
