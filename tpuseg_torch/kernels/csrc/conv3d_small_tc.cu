// Stride-1 SAME 3x3x3 conv on NDHWC in bf16 on the tensor cores, fp32
// accumulation, bf16 output, no bias; 1 <= Cin <= 64, 1 <= Cout <= 64.
// The backward's dX is the same conv of the output gradient with the
// flipped, transposed weight, so it runs this kernel too.
//
// Replaces the Pallas kernel tpuseg/kernels/conv3d.py `conv3d_small` for
// bf16 (f32 runs csrc/conv3d_small_tf32.cu).  Python wrapper, packing
// and design note: tpuseg_torch/kernels/conv3d.py.
//
// An implicit GEMM whose shifts are addresses: M = the TY x TX output
// voxels of a tile (8 warps of MT m16 tiles: warpgroup g's m64 tile mt is
// the m16 tiles mt of its 4 warps), N = NT output channels (one slice of
// cout_pad, grid.y), K = 27 x cin_pad in (dz, dy, dx, ci) order.  The
// block keeps its weight slice resident in shared memory, copied once, in
// the packed layout [k16 step][n8][k half][8 n][8 k]: 128-byte core
// matrices, wgmma's canonical K-major layout without swizzle.  The input
// planes stream through the ring of csrc/conv3d_tc.cuh (cp.async,
// zero-filled at the borders); the A fragment of tap (dz, dy, dx) is an
// ldmatrix of the staged plane dz at the voxel shifted by (dy, dx): no
// im2col, no relayout.  The 27 x KCI k16 steps are unrolled: each step is
// one wgmma m64nNTk16 per m64 tile, A from those registers, B from the
// resident weight through a descriptor, fp32 accumulators in registers;
// A fragments are loaded two steps ahead, and a step waits for the one
// before it, whose registers it reloads.  bf16 stores from the
// accumulators.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "conv3d_tc.cuh"

namespace {

using namespace tpuseg;
using namespace tpuseg::tc;

template <int NT, int KCI, int MT>
__global__ void __launch_bounds__(THREADS) conv3d_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wp, bf16* __restrict__ y,
    Tiles t, int cout, int nj_all, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NJ = NT / 8;        // n8 tiles of the slice
  constexpr int KS = 27 * KCI;      // k16 steps
  constexpr int W_ELEMS = KS * 16 * NT;
  bf16* wsm = reinterpret_cast<bf16*>(smem);  // [KS][NJ][2][8][8]
  bf16* ring = wsm + W_ELEMS;                 // [stages][patch]
  zero_smem(smem, (W_ELEMS + t.stages * t.patch) * 2);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j0 = blockIdx.y * NJ;
  // the weight slice, with the first step's group
  for (int i = threadIdx.x; i < KS * NJ * 16; i += THREADS) {
    const int kc = (i >> 4) / NJ;
    const int jl = (i >> 4) - kc * NJ;
    cp_async_zfill<16>(wsm + (size_t)i * 8,
                       wp + (((size_t)kc * nj_all + j0 + jl) * 16 + (i & 15)) * 8, true);
  }

  const int m_tile = t.ty * t.tx;
  // the warp's m16 tiles are MT w .. MT w + MT - 1; a warpgroup computes
  // when its first warp's first tile holds voxels.  Each lane's A row:
  // voxel 16 tile + (lane & 15) (clamped into the tile: rows past it are
  // computed and not stored), channels 8 (lane >> 4) .. + 8 of each k16
  // chunk; byte offsets
  const bool live = 16 * MT * (warp & ~3) < m_tile;
  const uint32_t vs_b = t.vs * 2;
  const uint32_t row_b = (t.tx + 2) * vs_b;
  uint32_t a_lane[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int ma = min(16 * (MT * warp + mt) + (lane & 15), m_tile - 1);
    a_lane[mt] = (ma / t.tx) * row_b + (ma % t.tx) * vs_b + (lane >> 4) * 16;
  }
  const uint32_t ring_u = smem_u32(ring);

  const int depth = t.stages - 3;
  Step prod, cons;
  prod.start(blockIdx.x, t);
  cons = prod;
  int s_prod = 0;  // slot of the next step to stage
  for (int k = 0; k < depth; ++k) {
    if (prod.valid(t)) {
      stage_plane(ring + s_prod * t.patch, x, t, vec, prod.n, prod.z0 - 1 + prod.p,
                  prod.y0, prod.x0);
      prod.next(t);
    }
    cp_async_commit();
    if (++s_prod == t.stages) s_prod = 0;
  }
  int s_cons = 0;  // slot of the step being computed
  while (cons.valid(t)) {
    wait_step(depth);
    // step s_cons has landed for every thread, and every warp is done with
    // the slot the next stage overwrites (the one computed from last)
    __syncthreads();
    if (prod.valid(t)) {
      stage_plane(ring + s_prod * t.patch, x, t, vec, prod.n, prod.z0 - 1 + prod.p,
                  prod.y0, prod.x0);
      prod.next(t);
    }
    cp_async_commit();
    if (++s_prod == t.stages) s_prod = 0;

    if (cons.p >= 2 && live) {
      uint32_t plane[3];
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        int sl = s_cons - 2 + dz;
        if (sl < 0) sl += t.stages;
        plane[dz] = ring_u + sl * t.patch * 2;
      }
      float acc[MT][NJ][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;
      // k16 steps (tap, kc): the A fragments of step s loaded two steps
      // ahead (a ring of three register sets), one m64nNTk16 wgmma per m64
      // tile of the warpgroup with B read from the resident weight; at most
      // two steps' wgmmas in flight, so that a register set is free before
      // it is loaded again
      uint32_t fa[3][MT][4];
      const uint64_t desc0 = wgmma_desc(smem_u32(wsm), 128, 256);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int tap = s / KCI, kc = s % KCI;
        const uint32_t a_at = plane[tap / 9] + ((tap / 3) % 3) * row_b + (tap % 3) * vs_b
                              + kc * 32;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(fa[s][mt], a_at + a_lane[mt]);
      }
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        wgmma_fence();  // the ldmatrix writes (and the zeroed sums) are visible
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          wgmma_rs<NT>(acc[mt], fa[s % 3][mt], desc0 + (uint64_t)((s * NJ * 256) >> 4));
        wgmma_commit();
        wgmma_wait<1>();
        if (s + 2 < KS) {
          const int tap = (s + 2) / KCI, kc = (s + 2) % KCI;
          const uint32_t a_at = plane[tap / 9] + ((tap / 3) % 3) * row_b + (tap % 3) * vs_b
                                + kc * 32;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(fa[(s + 2) % 3][mt], a_at + a_lane[mt]);
        }
      }
      wgmma_wait<0>();
      // rows lane / 4 and lane / 4 + 8 of each m16 tile; columns
      // 2 (lane % 4) + 0..1 of each n8 tile
      const int z = cons.z0 + cons.p - 2;
      const bool pairs = (cout & 1) == 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = 16 * (MT * warp + mt) + (lane >> 2) + 8 * half;
          if (m >= m_tile) continue;
          const int yy = cons.y0 + m / t.tx;
          const int xx = cons.x0 + m % t.tx;
          if (yy >= t.H || xx >= t.W) continue;
          bf16* out =
              y + ((((size_t)cons.n * t.D + z) * t.H + yy) * (size_t)t.W + xx) * cout;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int co = (j0 + j) * 8 + 2 * (lane & 3);
            const float v0 = acc[mt][j][2 * half], v1 = acc[mt][j][2 * half + 1];
            if (pairs) {
              if (co < cout)
                *reinterpret_cast<__nv_bfloat162*>(out + co) = __floats2bfloat162_rn(v0, v1);
            } else {
              if (co < cout) out[co] = __float2bfloat16(v0);
              if (co + 1 < cout) out[co + 1] = __float2bfloat16(v1);
            }
          }
        }
      }
    }
    cons.next(t);
    if (++s_cons == t.stages) s_cons = 0;
  }
  cp_async_wait<0>();
}

using Kernel = void (*)(const bf16*, const bf16*, bf16*, Tiles, int, int, int);

template <int NT, int MT>
Kernel pick_kci(int kci) {
  switch (kci) {
    case 1: return conv3d_tc_kernel<NT, 1, MT>;
    case 2: return conv3d_tc_kernel<NT, 2, MT>;
    case 3: return conv3d_tc_kernel<NT, 3, MT>;
    default: return conv3d_tc_kernel<NT, 4, MT>;
  }
}

template <int MT>
Kernel pick(int nt, int kci) {
  switch (nt) {
    case 16: return pick_kci<16, MT>(kci);
    case 32: return pick_kci<32, MT>(kci);
    case 48: return pick_kci<48, MT>(kci);
    default: return pick_kci<64, MT>(kci);
  }
}

}  // namespace

// x (n, d, h, w, cin) and y (n, d, h, w, cout) contiguous bf16 (x 2-byte
// aligned at least, y 4-byte aligned); w_packed the bf16 weight in the
// layout of kernels/conv3d.py `pack_weight` (27 cin_pad / 16, cout_pad / 8,
// 2, 8, 8), 16-byte aligned.  ty x tx: the output tile, at most 128 voxels
// for mt = 1 (one m16 tile a warp) and 256 for mt = 2; nt: output channels
// per block (16, 32, 48 or 64, dividing cout_pad); stages: ring slots (4
// to 8).  The z chunk and the persistent grid follow from the occupancy.
// Returns cudaGetLastError() after the launch.
extern "C" int tpuseg_conv3d_small_tc(const void* x, const void* w_packed, void* y,
                                      int n, int d, int h, int w, int cin, int cout,
                                      int ty, int tx, int nt, int mt, int stages,
                                      void* stream) {
  const int cin_pad = (cin + 15) / 16 * 16;
  const int cout_pad = (cout + 15) / 16 * 16;
  if (cin < 1 || cin > 64 || cout < 1 || cout > 64 || n < 1 || d < 1 || h < 1 ||
      w < 1 || ty < 1 || tx < 1 || (mt != 1 && mt != 2) || ty * tx > 16 * WARPS * mt ||
      stages < 4 || stages > 8 || (nt != 16 && nt != 32 && nt != 48 && nt != 64) ||
      cout_pad % nt != 0 || reinterpret_cast<uintptr_t>(w_packed) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Tiles t = make_tiles(n, d, h, w, cin, ty, tx, 1, stages);
  const size_t smem = (size_t)(27 * cin_pad * nt + stages * t.patch) * 2;
  if (smem > (size_t)SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = copy_bytes(x, cin);
  const Kernel fn = mt == 1 ? pick<1>(nt, cin_pad / 16) : pick<2>(nt, cin_pad / 16);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent blocks: as many as are resident at once, over the splits
  const int splits = cout_pad / nt;
  const long long per_split =
      ((long long)(per_sm > 0 ? per_sm : 1) * sms + splits - 1) / splits;
  t = make_tiles(n, d, h, w, cin, ty, tx, pick_zc(n, d, h, w, ty, tx, per_split), stages);
  const long long grid_x = per_split < t.items ? per_split : t.items;
  fn<<<dim3((unsigned)grid_x, splits), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w_packed), static_cast<bf16*>(y),
      t, cout, cout_pad / 8, vec);
  return static_cast<int>(cudaGetLastError());
}
