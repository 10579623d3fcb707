// Weight gradient of the bf16 stride-1 SAME 3x3x3 conv on NDHWC (the
// backward of csrc/conv3d_small_tc.cu) on the tensor cores, fp32:
//   dw[tap, ci, co] = sum_v xpad[v + off(tap), ci] * g[v, co]
// over all N*D*H*W output voxels v, xpad zero outside the volume; dw is
// (27, cin, cout) fp32 (DHWIO).  1 <= Cin, Cout <= 64.
//
// Replaces, for bf16, the XLA conv VJP that tpuseg/kernels/conv3d.py
// `conv3d_small_vjp` falls back to (the f32 path keeps
// csrc/conv3d_small_dw.cu).  Python wrapper and design note:
// tpuseg_torch/kernels/conv3d.py.
//
// A GEMM per tap, M = ci, N = co, K = the voxels, split over blocks:
//  1. conv3d_dw_tc_kernel: a block walks its items as the forward does
//     (csrc/conv3d_tc.cuh): each step stages one halo'd x plane and, from
//     the third step of an item on, the gradient tile of the output plane
//     it completes ([voxel][co], zero at voxels outside the volume), both
//     through the cp.async ring.  Work units are (tap, m16 tile of ci).
//     When a block cannot hold all 27 x cin_pad / 16 units' fp32 sums in
//     its registers (8 warps of 16 n8 tiles each), grid.y gives each block
//     one ci tile, whose 16 x channels alone it stages, and, where needed,
//     a part of the taps.  Warp w takes the block's units w, w + 8, ....
//     Per k16 group of voxels a warp loads the g tile's B fragments once
//     (ldmatrix.trans of [voxel][co]) and, per unit, the A fragment as an
//     ldmatrix.trans of the x plane dz at the voxels shifted by (dy, dx),
//     four units' loads in flight before their m16n8k16 mma.sync; the
//     accumulators stay in registers over the block's whole walk.  Each
//     block writes its units' sums to partial[chunk] once.
//  2. conv3d_dw_tc_reduce_kernel: dw = the sum over chunks in fp64, in a
//     fixed order: dW is deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "conv3d_tc.cuh"

namespace {

using namespace tpuseg;
using namespace tpuseg::tc;

constexpr int REDUCE_THREADS = 256;

constexpr int DW_MAX_M = 32 * WARPS;  // output voxels per tile

// g plane z of sample n for the tile at (y0, x0): ty x tx voxels of cout
// channels into `gs` as [m][vsg], m = row * tx + column; zero outside the
// volume.  Rows past ty * tx and channels past cout stay zero.
__device__ __forceinline__ void stage_grad(bf16* gs, const bf16* __restrict__ g,
                                           const Tiles& t, int vec, int cout, int vsg,
                                           int n, int z, int y0, int x0) {
  const int e = vec / 2;
  const int per_vox = cout / e;
  const int total = t.ty * t.tx * per_vox;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int m = i / per_vox;
    const int c = (i - m * per_vox) * e;
    const int yy = y0 + m / t.tx;
    const int xx = x0 + m % t.tx;
    const bool ok = yy < t.H && xx < t.W;
    const bf16* src =
        ok ? g + ((((size_t)n * t.D + z) * t.H + yy) * (size_t)t.W + xx) * cout + c : g;
    copy_chunk(gs + m * vsg + c, src, ok, vec);
  }
}

// one step of the walk: the x plane, and from the third step of an item on
// the gradient tile of the output plane it completes
__device__ __forceinline__ void stage_step(bf16* sp, const bf16* __restrict__ x,
                                           const bf16* __restrict__ g, const Tiles& t,
                                           int vec, int cout, int vsg, const Step& st) {
  stage_plane(sp, x, t, vec, st.n, st.z0 - 1 + st.p, st.y0, st.x0);
  if (st.p >= 2)
    stage_grad(sp + t.patch, g, t, vec, cout, vsg, st.n, st.z0 + st.p - 2, st.y0, st.x0);
}

// A loads of this many units are in flight before their MMAs
constexpr int A_BATCH = 4;

template <int NJ, int UPW>
__global__ void __launch_bounds__(THREADS, 2) conv3d_dw_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ g, float* __restrict__ partial,
    Tiles t, int cout, int mtb, int groups, int taps_per_block, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int VSG = NJ * 8 + CPAD;  // odd number of 16-byte units
  // this block's ci tiles and taps: grid.y = tap groups x ci groups
  const int cg = blockIdx.y % groups;
  const int tap0 = (blockIdx.y / groups) * taps_per_block;
  const int taps = min(taps_per_block, 27 - tap0);
  const int cin = t.cin;
  t.c0 = 16 * mtb * cg;
  t.cin = min(16 * mtb, cin - t.c0);
  const int upb = taps * mtb;
  const int m_tile = t.ty * t.tx;
  const int m_pad = (m_tile + 15) / 16 * 16;
  const int slot_elems = t.patch + m_pad * VSG;  // [x plane][g tile]
  bf16* ring = reinterpret_cast<bf16*>(smem);
  zero_smem(smem, t.stages * slot_elems * 2);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t vs_b = t.vs * 2;
  const uint32_t row_b = (t.tx + 2) * vs_b;
  // this warp's units l = warp, warp + 8, ... of the block's taps x ci
  // tiles: the dz plane and the byte offset of the shifted voxel and of
  // the ci tile in a staged plane
  uint32_t u_off[UPW];
  int u_dz[UPW];
  bool u_ok[UPW];
#pragma unroll
  for (int j = 0; j < UPW; ++j) {
    const int l = warp + WARPS * j;
    u_ok[j] = l < upb;
    const int tap = u_ok[j] ? tap0 + l / mtb : 0;
    const int mt = u_ok[j] ? l % mtb : 0;
    u_dz[j] = tap / 9;
    u_off[j] = ((tap / 3) % 3) * row_b + (tap % 3) * vs_b + 32 * mt;
  }
  float acc[UPW][NJ][4];
#pragma unroll
  for (int j = 0; j < UPW; ++j)
#pragma unroll
    for (int k = 0; k < NJ; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][k][q] = 0.f;
  const uint32_t ring_u = smem_u32(ring);

  const int depth = t.stages - 3;
  Step prod, cons;
  prod.start(blockIdx.x, t);
  cons = prod;
  int s_prod = 0;
  for (int k = 0; k < depth; ++k) {
    if (prod.valid(t)) {
      stage_step(ring + s_prod * slot_elems, x, g, t, vec, cout, VSG, prod);
      prod.next(t);
    }
    cp_async_commit();
    if (++s_prod == t.stages) s_prod = 0;
  }
  int s_cons = 0;
  while (cons.valid(t)) {
    wait_step(depth);
    __syncthreads();
    if (prod.valid(t)) {
      stage_step(ring + s_prod * slot_elems, x, g, t, vec, cout, VSG, prod);
      prod.next(t);
    }
    cp_async_commit();
    if (++s_prod == t.stages) s_prod = 0;

    if (cons.p >= 2) {
      uint32_t plane[3];
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        int sl = s_cons - 2 + dz;
        if (sl < 0) sl += t.stages;
        plane[dz] = ring_u + sl * slot_elems * 2;
      }
      uint32_t ua[UPW];
#pragma unroll
      for (int j = 0; j < UPW; ++j)
        ua[j] = (u_dz[j] == 0 ? plane[0] : u_dz[j] == 1 ? plane[1] : plane[2]) + u_off[j];
      const uint32_t gs = ring_u + (s_cons * slot_elems + t.patch) * 2 +
                          (lane & 15) * VSG * 2 + (lane >> 4) * 16;
      for (int k0 = 0; k0 < m_pad; k0 += 16) {
        // B: g rows k0 .. k0 + 15, the n8 tiles in pairs
        uint32_t b[NJ / 2][4];
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp)
          ldmatrix_x4_trans(b[jp], gs + k0 * VSG * 2 + jp * 32);
        // A: this lane's voxel row of the transposed x tile (voxels
        // k0 + (lane & 7) + 8 (lane >> 4), ci 8 ((lane >> 3) & 1) .. + 8);
        // voxels past the tile read a voxel inside it and meet zero rows of g
        const int k = min(k0 + (lane & 7) + 8 * (lane >> 4), m_tile - 1);
        const uint32_t base = (k / t.tx) * row_b + (k % t.tx) * vs_b + 16 * ((lane >> 3) & 1);
#pragma unroll
        for (int j0 = 0; j0 < UPW; j0 += A_BATCH) {
          uint32_t a[A_BATCH][4];
#pragma unroll
          for (int j = 0; j < A_BATCH && j0 + j < UPW; ++j)
            if (u_ok[j0 + j]) ldmatrix_x4_trans(a[j], ua[j0 + j] + base);
#pragma unroll
          for (int j = 0; j < A_BATCH && j0 + j < UPW; ++j) {
            if (!u_ok[j0 + j]) continue;
#pragma unroll
            for (int jp = 0; jp < NJ / 2; ++jp) {
              const uint32_t b0[2] = {b[jp][0], b[jp][1]};
              const uint32_t b1[2] = {b[jp][2], b[jp][3]};
              mma_bf16_16816(acc[j0 + j][2 * jp], a[j], b0);
              mma_bf16_16816(acc[j0 + j][2 * jp + 1], a[j], b1);
            }
          }
        }
      }
    }
    cons.next(t);
    if (++s_cons == t.stages) s_cons = 0;
  }
  cp_async_wait<0>();

  // rows (ci) lane / 4 and + 8 of each unit's m16 tile, columns (co)
  // 2 (lane % 4) + 0..1 of each n8 tile
  float* out = partial + (size_t)blockIdx.x * 27 * cin * cout;
#pragma unroll
  for (int j = 0; j < UPW; ++j) {
    if (!u_ok[j]) continue;
    const int l = warp + WARPS * j;
    const int tap = tap0 + l / mtb;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ci = t.c0 + 16 * (l % mtb) + (lane >> 2) + 8 * half;
      if (ci >= cin) continue;
      float* row = out + ((size_t)tap * cin + ci) * cout;
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        const int co = 8 * nj + 2 * (lane & 3);
        if (co < cout) row[co] = acc[j][nj][2 * half];
        if (co + 1 < cout) row[co + 1] = acc[j][nj][2 * half + 1];
      }
    }
  }
}

__global__ void __launch_bounds__(REDUCE_THREADS) conv3d_dw_tc_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ dw, int n_chunks, int m) {
  const int i = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= m) return;
  double s = 0.0;
  for (int k = 0; k < n_chunks; ++k) s += partial[(size_t)k * m + i];
  dw[i] = static_cast<float>(s);
}

using Kernel = void (*)(const bf16*, const bf16*, float*, Tiles, int, int, int, int, int);

// units per warp: 16 n8 accumulator tiles per thread (64 fp32 registers,
// so that two blocks fit an SM's registers)
constexpr int ACC_TILES = 16;

Kernel pick(int nj) {
  switch (nj) {
    case 2: return conv3d_dw_tc_kernel<2, ACC_TILES / 2>;
    case 4: return conv3d_dw_tc_kernel<4, ACC_TILES / 4>;
    case 6: return conv3d_dw_tc_kernel<6, ACC_TILES / 6>;
    default: return conv3d_dw_tc_kernel<8, ACC_TILES / 8>;
  }
}

}  // namespace

// x (n, d, h, w, cin) and g (n, d, h, w, cout) contiguous bf16 (2-byte
// aligned at least); partial (max_chunks, 27, cin, cout) fp32 scratch; dw
// (27, cin, cout) fp32.  ty x tx: the output tile (at most 256 voxels);
// stages: ring slots (4 to 8); mtb: ci tiles of 16 per block (all
// cin_pad / 16 of them, or 1); tap_splits: blocks over the 27 taps.  A
// block stages the x channels of its ci tiles only and takes
// (27 / tap_splits) x mtb units, at most 8 * (16 / (cout_pad / 8)); grid.y
// is tap_splits x (cin_pad / 16 / mtb).  The z chunk and the number of
// chunks (at most max_chunks) follow from the occupancy.  Returns
// cudaGetLastError() after the launches.
extern "C" int tpuseg_conv3d_small_dw_tc(const void* x, const void* g, void* partial,
                                         void* dw, int n, int d, int h, int w, int cin,
                                         int cout, int ty, int tx, int stages, int mtb,
                                         int tap_splits, int max_chunks, void* stream) {
  const int mts = (cin + 15) / 16;
  const int cout_pad = (cout + 15) / 16 * 16;
  const int nj = cout_pad / 8;
  const int groups = mtb > 0 ? mts / mtb : 0;
  const int taps_per_block = tap_splits > 0 ? (27 + tap_splits - 1) / tap_splits : 0;
  if (cin < 1 || cin > 64 || cout < 1 || cout > 64 || n < 1 || d < 1 || h < 1 ||
      w < 1 || ty < 1 || tx < 1 || ty * tx > DW_MAX_M || stages < 4 || stages > 8 ||
      (mtb != 1 && mtb != mts) || tap_splits < 1 || tap_splits > 27 ||
      taps_per_block * mtb > WARPS * (ACC_TILES / nj) || max_chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // the block's staged channels: 16 mtb of them (the last group fewer)
  Tiles t = make_tiles(n, d, h, w, 16 * mtb, ty, tx, 1, stages);
  t.cstride = cin;
  const int m_pad = (ty * tx + 15) / 16 * 16;
  const size_t smem = (size_t)stages * (t.patch + m_pad * (cout_pad + CPAD)) * 2;
  if (smem > (size_t)SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int vx = copy_bytes(x, cin), vg = copy_bytes(g, cout);
  const int vec = vx < vg ? vx : vg;
  const Kernel fn = pick(nj);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = groups * tap_splits;
  long long chunks = ((long long)(per_sm > 0 ? per_sm : 1) * sms + splits - 1) / splits;
  if (chunks > max_chunks) chunks = max_chunks;
  const Tiles walk = make_tiles(n, d, h, w, 16 * mtb, ty, tx,
                                pick_zc(n, d, h, w, ty, tx, chunks), stages);
  t.zc = walk.zc;
  t.nzc = walk.nzc;
  t.items = walk.items;
  if (chunks > t.items) chunks = t.items;
  t.cin = cin;  // the kernel narrows it to its ci group
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(partial);
  fn<<<dim3((unsigned)chunks, splits), THREADS, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), pa, t, cout, mtb, groups,
      taps_per_block, vec);
  const int m = 27 * cin * cout;
  conv3d_dw_tc_reduce_kernel<<<(m + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS,
                               0, s>>>(pa, static_cast<float*>(dw), (int)chunks, m);
  return static_cast<int>(cudaGetLastError());
}
