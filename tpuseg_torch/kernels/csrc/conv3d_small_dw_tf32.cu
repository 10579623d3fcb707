// Weight gradient of the float32 stride-1 SAME 3x3x3 conv on NDHWC (the
// backward of csrc/conv3d_small_tf32.cu) on the tensor cores by a 3xTF32
// split (a_lo b_hi + a_hi b_lo + a_hi b_hi, each half rounded with
// cvt.rna.tf32, fp32 accumulation):
//   dw[tap, ci, co] = sum_v xpad[v + off(tap), ci] * g[v, co]
// over all N*D*H*W output voxels v, xpad zero outside the volume; dw is
// (27, cin, cout) fp32 (DHWIO).  1 <= Cin, Cout <= 64.
//
// Replaces, for float32, the XLA conv VJP that tpuseg/kernels/conv3d.py
// `conv3d_small_vjp` falls back to (bf16 runs csrc/conv3d_small_dw_tc.cu).
// Python wrapper, plan and design note: tpuseg_torch/kernels/conv3d.py.
//
// The bf16 dW kernel's design: a GEMM per tap, M = ci, N = co, K = the
// voxels, split over blocks.
//  1. conv3d_dw_tf32_kernel: a block walks its items as the forward does
//     (csrc/conv3d_tc.cuh): each step stages one halo'd x plane and, from
//     the third step of an item on, the gradient tile of the output plane
//     it completes ([voxel][co], zero at voxels outside the volume), both
//     through the cp.async ring.  Work units are (tap, m16 tile of ci).
//     When a block cannot hold all 27 x cin_pad / 16 units' fp32 sums in
//     its registers (8 warps of 16 n8 tiles each), grid.y gives each block
//     one ci tile, whose 16 x channels alone it stages, and, where needed,
//     a part of the taps.  Warp w takes the block's units w, w + 8, ....
//     The MMA is mma.sync m16n8k8 in tf32: wgmma reads tf32 operands from
//     shared memory only K-major, and both staged tiles are MN-major here
//     (ldmatrix.trans moves 16-bit halves, so it cannot transpose them
//     either).  Both fragments are built from 32-bit shared loads instead:
//     per k8 group of voxels a warp loads the g tile's B fragments once
//     (g[k0 + t][8 j + g8], g[k0 + t + 4][...]) and, per unit, the A
//     fragment (x[k0 + t][g8], x[k0 + t][g8 + 8], and voxel k0 + t + 4) of
//     the x plane dz at the voxels shifted by (dy, dx), and splits each into
//     tf32 hi / lo.  Voxel strides of 16 mtb + 8 and cout_pad + 8 floats
//     (8 or 24 modulo 32 banks) put the 32 lanes' loads in 32 banks.  The
//     accumulators stay in registers over the block's whole walk, and each
//     block writes its units' sums to partial[chunk] once.
//  2. conv3d_dw_tf32_reduce_kernel: dw = the sum over chunks in fp64, in a
//     fixed order: dW is deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "conv3d_tc.cuh"

namespace {

using namespace tpuseg;
using namespace tpuseg::tc;

constexpr int REDUCE_THREADS = 256;
constexpr int DW_MAX_M = 32 * WARPS;  // output voxels per tile
constexpr int DW_CPAD = 8;            // floats of padding per staged voxel

// d += a (16 x 8 tf32, row) * b (8 x 8 tf32, col), fp32.  a0 (row g8, col
// t), a1 (g8 + 8, t), a2 (g8, t + 4), a3 (g8 + 8, t + 4); b0 (k t, col g8),
// b1 (k t + 4, g8); d[0..1] row g8, columns 2 t + 0..1, d[2..3] row g8 + 8;
// g8 = lane / 4, t = lane % 4
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void split2(float a, float b, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  hi[0] = tf32_rna(a);
  lo[0] = tf32_rna(a - __uint_as_float(hi[0]));
  hi[1] = tf32_rna(b);
  lo[1] = tf32_rna(b - __uint_as_float(hi[1]));
}

// g plane z of sample n for the tile at (y0, x0): ty x tx voxels of cout
// channels into `gs` as [m][vsg], m = row * tx + column; zero outside the
// volume.  Rows past ty * tx and channels past cout stay zero.
__device__ __forceinline__ void stage_grad(float* gs, const float* __restrict__ g,
                                           const Tiles& t, int vec, int cout, int vsg,
                                           int n, int z, int y0, int x0) {
  const int e = vec / 4;
  const int per_vox = cout / e;
  const int total = t.ty * t.tx * per_vox;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int m = i / per_vox;
    const int c = (i - m * per_vox) * e;
    const int yy = y0 + m / t.tx;
    const int xx = x0 + m % t.tx;
    const bool ok = yy < t.H && xx < t.W;
    const float* src =
        ok ? g + ((((size_t)n * t.D + z) * t.H + yy) * (size_t)t.W + xx) * cout + c : g;
    copy_chunk(gs + m * vsg + c, src, ok, vec);
  }
}

// one step of the walk: the x plane, and from the third step of an item on
// the gradient tile of the output plane it completes
__device__ __forceinline__ void stage_step(float* sp, const float* __restrict__ x,
                                           const float* __restrict__ g, const Tiles& t,
                                           int vec, int cout, int vsg, const Step& st) {
  stage_plane(sp, x, t, vec, st.n, st.z0 - 1 + st.p, st.y0, st.x0);
  if (st.p >= 2)
    stage_grad(sp + t.patch, g, t, vec, cout, vsg, st.n, st.z0 + st.p - 2, st.y0, st.x0);
}

template <int NJ, int UPW>
__global__ void __launch_bounds__(THREADS, 1) conv3d_dw_tf32_kernel(
    const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ partial,
    Tiles t, int cout, int mtb, int groups, int taps_per_block, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int VSG = NJ * 8 + DW_CPAD;  // 8 or 24 modulo 32
  // this block's ci tiles and taps: grid.y = tap groups x ci groups
  const int cg = blockIdx.y % groups;
  const int tap0 = (blockIdx.y / groups) * taps_per_block;
  const int taps = min(taps_per_block, 27 - tap0);
  const int cin = t.cin;
  t.c0 = 16 * mtb * cg;
  t.cin = min(16 * mtb, cin - t.c0);
  const int upb = taps * mtb;
  const int m_tile = t.ty * t.tx;
  const int m_pad = (m_tile + 7) / 8 * 8;
  const int slot_elems = t.patch + m_pad * VSG;  // [x plane][g tile]
  float* ring = reinterpret_cast<float*>(smem);
  zero_smem(smem, t.stages * slot_elems * 4);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t4 = lane & 3, g8 = lane >> 2;
  const int row = (t.tx + 2) * t.vs;  // floats
  // this warp's units l = warp, warp + 8, ... of the block's taps x ci
  // tiles: the dz plane and the float offset of the shifted voxel and of
  // the ci tile in a staged plane
  int u_off[UPW], u_dz[UPW];
  bool u_ok[UPW];
#pragma unroll
  for (int j = 0; j < UPW; ++j) {
    const int l = warp + WARPS * j;
    u_ok[j] = l < upb;
    const int tap = u_ok[j] ? tap0 + l / mtb : 0;
    const int mt = u_ok[j] ? l % mtb : 0;
    u_dz[j] = tap / 9;
    u_off[j] = ((tap / 3) % 3) * row + (tap % 3) * t.vs + 16 * mt + g8;
  }
  // the MMAs' sums over one output tile-plane (at most 256 voxels), and the
  // block's sums of those: the tensor cores' fp32 sums over a block's whole
  // walk (~12 000 voxels at level 0) drifted to 8.5e-5 of the scale on an
  // H100, against 5e-6 in two levels
  float acc[UPW][NJ][4], sum[UPW][NJ][4];
#pragma unroll
  for (int j = 0; j < UPW; ++j)
#pragma unroll
    for (int k = 0; k < NJ; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][k][q] = sum[j][k][q] = 0.f;

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
      const float* plane[3];
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        int sl = s_cons - 2 + dz;
        if (sl < 0) sl += t.stages;
        plane[dz] = ring + sl * slot_elems;
      }
      const float* ua[UPW];
#pragma unroll
      for (int j = 0; j < UPW; ++j)
        ua[j] = (u_dz[j] == 0 ? plane[0] : u_dz[j] == 1 ? plane[1] : plane[2]) + u_off[j];
      const float* gs = ring + s_cons * slot_elems + t.patch + t4 * VSG + g8;
      for (int k0 = 0; k0 < m_pad; k0 += 8) {
        // B: g rows k0 + t and k0 + t + 4 (zero past the tile), columns
        // 8 j + g8 of each n8 tile, split into tf32 hi / lo
        uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          split2(gs[k0 * VSG + 8 * j], gs[(k0 + 4) * VSG + 8 * j], bh[j], bl[j]);
        }
        // A: this lane's voxels k0 + t and k0 + t + 4 of the x tile (voxels
        // past the tile read a voxel inside it and meet zero rows of g),
        // ci g8 and g8 + 8 of the unit's tile
        const int v1 = min(k0 + t4, m_tile - 1), v2 = min(k0 + t4 + 4, m_tile - 1);
        const int o1 = (v1 / t.tx) * row + (v1 % t.tx) * t.vs;
        const int o2 = (v2 / t.tx) * row + (v2 % t.tx) * t.vs;
#pragma unroll
        for (int j = 0; j < UPW; ++j) {
          if (!u_ok[j]) continue;
          const uint32_t a_raw[4] = {__float_as_uint(ua[j][o1]), __float_as_uint(ua[j][o1 + 8]),
                                     __float_as_uint(ua[j][o2]), __float_as_uint(ua[j][o2 + 8])};
          uint32_t ah[4], al[4];
          tf32_split(a_raw, ah, al);
#pragma unroll
          for (int nj = 0; nj < NJ; ++nj) {
            mma_tf32_1688(acc[j][nj], al, bh[nj]);
            mma_tf32_1688(acc[j][nj], ah, bl[nj]);
            mma_tf32_1688(acc[j][nj], ah, bh[nj]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < UPW; ++j)
#pragma unroll
        for (int k = 0; k < NJ; ++k)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            sum[j][k][q] += acc[j][k][q];
            acc[j][k][q] = 0.f;
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
      const int ci = t.c0 + 16 * (l % mtb) + g8 + 8 * half;
      if (ci >= cin) continue;
      float* r = out + ((size_t)tap * cin + ci) * cout;
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        const int co = 8 * nj + 2 * t4;
        if (co < cout) r[co] = sum[j][nj][2 * half];
        if (co + 1 < cout) r[co + 1] = sum[j][nj][2 * half + 1];
      }
    }
  }
}

__global__ void __launch_bounds__(REDUCE_THREADS) conv3d_dw_tf32_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ dw, int n_chunks, int m) {
  const int i = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= m) return;
  double s = 0.0;
  for (int k = 0; k < n_chunks; ++k) s += partial[(size_t)k * m + i];
  dw[i] = static_cast<float>(s);
}

using Kernel = void (*)(const float*, const float*, float*, Tiles, int, int, int, int, int);

// units per warp: 16 n8 accumulator tiles per thread (64 fp32 registers)
constexpr int ACC_TILES = 16;

Kernel pick(int nj) {
  switch (nj) {
    case 2: return conv3d_dw_tf32_kernel<2, ACC_TILES / 2>;
    case 4: return conv3d_dw_tf32_kernel<4, ACC_TILES / 4>;
    case 6: return conv3d_dw_tf32_kernel<6, ACC_TILES / 6>;
    default: return conv3d_dw_tf32_kernel<8, ACC_TILES / 8>;
  }
}

}  // namespace

// x (n, d, h, w, cin) and g (n, d, h, w, cout) contiguous float32 (4-byte
// aligned at least); partial (max_chunks, 27, cin, cout) fp32 scratch; dw
// (27, cin, cout) fp32.  ty x tx: the output tile (at most 256 voxels);
// stages: ring slots (4 to 8); mtb: ci tiles of 16 per block (all
// cin_pad / 16 of them, or 1); tap_splits: blocks over the 27 taps.  A
// block stages the x channels of its ci tiles only and takes
// (27 / tap_splits) x mtb units, at most 8 * (16 / (cout_pad / 8)); grid.y
// is tap_splits x (cin_pad / 16 / mtb).  The z chunk and the number of
// chunks (at most max_chunks) follow from the occupancy.  Returns
// cudaGetLastError() after the launches.
extern "C" int tpuseg_conv3d_small_dw_tf32x3(const void* x, const void* g, void* partial,
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
      taps_per_block * mtb > WARPS * (ACC_TILES / nj) || max_chunks < 1 ||
      reinterpret_cast<uintptr_t>(x) % 4 != 0 || reinterpret_cast<uintptr_t>(g) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the block's staged channels: 16 mtb of them (the last group fewer)
  Tiles t = make_tiles(n, d, h, w, 16 * mtb, ty, tx, 1, stages, 16, DW_CPAD);
  t.cstride = cin;
  const int m_pad = (ty * tx + 7) / 8 * 8;
  const size_t smem = (size_t)stages * (t.patch + m_pad * (cout_pad + DW_CPAD)) * 4;
  if (smem > (size_t)SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int vx = copy_bytes(x, cin, 4), vg = copy_bytes(g, cout, 4);
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
                                pick_zc(n, d, h, w, ty, tx, chunks), stages, 16, DW_CPAD);
  t.zc = walk.zc;
  t.nzc = walk.nzc;
  t.items = walk.items;
  if (chunks > t.items) chunks = t.items;
  t.cin = cin;  // the kernel narrows it to its ci group
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(partial);
  fn<<<dim3((unsigned)chunks, splits), THREADS, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), pa, t, cout, mtb, groups,
      taps_per_block, vec);
  const int m = 27 * cin * cout;
  conv3d_dw_tf32_reduce_kernel<<<(m + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS,
                                 0, s>>>(pa, static_cast<float*>(dw), (int)chunks, m);
  return static_cast<int>(cudaGetLastError());
}
