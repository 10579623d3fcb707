// Stride-1 SAME 3x3x3 conv on NDHWC in float32 on the tensor cores by a
// 3xTF32 split (a_hi b_hi + a_lo b_hi + a_hi b_lo, each half rounded to
// nearest tf32, fp32 accumulation), which keeps about fp32's accuracy; no
// bias; 1 <= Cin <= 64, 1 <= Cout <= 64.  The backward's dX is the same conv
// of the output gradient with the flipped, transposed weight, so it runs
// this kernel too.
//
// Replaces the Pallas kernel tpuseg/kernels/conv3d.py `conv3d_small` for
// float32 (bf16 runs csrc/conv3d_small_tc.cu).  Python wrapper, packing,
// plan and design note: tpuseg_torch/kernels/conv3d.py.
//
// The bf16 kernel's walk (csrc/conv3d_tc.cuh): persistent blocks walk
// stacks of output tiles along z; each input plane is staged once per
// stack, halo'd and zero-filled, through the cp.async ring, as [row][x][ci]
// with a voxel stride of cin_pad + 4 floats (an odd number of 16-byte
// units).  A tile is TY rows x TXO = 14 output columns, so 16 staged
// columns.
//
// The GEMM folds the dx taps into N: a tf32 wgmma at N = Cout = 16 runs at
// about a fifth of the TF32 rate on an H100 and one three times wider
// costs little more.  Per (dz, dy, ci) the weights of the three dx taps sit
// side by side, N = 3 NT (NT = cout_pad), K = 9 x cin_pad in (dz, dy, ci)
// order: 9 x KCI k8 steps.  M = the 16 staged columns of a tile row (one
// m16 tile a warp and MT: row MT w + mt), so the product P at staged
// column c' and tap dx belongs to output column c = c' - dx, and the
// epilogue adds P[c][dx 0] + P[c + 1][dx 1] + P[c + 2][dx 2] with warp
// shuffles (rows c and c + 8 of an m16 tile sit in one thread, rows c and
// c + 1 in neighbouring quads of lanes).  The A fragment of step (dz, dy,
// kc) is an ldmatrix.x4 of the staged plane dz at row + dy: four 8-voxel x
// 4-float sub-tiles, which is the tf32 m16k8 fragment (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4).  It is split into tf32 hi / lo in registers,
// and each step is three wgmma m64n(3 NT)k8 per m64 tile, B from shared
// memory through a descriptor.
//
// The tensor cores add each product into the fp32 accumulator with the
// sum truncated toward zero, not rounded, so one accumulator over all
// 9 x KCI steps drifts toward zero by about a unit in the last place of
// fp32 per step: at 64 -> 64 (72 steps) ~4e-6 of the output's scale, eight
// times cuDNN's fp32 error.  So a pair of k8 steps (six wgmmas a m64 tile)
// goes into `acc`, its first wgmma overwriting it (scale-d 0), and after
// the pair the warp waits and adds `acc` into `sum` with fp32 adds, which
// round to nearest; the next pair's A is loaded while the pair's wgmmas
// run.  Where `sum` and a whole-N `acc` would not fit the registers (N =
// 192, or two m16 tiles a warp at N = 96), a pair runs once per half of N.
//
// The weight: the tf32 hi/lo pair of kernels/conv3d.py `pack_weight`, per
// k8 step [hi, lo][3 NT / 8 n8 tiles, dx-major][k half][8 n][4 k]
// (128-byte core matrices, K-major, no swizzle: LBO 128, SBO 256).  The
// pair takes 27 cin_pad cout_pad x 8 bytes (55 KB at 16 -> 16, 885 KB at
// 64 -> 64), so it does not always fit beside the ring.  It is cut into
// chunks of KPC steps that one thread copies with cp.async.bulk into a ring
// of slots, each with a `full` mbarrier (the copy's bytes) and an `empty`
// one (one arrival per warp once its wgmmas have read the slot).  When one
// chunk holds the whole weight it is copied once into one slot and stays
// resident; otherwise the chunks stream from L2 once per output plane
// through WSLOTS slots, one chunk ahead of the wgmmas.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "conv3d_tc.cuh"

namespace {

using namespace tpuseg;
using namespace tpuseg::tc;

constexpr int BAR_BYTES = 128;  // full[WSLOTS], empty[WSLOTS]
constexpr int WSLOTS = 2;       // weight ring slots when the weight streams
constexpr int F32_CPAD = 4;     // floats of padding per staged voxel
constexpr int TXO = 14;         // output columns of a tile: 16 staged

// ---- d (m64 x N fp32, the first N / 8 n8 tiles of d: each warp's 16 rows
// in the m16n8 C layout per n8 tile) = scale_d d + a (this warp's 16 rows
// of the m64 x k8 tf32 A tile) * B (k8 x N tf32, K-major, through desc_b);
// scale_d 0 or 1
template <int N, int M>
__device__ __forceinline__ void wgmma_tf32(float (&d)[M][4], const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  static_assert(N % 24 == 0 && N / 8 <= M, "3 NT columns, NT a multiple of 8");
  if constexpr (N == 24) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
  else if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
  else if constexpr (N == 96) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
  else if constexpr (N == 144) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71}, {%72, %73, %74, %75}, %76, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
  else if constexpr (N == 192) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]), "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]), "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]), "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]), "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]), "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]), "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]), "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]), "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
}

// the three dx taps' products in 3 NT columns; an accumulator holds PN
// of them (all, or half where the registers need it)
template <int NT, int MT>
struct Fold {
  static constexpr int N = 3 * NT;
  static constexpr int NJ = N / 8;
  static constexpr int PARTS = (NT == 64 || (NT == 32 && MT == 2)) ? 2 : 1;
  static constexpr int PN = N / PARTS;
  static constexpr int PJ = NJ / PARTS;
};

// one pair of k8 steps (ns = 1 or 2, their A split into register sets 0
// and 1) for columns part PN .. + PN: per step and m64 tile a_hi b_hi,
// a_lo b_hi and a_hi b_lo into `acc`, the pair's first wgmma overwriting
// it; one commit group
template <int NT, int MT>
__device__ __forceinline__ void tf32x3_pair(float (&acc)[MT][Fold<NT, MT>::PJ][4],
                                            const uint32_t (&hi)[2][MT][4],
                                            const uint32_t (&lo)[2][MT][4], uint32_t b_at,
                                            int ns, int part) {
  constexpr int N = Fold<NT, MT>::N;
  constexpr int PN = Fold<NT, MT>::PN;
  wgmma_fence();  // the split's registers, and the reads of `acc`, are ordered
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i < ns) {
      const uint32_t b = b_at + i * N * 64 + part * PN * 32;
      const uint64_t dh = wgmma_desc(b, 128, 256);
      const uint64_t dl = wgmma_desc(b + N * 32, 128, 256);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wgmma_tf32<PN>(acc[mt], hi[i][mt], dh, i);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wgmma_tf32<PN>(acc[mt], lo[i][mt], dh, 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wgmma_tf32<PN>(acc[mt], hi[i][mt], dl, 1);
    }
  }
  wgmma_commit();
}

// output planes of the items blockIdx.x, + gridDim.x, ... of the walk
__device__ long long planes_of_block(const Tiles& t) {
  long long total = 0;
  for (long long it = blockIdx.x; it < t.items; it += gridDim.x) {
    const int zt = (int)((it / ((long long)t.ntx * t.nty)) % t.nzc);
    total += min(t.zc, t.D - zt * t.zc);
  }
  return total;
}

template <int NT, int MT>
__global__ void __launch_bounds__(THREADS, 1) conv3d_tf32_kernel(
    const float* __restrict__ x, const unsigned char* __restrict__ wp, float* __restrict__ y,
    Tiles t, int cout, int kci, int kpc, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NJ = NT / 8;
  constexpr int FJ = Fold<NT, MT>::NJ;
  constexpr int PARTS = Fold<NT, MT>::PARTS;
  constexpr int PJ = Fold<NT, MT>::PJ;
  constexpr int STEP_BYTES = Fold<NT, MT>::N * 64;  // k8 step: hi, lo of k8 x 3 NT
  const int nchunks = 9 * kci / kpc;
  const bool resident = nchunks == 1;
  const int wslots = resident ? 1 : WSLOTS;
  const uint32_t chunk_bytes = (uint32_t)kpc * STEP_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + WSLOTS;
  unsigned char* wring = smem + BAR_BYTES;
  float* ring = reinterpret_cast<float*>(wring + (size_t)wslots * chunk_bytes);
  zero_smem(ring, t.stages * t.patch * 4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  long long q_total = 0;  // weight chunks this block consumes (thread 0)
  if (tid == 0) {
    for (int i = 0; i < wslots; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    q_total = resident ? 1 : planes_of_block(t) * nchunks;
  }
  __syncthreads();
  // chunk q of the sequence into its slot: chunk q % nchunks of the weight
  auto fetch_chunk = [&](long long q) {
    const int slot = (int)(q % wslots);
    mbar_expect_tx(full + slot, chunk_bytes);
    bulk_copy(wring + (size_t)slot * chunk_bytes,
              wp + (size_t)(q % nchunks) * chunk_bytes, chunk_bytes, full + slot);
  };
  if (tid == 0)
    for (long long q = 0; q < wslots && q < q_total; ++q) fetch_chunk(q);

  // the warp's m16 tiles are tile rows MT w .. MT w + MT - 1 (clamped into
  // the tile: rows past it are computed and not stored), 16 staged columns
  // each; a warpgroup computes when its first warp's first row is in the
  // tile.  Each lane's ldmatrix row: column lane & 15, floats 4 (lane >> 4)
  // .. + 4 of each k8 step; byte offsets
  const bool live = MT * (warp & ~3) < t.ty;
  const uint32_t vs_b = t.vs * 4;
  const uint32_t row_b = (t.tx + 2) * vs_b;
  uint32_t a_lane[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    a_lane[mt] = min(MT * warp + mt, t.ty - 1) * row_b + (lane & 15) * vs_b + (lane >> 4) * 16;
  const uint32_t ring_u = smem_u32(ring);
  const uint32_t wring_u = smem_u32(wring);

  const int depth = t.stages - 3;
  Step prod, cons;
  prod.start(blockIdx.x, t);
  cons = prod;
  int s_prod = 0;  // slot of the next step to stage
  for (int k = 0; k < depth; ++k) {
    if (prod.valid(t)) {
      stage_plane(ring + s_prod * t.patch, x, t, vec, prod.n, prod.z0 - 1 + prod.p, prod.y0,
                  prod.x0);
      prod.next(t);
    }
    cp_async_commit();
    if (++s_prod == t.stages) s_prod = 0;
  }
  int s_cons = 0;    // slot of the step being computed
  long long q = 0;   // weight chunks consumed so far
  while (cons.valid(t)) {
    wait_step(depth);
    // step s_cons has landed for every thread, and every warp is done with
    // the slot the next stage overwrites (the one computed from last)
    __syncthreads();
    if (prod.valid(t)) {
      stage_plane(ring + s_prod * t.patch, x, t, vec, prod.n, prod.z0 - 1 + prod.p, prod.y0,
                  prod.x0);
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
        plane[dz] = ring_u + sl * t.patch * 4;
      }
      float acc[MT][PJ][4], sum[MT][FJ][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < FJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[mt][j][e] = 0.f;
#pragma unroll
        for (int j = 0; j < PJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
      }
      uint32_t raw[2][MT][4], hi[2][MT][4], lo[2][MT][4];
      int dz = 0, dy = 0, kc = 0;  // of the next step to load
      for (int c = 0; c < nchunks; ++c, ++q) {
        const int slot = resident ? 0 : (int)(q % wslots);
        mbar_wait(full + slot, resident ? 0u : (uint32_t)((q / wslots) & 1));
        if (live) {
          const uint32_t b0 = wring_u + slot * chunk_bytes;
          // the A fragments of the next step into `r`
          auto load_a = [&](uint32_t (&r)[MT][4]) {
            const uint32_t a_at =
                (dz == 0 ? plane[0] : dz == 1 ? plane[1] : plane[2]) + dy * row_b + kc * 32;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(r[mt], a_at + a_lane[mt]);
            if (++kc == kci) {  // the next (dz, dy), row-major
              kc = 0;
              if (++dy == 3) {
                dy = 0;
                ++dz;
              }
            }
          };
          // the chunk's steps in pairs: the pair's A is split, its wgmmas
          // run (per part of N) while the next pair's A loads, and after
          // each part the warp waits (so it also holds no read of the
          // weight slot at the chunk's end) and adds `acc` into `sum`
          int ns = min(2, kpc);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (i < ns) load_a(raw[i]);
          for (int s = 0; s < kpc; s += 2) {
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (i < ns)
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) tf32_split(raw[i][mt], hi[i][mt], lo[i][mt]);
            const int next_ns = min(2, kpc - s - 2);
#pragma unroll
            for (int part = 0; part < PARTS; ++part) {
              tf32x3_pair<NT, MT>(acc, hi, lo, b0 + s * STEP_BYTES, ns, part);
              if (part == PARTS - 1) {
#pragma unroll
                for (int i = 0; i < 2; ++i)
                  if (i < next_ns) load_a(raw[i]);
              }
              wgmma_wait<0>();
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int j = 0; j < PJ; ++j)
#pragma unroll
                  for (int e = 0; e < 4; ++e) sum[mt][part * PJ + j][e] += acc[mt][j][e];
            }
            ns = next_ns;
          }
        }
        if (!resident) {
          if (lane == 0) mbar_arrive(empty + slot);
          if (tid == 0 && q + wslots < q_total) {
            mbar_wait(empty + slot, (uint32_t)((q / wslots) & 1));
            fetch_chunk(q + wslots);
          }
          __syncwarp();
        }
      }
      // the product of staged column c' and tap dx is output column
      // c' - dx.  This lane holds rows (columns) g and g + 8 of each m16
      // tile, output columns 2 t + 0..1 of each n8 tile: it adds, for its
      // column c = g + 8 h, rows c + 1 (dx 1) and c + 2 (dx 2), from the
      // lanes of row (c + dx) & 7, half (c + dx) >> 3.  Columns 14 and 15
      // (and rows past the tile or the volume) are not stored.
      const int z = cons.z0 + cons.p - 2;
      const bool pairs = (cout & 1) == 0;
      const int g = lane >> 2, t4 = lane & 3;
      if (live) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int r = MT * warp + mt;
          const int yy = cons.y0 + r;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            float v[2][2];  // [h][column pair], this lane's rows
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                v[h][e] = sum[mt][j][2 * h + e];
#pragma unroll
            for (int dx = 1; dx < 3; ++dx) {
              const int src = (((g + dx) & 7) << 2) | t4;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int jj = dx * NJ + j;
                const float p0 = __shfl_sync(0xffffffffu, sum[mt][jj][e], src);
                const float p1 = __shfl_sync(0xffffffffu, sum[mt][jj][2 + e], src);
                v[0][e] += (g + dx) >> 3 ? p1 : p0;  // row g + dx
                v[1][e] += p1;                       // row g + 8 + dx, where stored
              }
            }
            if (r >= t.ty || yy >= t.H) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int col = g + 8 * h;
              const int xx = cons.x0 + col;
              if (col >= TXO || xx >= t.W) continue;
              float* out =
                  y + ((((size_t)cons.n * t.D + z) * t.H + yy) * (size_t)t.W + xx) * cout;
              const int co = 8 * j + 2 * t4;
              if (pairs) {
                if (co < cout) *reinterpret_cast<float2*>(out + co) = make_float2(v[h][0], v[h][1]);
              } else {
                if (co < cout) out[co] = v[h][0];
                if (co + 1 < cout) out[co + 1] = v[h][1];
              }
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

using Kernel = void (*)(const float*, const unsigned char*, float*, Tiles, int, int, int, int);

Kernel pick(int nt, int mt) {
  if (mt == 2) {
    switch (nt) {
      case 8: return conv3d_tf32_kernel<8, 2>;
      case 16: return conv3d_tf32_kernel<16, 2>;
      default: return conv3d_tf32_kernel<32, 2>;
    }
  }
  switch (nt) {
    case 8: return conv3d_tf32_kernel<8, 1>;
    case 16: return conv3d_tf32_kernel<16, 1>;
    case 32: return conv3d_tf32_kernel<32, 1>;
    case 48: return conv3d_tf32_kernel<48, 1>;
    default: return conv3d_tf32_kernel<64, 1>;
  }
}

}  // namespace

// x (n, d, h, w, cin) and y (n, d, h, w, cout) contiguous float32 (y 8-byte
// aligned); w_packed the tf32 hi/lo weight of kernels/conv3d.py
// `pack_weight` (9 cin_pad / 8, 2, 3 cout_pad / 8, 2, 8, 4) with cin_pad =
// cin rounded up to 8 and cout_pad = 8 for cout <= 8, else cout rounded up
// to 16; 16-byte aligned.  ty: the output tile's rows (14 columns), at most
// 8 mt (mt = 1 or 2 m16 tiles a warp; 2 only for cout_pad <= 32); stages:
// plane ring slots (4 to 8); kpc: k8 steps per weight chunk, dividing
// 9 cin_pad / 8 (all of them: the weight resident in one slot; fewer:
// streamed through WSLOTS).  The z chunk and the persistent grid follow
// from the occupancy.  Returns cudaGetLastError() after the launch.
extern "C" int tpuseg_conv3d_small_tf32x3(const void* x, const void* w_packed, void* y,
                                          int n, int d, int h, int w, int cin, int cout,
                                          int ty, int mt, int stages, int kpc, void* stream) {
  const int cin_pad = (cin + 7) / 8 * 8;
  const int nt = cout <= 8 ? 8 : (cout + 15) / 16 * 16;
  const int steps = 9 * cin_pad / 8;
  if (cin < 1 || cin > 64 || cout < 1 || cout > 64 || n < 1 || d < 1 || h < 1 || w < 1 ||
      ty < 1 || (mt != 1 && mt != 2) || ty > 8 * mt || (mt == 2 && nt > 32) || stages < 4 ||
      stages > 8 || kpc < 1 || steps % kpc != 0 ||
      reinterpret_cast<uintptr_t>(w_packed) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 4 != 0 || reinterpret_cast<uintptr_t>(y) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Tiles t = make_tiles(n, d, h, w, cin, ty, TXO, 1, stages, 8, F32_CPAD);
  const int wslots = kpc == steps ? 1 : WSLOTS;
  const size_t smem =
      BAR_BYTES + (size_t)wslots * kpc * 3 * nt * 64 + (size_t)stages * t.patch * 4;
  if (smem > (size_t)SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = copy_bytes(x, cin, 4);
  const Kernel fn = pick(nt, mt);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent blocks: as many as are resident at once
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  t = make_tiles(n, d, h, w, cin, ty, TXO, pick_zc(n, d, h, w, ty, TXO, resident), stages, 8,
                 F32_CPAD);
  const long long grid_x = resident < t.items ? resident : t.items;
  fn<<<(unsigned)grid_x, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const unsigned char*>(w_packed),
      static_cast<float*>(y), t, cout, cin_pad / 8, kpc, vec);
  return static_cast<int>(cudaGetLastError());
}
