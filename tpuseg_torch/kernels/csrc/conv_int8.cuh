// W8A8 int8 convolution for Hopper: int8 wgmma over an input brick staged
// once per output tile.
//
// y[m, o] = cast(float(acc[m, o]) * scale[o] (+ bias[o])),
// acc[m, o] = sum_k A[m, k] * W[o, k]   (exact, int32)
//
// m runs over the output voxels (n, od, oh, ow) of a channels-last map, o
// over the output channels, and k over a K-row table (kernels/conv_int8.py
// `_table`).  A row of the table is a 16-byte piece of input channels at
// one tap (dz, dy, dx) of one input part: every (tap, piece) for a dense
// conv, or only the pieces that carry a nonzero of a packed k3's weight
// (the structural rows of kernels/packed_conv.py `_taps`), so that the
// packed k3 skips its structural zeros.  A k32 step is two pieces.  Where
// Cin is not a multiple of 16 (the Cin 1 stem), the "byte path" packs
// (tap, ci) densely into the k32 steps instead, one table row a byte.
//
// The block is persistent (one a SM) and walks output tiles of 128
// consecutive voxels: 128 within one output plane, or whole planes when a
// plane holds fewer than 128.  For each tile a producer warp stages the
// tile's halo'd input brick into shared memory: per part and tap plane dz
// the contiguous run of input voxels the tile reads (or one run for all
// dz when the tile spans planes; or, on wide maps, where such a run holds
// kh - 1 whole rows, one run a tap row (dz, dy), about 128 + kw voxels
// whatever the width), by TMA on a 2D (voxel, channel) tensor
// map whose swizzle makes the A loads free of bank conflicts, or by
// cp.async.bulk on the byte path.  Out-of-volume voxels of the run are
// zero-filled by TMA or never read.  Bricks sit in a ring of 2 to 8 slots
// on mbarriers (as many as fit), so the next tiles' bricks load while this
// tile computes and stores.  Where two whole bricks do not fit beside the
// weight's ring (many channels on wide planes), a slot holds one chunk of
// the brick instead: one 128-, 64- or 32-byte sub-part of one part's
// channels (a "chunked" plan; where 32 does not divide a part, its last
// 32-byte sub-part runs past its channels, and the table's zero pieces
// stand for those).  The K-row table then runs chunk by chunk
// (kernels/conv_int8.py `dense_pieces`: chunk-major), the consumers free a
// slot once its A fragments are in registers, and the producer stages the
// next chunk, of this tile or the next, while they compute.
// The weight, pre-laid by the wrapper in wgmma's K-major core-matrix
// layout per k32 step, stays resident when it fits beside the bricks and
// streams through a ring of chunks (up to 4 k32 steps each, never
// straddling a brick chunk) by cp.async.bulk otherwise, each brick chunk's
// weight chunks issued after it.  Tiles 24 or fewer outputs wide run two
// blocks a SM.  The K-row table, the scales and the bias are staged in
// shared memory once a block.
//
// Two consumer warpgroups each own 64 rows of the tile and all N <= 256
// output channels: per k32 step each lane names one row of its warp's
// 16 rows and one of the step's two pieces, checks the tap against the
// volume (a tap in the padding reads a zero row), and `ldmatrix` loads the
// A fragments from the brick (the tap shift is an address offset).  A
// weight chunk's steps go as one commit group: their A fragments loaded,
// one fence, their `wgmma.mma_async.m64nNk32.s32.s8.s8` (A from registers,
// B from shared memory) back to back, summing in s32 registers, exactly;
// the next chunk's loads overlap them.  A wgmma under a runtime condition
// (a chunk's steps) makes ptxas serialize every wgmma of the kernel
// (C7520), so where every weight chunk is four k32 steps (kFull) the
// kernel issues its four wgmmas unconditionally (on an H100, 18 % faster
// at the UNet3d's 256 -> 128 decoder k3); plans with shorter chunks (the
// small-K ones: the Cin 1 stem, narrow 1x1s) issue a chunk's steps under
// the condition.
//
// The epilogue rounds as the JAX reference does: float(acc) (nearest),
// times scale[o] = a_scale * w_scale[o] (rounded once, made by the
// caller), then bias_mode 1 adds the bias in fp32 before the cast to the
// output dtype, bias_mode 2 casts the product and the bias to the output
// dtype first and adds those (the packed nets' `conv + bias` in the
// activation dtype).  __fmul_rn / __fadd_rn keep the compiler from
// fusing the multiply and the add.  Each quad of lanes stores one full
// 32-byte sector (f32) per row and n8 tile.
//
// This header holds the kernels (csrc/conv_int8.cu: the host side and the
// launches that issue a chunk's wgmmas under a condition;
// csrc/conv_int8_full.cu: those that issue four unconditionally, a
// translation unit of its own so that the two halves build in parallel).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace tpuseg {
namespace int8conv {

constexpr int kConsumers = 256;               // two warpgroups
constexpr int kThreads = kConsumers + 32;     // and the producer warp
constexpr int kBM = 128;                      // output voxels a tile
constexpr int kMaxSlots = 64;                 // weight ring slots at most
constexpr int kMaxBricks = 8;                 // brick ring slots at most
constexpr int kMaxChunk = 4;                  // k32 steps a weight chunk at most
constexpr int kSmemLimit = 232448;            // dynamic shared memory of a block
constexpr uint32_t kPad = 1u << 16;           // table row: a zero piece

// the host's plan (kernels/conv_int8.py `_plan`), in this order
enum Geo {
  G_N, G_D, G_H, G_W, G_OD, G_OH, G_OW, G_SD, G_SH, G_SW, G_PD, G_PH, G_PW,
  G_GROUP, G_TPG, G_TILES_M, G_N_TILES, G_COUT, G_NSEG, G_LPAD,
  G_K_STEPS, G_CHUNK_STEPS, G_W_SLOTS, G_RESIDENT, G_BRICK_BYTES, G_BIAS_MODE,
  G_BYTE_PATH, G_NPARTS, G_BN,
  G_CIN0, G_CS0, G_NSUB0, G_BOX0, G_BASE0, G_SEG0,
  G_CIN1, G_CS1, G_NSUB1, G_BOX1, G_BASE1, G_SEG1, G_STRUCTURED, G_BSLOTS, G_CHUNKS,
  G_SROWS, G_COUNT
};

struct Params {
  int n, d, h, w, od, oh, ow, sd, sh, sw, pd, ph, pw;
  int m_total, tiles_m, hw;  // all below 2^31 (the host checks)
  int group, tpg, n_tiles, cout, nseg, lpad;
  int srows;    // segments a tap plane: 1 (a run a plane) or kh (a run a row)
  int k_steps, chunk_steps, n_chunks, w_slots, resident, brick_bytes, chunk_bytes, bslots;
  int bchunks;  // brick chunks a tile (1: the whole brick a slot)
  int cpb;      // weight chunks a brick chunk
  int table_rows;  // 2 a k32 step, 32 on the byte path
  int bias_mode, byte_path, nparts;
  int cin[2], cs[2], nsub[2], box[2], base[2], seg[2];
  long long total_bytes[2];
  const int8_t* x[2];
  const int4* table;
  const int8_t* wp;
  const float* scale;
  const float* bias;
  void* y;
};

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 8][4], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d);

// d (m64 x N s32: per n8 tile each warp's 16 rows, lane l holding rows
// l / 4 and l / 4 + 8, columns 2 (l % 4) + 0..1) = scale_d d + a (this
// warp's 16 rows of the m64 x k32 s8 A tile, four 32-bit registers as
// `ldmatrix_x4` fills them) * B (k32 x N s8, K-major in shared memory
// through desc_b); scale_d 0 or 1
template <>
__device__ __forceinline__ void wgmma_s8<8>(int (&d)[1][4], const uint32_t (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[2][4], const uint32_t (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<24>(int (&d)[3][4], const uint32_t (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]), "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[4][4], const uint32_t (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]), "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]), "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[8][4], const uint32_t (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]), "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]), "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]), "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]), "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]), "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]), "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[16][4], const uint32_t (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]), "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]), "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]), "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]), "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]), "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]), "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]), "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]), "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]), "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]), "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]), "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]), "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]), "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]), "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[32][4], const uint32_t (&a)[4],
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]), "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]), "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]), "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]), "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]), "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]), "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]), "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]), "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]), "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]), "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]), "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]), "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]), "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]), "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3]), "+r"(d[16][0]), "+r"(d[16][1]), "+r"(d[16][2]), "+r"(d[16][3]), "+r"(d[17][0]), "+r"(d[17][1]), "+r"(d[17][2]), "+r"(d[17][3]), "+r"(d[18][0]), "+r"(d[18][1]), "+r"(d[18][2]), "+r"(d[18][3]), "+r"(d[19][0]), "+r"(d[19][1]), "+r"(d[19][2]), "+r"(d[19][3]), "+r"(d[20][0]), "+r"(d[20][1]), "+r"(d[20][2]), "+r"(d[20][3]), "+r"(d[21][0]), "+r"(d[21][1]), "+r"(d[21][2]), "+r"(d[21][3]), "+r"(d[22][0]), "+r"(d[22][1]), "+r"(d[22][2]), "+r"(d[22][3]), "+r"(d[23][0]), "+r"(d[23][1]), "+r"(d[23][2]), "+r"(d[23][3]), "+r"(d[24][0]), "+r"(d[24][1]), "+r"(d[24][2]), "+r"(d[24][3]), "+r"(d[25][0]), "+r"(d[25][1]), "+r"(d[25][2]), "+r"(d[25][3]), "+r"(d[26][0]), "+r"(d[26][1]), "+r"(d[26][2]), "+r"(d[26][3]), "+r"(d[27][0]), "+r"(d[27][1]), "+r"(d[27][2]), "+r"(d[27][3]), "+r"(d[28][0]), "+r"(d[28][1]), "+r"(d[28][2]), "+r"(d[28][3]), "+r"(d[29][0]), "+r"(d[29][1]), "+r"(d[29][2]), "+r"(d[29][3]), "+r"(d[30][0]), "+r"(d[30][1]), "+r"(d[30][2]), "+r"(d[30][3]), "+r"(d[31][0]), "+r"(d[31][1]), "+r"(d[31][2]), "+r"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store_out(float* p, float a, float b, bool pair) {
  if (pair) *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else *p = a;
}
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float a, float b, bool pair) {
  if (pair) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  else *p = __float2bfloat16(a);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16) from global memory to shared address `dst`,
// completing on `bar`
__device__ __forceinline__ void bulk_copy_u32(uint32_t dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// until the phase of `bar` with this parity has completed; a wait of more
// than 10 s traps (a fault in the ring's bookkeeping then fails the launch
// instead of hanging the card)
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (int spin = 0; !done; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && (spin & 1023) == 1023) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) t0 = now;
      else if (now - t0 > 10000000000ull) __trap();
    }
  }
}

// output tile mt: its first output voxel and how many it holds
__device__ __forceinline__ void tile_of(int mt, const Params& p, int& m0, int& len) {
  const int grp = mt / p.tpg;
  const int q0 = (mt - grp * p.tpg) * kBM;
  m0 = grp * p.group + q0;
  len = min(kBM, min(p.group - q0, p.m_total - m0));
}

// output voxel m: the input corner (z0, y0, x0) its tap (0, 0, 0) reads,
// and that corner's flat voxel index (which may lie outside the volume)
__device__ __forceinline__ int corner(int m, const Params& p, int& z0, int& y0, int& x0) {
  const int ox = m % p.ow;
  int r = m / p.ow;
  const int oy = r % p.oh;
  r /= p.oh;
  const int oz = r % p.od;
  const int nn = r / p.od;
  z0 = oz * p.sd - p.pd;
  y0 = oy * p.sh - p.ph;
  x0 = ox * p.sw - p.pw;
  return ((nn * p.d + z0) * p.h + y0) * p.w + x0;
}

// the first voxel of the staged run that tap plane dz (and row dy) of the
// tile whose first corner is f0 reads: a run a tap plane, or a tap row
// (srows kh), or (nseg 1) one run for every tap
__device__ __forceinline__ int run_lo(int f0, int dz, int dy, const Params& p) {
  return p.nseg > 1 ? f0 + dz * p.hw + (p.srows > 1 ? dy * p.w : 0) : f0;
}

// that of staged segment g: tap plane g, or tap row (g / srows, g % srows)
// (no division where srows is 1)
__device__ __forceinline__ int seg_lo(int f0, int g, const Params& p) {
  return p.srows == 1 ? run_lo(f0, g, 0, p) : run_lo(f0, g / p.srows, g % p.srows, p);
}

// the producer warp: each tile's brick (or its chunks), and the weight
// chunks
template <int BN>
__device__ void produce(const Params& p, const CUtensorMap* map0, const CUtensorMap* map1,
                        uint32_t bricks, unsigned char* bricks_ptr, uint32_t wslots,
                        uint64_t* bfull, uint64_t* bempty, uint64_t* wfull, uint64_t* wempty) {
  const int lane = threadIdx.x & 31;
  const int tiles = p.tiles_m * p.n_tiles;
  const uint32_t wbytes = BN * 32;  // one k32 step of the weight
  if (p.resident && lane == 0) {
    for (int c = 0; c < p.n_chunks; ++c) {
      const int steps = min(p.chunk_steps, p.k_steps - c * p.chunk_steps);
      mbar_expect_tx(&wfull[c], steps * wbytes);
      bulk_copy_u32(wslots + c * p.chunk_bytes, p.wp + (long long)c * p.chunk_steps * wbytes,
                    steps * wbytes, &wfull[c]);
    }
  }
  int q = 0;  // weight chunks streamed
  int i = 0;  // brick slots filled
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int mt = t / p.n_tiles;
    const int nt = t - mt * p.n_tiles;
    int m0, len, z0, y0, x0;
    tile_of(mt, p, m0, len);
    const int f0 = corner(m0, p, z0, y0, x0);
    for (int j = 0; j < p.bchunks; ++j, ++i) {
      const int slot = i % p.bslots, use = i / p.bslots;
      if (use >= 1) wait_phase(&bempty[slot], (use - 1) & 1);
      if (!p.byte_path) {
        if (lane == 0) mbar_expect_tx(&bfull[slot], (uint32_t)p.brick_bytes);
        __syncwarp();
        // the sub-parts this slot holds: every part's (the whole brick),
        // or sub-part s0 of one part (chunk j, in the concat's order)
        int nsub[2] = {p.nsub[0], p.nparts > 1 ? p.nsub[1] : 0}, s0[2] = {0, 0};
        if (p.bchunks > 1) {
          const int kc = j < p.nsub[0] ? 0 : 1;
          nsub[0] = nsub[1] = 0;
          nsub[kc] = 1;
          s0[kc] = kc == 0 ? j : j - p.nsub[0];
        }
        // boxes (part, sub-part, segment, box), the box fastest
        int nbox[2] = {0, 0};
        for (int k = 0; k < 2; ++k)
          if (nsub[k] > 0) nbox[k] = nsub[k] * p.nseg * (p.lpad / p.box[k]);
        const uint32_t dst0 = bricks + slot * p.brick_bytes;
        for (int jb = lane; jb < nbox[0] + nbox[1]; jb += 32) {
          const int k = jb < nbox[0] ? 0 : 1;
          const int jj = k == 0 ? jb : jb - nbox[0];
          const int per_seg = p.lpad / p.box[k];
          const int b = jj % per_seg, r = jj / per_seg;
          const int g = r % p.nseg, s = r / p.nseg;
          const int lo = seg_lo(f0, g, p) + b * p.box[k];
          tma_load_2d(dst0 + p.base[k] + (s * p.nseg + g) * p.seg[k] + b * p.box[k] * p.cs[k],
                      k == 0 ? map0 : map1, (s0[k] + s) * p.cs[k], lo, &bfull[slot]);
        }
      } else {
        // one part; per segment the bytes [lo cin, (lo + lpad) cin) of the
        // flat input that exist: the 16-byte-aligned body by cp.async.bulk,
        // the last < 16 bytes by this warp's stores, made before lane 0's
        // arrive so that it orders them before the consumers' reads
        const long long cin = p.cin[0];
        unsigned char* slot_ptr = bricks_ptr + slot * p.brick_bytes;
        uint32_t tx = 0;
        for (int g = 0; g < p.nseg; ++g) {
          const long long lo = (long long)seg_lo(f0, g, p) * cin;
          const long long b_lo = max(lo, 0LL), b_hi = min(lo + p.lpad * cin, p.total_bytes[0]);
          if (b_hi <= b_lo) continue;
          const long long a_lo = b_lo & ~15LL, a_hi = b_hi & ~15LL;
          const long long origin = lo & ~15LL;  // the segment buffer's first byte
          for (long long bb = max(a_hi, b_lo) + lane; bb < b_hi; bb += 32)
            slot_ptr[g * p.seg[0] + (bb - origin)] = (unsigned char)p.x[0][bb];
          if (a_hi > a_lo) tx += (uint32_t)(a_hi - a_lo);
        }
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(&bfull[slot], tx);
          for (int g = 0; g < p.nseg; ++g) {
            const long long lo = (long long)seg_lo(f0, g, p) * cin;
            const long long b_lo = max(lo, 0LL), b_hi = min(lo + p.lpad * cin, p.total_bytes[0]);
            const long long a_lo = b_lo & ~15LL, a_hi = b_hi & ~15LL;
            if (b_hi <= b_lo || a_hi <= a_lo) continue;
            bulk_copy_u32(bricks + slot * p.brick_bytes + g * p.seg[0] +
                              (uint32_t)(a_lo - (lo & ~15LL)),
                          p.x[0] + a_lo, (uint32_t)(a_hi - a_lo), &bfull[slot]);
          }
        }
      }
      // the weight chunks of this brick chunk (of the tile, whole brick)
      if (!p.resident && lane == 0) {
        for (int c = j * p.cpb; c < (j + 1) * p.cpb; ++c, ++q) {
          const int ws = q % p.w_slots, wuse = q / p.w_slots;
          if (wuse >= 1) wait_phase(&wempty[ws], (wuse - 1) & 1);
          const int steps = min(p.chunk_steps, p.k_steps - c * p.chunk_steps);
          mbar_expect_tx(&wfull[ws], steps * wbytes);
          bulk_copy_u32(wslots + ws * p.chunk_bytes,
                        p.wp + ((long long)nt * p.k_steps + (long long)c * p.chunk_steps) * wbytes,
                        steps * wbytes, &wfull[ws]);
        }
      }
      __syncwarp();
    }
  }
}

template <typename OutT>
__device__ __forceinline__ float epilogue(int acc, float s, float b, int mode) {
  float v = __fmul_rn(__int2float_rn(acc), s);
  if (mode == 1) v = __fadd_rn(v, b);
  else if (mode == 2) v = __fadd_rn(round_to<OutT>(v), round_to<OutT>(b));
  return v;
}

// one output row a lane reads for: live, its input corner and its flat
// corner's offset from the tile's
struct Row {
  bool live;
  int z0, y0, x0, rel;

  __device__ __forceinline__ void at(int r, int m0, int len, int f0, const Params& p) {
    live = r < len;
    rel = corner(m0 + (live ? r : 0), p, z0, y0, x0) - f0;
  }
  // whether tap (dz, dy, dx) of this row lies in the volume
  __device__ __forceinline__ bool in(int dz, int dy, int dx, const Params& p) const {
    return live && (unsigned)(z0 + dz) < (unsigned)p.d && (unsigned)(y0 + dy) < (unsigned)p.h &&
           (unsigned)(x0 + dx) < (unsigned)p.w;
  }
};

// the consumer warpgroups: the K loop of each tile and its epilogue;
// kFull: every weight chunk is kMaxChunk k32 steps, issued unconditionally
// (module comment)
template <int BN, typename OutT, bool kFull>
__device__ void consume(const Params& p, uint32_t bricks, const unsigned char* bricks_ptr,
                        uint32_t wslots, uint32_t zero, const int4* table, const float* sscale,
                        const float* sbias, uint64_t* bfull, uint64_t* bempty,
                        uint64_t* wfull, uint64_t* wempty) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rbase = (warp >> 2) * 64 + (warp & 3) * 16;
  const int tiles = p.tiles_m * p.n_tiles;
  int acc[BN / 8][4];
  uint32_t af0[kMaxChunk][4], af1[kMaxChunk][4];
  int q = 0;  // weight chunks consumed
  int i = 0;  // brick slots consumed
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int mt = t / p.n_tiles;
    const int nt = t - mt * p.n_tiles;
    int m0, len, z0, y0, x0;
    tile_of(mt, p, m0, len);
    const int f0 = corner(m0, p, z0, y0, x0);
    // the ldmatrix path: lane names row (lane & 7) + 8 ((lane >> 3) & 1)
    // of its warp's 16 and piece lane >> 4 of the step; the byte path
    // builds rows lane / 4 and lane / 4 + 8 itself
    Row ra, rb;
    if (!p.byte_path) {
      ra.at(rbase + (lane & 7) + ((lane >> 3) & 1) * 8, m0, len, f0, p);
    } else {
      ra.at(rbase + (lane >> 2), m0, len, f0, p);
      rb.at(rbase + (lane >> 2) + 8, m0, len, f0, p);
    }
    // the ring slot of the brick chunk the K loop is in
    uint32_t brick = bricks;
    const unsigned char* brick_ptr = bricks_ptr;
    // one k32 step's A fragment (this warp's 16 rows) into `a`
    auto load_a = [&](int ks, uint32_t(&a)[4]) {
      if (!p.byte_path) {
        const int4 e = table[2 * ks + (lane >> 4)];
        const uint32_t ew = (uint32_t)e.w;
        uint32_t addr = zero;
        if (!(ew & kPad) && ra.in(ew & 15, (ew >> 4) & 15, (ew >> 8) & 15, p)) {
          const int cl = (ew >> 12) & 15;  // log2 of the sub-part's bytes a voxel
          const uint32_t lin = ((uint32_t)(ra.rel + e.z) << cl) + (uint32_t)e.y;
          // the TMA swizzle of 2^cl-byte rows (none at 16 bytes)
          addr = brick + (uint32_t)e.x + (lin ^ ((lin >> 3) & ((((1u << cl) >> 4) - 1) << 4)));
        }
        ldmatrix_x4(a, addr);
      } else {
        const long long cin = p.cin[0];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const Row& row = (r & 1) ? rb : ra;
          const int kb = ks * 32 + (r >> 1) * 16 + (lane & 3) * 4;
          uint32_t word = 0;
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const int4 e = table[kb + bb];
            const uint32_t ew = (uint32_t)e.w;
            const int dz = ew & 15;
            if (!(ew & kPad) && row.in(dz, (ew >> 4) & 15, (ew >> 8) & 15, p)) {
              // the segment buffer starts at its first byte rounded down to 16
              const long long lo = (long long)run_lo(f0, dz, (ew >> 4) & 15, p) * cin;
              const long long off = (long long)(row.rel + e.z) * cin + e.y + (lo & 15);
              word |= (uint32_t)brick_ptr[e.x + off] << (8 * bb);
            }
          }
          a[r] = word;
        }
      }
    };
    // one weight chunk (up to 4 k32 steps) as one commit group: its A
    // fragments loaded into `a` (two sets, so that a chunk's loads overlap
    // the previous chunk's wgmmas), one fence, its wgmmas back to back
    // (kFull: all four, under no runtime condition)
    auto chunk = [&](int c, uint32_t(&a)[kMaxChunk][4]) {
      const int ws = p.resident ? c : q % p.w_slots;
      wait_phase(&wfull[ws], p.resident ? 0u : (uint32_t)((q / p.w_slots) & 1));
      const int k0 = c * p.chunk_steps, steps = min(p.chunk_steps, p.k_steps - k0);
#pragma unroll
      for (int s = 0; s < kMaxChunk; ++s)
        if (kFull || s < steps) load_a(k0 + s, a[s]);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kMaxChunk; ++s)
        if (kFull || s < steps)
          wgmma_s8<BN>(acc, a[s], wgmma_desc(wslots + ws * p.chunk_bytes + s * BN * 32, 128, 256),
                       k0 + s > 0);
      wgmma_commit();
      wgmma_wait<1>();
      // every chunk before this one has completed: its slot is free
      if (!p.resident && c > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&wempty[(q - 1) % p.w_slots]);
      }
      ++q;
    };
    // per brick chunk (one: the whole brick) its slot, once full, and its
    // weight chunks; the slot is freed once their A fragments are in
    // registers
    for (int j = 0, c0 = 0; j < p.bchunks; ++j, ++i, c0 += p.cpb) {
      const int slot = i % p.bslots;
      brick = bricks + slot * p.brick_bytes;
      brick_ptr = bricks_ptr + slot * p.brick_bytes;
      wait_phase(&bfull[slot], (i / p.bslots) & 1);
      // an odd count of weight chunks a brick chunk left af0 feeding the
      // last chunk's wgmmas
      if (j > 0 && (p.cpb & 1)) wgmma_wait<0>();
      for (int c = c0; c < c0 + p.cpb; c += 2) {
        chunk(c, af0);
        if (c + 1 < c0 + p.cpb) chunk(c + 1, af1);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&bempty[slot]);
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0 && !p.resident) mbar_arrive(&wempty[(q - 1) % p.w_slots]);
    // rows lane / 4 and lane / 4 + 8 of this warp's 16; columns
    // 2 (lane % 4) + 0..1 of each n8 tile
    OutT* y = static_cast<OutT*>(p.y);
    const bool even = (p.cout & 1) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int o = nt * BN + 8 * j + 2 * (lane & 3);
      if (o >= p.cout) continue;
      const bool two = o + 1 < p.cout;
      const float s0 = sscale[o], s1 = sscale[o + 1], b0 = sbias[o], b1 = sbias[o + 1];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = rbase + (lane >> 2) + 8 * hr;
        if (r >= len) continue;
        OutT* out = y + (long long)(m0 + r) * p.cout + o;
        const float v0 = epilogue<OutT>(acc[j][2 * hr], s0, b0, p.bias_mode);
        const float v1 = epilogue<OutT>(acc[j][2 * hr + 1], s1, b1, p.bias_mode);
        store_out(out, v0, v1, two && even);
        if (two && !even) store_out(out + 1, v1, 0.f, false);
      }
    }
  }
}

template <int BN, typename OutT, bool kFull>
__device__ __forceinline__ void conv_int8_block(const CUtensorMap* map0, const CUtensorMap* map1,
                                                const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  // the bricks on a 1024-byte boundary: the TMA swizzle is a function of
  // the shared-memory address, and the consumers' address of it of the
  // offset in the buffer
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t skip = ((raw + 1023u) & ~1023u) - raw;
  unsigned char* base = smem_raw + skip;
  const uint32_t bricks = raw + skip;
  const uint32_t wslots = bricks + p.bslots * p.brick_bytes;
  const uint32_t zero = wslots + p.w_slots * p.chunk_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + (zero - bricks) + 32);
  uint64_t* bfull = bars;
  uint64_t* bempty = bars + p.bslots;
  uint64_t* wfull = bars + 2 * p.bslots;
  uint64_t* wempty = wfull + p.w_slots;
  // the K-row table, the scales and the bias in shared memory: the K loop
  // and the epilogue then make no global load, which would queue behind
  // the previous tile's output stores
  int4* table = reinterpret_cast<int4*>(wempty + p.w_slots);
  float* sscale = reinterpret_cast<float*>(table + p.table_rows);
  float* sbias = sscale + p.n_tiles * BN;
  const int tid = threadIdx.x;
  for (int k = tid; k < p.table_rows; k += kThreads) table[k] = p.table[k];
  for (int k = tid; k < p.n_tiles * BN; k += kThreads) {
    sscale[k] = k < p.cout ? p.scale[k] : 0.f;
    sbias[k] = k < p.cout && p.bias_mode ? p.bias[k] : 0.f;
  }
  if (tid == 0) {
    for (int k = 0; k < p.bslots; ++k) {
      mbar_init(&bfull[k], 1);
      mbar_init(&bempty[k], kConsumers / 32);
    }
    for (int k = 0; k < p.w_slots; ++k) {
      mbar_init(&wfull[k], 1);
      mbar_init(&wempty[k], kConsumers / 32);
    }
    mbar_init_fence();
  }
  if (tid < 8) reinterpret_cast<uint32_t*>(base + (zero - bricks))[tid] = 0u;
  __syncthreads();
  if (tid >= kConsumers)
    produce<BN>(p, map0, map1, bricks, base, wslots, bfull, bempty, wfull, wempty);
  else
    consume<BN, OutT, kFull>(p, bricks, base, wslots, zero, table, sscale, sbias, bfull,
                             bempty, wfull, wempty);
}

// the dense mode (the whole brick a slot, or by chunks) and the structured
// mode: one kernel under three names, so that a profile tells them apart
template <int BN, typename OutT, bool kFull>
__global__ void __launch_bounds__(kThreads, BN <= 24 ? 2 : 1)
    conv_int8_dense_kernel(const __grid_constant__ CUtensorMap map0,
                           const __grid_constant__ CUtensorMap map1, const Params p) {
  conv_int8_block<BN, OutT, kFull>(&map0, &map1, p);
}

template <int BN, typename OutT, bool kFull>
__global__ void __launch_bounds__(kThreads, BN <= 24 ? 2 : 1)
    conv_int8_chunked_kernel(const __grid_constant__ CUtensorMap map0,
                             const __grid_constant__ CUtensorMap map1, const Params p) {
  conv_int8_block<BN, OutT, kFull>(&map0, &map1, p);
}

template <int BN, typename OutT, bool kFull>
__global__ void __launch_bounds__(kThreads, BN <= 24 ? 2 : 1)
    conv_int8_structured_kernel(const __grid_constant__ CUtensorMap map0,
                                const __grid_constant__ CUtensorMap map1, const Params p) {
  conv_int8_block<BN, OutT, kFull>(&map0, &map1, p);
}

// the structured mode serves the packed k3s, whose P F output channels
// take tiles 64 to 256 wide: it is built for those widths only
template <int BN, typename OutT, bool kFull>
int launch(const Params& p, const CUtensorMap& m0, const CUtensorMap& m1, int smem, int grid,
           bool structured, cudaStream_t stream) {
  auto fn = p.bchunks > 1 ? conv_int8_chunked_kernel<BN, OutT, kFull>
                          : conv_int8_dense_kernel<BN, OutT, kFull>;
  if constexpr (BN >= 64) {
    if (structured) fn = conv_int8_structured_kernel<BN, OutT, kFull>;
  } else if (structured) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // the blocks a SM can hold (two for the narrow tiles when their shared
  // memory allows), each persistent
  int per_sm = 1;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  grid = max(1, min(grid * max(per_sm, 1), p.tiles_m * p.n_tiles));
  fn<<<grid, kThreads, smem, stream>>>(m0, m1, p);
  return (int)cudaGetLastError();
}

template <typename OutT, bool kFull>
int launch_bn(const Params& p, const CUtensorMap& m0, const CUtensorMap& m1, int bn, int smem,
              int grid, bool structured, cudaStream_t s) {
  switch (bn) {
    case 8: return launch<8, OutT, kFull>(p, m0, m1, smem, grid, structured, s);
    case 16: return launch<16, OutT, kFull>(p, m0, m1, smem, grid, structured, s);
    case 24: return launch<24, OutT, kFull>(p, m0, m1, smem, grid, structured, s);
    case 32: return launch<32, OutT, kFull>(p, m0, m1, smem, grid, structured, s);
    case 64: return launch<64, OutT, kFull>(p, m0, m1, smem, grid, structured, s);
    case 128: return launch<128, OutT, kFull>(p, m0, m1, smem, grid, structured, s);
    case 256: return launch<256, OutT, kFull>(p, m0, m1, smem, grid, structured, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// launch_bn<OutT, true> by out_dtype (0 fp32, 1 bf16): csrc/conv_int8_full.cu
int launch_full(const Params& p, const CUtensorMap& m0, const CUtensorMap& m1, int bn, int smem,
                int grid, bool structured, int out_dtype, cudaStream_t s);

}  // namespace int8conv
}  // namespace tpuseg
