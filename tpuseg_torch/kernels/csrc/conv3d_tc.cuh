// What the tensor-core kernels of the 3x3x3 conv share (bf16:
// csrc/conv3d_small_tc.cu, forward and dX, csrc/conv3d_small_dw_tc.cu, dW;
// float32 by 3xTF32: csrc/conv3d_small_tf32.cu, csrc/conv3d_small_dw_tf32.cu):
// the output tiling, the walk of a persistent block over its tiles, the
// asynchronous staging of one halo'd input plane, and the tf32 split.
//
// An output tile is TY rows x TX columns of one (n, z) plane, at most 256
// voxels (8 warps x 2 m16 tiles).  A "column" is the stack of such tiles over z;
// its z range is cut into chunks of ZC planes, and one item is one chunk
// of one column.  A block walks the items blockIdx.x, + gridDim.x, ...;
// along an item it stages the input planes z0 - 1 .. z0 + len, one per
// step, into a ring of `stages` slots, and output plane z0 + p - 2 is
// computed at step p >= 2 from the three slots that hold planes
// z0 + p - 3 .. z0 + p - 1.  So each input plane is staged once per
// column chunk, not three times.  The steps run stages - 3 ahead of the
// compute (cp.async groups), across item boundaries too.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace tpuseg {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_M = 32 * WARPS;   // output voxels per tile (two m16 tiles a warp)
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block
constexpr int CPAD = 8;             // bf16 of padding per staged voxel (bf16)

struct Tiles {
  int D, H, W;
  int cstride, c0;   // channels of an input voxel, first one staged
  int cin, cin_pad;  // staged channels, and them rounded up (to 16 in bf16)
  int vs;            // staged voxel stride in elements (cin_pad + padding;
                     // for an ldmatrix an odd number of 16-byte units, so
                     // its 8 rows (8 neighbouring voxels) fall in 8 bank
                     // groups)
  int ty, tx, nty, ntx, zc, nzc;
  long long items;   // N * nzc * nty * ntx
  int stages;        // ring slots (4 to 8): stages - 3 steps in flight
  int patch;         // elements of one staged plane, (ty + 2) x (tx + 2) x vs
};

// cin rounded up to a multiple of `calign`, `cpad` elements of padding per
// staged voxel (bf16: 16 and CPAD)
__host__ inline Tiles make_tiles(int n, int d, int h, int w, int cin, int ty,
                                 int tx, int zc, int stages, int calign = 16,
                                 int cpad = CPAD) {
  Tiles t;
  t.D = d; t.H = h; t.W = w;
  t.cstride = cin;
  t.c0 = 0;
  t.cin = cin;
  t.cin_pad = (cin + calign - 1) / calign * calign;
  t.vs = t.cin_pad + cpad;
  t.ty = ty; t.tx = tx;
  t.nty = (h + ty - 1) / ty;
  t.ntx = (w + tx - 1) / tx;
  t.zc = zc;
  t.nzc = (d + zc - 1) / zc;
  t.items = (long long)n * t.nzc * t.nty * t.ntx;
  t.stages = stages;
  t.patch = (ty + 2) * (tx + 2) * t.vs;
  return t;
}

// z chunk length: the one that gives the fewest steps to the busiest of
// `resident` blocks, (items per block, rounded up) x (chunk + 2 staged
// planes); each chunk stages two planes more than it outputs
__host__ inline int pick_zc(int n, int d, int h, int w, int ty, int tx,
                            long long resident) {
  const long long columns =
      (long long)n * ((h + ty - 1) / ty) * ((w + tx - 1) / tx);
  long long best = -1;
  int best_zc = 1;
  for (int zc = 1; zc <= d && zc <= 1024; ++zc) {
    const long long items = columns * ((d + zc - 1) / zc);
    const long long steps = (items + resident - 1) / resident * (zc + 2);
    if (best < 0 || steps < best) {
      best = steps;
      best_zc = zc;
    }
  }
  return best_zc;
}

// One step of a block's walk: item `item`, plane index p (input plane
// z0 - 1 + p).
struct Step {
  long long item;
  int p, len, n, z0, y0, x0;

  __device__ __forceinline__ void start(long long it, const Tiles& t) {
    item = it;
    p = 0;
    if (it >= t.items) return;
    long long r = it;
    const int xt = (int)(r % t.ntx); r /= t.ntx;
    const int yt = (int)(r % t.nty); r /= t.nty;
    const int zt = (int)(r % t.nzc); r /= t.nzc;
    n = (int)r;
    z0 = zt * t.zc;
    len = min(t.zc, t.D - z0);
    y0 = yt * t.ty;
    x0 = xt * t.tx;
  }
  __device__ __forceinline__ bool valid(const Tiles& t) const { return item < t.items; }
  __device__ __forceinline__ void next(const Tiles& t) {
    if (++p == len + 2) start(item + gridDim.x, t);
  }
};

// `vec` bytes of channels from global to shared memory: cp.async for 4, 8
// and 16 (zero-filled outside the volume), a plain load and store for 2
// (bf16 x only 2-byte aligned, or an odd channel count).  `vec` is the same
// for the whole block, so the switch does not diverge.
__device__ __forceinline__ void copy_chunk(float* dst, const float* src, bool ok, int vec) {
  switch (vec) {
    case 16: cp_async_zfill<16>(dst, src, ok); break;
    case 8: cp_async_zfill<8>(dst, src, ok); break;
    default: cp_async_zfill<4>(dst, src, ok);
  }
}

__device__ __forceinline__ void copy_chunk(bf16* dst, const bf16* src, bool ok, int vec) {
  switch (vec) {
    case 16: cp_async_zfill<16>(dst, src, ok); break;
    case 8: cp_async_zfill<8>(dst, src, ok); break;
    case 4: cp_async_zfill<4>(dst, src, ok); break;
    default:
      *reinterpret_cast<uint16_t*>(dst) =
          ok ? *reinterpret_cast<const uint16_t*>(src) : uint16_t(0);
  }
}

// Input plane z of sample n around the tile at (y0, x0): (ty + 2) x
// (tx + 2) voxels, channels c0 .. c0 + cin of each, into `slot` as
// [row][x][vs], zero outside the volume, in copies of `vec` bytes.  Channels cin .. cin_pad
// of every voxel are left as they are (zeroed once when the block starts).
template <typename T>
__device__ __forceinline__ void stage_plane(T* slot, const T* __restrict__ x,
                                            const Tiles& t, int vec, int n, int z, int y0,
                                            int x0) {
  const int e = vec / (int)sizeof(T);  // channels per copy
  const int per_vox = t.cin / e;
  const int w2 = t.tx + 2;
  const int total = (t.ty + 2) * w2 * per_vox;
  const bool z_ok = z >= 0 && z < t.D;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int v = i / per_vox;
    const int c = (i - v * per_vox) * e;
    const int r = v / w2;
    const int lx = v - r * w2;
    const int yy = y0 - 1 + r;
    const int xx = x0 - 1 + lx;
    const bool ok = z_ok && yy >= 0 && yy < t.H && xx >= 0 && xx < t.W;
    const T* src =
        ok ? x + ((((size_t)n * t.D + z) * t.H + yy) * (size_t)t.W + xx) * t.cstride + t.c0 + c
           : x;
    copy_chunk(slot + v * t.vs + c, src, ok, vec);
  }
}

// wait until this thread's group of `depth` steps ago has landed (at most
// depth - 1 younger groups in flight); depth = stages - 3, 1 to 5
__device__ __forceinline__ void wait_step(int depth) {
  switch (depth) {
    case 1: cp_async_wait<0>(); break;
    case 2: cp_async_wait<1>(); break;
    case 3: cp_async_wait<2>(); break;
    case 4: cp_async_wait<3>(); break;
    default: cp_async_wait<4>();
  }
}

// zero `bytes` (a multiple of 16) of shared memory from `p`
__device__ __forceinline__ void zero_smem(void* p, int bytes) {
  uint4* q = reinterpret_cast<uint4*>(p);
  for (int i = threadIdx.x; i < bytes / 16; i += THREADS) q[i] = make_uint4(0, 0, 0, 0);
}

// widest copy (16, 8, 4, or for bf16 2 bytes) that c channels of `es`
// bytes each at `p` allow
__host__ inline int copy_bytes(const void* p, int c, int es = 2) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int v = 16; v > es; v >>= 1)
    if ((c * es) % v == 0 && a % v == 0) return v;
  return es;
}

// float32 -> the nearest tf32 (10 mantissa bits, ties away from zero), as
// the 32-bit pattern the tf32 MMAs read: the rounding of cvt.rna.tf32.f32,
// bit for bit, in two integer operations (half of the 13 dropped bits'
// range added to the magnitude, then cleared), which the H100 runs faster
// than the conversion
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// the 3xTF32 split of one fragment: v = hi + lo to about 2**-22, each a tf32
__device__ __forceinline__ void tf32_split(const uint32_t (&v)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float f = __uint_as_float(v[i]);
    hi[i] = tf32_rna(f);
    lo[i] = tf32_rna(f - __uint_as_float(hi[i]));
  }
}

}  // namespace tc
}  // namespace tpuseg
