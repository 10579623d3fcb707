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
// wrapper, plan and design note: tpuseg_torch/kernels/flat_conv.py.
//
// A persistent walk (csrc/probe_walk.cuh): a block owns TM = 448 output
// rows of one sample and walks its planes d along a z chunk.  One warp of a
// producer warpgroup (whose registers setmaxnreg hands to the two consumer
// warpgroups) fills a ring of plane windows with cp.async.bulk on full /
// empty mbarriers: the rows [s0, s0 + TM + 2 WS + 16) of one plane
// (clipped at S), one contiguous run of xflat (`cat`: each plane staged
// once per strip, read by three output planes) or of xcat (`pre`).  The
// weight is resident, in wgmma's K-major layout without swizzle.
//
// One accumulator for all nine (dz, dy) taps: Z[s, (dx, co)] = sum over
// (dz, dy, ci) of X_{d+dz}[s + dy WS, ci] w2[dz C + ci, dy 48 + (dx, co)],
// K = 9C in (dz, dy, ci) order, N = 48, so dz is a slot (or a channel
// offset in xcat) and dy a row offset of the A fragment.  M tiles: m16
// tiles of 16 rows that keep 14 outputs (tile j starts at row 14 j), four
// a warpgroup's m64 tile, MT m64 tiles a warpgroup, two warpgroups; the A
// fragment is an ldmatrix of 16 staged rows (rows past S from a zero
// word).  Then out[s, co] = Z[s, co] + Z[s+1, 16 + co] + Z[s+2, 32 + co]
// by warp shuffles inside the m16 tile, stored from registers (a tile's
// 14 rows are 448 contiguous bytes).
//
// What bounds it on the card: memory at the probe shapes (kernels/
// flat_conv.py); the GEMM, 16/14 of the output's 27 C multiply-adds a
// value on wgmma m64n48k16, is what it reaches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "probe_walk.cuh"

namespace {

using namespace tpuseg;
using namespace tpuseg::walk;
using bf16 = __nv_bfloat16;

constexpr int COUT = 16;                        // output channels (the probe's)
constexpr int NZ = 3 * COUT;                    // Z columns (dx, co): wgmma's N
constexpr int NJ = NZ / 8;
constexpr int CONSUMERS = 8;                    // consumer warps: two warpgroups
constexpr int THREADS = 32 * (CONSUMERS + 4);   // and a producer warpgroup
constexpr int PRODUCER_REGS = 40;               // registers per thread after setmaxnreg:
constexpr int CONSUMER_REGS = 232;              // 128 x 40 + 256 x 232 <= 65536
constexpr int MT = 4;                           // m64 tiles of a warpgroup
constexpr int TILE_OUT = 14;                    // output rows of an m16 tile
constexpr int TM = TILE_OUT * 4 * MT * 2;       // output rows of a strip: 448
constexpr int HALO = 16;                        // window rows past TM + 2 WS
constexpr int BAR_BYTES = 128;                  // full[MAX_STAGES], empty[MAX_STAGES]
constexpr int ZERO_BYTES = 128;                 // the zero word rows past S read
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;              // dynamic shared memory of one block

struct Geo {
  int D, S, SV, C, WS;
  int rowe;       // elements of a staged row: C, or 3C (xcat)
  int slot_rows;  // rows of a slot: min(TM + 2 WS + HALO, S)
  int stages;     // ring slots
};

// The launch plan (kernels/flat_conv.py `plan` mirrors it)
struct Plan {
  int rowe, slot_rows, stages;
  size_t smem;
};

Plan make_plan(bool pre, int c, int s, int ws) {
  Plan p;
  p.rowe = pre ? 3 * c : c;
  p.slot_rows = TM + 2 * ws + HALO < s ? TM + 2 * ws + HALO : s;
  const long long fixed = BAR_BYTES + ZERO_BYTES + 9LL * c * NZ * 2;
  const long long slot = (long long)p.slot_rows * p.rowe * 2;
  const long long fit = (SMEM_LIMIT - fixed) / slot;
  p.stages = (int)(fit < MAX_STAGES ? fit : MAX_STAGES);
  p.smem = (size_t)(fixed + p.stages * slot);
  return p;
}

template <bool PRE>
__global__ void __launch_bounds__(THREADS, 1) flat_conv_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w2, bf16* __restrict__ out, Geo g,
    Walk w) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  unsigned char* zero = smem + BAR_BYTES;
  bf16* wsm = reinterpret_cast<bf16*>(zero + ZERO_BYTES);  // [ks][NJ][2][8][8]
  const int ks = 9 * g.C / 16;
  bf16* ring = wsm + ks * 16 * NZ;                        // [stages][slot_rows][rowe]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slot_elems = g.slot_rows * g.rowe;

  // the weight as B[k = (dz, dy, ci)][n = (dx, co)] = w2[dz C + ci][dy 48 + n]
  for (int i = tid; i < 9 * g.C * NZ; i += THREADS) {
    const int k = i / NZ, nn = i - k * NZ;
    const int t = k / g.C, ci = k - t * g.C, dz = t / 3, dy = t - 3 * dz;
    wsm[(((k >> 4) * NJ + (nn >> 3)) * 2 + ((k >> 3) & 1)) * 64 + (nn & 7) * 8 + (k & 7)] =
        w2[(size_t)(dz * g.C + ci) * (3 * NZ) + dy * NZ + nn];
  }
  if (tid < ZERO_BYTES / 16) reinterpret_cast<uint4*>(zero)[tid] = make_uint4(0, 0, 0, 0);
  fence_proxy_async();  // the weight's stores before the wgmmas read it
  if (tid == 0) {
    for (int i = 0; i < g.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS) {  // the producer warpgroup: one warp issues the
    setmaxnreg_dec<PRODUCER_REGS>();  // block's fills, in order
    if (warp != CONSUMERS) return;
    int q = 0;
    for (long long it = blockIdx.x; it < w.items; it += gridDim.x) {
      Item item;
      item.decode(it, w);
      const int s0 = item.strip * TM;
      const int rows = min(g.slot_rows, g.S - s0);
      const int per = (rows + 31) / 32;  // rows of one lane's copy
      for (int f = 0; f < item.nf; ++f, ++q) {
        const int slot = q % g.stages;
        if (lane == 0) {
          if (q >= g.stages) mbar_wait(empty + slot, (uint32_t)(q / g.stages + 1) & 1);
          mbar_expect_tx(full + slot, (uint32_t)rows * g.rowe * 2);
        }
        __syncwarp();
        const int z = item.fill_z(f, w);
        const bf16* src = x + ((size_t)item.n * (PRE ? g.D : g.D + 2) + z) * g.S * g.rowe +
                          (size_t)s0 * g.rowe;
        const int r0 = lane * per, r1 = min(rows, r0 + per);
        if (r0 < r1)
          bulk_copy(ring + (size_t)slot * slot_elems + (size_t)r0 * g.rowe,
                    src + (size_t)r0 * g.rowe, (uint32_t)(r1 - r0) * g.rowe * 2, full + slot);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  // consumers: warpgroup wg, warp wq of it; m16 tile J = (wg MT + mt) 4 + wq
  // of a strip covers rows 14 J .. 14 J + 15.  ldmatrix lane roles: row
  // lane & 15 of the tile, channels 8 (lane >> 4) .. + 8 of the k16 step
  const int wg = warp >> 2, wq = warp & 3;
  int trow[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) trow[mt] = TILE_OUT * ((wg * MT + mt) * 4 + wq);
  const uint32_t ring_u = smem_u32(ring);
  const uint32_t zero_u = smem_u32(zero);
  const uint32_t rowb = g.rowe * 2;
  const uint32_t colb = (lane >> 4) * 16;
  const uint64_t desc0 = wgmma_desc(smem_u32(wsm), 128, 256);
  const int gq = lane >> 2, t4 = lane & 3;

  int q = 0;  // fills of the items before this one
  for (long long it = blockIdx.x; it < w.items; it += gridDim.x) {
    Item item;
    item.decode(it, w);
    const int s0 = item.strip * TM;
    const int rlim = g.S - s0;  // staged rows at or past it read as zero

    for (int p = 0; p < item.len; ++p) {
      const int f0 = item.first(p, w);
      uint32_t sa[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int qq = q + f0 + (i < w.span ? i : 0);
        const int slot = qq % g.stages;
        if (i < w.span) mbar_wait(full + slot, (uint32_t)(qq / g.stages) & 1);
        sa[i] = ring_u + slot * slot_elems * 2;
      }
      // the A fragments of the next k16 step (steps 0, 1, 2, ... in turn):
      // tap ft = (dz, dy), channels fci .. + 16, advanced a step at a time
      // (no division in the loop)
      int ft = 0, fci = 0;
      auto load_a = [&](uint32_t (&r)[MT][4]) {
        const int dz = ft / 3, dy = ft - 3 * dz;
        const uint32_t base = PRE ? sa[0] + (dz * g.C + fci) * 2
                                  : (dz == 0 ? sa[0] : dz == 1 ? sa[1] : sa[2]) + fci * 2;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int row = trow[mt] + (lane & 15) + dy * g.WS;
          ldmatrix_x4(r[mt], row < rlim ? base + row * rowb + colb : zero_u);
#pragma unroll
          for (int i = 0; i < 4; ++i) fence_reg(r[mt][i]);
        }
        fci += 16;  // C is a multiple of 16
        if (fci == g.C) {
          fci = 0;
          ++ft;
        }
      };

      float acc[MT][NJ][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mt][j][e] = 0.f;
            fence_reg(acc[mt][j][e]);
          }
      // step s uses register set s % 3, loaded two steps ahead; a step
      // waits for the one before it, whose set it reloads
      uint32_t fa[3][MT][4];
      load_a(fa[0]);
      load_a(fa[1]);  // ks >= 9
      for (int s0k = 0; s0k < ks; s0k += 3) {
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          const int s = s0k + u;  // ks is a multiple of 9
          wgmma_fence();
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            wgmma_rs<NZ>(acc[mt], fa[u][mt], desc0 + (uint64_t)((s * NJ * 256) >> 4));
          wgmma_commit();
          wgmma_wait<1>();
          if (s + 2 < ks) load_a(fa[(u + 2) % 3]);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) fence_reg(acc[mt][j][e]);
      __syncwarp();
      if (lane == 0) {  // this warp is done with the fills no later plane reads
        const int f1 = item.first(p + 1, w);
        for (int f = f0; f < f1; ++f) mbar_arrive(empty + (q + f) % g.stages);
      }

      // out[s] = Z[s, co] + Z[s + 1, 16 + co] + Z[s + 2, 32 + co]: this lane
      // holds rows gq and gq + 8 of each m16 tile, columns 8 j + 2 t4 + 0..1
      // of each n8 tile; row gq + dx sits in the lanes of row (gq + dx) & 7,
      // half (gq + dx) >> 3.  Rows 14 and 15 of a tile are not stored.
      const int src1 = (((gq + 1) & 7) << 2) | t4, src2 = (((gq + 2) & 7) << 2) | t4;
      bf16* oplane = out + ((size_t)item.n * g.D + item.z0 + p) * g.SV * COUT;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float v[2][2][2];  // [half][j][e]
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p1a = __shfl_sync(0xffffffffu, acc[mt][j + 2][e], src1);
            const float p1b = __shfl_sync(0xffffffffu, acc[mt][j + 2][2 + e], src1);
            const float p2a = __shfl_sync(0xffffffffu, acc[mt][j + 4][e], src2);
            const float p2b = __shfl_sync(0xffffffffu, acc[mt][j + 4][2 + e], src2);
            v[0][j][e] = acc[mt][j][e] + (gq == 7 ? p1b : p1a) + (gq >= 6 ? p2b : p2a);
            v[1][j][e] = acc[mt][j][2 + e] + p1b + p2b;
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = gq + 8 * h;
          const int s = s0 + trow[mt] + r;
          if (r >= TILE_OUT || s >= g.SV) continue;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            *reinterpret_cast<__nv_bfloat162*>(oplane + (size_t)s * COUT + 8 * j + 2 * t4) =
                __floats2bfloat162_rn(v[h][j][0], v[h][j][1]);
        }
      }
    }
    q += item.nf;
  }
}

using Kernel = void (*)(const bf16*, const bf16*, bf16*, Geo, Walk);

}  // namespace

// pre: x is xcat (n, d, s, 3c); else x is xflat (n, d + 2, s, c).  w2
// (3c, 144) and out (n, d, sv, 16) bf16; all contiguous and 16-byte
// aligned; c a multiple of 16, sv + 2 ws <= s.  The z chunk and the
// persistent grid follow from the occupancy.  Returns cudaGetLastError()
// after the launch.
extern "C" int tpuseg_flat_conv(const void* x, const void* w2, void* out,
                                int n, int d, int s, int sv, int c, int ws,
                                int pre, void* stream) {
  if (n < 1 || d < 1 || c < 16 || c % 16 || ws < 1 || sv < 1 || sv + 2 * ws > s ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w2) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(pre != 0, c, s, ws);
  if (p.stages < (pre ? 2 : 4)) return static_cast<int>(cudaErrorInvalidValue);
  const Geo g{d, s, sv, c, ws, p.rowe, p.slot_rows, p.stages};
  const Kernel fn = pre ? flat_conv_kernel<true> : flat_conv_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const Walk w = make_walk(n, d, (sv + TM - 1) / TM, pre ? 1 : 3, 1, resident);
  const long long grid = resident < w.items ? resident : w.items;
  fn<<<(unsigned)grid, THREADS, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w2), static_cast<bf16*>(out), g,
      w);
  return static_cast<int>(cudaGetLastError());
}
