// Slab-layout conv GEMM probes (K4, K5): per output plane d, Y = Wm @ A in
// bf16 on the tensor cores with fp32 accumulation, A built from the z
// slabs d .. d+2 of a (N, D+2, C, LFULL) input with the dy taps as lane
// offsets dy*WP, then an epilogue that keeps Y's first COUT rows or adds
// the three dx row groups with lane shifts of 0, 1, 2 (mod LV).
//
// Replaces the Pallas probes benchmarks/kmicro_r2.py `make`/`run` (K4) and
// benchmarks/kmicro2_r2.py `variant`/`run` (K5).  Python wrapper, plan and
// design note: tpuseg_torch/kernels/slab_conv.py.
//
// A persistent walk (csrc/probe_walk.cuh): a block owns a strip of BN =
// 128 MT lanes of one sample and walks its planes d along a z chunk.  One
// warp of a producer warpgroup (whose registers setmaxnreg hands to the
// two consumer warpgroups) fills a ring of slab slots with cp.async.bulk,
// one copy per channel row (each row of the window is contiguous in xf),
// on full / empty mbarriers, as far ahead of the compute as the ring
// allows; a slot holds C x RS lanes of one slab z: the window [l0, l0 + BN
// + 2 WP) (BN for the kinds without dy taps) and, for `full`'s last strip,
// the first 8 lanes of the three dy rows (the wrap mod LV).  So each slab
// is staged once per strip.  The weight is resident, copied once per
// block, in wgmma's K-major layout without swizzle ([k16 step][n8][k
// half][8 n][8 k]).
//
// The GEMM is transposed: Y^T (lanes x M) = A^T (lanes x Kp) Wm^T.  Lanes
// are wgmma's M (two consumer warpgroups of MT m64 tiles), N is the probe's
// M (48, or 144 with MT = 2), K is Kp in k16 steps.  The A fragment of a
// k16 step is an ldmatrix.trans from the slot of its dz tap at its dy lane
// offset (a slot row is [ci][lane]: M-major), rows past the built K zero;
// one wgmma m64nNk16 per m64 tile, B from the resident weight.  `full`
// computes BN lanes and outputs BO = BN - 8 (strips overlap by 8 lanes):
// out[l] = y0[l] + y1[l+1] + y2[l+2] by warp shuffles inside an m16 tile
// and, for its last two rows, the next tile's first two rows through
// shared memory; the last strip's 8-lane group at LV reads the wrap lanes.
// The bf16 tile is staged transposed, [co][lane], and written with 16-byte
// stores.
//
// What bounds it on the card: memory at the probe shapes (kernels/
// slab_conv.py); the probe's own GEMM (all M rows, all Kp) on wgmma
// m64n48k16 (m64n144k16 for M = 144) is what it reaches.
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
constexpr int CONSUMERS = 8;                    // consumer warps: two warpgroups
constexpr int THREADS = 32 * (CONSUMERS + 4);   // and a producer warpgroup
constexpr int PRODUCER_REGS = 40;               // registers per thread after setmaxnreg:
constexpr int CONSUMER_REGS = 232;              // 128 x 40 + 256 x 232 <= 65536
constexpr int WRAP = 24;                        // slot lanes of `full`'s wrap: 8 per dy
constexpr int OPAD = 8;                         // bf16 of padding per staged output row
constexpr int BAR_BYTES = 128;                  // full[MAX_STAGES], empty[MAX_STAGES]
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;              // dynamic shared memory of one block

// A builds and epilogues (tpuseg_torch/kernels/slab_conv.py KINDS)
constexpr int kDotOnly = 0;  // A = the block's first slab, 9 times; y[:COUT]
constexpr int kSlab = 1;     // A = 3 dz x 3 dy slab slices; y[:COUT]
constexpr int kSlabDy0 = 2;  // A = 3 dz slabs at dy = 0; y[:COUT]
constexpr int kFull = 3;     // kSlab's A; y0 + y1 shifted 1 + y2 shifted 2

struct Geo {
  int D, C, lfull, lv, wp, kp, krows;
  int bo;      // output lanes of a strip
  int win;     // lanes of a slab row staged from l0 (clipped at lfull)
  int rs;      // slot row stride, lanes
  int stages;  // ring slots
};

// The launch plan (kernels/slab_conv.py `plan` mirrors it)
struct Plan {
  int mt, bn, bo, win, rs, stages;
  size_t smem;
};

Plan make_plan(int mode, int m, int kp, int c, int wp) {
  Plan p;
  p.mt = m == 144 ? 2 : 4;
  p.bn = 128 * p.mt;
  p.bo = p.bn - (mode == kFull ? 8 : 0);
  p.win = p.bn + (mode == kSlab || mode == kFull ? 2 * wp : 0);
  p.rs = p.win + (mode == kFull ? WRAP : 0);
  if ((p.rs / 8) % 2 == 0) p.rs += 8;  // an odd number of 16-byte units: the
                                       // 8 rows of an ldmatrix in 8 bank groups
  const long long fixed = BAR_BYTES + (long long)kp * m * 2 +
                          (long long)COUT * (p.bn + OPAD) * 2 +
                          (mode == kFull ? 8LL * p.mt * 96 * 4 : 0);
  const long long slot = (long long)c * p.rs * 2;
  const long long fit = (SMEM_LIMIT - fixed) / slot;
  p.stages = (int)(fit < MAX_STAGES ? fit : MAX_STAGES);
  p.smem = (size_t)(fixed + p.stages * slot);
  return p;
}

template <int N, int MT, int MODE>
__global__ void __launch_bounds__(THREADS, 1) slab_conv_kernel(
    const bf16* __restrict__ xf, const bf16* __restrict__ wm, bf16* __restrict__ out,
    Geo g, Walk w) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NJ = N / 8;        // n8 tiles
  constexpr int BN = 128 * MT;     // lanes computed per strip
  constexpr int OBS = BN + OPAD;   // staged output row stride
  constexpr int TILES = 8 * MT;    // m16 tiles of a strip
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  bf16* wsm = reinterpret_cast<bf16*>(smem + BAR_BYTES);  // [ks][NJ][2][8][8]
  bf16* ring = wsm + g.kp * N;                            // [stages][C][rs]
  bf16* ob = ring + (size_t)g.stages * g.C * g.rs;        // [COUT][OBS]
  float* xb = reinterpret_cast<float*>(ob + COUT * OBS);  // full: [TILES][3][32]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slot_elems = g.C * g.rs;
  const int ks = g.kp / 16;

  for (int i = tid; i < N * ks * 2; i += THREADS) {  // 16-byte chunks (m, 8 k)
    const int m = i / (ks * 2), r = i - m * (ks * 2);  // r = 2 step + k half
    *reinterpret_cast<uint4*>(wsm + (((r >> 1) * NJ + (m >> 3)) * 2 + (r & 1)) * 64 +
                              (m & 7) * 8) =
        __ldg(reinterpret_cast<const uint4*>(wm + (size_t)m * g.kp + r * 8));
  }
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
      const int l0 = item.strip * g.bo;
      const bool wrap = MODE == kFull && l0 + g.bo >= g.lv;  // the last strip
      const int win = min(g.win, g.lfull - l0);
      const uint32_t bytes = (uint32_t)g.C * (win * 2 + (wrap ? 3 * 16 : 0));
      for (int f = 0; f < item.nf; ++f, ++q) {
        const int slot = q % g.stages;
        if (lane == 0) {
          if (q >= g.stages) mbar_wait(empty + slot, (uint32_t)(q / g.stages + 1) & 1);
          mbar_expect_tx(full + slot, bytes);
        }
        __syncwarp();
        const bf16* slab = xf + ((size_t)item.n * (g.D + 2) + item.fill_z(f, w)) * g.C * g.lfull;
        bf16* dst = ring + (size_t)slot * slot_elems;
        for (int ci = lane; ci < g.C; ci += 32)
          bulk_copy(dst + ci * g.rs, slab + (size_t)ci * g.lfull + l0, win * 2, full + slot);
        if (wrap)
          for (int i = lane; i < 3 * g.C; i += 32) {
            const int ci = i / 3, dy = i - 3 * ci;
            bulk_copy(dst + ci * g.rs + g.win + 8 * dy, slab + (size_t)ci * g.lfull + dy * g.wp,
                      16, full + slot);
          }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  // consumers: warpgroup wg, warp wq of it; m64 tile mt of the warpgroup is
  // strip lanes (wg MT + mt) 64 .. + 64, warp wq's m16 tile of it lanes
  // + 16 wq.  ldmatrix.trans lane roles: k row (lane & 7) + 8 (lane >> 4)
  // of the k16 step, lanes 8 ((lane >> 3) & 1) .. + 8 of the m16 tile
  const int wg = warp >> 2, wq = warp & 3;
  const int krl = (lane & 7) + 8 * (lane >> 4);
  const int kt0 = krl / g.C, kci0 = krl - kt0 * g.C;  // its tap and channel at step 0
  int mrow[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mrow[mt] = (wg * MT + mt) * 64 + 16 * wq + 8 * ((lane >> 3) & 1);
  const uint32_t ring_u = smem_u32(ring);
  const uint32_t rsb = g.rs * 2;
  const uint64_t desc0 = wgmma_desc(smem_u32(wsm), 128, 256);
  const int gq = lane >> 2, t4 = lane & 3;

  int q = 0;  // fills of the items before this one
  for (long long it = blockIdx.x; it < w.items; it += gridDim.x) {
    Item item;
    item.decode(it, w);
    const int l0 = item.strip * g.bo;
    // full's last strip: its 8-lane group at LV reads the wrap lanes 0 .. 7
    const int wrap_row = (MODE == kFull && l0 + g.bo >= g.lv) ? g.lv - l0 : -1;
    uint32_t off0[MT], dyb[MT];  // bytes: this lane's group at dy = 0, per dy
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const bool wr = mrow[mt] == wrap_row;
      off0[mt] = (wr ? g.win : mrow[mt]) * 2;
      dyb[mt] = wr ? 16 : g.wp * 2;
    }
    const int nstore = min(g.bo, g.lv - l0);  // output lanes of this strip

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
      // the A fragments of k16 step s, called for s = 0, 1, 2, ... in turn:
      // this lane's k row is tap kt, channel kci, advanced 16 rows a step
      // (no division in the loop).  Rows past the built K (v5's padding)
      // are zero, the wgmma runs all the same; the zeros are masks, not
      // branches: no path that writes a wgmma's registers diverges
      int kt = kt0, kci = kci0;
      auto load_a = [&](uint32_t (&r)[MT][4], int s) {
        const int k0 = 16 * s;
        const uint32_t lo = k0 < g.krows ? ~0u : 0u;      // k rows 0 .. 7 built
        const uint32_t hi = k0 + 8 < g.krows ? ~0u : 0u;  // k rows 8 .. 15 built
        int dz = 0, dy = 0;
        if (MODE == kSlabDy0) {
          dz = kt;
        } else if (MODE != kDotOnly) {
          dz = kt / 3;
          dy = kt - 3 * dz;
        }
        // past the built K, dz >= 3 reads slot 2: any address in the ring
        const uint32_t base = (dz == 0 ? sa[0] : dz == 1 ? sa[1] : sa[2]) + kci * rsb;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          ldmatrix_x4_trans(r[mt], base + off0[mt] + dy * dyb[mt]);
          r[mt][0] &= lo;
          r[mt][1] &= lo;
          r[mt][2] &= hi;
          r[mt][3] &= hi;
#pragma unroll
          for (int i = 0; i < 4; ++i) fence_reg(r[mt][i]);
        }
        kci += 16;  // C >= 8: at most two taps on
        if (kci >= g.C) {
          kci -= g.C;
          ++kt;
        }
        if (kci >= g.C) {
          kci -= g.C;
          ++kt;
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
      load_a(fa[0], 0);
      if (ks > 1) load_a(fa[1], 1);
      for (int s0 = 0; s0 < ks; s0 += 3) {
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          const int s = s0 + u;
          if (s < ks) {
            wgmma_fence();
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              wgmma_rs<N>(acc[mt], fa[u][mt], desc0 + (uint64_t)((s * NJ * 256) >> 4));
            wgmma_commit();
            wgmma_wait<1>();
            if (s + 2 < ks) load_a(fa[(u + 2) % 3], s + 2);
          }
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

      // epilogue.  This lane holds rows gq and gq + 8 of each m16 tile
      // (strip lanes), columns 8 j + 2 t4 + 0..1 of each n8 tile
      named_barrier(1, CONSUMERS * 32);  // the last plane's stores have read ob, xb
      if (MODE == kFull) {
        // each tile's first two rows of y1 and y2, for the tile before it;
        // the lanes of rows 2 .. 7 write a spare row (no divergent read of
        // the accumulators)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float* row = xb + (((wg * MT + mt) * 4 + wq) * 3 + min(gq, 2)) * 32;
#pragma unroll
          for (int j = 2; j < 6; ++j) {
            row[8 * (j - 2) + 2 * t4] = acc[mt][j][0];
            row[8 * (j - 2) + 2 * t4 + 1] = acc[mt][j][1];
          }
        }
        named_barrier(1, CONSUMERS * 32);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int tile = (wg * MT + mt) * 4 + wq;
        const int row0 = tile * 16 + gq;
        // the next tile's rows 0 and 1 (the last tile's rows 14, 15 are
        // past BO and not stored)
        const float* nx = xb + (tile + 1 < TILES ? tile + 1 : tile) * 96;
        const int src1 = (((gq + 1) & 7) << 2) | t4, src2 = (((gq + 2) & 7) << 2) | t4;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v0 = acc[mt][j][e], v1 = acc[mt][j][2 + e];
            if (MODE == kFull) {
              // out[l] = y0[l] + y1[l + 1] + y2[l + 2]: row gq + dx from the
              // lanes of row (gq + dx) & 7, half (gq + dx) >> 3; rows past 15
              // from the next tile
              const float p1a = __shfl_sync(0xffffffffu, acc[mt][j + 2][e], src1);
              const float p1b = __shfl_sync(0xffffffffu, acc[mt][j + 2][2 + e], src1);
              const float p2a = __shfl_sync(0xffffffffu, acc[mt][j + 4][e], src2);
              const float p2b = __shfl_sync(0xffffffffu, acc[mt][j + 4][2 + e], src2);
              const int c = 8 * j + 2 * t4 + e;
              const float n1 = nx[c], n2 = nx[max(gq - 6, 0) * 32 + 16 + c];
              v0 += (gq == 7 ? p1b : p1a) + (gq >= 6 ? p2b : p2a);
              v1 += (gq == 7 ? n1 : p1b) + (gq >= 6 ? n2 : p2b);
            }
            const int co = 8 * j + 2 * t4 + e;
            ob[co * OBS + row0] = __float2bfloat16(v0);
            ob[co * OBS + row0 + 8] = __float2bfloat16(v1);
          }
      }
      named_barrier(1, CONSUMERS * 32);
      bf16* orow = out + ((size_t)item.n * g.D + item.z0 + p) * COUT * g.lv + l0;
      for (int i = tid; i < COUT * (BN / 8); i += CONSUMERS * 32) {
        const int co = i / (BN / 8), c8 = (i - co * (BN / 8)) * 8;
        if (c8 < nstore)
          *reinterpret_cast<uint4*>(orow + (size_t)co * g.lv + c8) =
              *reinterpret_cast<const uint4*>(ob + co * OBS + c8);
      }
    }
    q += item.nf;
  }
}

using Kernel = void (*)(const bf16*, const bf16*, bf16*, Geo, Walk);

Kernel pick(int m, int mode) {
  if (m == 144) {
    switch (mode) {
      case kDotOnly: return slab_conv_kernel<144, 2, kDotOnly>;
      case kSlab: return slab_conv_kernel<144, 2, kSlab>;
      default: return slab_conv_kernel<144, 2, kSlabDy0>;
    }
  }
  switch (mode) {
    case kDotOnly: return slab_conv_kernel<48, 4, kDotOnly>;
    case kSlab: return slab_conv_kernel<48, 4, kSlab>;
    case kSlabDy0: return slab_conv_kernel<48, 4, kSlabDy0>;
    default: return slab_conv_kernel<48, 4, kFull>;
  }
}

}  // namespace

// xf (n, d + 2, c, lfull) and wm (m, kp) bf16 contiguous, 16-byte aligned;
// out (n, d, 16, lv) bf16.  mode: 0 dot_only, 1 slab, 2 slab at dy = 0,
// 3 full; m = 48, or 144 for modes 0-2; kp a multiple of 16 at least the
// built K (9c, or 3c for mode 2), c, lfull, lv and wp multiples of 8,
// lv + 2 wp <= lfull; mode 0 reads slab (d / bd) * bd, bd dividing d;
// fuse (planes that share a block's weight in the probe) divides d and
// does not change the walk.  The z chunk and the persistent grid follow
// from the occupancy.  Returns cudaGetLastError() after the launch.
extern "C" int tpuseg_slab_conv(const void* xf, const void* wm, void* out,
                                int n, int d, int c, int lfull, int lv, int wp,
                                int m, int kp, int mode, int bd, int fuse,
                                void* stream) {
  const int krows = (mode == kSlabDy0 ? 3 : 9) * c;
  if (n < 1 || d < 1 || c < 8 || c % 8 || lv < 8 || lv % 8 || wp % 8 ||
      lfull % 8 || lv + 2 * wp > lfull || kp % 16 || kp < krows ||
      mode < kDotOnly || mode > kFull || (m != 48 && (m != 144 || mode == kFull)) ||
      fuse < 1 || d % fuse || bd < 1 || (mode == kDotOnly && d % bd) ||
      reinterpret_cast<uintptr_t>(xf) % 16 || reinterpret_cast<uintptr_t>(wm) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(mode, m, kp, c, wp);
  if (p.stages < (mode == kDotOnly ? 2 : 4)) return static_cast<int>(cudaErrorInvalidValue);
  const Geo g{d, c, lfull, lv, wp, kp, krows, p.bo, p.win, p.rs, p.stages};
  const Kernel fn = pick(m, mode);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const int nstrips = (lv + p.bo - 1) / p.bo;
  const Walk w = make_walk(n, d, nstrips, mode == kDotOnly ? 1 : 3, mode == kDotOnly ? bd : 1,
                           resident);
  const long long grid = resident < w.items ? resident : w.items;
  fn<<<(unsigned)grid, THREADS, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xf), static_cast<const bf16*>(wm), static_cast<bf16*>(out), g,
      w);
  return static_cast<int>(cudaGetLastError());
}
