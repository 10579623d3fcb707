// Structured space-to-depth packed k3 conv on the tensor cores: the SAME
// coarse 3x3x3 conv of one or two delta-major packed NDHWC tensors with a
// 1/P-dense kernel (P = 8 fully packed, 4 on a grid packed along H and W
// only), paying only the structural multiply-adds, fp32
// accumulation, optional bias and ReLU.  bf16 runs wgmma m64n128k16 with
// both operands in shared memory; f32 runs wgmma m64n128k8 in tf32 three
// times per step (3xTF32: a_hi b_hi + a_hi b_lo + a_lo b_hi, each half
// rounded with cvt.rna.tf32), which keeps about fp32's accuracy.  The
// tensor cores truncate each sum into their fp32 accumulator, so f32 sums
// one stage (4 k8 steps) on them, its first wgmma overwriting the
// accumulator, and adds the stages with rounded fp32 adds into a second
// set of registers (one m64 tile a warpgroup, for the registers): one
// accumulator over K = 64C drifts toward zero by a unit in the last place
// a step, ~7e-6 of the output's scale at C = 16.
//
// Replaces the Pallas kernel tpuseg/kernels/packed_conv.py
// `packed_conv3d_structured`.  Python wrapper, packing and design note:
// tpuseg_torch/kernels/packed_conv.py.
//
// An implicit GEMM: out[p, o] = sum_k A[p, k] * Wk[k, o] over the output
// positions p (n, z, y, x flattened) and the structural rows k.  Row k is
// one valid (tap, input channel) pair of one part, named by `rows[k]`, so
// A[p, k] is the part at p shifted by the tap (zero outside the volume).
// A tap is a -1/0/+1 shift per axis of the coarse grid whether that axis is
// packed or fine; which deltas it reads is the table's, so one kernel serves
// every packing: K = (4 per packed axis x 3 per fine axis) C per part.
// A block owns BM = 128 MT consecutive positions (two warpgroups of MT m64
// tiles each) and one 128-channel slice of 8F.  Per stage of 128 bytes of K it
// gathers the A tile with cp.async (each copy names its rows' tap and
// channel run, so the tap's shift is an address), and copies the weight
// tile, pre-laid by the wrapper in wgmma's K-major core-matrix layout
// ([n8][k 16-byte chunk][8 rows][16 bytes]: LBO 128, SBO 1024), as one
// contiguous block.  The A tile has the same layout.  A ring of STAGES
// slots keeps DIST stages in flight ahead of the wgmmas.
//
// Why a gather from L2 and not halo'd planes staged once (K2's design):
// at 8C = 128 one staged voxel is 256 bytes in bf16 and 512 in f32, so
// the three halo'd planes of even an 8 x 16 tile take 138 KB (bf16) or
// 276 KB (f32, over the 227 KB a block has), and the structural weight,
// 256 KB to 1 MB in bf16 and twice that as the f32 route's hi/lo pair,
// has to stream beside them.  The gather reads each input value once per
// (tap, delta) that uses it, about 8 times, from L2 (the inputs are 13-103
// MB); the weight tile of each stage is reused over BM positions.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace tpuseg;

constexpr int THREADS = 256;  // two warpgroups
constexpr int BN = 128;       // output channels per block
constexpr int BKB = 128;      // bytes of K per stage and row
// m64 tiles a warpgroup and ring slots: bf16 one tile in 6 slots, the
// faster of the H100 trials at the served shapes (against two in 4); f32
// one tile in 4 slots, as the stages' fp32 sum doubles the accumulator
// registers (two tiles in 3 slots were faster with one accumulator)
constexpr int MT_BF16 = 1;
constexpr int MT_TF32 = 1;
constexpr int STAGES_BF16 = 6;
constexpr int STAGES_TF32 = 4;
constexpr int MAX_C8 = 1 << 16;

// valid (tap, delta) pairs per fine channel on a grid with p deltas:
// 4 per packed axis, 3 per fine one (p = 8: 64, p = 4: 48, p = 2: 36, 1: 27)
int k_per_channel(int p) {
  switch (p) {
    case 8: return 64;
    case 4: return 48;
    case 2: return 36;
    case 1: return 27;
    default: return 0;
  }
}

template <bool TF32>
struct Cfg {
  static constexpr int ES = TF32 ? 4 : 2;             // bytes per element
  static constexpr int MT = TF32 ? MT_TF32 : MT_BF16;  // m64 tiles a warpgroup
  static constexpr int BM = 128 * MT;                 // positions per block
  static constexpr int STAGES = TF32 ? STAGES_TF32 : STAGES_BF16;
  // stages in flight ahead: bf16 leaves one stage's wgmmas in flight past
  // its wait, so the slot two back is the one free; 3xTF32 waits for its
  // own at the end of each stage, so the slot one back is
  static constexpr int DIST = TF32 ? STAGES - 1 : STAGES - 2;
  static constexpr int BK = BKB / ES;                 // K per stage
  static constexpr int A_BYTES = BM * BKB;
  static constexpr int B_BYTES = BN * BKB * (TF32 ? 2 : 1);  // tf32: hi, lo
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + BM * 16;  // + positions
};

struct Args {
  const unsigned char* xa;
  const unsigned char* xb;
  int c8a, c8b;
  const int* rows;
  const unsigned char* wt;
  const float* bias;
  void* y;
  int D, H, W;
  long long npos;
  int k_tiles, f8, relu, vec_log2;
};

#define TPUSEG_ACC64(d)                                                      \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),                \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),            \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),            \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),            \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),            \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),            \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),            \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),            \
      "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),            \
      "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),            \
      "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),        \
      "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),        \
      "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),        \
      "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),        \
      "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),        \
      "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])

#define TPUSEG_D64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d (m64 x n128 fp32) += A (m64 x k16 bf16, K-major in shared memory) * B
// (k16 x n128, K-major in shared memory)
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[16][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TPUSEG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TPUSEG_ACC64(d)
      : "l"(da), "l"(db), "r"(1));
}

// d (m64 x n128 fp32) = scale_d d + a (this warp's 16 rows of the m64 x
// k8 tf32 A tile: a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4), a3 (g
// + 8, t + 4) with g = lane / 4, t = lane % 4) * B (k8 x n128 tf32,
// K-major in shared memory); scale_d 0 or 1
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " TPUSEG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : TPUSEG_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// generic-proxy writes to shared memory (cp.async, stores) made visible to
// the async proxy that wgmma reads operands through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `vec` bytes from global to shared memory, zero-filled where !ok:
// cp.async for 16, 8 and 4 bytes, a plain 2-byte load and store otherwise
__device__ __forceinline__ void copy_async(unsigned char* dst, const unsigned char* src,
                                           bool ok, int vec) {
  switch (vec) {
    case 16: cp_async_zfill<16>(dst, src, ok); break;
    case 8: cp_async_zfill<8>(dst, src, ok); break;
    case 4: cp_async_zfill<4>(dst, src, ok); break;
    default:
      *reinterpret_cast<uint16_t*>(dst) =
          ok ? *reinterpret_cast<const uint16_t*>(src) : uint16_t(0);
  }
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <bool TF32, bool FAST>
__global__ void __launch_bounds__(THREADS, 1) packed_conv_tc_kernel(const Args a) {
  using C = Cfg<TF32>;
  using T = typename std::conditional<TF32, float, __nv_bfloat16>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  int4* pos = reinterpret_cast<int4*>(smem + C::STAGES * C::STAGE_BYTES);
  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * C::BM;
  const int nt = blockIdx.y;

  // each position's (flat voxel, z, y, x); z = -4 past the end, so that
  // every tap falls outside the volume
  for (int m = tid; m < C::BM; m += THREADS) {
    const long long p = p0 + m;
    int4 q = make_int4(0, -4, 0, 0);
    if (p < a.npos) {
      const long long t = p / a.W;
      q.w = (int)(p - t * a.W);
      const long long t2 = t / a.H;
      q.z = (int)(t - t2 * a.H);
      q.y = (int)(t2 % a.D);
      q.x = (int)p;
    }
    pos[m] = q;
  }
  __syncthreads();

  const unsigned char* wt = a.wt + (size_t)nt * a.k_tiles * C::B_BYTES;
  const int ulog = 7 - a.vec_log2;  // copies per row and stage, log2
  const int vec = 1 << a.vec_log2;
  const int HW = a.H * a.W;

  auto load_stage = [&](int kt, int slot) {
    unsigned char* As = smem + slot * C::STAGE_BYTES;
    unsigned char* Bs = As + C::A_BYTES;
    const unsigned char* src = wt + (size_t)kt * C::B_BYTES;
#pragma unroll
    for (int i = tid; i < C::B_BYTES / 16; i += THREADS)
      cp_async_zfill<16>(Bs + i * 16, src + i * 16, true);
    const int k0 = kt * C::BK;
    if constexpr (FAST) {
      // 16-byte copies: this thread's bytes kbyte.. of rows
      // 8 (tid / 64 + 4 j) + tid % 8, so 8 lanes fill one 128-byte core
      // matrix and the row's tap and channel are read once per stage
      const int kbyte = ((tid >> 3) & 7) * 16;
      const int code = __ldg(a.rows + k0 + kbyte / C::ES);
      const int tap = (code >> 16) & 0xff;
      const int dz = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dx = tap % 3 - 1;
      const bool second = (code >> 24) != 0;
      const unsigned char* base = second ? a.xb : a.xa;
      const long long c8 = second ? a.c8b : a.c8a;
      const int shift = dz * HW + dy * a.W + dx;
      const int ch = code & 0xffff;
      unsigned char* dst = As + (kbyte >> 4) * 128 + (tid & 7) * 16;
#pragma unroll
      for (int j = 0; j < C::BM / 32; ++j) {
        const int mg = (tid >> 6) + 4 * j;
        const int4 q = pos[mg * 8 + (tid & 7)];
        const int zi = q.y + dz, yi = q.z + dy, xi = q.w + dx;
        const bool ok = zi >= 0 && zi < a.D && yi >= 0 && yi < a.H && xi >= 0 && xi < a.W;
        const unsigned char* g = ok ? base + ((long long)(q.x + shift) * c8 + ch) * C::ES : base;
        cp_async_zfill<16>(dst + mg * 1024, g, ok);
      }
    } else {
      // copy i: row m = 8 (i >> (3 + ulog)) + (i & 7), bytes kbyte.. of the
      // stage's K, so 8 lanes fill one 128-byte core matrix
      const int total = C::BM << ulog;
      for (int i = tid; i < total; i += THREADS) {
        const int m = ((i >> (3 + ulog)) << 3) | (i & 7);
        const int kbyte = ((i >> 3) & ((1 << ulog) - 1)) << a.vec_log2;
        const int code = __ldg(a.rows + k0 + kbyte / C::ES);
        const int tap = (code >> 16) & 0xff;
        const int dz = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dx = tap % 3 - 1;
        const bool second = (code >> 24) != 0;
        const int4 q = pos[m];
        const int zi = q.y + dz, yi = q.z + dy, xi = q.w + dx;
        const bool ok = zi >= 0 && zi < a.D && yi >= 0 && yi < a.H && xi >= 0 && xi < a.W;
        const unsigned char* base = second ? a.xb : a.xa;
        const long long c8 = second ? a.c8b : a.c8a;
        const long long vox = (long long)q.x + dz * HW + dy * a.W + dx;
        const unsigned char* g = ok ? base + (vox * c8 + (code & 0xffff)) * C::ES : base;
        copy_async(As + (m >> 3) * 1024 + (kbyte >> 4) * 128 + (m & 7) * 16 + (kbyte & 15), g,
                   ok, vec);
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wq = warp & 3;
  // f32: `acc` a stage's sums, `sum` the stages'
  float acc[C::MT][16][4], sum[C::MT][16][4];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][j][q] = sum[mt][j][q] = 0.f;

  const int KT = a.k_tiles;
#pragma unroll 1
  for (int s = 0; s < C::DIST; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < KT; ++kt) {
    // stage kt has landed for every thread; every warpgroup is done with
    // the slot the next load overwrites (stage kt - 2's in bf16, whose
    // wgmmas may leave one commit group in flight; stage kt - 1's in f32)
    cp_async_wait<C::DIST - 1>();
    fence_proxy_async();
    __syncthreads();
    if (kt + C::DIST < KT) load_stage(kt + C::DIST, (kt + C::DIST) % C::STAGES);
    cp_async_commit();
    const int slot = kt % C::STAGES;
    const uint32_t a_s = smem_u32(smem + slot * C::STAGE_BYTES);
    const uint32_t b_s = a_s + C::A_BYTES;
    if constexpr (!TF32) {
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < C::BK / 16; ++s) {
        const uint64_t db = wgmma_desc(b_s + s * 256, 128, 1024);
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt)
          wgmma_bf16_ss(acc[mt],
                        wgmma_desc(a_s + (wg * C::MT + mt) * 8 * 1024 + s * 256, 128, 1024),
                        db);
      }
      wgmma_commit();
      wgmma_wait<1>();
    } else {
      // this warp's rows of m64 tile mt: 64 (wg MT + mt) + 16 wq + lane / 4
      // (+ 8), m8 groups 8 (wg MT + mt) + 2 wq (+ 1); k8 step s is 16-byte
      // chunks 2 s, 2 s + 1.  Per k8 step: the A fragments split into
      // tf32 hi / lo in one of two register sets, three wgmmas per m64
      // tile (the stage's first overwriting `acc`), one commit group; the
      // wait keeps one step in flight, so the set written next is free.
      const unsigned char* ar = smem + slot * C::STAGE_BYTES +
                                (8 * wg * C::MT + 2 * wq) * 1024 + (lane >> 2) * 16 +
                                (lane & 3) * 4;
      uint32_t hi[2][C::MT][4], lo[2][C::MT][4];
#pragma unroll
      for (int s = 0; s < C::BK / 8; ++s) {
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float v = *reinterpret_cast<const float*>(
                ar + (8 * mt + (r & 1)) * 1024 + (2 * s + (r >> 1)) * 128);
            hi[s & 1][mt][r] = tf32_rna(v);
            lo[s & 1][mt][r] = tf32_rna(v - __uint_as_float(hi[s & 1][mt][r]));
          }
        wgmma_fence();
        const uint64_t dh = wgmma_desc(b_s + s * 256, 128, 1024);
        const uint64_t dl = wgmma_desc(b_s + BN * BKB + s * 256, 128, 1024);
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
          wgmma_tf32_rs(acc[mt], lo[s & 1][mt], dh, s > 0);
          wgmma_tf32_rs(acc[mt], hi[s & 1][mt], dl, 1);
          wgmma_tf32_rs(acc[mt], hi[s & 1][mt], dh, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();
      }
      wgmma_wait<0>();  // this stage's slot is free for the next load
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) sum[mt][j][q] += acc[mt][j][q];
    }
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  // rows lane / 4 and lane / 4 + 8 of each warp's 16; columns
  // 2 (lane % 4) + 0..1 of each n8 tile
  T* y = static_cast<T*>(a.y);
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long p = p0 + (wg * C::MT + mt) * 64 + 16 * wq + (lane >> 2) + 8 * half;
      if (p >= a.npos) continue;
      T* out = y + p * a.f8;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int o = nt * BN + 8 * j + 2 * (lane & 3);
        if (o >= a.f8) continue;
        float v0 = TF32 ? sum[mt][j][2 * half] : acc[mt][j][2 * half];
        float v1 = TF32 ? sum[mt][j][2 * half + 1] : acc[mt][j][2 * half + 1];
        if (a.bias != nullptr) {
          v0 += __ldg(a.bias + o);
          v1 += __ldg(a.bias + o + 1);
        }
        if (a.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        store_pair(out + o, v0, v1);
      }
    }
  }
}

template <bool TF32>
int launch(const void* xa, const void* xb, int c8a, int c8b, int p, const void* rows,
           const void* wt, const void* bias, void* y, int n, int d, int h, int w, int k,
           int n_pad, int f8, int relu, void* stream) {
  using C = Cfg<TF32>;
  const long long npos = (long long)n * d * h * w;
  const long long blocks = (npos + C::BM - 1) / C::BM;
  if (k_per_channel(p) == 0 || n < 1 || d < 1 || h < 1 || w < 1 || c8a < p ||
      c8a % p != 0 || c8a > MAX_C8 || c8b < 0 || c8b % p != 0 || c8b > MAX_C8 ||
      (c8b > 0) != (xb != nullptr) || k != k_per_channel(p) * ((c8a + c8b) / p) ||
      k % C::BK != 0 || n_pad < BN || n_pad % BN != 0 ||
      n_pad / BN > 65535 || f8 < 8 || f8 % 8 != 0 || f8 > n_pad || npos >= (1LL << 31) ||
      (long long)d * h * w >= (1LL << 31) || blocks > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(wt) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // widest copy that every part's channel runs (multiples of C = c8 / p
  // channels) and base pointers allow
  int vec = 16;
  auto fits = [&](const void* ptr, int c8) {
    return c8 == 0 ||
           ((c8 / p) * C::ES % vec == 0 && reinterpret_cast<uintptr_t>(ptr) % vec == 0);
  };
  while (vec > C::ES && !(fits(xa, c8a) && fits(xb, c8b))) vec >>= 1;
  if (!(fits(xa, c8a) && fits(xb, c8b))) return static_cast<int>(cudaErrorInvalidValue);
  int vec_log2 = 0;
  while ((1 << vec_log2) < vec) ++vec_log2;

  Args a;
  a.xa = static_cast<const unsigned char*>(xa);
  a.xb = static_cast<const unsigned char*>(xb);
  a.c8a = c8a;
  a.c8b = c8b;
  a.rows = static_cast<const int*>(rows);
  a.wt = static_cast<const unsigned char*>(wt);
  a.bias = static_cast<const float*>(bias);
  a.y = y;
  a.D = d;
  a.H = h;
  a.W = w;
  a.npos = npos;
  a.k_tiles = k / C::BK;
  a.f8 = f8;
  a.relu = relu;
  a.vec_log2 = vec_log2;
  const auto fn = vec == 16 ? packed_conv_tc_kernel<TF32, true> : packed_conv_tc_kernel<TF32, false>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<dim3((unsigned)blocks, n_pad / BN), THREADS, C::SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xa (n, d, h, w, c8a) and, when c8b > 0, xb (n, d, h, w, c8b) contiguous
// bf16 on a grid with p deltas a channel group (8 fully packed, 4 packed
// along H and W; c8 multiples of p); rows (k,) int32 with k = 64 (c8a +
// c8b) / 8 fully packed, 48 (c8a + c8b) / 4 on the (H, W) grid; wt the
// bf16 weight in the layout of kernels/packed_conv.py `pack_tc`, 16-byte
// aligned; bias (f8,) fp32 or null; y (n, d, h, w, f8) bf16, f8 a multiple
// of 8 and at most n_pad (a multiple of 128).  Returns cudaGetLastError()
// after the launch.
extern "C" int tpuseg_packed_conv3d_bf16(const void* xa, const void* xb, int c8a, int c8b,
                                         int p, const void* rows, const void* wt,
                                         const void* bias, void* y, int n, int d, int h,
                                         int w, int k, int n_pad, int f8, int relu,
                                         void* stream) {
  return launch<false>(xa, xb, c8a, c8b, p, rows, wt, bias, y, n, d, h, w, k, n_pad, f8,
                       relu, stream);
}

// The same for float32 parts and output; wt the tf32 hi/lo weight pair of
// `pack_tc` (fp32 storage).
extern "C" int tpuseg_packed_conv3d_tf32x3(const void* xa, const void* xb, int c8a, int c8b,
                                           int p, const void* rows, const void* wt,
                                           const void* bias, void* y, int n, int d, int h,
                                           int w, int k, int n_pad, int f8, int relu,
                                           void* stream) {
  return launch<true>(xa, xb, c8a, c8b, p, rows, wt, bias, y, n, d, h, w, k, n_pad, f8,
                      relu, stream);
}
