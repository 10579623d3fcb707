// W8A8 int8 convolution for Hopper, the host side: the plan's checks, the
// input's TMA tensor maps and the launch (the kernels and their design:
// csrc/conv_int8.cuh).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "conv_int8.cuh"

namespace {

using namespace tpuseg::int8conv;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, found through the runtime
// (no -lcuda at link time)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
        cudaSuccess)
      return nullptr;
#endif
    if (found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a 2D (channel byte, voxel) map of one int8 part: boxes of `box` voxels x
// `cs` bytes, swizzled by their width
bool make_map(CUtensorMap* map, const void* x, int cin, long long voxels, int cs, int box) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cin, (cuuint64_t)voxels};
  const cuuint64_t strides[1] = {(cuuint64_t)cin};
  const cuuint32_t boxes[2] = {(cuuint32_t)cs, (cuuint32_t)box};
  const cuuint32_t elems[2] = {1, 1};
  CUtensorMapSwizzle swz = cs == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                           : cs == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : cs == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                      : CU_TENSOR_MAP_SWIZZLE_NONE;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(x), dims, strides,
                boxes, elems, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return n;
}

// the kernels that issue a chunk's wgmmas under a condition, or, where
// every weight chunk is kMaxChunk k32 steps, those that issue them
// unconditionally
int launch_out(const Params& p, const CUtensorMap& m0, const CUtensorMap& m1, int bn, int smem,
               int grid, bool structured, int out_dtype, cudaStream_t s) {
  if (p.chunk_steps == kMaxChunk && p.k_steps % kMaxChunk == 0)
    return launch_full(p, m0, m1, bn, smem, grid, structured, out_dtype, s);
  switch (out_dtype) {
    case 0: return launch_bn<float, false>(p, m0, m1, bn, smem, grid, structured, s);
    case 1: return launch_bn<__nv_bfloat16, false>(p, m0, m1, bn, smem, grid, structured, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x0 (and x1 when the plan has two parts) int8 NDHWC of the plan's n, d, h,
// w with cin0 (cin1) channels, 16-byte aligned; table the K-row table
// (int4 rows, kernels/conv_int8.py `_table`); wp the packed weight
// (n_tiles, k_steps, bn / 8, 2, 8, 16) int8; scale (cout,) fp32; bias
// (cout,) fp32 or null (bias_mode 0); y (n, od, oh, ow, cout) of out_dtype
// (0 fp32, 1 bf16); geo the plan (conv_int8.cuh `Geo`).  Returns
// cudaGetLastError() after the launch.
extern "C" int tpuseg_conv_int8(const void* x0, const void* x1, const void* table,
                                const void* wp, const void* scale, const void* bias, void* y,
                                const long long* geo, int out_dtype, void* stream) {
  Params p{};
  p.n = (int)geo[G_N]; p.d = (int)geo[G_D]; p.h = (int)geo[G_H]; p.w = (int)geo[G_W];
  p.od = (int)geo[G_OD]; p.oh = (int)geo[G_OH]; p.ow = (int)geo[G_OW];
  p.sd = (int)geo[G_SD]; p.sh = (int)geo[G_SH]; p.sw = (int)geo[G_SW];
  p.pd = (int)geo[G_PD]; p.ph = (int)geo[G_PH]; p.pw = (int)geo[G_PW];
  const long long m_total = (long long)p.n * p.od * p.oh * p.ow;
  p.m_total = (int)m_total;
  p.hw = p.h * p.w;
  p.group = (int)geo[G_GROUP]; p.tpg = (int)geo[G_TPG]; p.tiles_m = (int)geo[G_TILES_M];
  p.n_tiles = (int)geo[G_N_TILES]; p.cout = (int)geo[G_COUT];
  p.nseg = (int)geo[G_NSEG]; p.lpad = (int)geo[G_LPAD];
  p.k_steps = (int)geo[G_K_STEPS]; p.chunk_steps = (int)geo[G_CHUNK_STEPS];
  p.w_slots = (int)geo[G_W_SLOTS]; p.resident = (int)geo[G_RESIDENT];
  p.brick_bytes = (int)geo[G_BRICK_BYTES]; p.bias_mode = (int)geo[G_BIAS_MODE];
  p.byte_path = (int)geo[G_BYTE_PATH]; p.nparts = (int)geo[G_NPARTS];
  p.bslots = (int)geo[G_BSLOTS];
  p.bchunks = (int)geo[G_CHUNKS];
  p.srows = (int)geo[G_SROWS];
  const int bn = (int)geo[G_BN];
  p.n_chunks = (p.k_steps + p.chunk_steps - 1) / max(p.chunk_steps, 1);
  p.cpb = p.n_chunks / max(p.bchunks, 1);
  p.chunk_bytes = p.chunk_steps * bn * 32;
  const long long voxels = (long long)p.n * p.d * p.h * p.w;
  const void* xs[2] = {x0, x1};
  for (int k = 0; k < 2; ++k) {
    const int o = k == 0 ? G_CIN0 : G_CIN1;
    p.cin[k] = (int)geo[o]; p.cs[k] = (int)geo[o + 1]; p.nsub[k] = (int)geo[o + 2];
    p.box[k] = (int)geo[o + 3]; p.base[k] = (int)geo[o + 4]; p.seg[k] = (int)geo[o + 5];
    p.x[k] = static_cast<const int8_t*>(xs[k]);
    p.total_bytes[k] = voxels * p.cin[k];
  }
  p.table = static_cast<const int4*>(table);
  p.wp = static_cast<const int8_t*>(wp);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.y = y;
  p.table_rows = (p.byte_path ? 32 : 2) * p.k_steps;
  const long long smem = 1024 + (long long)p.bslots * p.brick_bytes +
                        (long long)p.w_slots * p.chunk_bytes + 32 +
                        8 * (2 * p.bslots + 2 * p.w_slots) + 16LL * p.table_rows +
                        8LL * p.n_tiles * bn;
  bool ok = p.nparts >= 1 && p.nparts <= 2 && p.k_steps >= 1 && p.chunk_steps >= 1 &&
            p.chunk_steps <= kMaxChunk &&
            p.w_slots >= 1 && p.w_slots <= kMaxSlots && p.bslots >= 2 &&
            p.bslots <= kMaxBricks && smem <= kSmemLimit &&
            (!p.resident || p.n_chunks <= p.w_slots) && p.brick_bytes % 1024 == 0 &&
            m_total < (1LL << 31) && p.tiles_m >= 1 && p.tpg >= 1 &&
            (long long)p.tiles_m * p.n_tiles < (1LL << 31) &&
            (p.bias_mode == 0 || bias != nullptr) && voxels < (1LL << 31) &&
            reinterpret_cast<uintptr_t>(wp) % 16 == 0;
  // a chunked plan: one sub-part of one part a slot, the weight chunks
  // tiling each brick chunk's k32 steps exactly
  const bool chunked = p.bchunks > 1;
  // a run a tap row: kd kh segments a part
  ok = ok && p.srows >= 1 && p.nseg % p.srows == 0;
  ok = ok && p.bchunks >= 1 && p.n_chunks % p.bchunks == 0 &&
       (!chunked || (!p.byte_path && p.k_steps == p.n_chunks * p.chunk_steps &&
                     p.bchunks == p.nsub[0] + (p.nparts > 1 ? p.nsub[1] : 0)));
  for (int k = 0; k < p.nparts && ok; ++k)
    ok = xs[k] != nullptr && reinterpret_cast<uintptr_t>(xs[k]) % 16 == 0 &&
         (p.byte_path ? (p.nparts == 1 && p.seg[k] % 16 == 0)
                      : (p.cin[k] % 16 == 0 &&
                         // a padded chunked plan's last sub-part of a part
                         // may run past its channels (TMA zero-fills them;
                         // the table reads none of them)
                         (chunked ? p.cs[k] * (p.nsub[k] - 1) < p.cin[k] &&
                                        p.cs[k] * p.nsub[k] >= p.cin[k]
                                  : p.cs[k] * p.nsub[k] == p.cin[k]) &&
                         p.lpad % p.box[k] == 0 && p.box[k] <= 256 &&
                         (p.box[k] * p.cs[k]) % 1024 == 0 && p.seg[k] == p.lpad * p.cs[k] &&
                         p.base[k] % 1024 == 0 &&
                         (!chunked || (p.base[k] == 0 &&
                                       p.brick_bytes == (long long)p.nseg * p.seg[k]))));
  if (!ok) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  memset(maps, 0, sizeof(maps));
  if (!p.byte_path)
    for (int k = 0; k < p.nparts; ++k)
      if (!make_map(&maps[k], xs[k], p.cin[k], voxels, p.cs[k], p.box[k]))
        return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool structured = geo[G_STRUCTURED] != 0;
  return launch_out(p, maps[0], maps[1], bn, (int)smem, grid, structured, out_dtype, s);
}
