// The W8A8 int8 conv's kernels that issue a weight chunk's four wgmmas
// unconditionally (csrc/conv_int8.cuh), in a translation unit of their
// own so that they build beside csrc/conv_int8.cu's.
#include "conv_int8.cuh"

namespace tpuseg {
namespace int8conv {

int launch_full(const Params& p, const CUtensorMap& m0, const CUtensorMap& m1, int bn, int smem,
                int grid, bool structured, int out_dtype, cudaStream_t s) {
  switch (out_dtype) {
    case 0: return launch_bn<float, true>(p, m0, m1, bn, smem, grid, structured, s);
    case 1: return launch_bn<__nv_bfloat16, true>(p, m0, m1, bn, smem, grid, structured, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace int8conv
}  // namespace tpuseg
