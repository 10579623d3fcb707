// The persistent walk of the K4-K6 probe kernels (csrc/slab_conv.cu,
// csrc/flat_conv.cu): items, the fills of a ring of shared-memory slots, and
// which fills an output plane reads.
//
// An item is one z chunk of one strip (a lane range of a slab plane, or a
// row range of a flat plane) of one sample: (n, z chunk, strip), strip
// fastest, so that the blocks running at one time walk neighbouring strips
// of the same planes and share their halos in L2.  A block walks the items
// blockIdx.x, + gridDim.x, ...  Along an item it stages input planes
// ("fills") into a ring of `stages` slots and computes the item's output
// planes p = 0 .. len - 1 (z = z0 + p):
//
// * span 3: fill f is input plane z0 + f (len + 2 of them); output plane p
//   reads fills p, p + 1, p + 2 (the dz taps);
// * span 1: fill f is input plane z0 + f * group; output plane p reads fill
//   p / group (K4 `dot_only`: the first slab of each block of `group` = BD
//   planes; K6 `pre`: its own xcat plane, group 1).
//
// Fills are numbered along the block's whole walk (q), so fill q sits in
// slot q % stages; each slot has a `full` mbarrier (the copy's bytes) and an
// `empty` one (one arrival per consumer warp when no later plane of the
// item reads it).  After plane p the fills [first(p), first(p + 1)) are
// released, after the item's last plane all that remain: each fill once.
#pragma once

#include <cuda_runtime.h>

namespace tpuseg {
namespace walk {

struct Walk {
  int D;        // output planes per sample
  int zc, nzc;  // z chunk length and chunks per sample
  int nstrips;  // strips per plane
  int span;     // fills an output plane reads: 3 or 1
  int group;    // output planes per fill when span == 1
  long long items;
};

struct Item {
  int n, z0, len, strip, nf;

  __device__ __forceinline__ void decode(long long it, const Walk& w) {
    strip = (int)(it % w.nstrips);
    it /= w.nstrips;
    const int zt = (int)(it % w.nzc);
    n = (int)(it / w.nzc);
    z0 = zt * w.zc;
    len = min(w.zc, w.D - z0);
    nf = w.span == 3 ? len + 2 : (len + w.group - 1) / w.group;
  }
  // input plane of fill f
  __device__ __forceinline__ int fill_z(int f, const Walk& w) const {
    return w.span == 3 ? z0 + f : z0 + f * w.group;
  }
  // first fill output plane p reads (p == len: past the last)
  __device__ __forceinline__ int first(int p, const Walk& w) const {
    if (p >= len) return nf;
    return w.span == 3 ? p : p / w.group;
  }
};

// The z chunk (a multiple of `group`) that gives the fewest steps to the
// busiest of `resident` blocks: rounds of items per block x (chunk + the
// span - 1 extra fills of a chunk).  Ties go to the longer chunk (fewer
// halo fills).
__host__ inline Walk make_walk(int n, int d, int nstrips, int span, int group,
                               long long resident) {
  Walk w;
  w.D = d;
  w.nstrips = nstrips;
  w.span = span;
  w.group = group;
  long long best = -1;
  w.zc = d;
  for (int zc = d - d % group; zc >= group; zc -= group) {
    const long long items = (long long)n * nstrips * ((d + zc - 1) / zc);
    const long long cost = (items + resident - 1) / resident * (zc + span - 1);
    if (best < 0 || cost < best) {
      best = cost;
      w.zc = zc;
    }
  }
  w.nzc = (d + w.zc - 1) / w.zc;
  w.items = (long long)n * w.nzc * nstrips;
  return w;
}

}  // namespace walk
}  // namespace tpuseg
