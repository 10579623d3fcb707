// Host ops of tpuseg_torch: ITK-semantics resampling (linear and
// nearest), KD-tree nearest-neighbour distances, the percentile z-score and
// the NIfTI-1 voxel codec, behind a plain C interface loaded with ctypes
// (tpuseg_torch/io_native/__init__.py).  The same code as the JAX package's
// tpuseg/io_native/native.cc, kept here because the port imports nothing of
// that package.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libtpuseg_torch_native.so native.cc -lz

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------- resample
// ITK index mapping: input continuous index = output index * factor (per
// axis), border-clamped, as tpuseg_torch/data/geometry.py resample_to_size.
void resample_linear_f32(const float* in, int64_t iz, int64_t iy, int64_t ix,
                         float* out, int64_t oz, int64_t oy, int64_t ox,
                         double fz, double fy, double fx) {
  const int64_t ixy = ix * iy;
  for (int64_t z = 0; z < oz; ++z) {
    double zc = std::min(std::max(z * fz, 0.0), double(iz - 1));
    int64_t z0 = (int64_t)zc;
    int64_t z1 = std::min(z0 + 1, iz - 1);
    double wz = zc - z0;
    for (int64_t y = 0; y < oy; ++y) {
      double yc = std::min(std::max(y * fy, 0.0), double(iy - 1));
      int64_t y0 = (int64_t)yc;
      int64_t y1 = std::min(y0 + 1, iy - 1);
      double wy = yc - y0;
      float* orow = out + (z * oy + y) * ox;
      for (int64_t x = 0; x < ox; ++x) {
        double xc = std::min(std::max(x * fx, 0.0), double(ix - 1));
        int64_t x0 = (int64_t)xc;
        int64_t x1 = std::min(x0 + 1, ix - 1);
        double wx = xc - x0;
        const float* p00 = in + z0 * ixy + y0 * ix;
        const float* p01 = in + z0 * ixy + y1 * ix;
        const float* p10 = in + z1 * ixy + y0 * ix;
        const float* p11 = in + z1 * ixy + y1 * ix;
        double c00 = p00[x0] * (1 - wx) + p00[x1] * wx;
        double c01 = p01[x0] * (1 - wx) + p01[x1] * wx;
        double c10 = p10[x0] * (1 - wx) + p10[x1] * wx;
        double c11 = p11[x0] * (1 - wx) + p11[x1] * wx;
        double c0 = c00 * (1 - wy) + c01 * wy;
        double c1 = c10 * (1 - wy) + c11 * wy;
        orow[x] = (float)(c0 * (1 - wz) + c1 * wz);
      }
    }
  }
}

void resample_nearest_u8(const uint8_t* in, int64_t iz, int64_t iy, int64_t ix,
                         uint8_t* out, int64_t oz, int64_t oy, int64_t ox,
                         double fz, double fy, double fx) {
  const int64_t ixy = ix * iy;
  for (int64_t z = 0; z < oz; ++z) {
    int64_t zi = (int64_t)std::lround(std::min(std::max(z * fz, 0.0), double(iz - 1)));
    for (int64_t y = 0; y < oy; ++y) {
      int64_t yi = (int64_t)std::lround(std::min(std::max(y * fy, 0.0), double(iy - 1)));
      const uint8_t* irow = in + zi * ixy + yi * ix;
      uint8_t* orow = out + (z * oy + y) * ox;
      for (int64_t x = 0; x < ox; ++x) {
        int64_t xi = (int64_t)std::lround(std::min(std::max(x * fx, 0.0), double(ix - 1)));
        orow[x] = irow[xi];
      }
    }
  }
}

// ----------------------------------------------------------------- KD-tree
// 3D KD-tree for surface-distance metrics (ASSD/RMSD/MSD).
namespace {
struct KDNode {
  double pt[3];
  int left = -1, right = -1;
  int axis = 0;
};

struct KDTree {
  std::vector<KDNode> nodes;
  int root = -1;

  int build(std::vector<int>& idx, const double* pts, int lo, int hi, int depth) {
    if (lo >= hi) return -1;
    int axis = depth % 3;
    int mid = (lo + hi) / 2;
    std::nth_element(idx.begin() + lo, idx.begin() + mid, idx.begin() + hi,
                     [&](int a, int b) { return pts[a * 3 + axis] < pts[b * 3 + axis]; });
    int node_id = (int)nodes.size();
    nodes.push_back(KDNode());
    KDNode& n = nodes.back();
    std::memcpy(nodes[node_id].pt, pts + idx[mid] * 3, 3 * sizeof(double));
    nodes[node_id].axis = axis;
    int l = build(idx, pts, lo, mid, depth + 1);
    int r = build(idx, pts, mid + 1, hi, depth + 1);
    nodes[node_id].left = l;
    nodes[node_id].right = r;
    (void)n;
    return node_id;
  }

  void query(int node_id, const double* q, double& best) const {
    if (node_id < 0) return;
    const KDNode& n = nodes[node_id];
    double d2 = 0;
    for (int k = 0; k < 3; ++k) {
      double d = q[k] - n.pt[k];
      d2 += d * d;
    }
    best = std::min(best, d2);
    double diff = q[n.axis] - n.pt[n.axis];
    int near = diff < 0 ? n.left : n.right;
    int far = diff < 0 ? n.right : n.left;
    query(near, q, best);
    if (diff * diff < best) query(far, q, best);
  }
};
}  // namespace

// from (n_from,3), to (n_to,3) -> out (n_from) euclidean NN distances.
void nn_distances(const double* from_pts, int64_t n_from,
                  const double* to_pts, int64_t n_to, double* out) {
  if (n_to == 0) {
    std::fill(out, out + n_from, 0.0);
    return;
  }
  KDTree tree;
  tree.nodes.reserve(n_to);
  std::vector<int> idx(n_to);
  std::iota(idx.begin(), idx.end(), 0);
  tree.root = tree.build(idx, to_pts, 0, (int)n_to, 0);
  for (int64_t i = 0; i < n_from; ++i) {
    double best = 1e300;
    tree.query(tree.root, from_pts + i * 3, best);
    out[i] = std::sqrt(best);
  }
}

// --------------------------------------------------------- intensity ops
// percentile-clipped nonzero z-score (data/normalize.py percentile_zscore)
void percentile_zscore_f32(float* data, int64_t n, double lower_pct,
                           double upper_pct) {
  std::vector<float> nz;
  nz.reserve(n);
  for (int64_t i = 0; i < n; ++i)
    if (data[i] != 0.0f) nz.push_back(data[i]);
  if (nz.empty()) return;
  auto pct = [&](double p) {
    // numpy 'linear' percentile interpolation
    double pos = p / 100.0 * (nz.size() - 1);
    size_t lo = (size_t)pos;
    size_t hi = std::min(lo + 1, nz.size() - 1);
    std::nth_element(nz.begin(), nz.begin() + lo, nz.end());
    double vlo = nz[lo];
    std::nth_element(nz.begin(), nz.begin() + hi, nz.end());
    double vhi = nz[hi];
    return vlo + (pos - lo) * (vhi - vlo);
  };
  double lo = pct(lower_pct), hi = pct(upper_pct);
  double sum = 0, sum2 = 0;
  int64_t cnt = 0;
  for (int64_t i = 0; i < n; ++i) {
    float v = std::min(std::max(data[i], (float)lo), (float)hi);
    data[i] = v;
    if (v != 0.0f) {
      sum += v;
      sum2 += (double)v * v;
      ++cnt;
    }
  }
  if (cnt == 0) return;
  double mean = sum / cnt;
  double var = sum2 / cnt - mean * mean;
  double std = var > 0 ? std::sqrt(var) : 1.0;
  for (int64_t i = 0; i < n; ++i) data[i] = (float)((data[i] - mean) / std);
}

// ------------------------------------------------------------ NIfTI codec
// Bulk data path of the NIfTI-1 codec (tpuseg_torch/data/nifti.py owns the
// 348-byte header math).  zlib reads .nii.gz and plain .nii transparently;
// decode streams straight into the caller's numpy buffer (no intermediate
// whole-file bytes object).

// Read `n` decompressed bytes starting at decompressed offset `off`.
// Returns bytes read, or -1 on open/seek failure.
int64_t nifti_read_bytes(const char* path, int64_t off, int64_t n,
                         uint8_t* out) {
  gzFile f = gzopen(path, "rb");
  if (!f) return -1;
  if (gzseek(f, (z_off_t)off, SEEK_SET) < 0) {
    gzclose(f);
    return -1;
  }
  int64_t got = 0;
  while (got < n) {
    unsigned chunk = (unsigned)std::min<int64_t>(n - got, 1 << 24);
    int r = gzread(f, out + got, chunk);
    if (r <= 0) break;
    got += r;
  }
  gzclose(f);
  return got;
}

// Write header + voxel payload; level<=0 writes plain bytes, 1-9 gzip.
// Returns bytes written (decompressed count), or -1 on failure.
int64_t nifti_write_bytes(const char* path, const uint8_t* hdr, int64_t hdr_n,
                          const uint8_t* data, int64_t data_n, int level) {
  char mode[8];
  if (level <= 0)
    std::snprintf(mode, sizeof(mode), "wbT");  // T = transparent (no gzip)
  else
    std::snprintf(mode, sizeof(mode), "wb%d", level > 9 ? 9 : level);
  gzFile f = gzopen(path, mode);
  if (!f) return -1;
  int64_t total = 0;
  const uint8_t* bufs[2] = {hdr, data};
  int64_t lens[2] = {hdr_n, data_n};
  for (int b = 0; b < 2; ++b) {
    int64_t done = 0;
    while (done < lens[b]) {
      unsigned chunk = (unsigned)std::min<int64_t>(lens[b] - done, 1 << 24);
      int w = gzwrite(f, bufs[b] + done, chunk);
      if (w <= 0) {
        gzclose(f);
        return -1;
      }
      done += w;
      total += w;
    }
  }
  return gzclose(f) == Z_OK ? total : -1;
}

}  // extern "C"
