// Host ops of tpuseg_torch: ITK-semantics resampling (linear and
// nearest), KD-tree nearest-neighbour distances, the percentile z-score and
// the NIfTI-1 voxel codec, behind a plain C interface loaded with ctypes
// (tpuseg_torch/io_native/__init__.py).  The same code as the JAX package's
// tpuseg/io_native/native.cc, kept here because the port imports nothing of
// that package; and the 8-bit PNG / BMP decoders of the 2D datasets, which
// the JAX package takes from cv2 (tpuseg_torch/io_native/image.py).
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

// ------------------------------------------------------------ PNG and BMP
// Decoders of the 2D datasets' images, read as cv2.imread reads them with
// flag 0 (gray) or 1 (BGR).  PNG: 8-bit gray, gray+alpha, RGB and RGBA,
// non-interlaced, the five row filters; to gray as libpng's
// png_set_rgb_to_gray(0.299, 0.587) computes it (integer weights 9797,
// 19234, 3737, the sum shifted down by 15 bits, truncated), alpha dropped.
// BMP: uncompressed 8-bit paletted, 24-bit and 32-bit (bit fields only in
// B, G, R byte order); to gray as cv2 reads them: 8- and 24-bit by its
// BGR->gray (weights 1868, 9617, 4899 over 2^14, rounded), 32-bit as
// floor((0.299 r + 0.587 g) + 0.114 b) in float32.  Other files
// return a negative code.

namespace {

constexpr int64_t kBadFormat = -2, kUnsupported = -3, kCorrupt = -4;

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}
inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24);
}
inline uint16_t le16(const uint8_t* p) { return uint16_t(p[0] | (p[1] << 8)); }

inline uint8_t png_gray(int r, int g, int b) {
  return uint8_t((9797 * r + 19234 * g + 3737 * b) >> 15);
}
inline uint8_t bmp_gray(int b, int g, int r) {
  return uint8_t((b * 1868 + g * 9617 + r * 4899 + (1 << 13)) >> 14);
}
inline uint8_t bmp32_gray(int b, int g, int r) {
  // float32 products and sums in this order, none fused into an FMA
  volatile float pr = float(r) * 0.299f, pg = float(g) * 0.587f;
  volatile float prg = pr + pg, pb = float(b) * 0.114f;
  return uint8_t(std::floor(prg + pb));
}

struct Image {
  int64_t h = 0, w = 0;
};

const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', 0x0D, 0x0A, 0x1A, 0x0A};

// PNG header: dims and the sample layout; 0 or a negative code.
int64_t png_header(const uint8_t* buf, int64_t n, Image* im, int* channels) {
  if (n < 33 || std::memcmp(buf, kPngSig, 8) != 0) return kBadFormat;
  if (std::memcmp(buf + 12, "IHDR", 4) != 0) return kCorrupt;
  const uint8_t* h = buf + 16;
  im->w = be32(h);
  im->h = be32(h + 4);
  int depth = h[8], type = h[9], interlace = h[12];
  if (depth != 8 || interlace != 0) return kUnsupported;
  switch (type) {
    case 0: *channels = 1; break;
    case 2: *channels = 3; break;
    case 4: *channels = 2; break;
    case 6: *channels = 4; break;
    default: return kUnsupported;  // palette
  }
  if (im->w <= 0 || im->h <= 0) return kCorrupt;
  return 0;
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

int64_t png_decode(const uint8_t* buf, int64_t n, uint8_t* out, int out_ch) {
  Image im;
  int ch = 0;
  int64_t err = png_header(buf, n, &im, &ch);
  if (err) return err;
  std::vector<uint8_t> z;
  for (int64_t pos = 8; pos + 12 <= n;) {
    uint32_t len = be32(buf + pos);
    const uint8_t* type = buf + pos + 4;
    if (pos + 12 + int64_t(len) > n) return kCorrupt;
    if (std::memcmp(type, "IDAT", 4) == 0) z.insert(z.end(), type + 4, type + 4 + len);
    if (std::memcmp(type, "IEND", 4) == 0) break;
    pos += 12 + int64_t(len);
  }
  const int64_t stride = im.w * ch;
  std::vector<uint8_t> raw(size_t(im.h * (stride + 1)));
  uLongf got = uLongf(raw.size());
  if (uncompress(raw.data(), &got, z.data(), uLong(z.size())) != Z_OK || got != raw.size())
    return kCorrupt;
  std::vector<uint8_t> prev(static_cast<size_t>(stride), 0);
  std::vector<uint8_t> cur(static_cast<size_t>(stride), 0);
  for (int64_t y = 0; y < im.h; ++y) {
    const uint8_t* row = raw.data() + y * (stride + 1);
    int filter = row[0];
    ++row;
    for (int64_t i = 0; i < stride; ++i) {
      int a = i >= ch ? cur[size_t(i - ch)] : 0, b = prev[size_t(i)];
      int c = i >= ch ? prev[size_t(i - ch)] : 0;
      int p;
      switch (filter) {
        case 0: p = 0; break;
        case 1: p = a; break;
        case 2: p = b; break;
        case 3: p = (a + b) >> 1; break;
        case 4: p = paeth(a, b, c); break;
        default: return kCorrupt;
      }
      cur[size_t(i)] = uint8_t(row[i] + p);
    }
    uint8_t* o = out + y * im.w * out_ch;
    for (int64_t x = 0; x < im.w; ++x) {
      const uint8_t* s = cur.data() + x * ch;
      int r = s[0], g = ch >= 3 ? s[1] : s[0], b = ch >= 3 ? s[2] : s[0];
      if (out_ch == 1) {
        o[x] = ch >= 3 ? png_gray(r, g, b) : uint8_t(r);
      } else {
        o[3 * x] = uint8_t(b);
        o[3 * x + 1] = uint8_t(g);
        o[3 * x + 2] = uint8_t(r);
      }
    }
    std::swap(prev, cur);
  }
  return 0;
}

struct Bmp {
  int64_t offset = 0, dib = 0, bpp = 0, colors = 0;
  bool bottom_up = true;
};

int64_t bmp_header(const uint8_t* buf, int64_t n, Image* im, Bmp* bm) {
  if (n < 54 || buf[0] != 'B' || buf[1] != 'M') return kBadFormat;
  bm->offset = le32(buf + 10);
  bm->dib = le32(buf + 14);
  if (bm->dib < 40) return kUnsupported;  // OS/2 core headers
  int32_t w = int32_t(le32(buf + 18)), h = int32_t(le32(buf + 22));
  bm->bpp = le16(buf + 28);
  uint32_t compression = le32(buf + 30);
  bm->colors = le32(buf + 46);
  if (bm->bpp != 8 && bm->bpp != 24 && bm->bpp != 32) return kUnsupported;
  // bit fields only in the B, G, R byte order that cv2 writes 32-bit BMPs in
  bool bgr_fields = bm->bpp == 32 && compression == 3 && n >= 66 &&
                    le32(buf + 54) == 0x00ff0000u && le32(buf + 58) == 0x0000ff00u &&
                    le32(buf + 62) == 0x000000ffu;
  if (compression != 0 && !bgr_fields) return kUnsupported;  // RLE, other fields
  if (bm->bpp == 8 && (bm->colors == 0 || bm->colors > 256)) bm->colors = 256;
  bm->bottom_up = h > 0;
  im->w = w;
  im->h = h > 0 ? h : -int64_t(h);
  if (im->w <= 0 || im->h <= 0) return kCorrupt;
  int64_t row = (im->w * bm->bpp / 8 + 3) & ~int64_t(3);
  if (bm->offset + row * im->h > n) return kCorrupt;
  if (bm->bpp == 8 && 14 + bm->dib + 4 * bm->colors > n) return kCorrupt;
  return 0;
}

int64_t bmp_decode(const uint8_t* buf, int64_t n, uint8_t* out, int out_ch) {
  Image im;
  Bmp bm;
  int64_t err = bmp_header(buf, n, &im, &bm);
  if (err) return err;
  const uint8_t* pal = buf + 14 + bm.dib;  // B, G, R, 0 per entry
  const int64_t row_bytes = (im.w * bm.bpp / 8 + 3) & ~int64_t(3);
  const int step = int(bm.bpp / 8);
  for (int64_t y = 0; y < im.h; ++y) {
    const uint8_t* row = buf + bm.offset + (bm.bottom_up ? im.h - 1 - y : y) * row_bytes;
    uint8_t* o = out + y * im.w * out_ch;
    for (int64_t x = 0; x < im.w; ++x) {
      const uint8_t* s = row + x * step;
      if (bm.bpp == 8) {
        if (*s >= bm.colors) return kCorrupt;
        s = pal + 4 * int64_t(*s);
      }
      if (out_ch == 1) {
        o[x] = bm.bpp == 32 ? bmp32_gray(s[0], s[1], s[2]) : bmp_gray(s[0], s[1], s[2]);
      } else {
        o[3 * x] = s[0];
        o[3 * x + 1] = s[1];
        o[3 * x + 2] = s[2];
      }
    }
  }
  return 0;
}

}  // namespace

// Height and width of a PNG or BMP held in `buf`; 0 or a negative code
// (-2 not a PNG or BMP, -3 a variant the decoder does not read, -4 corrupt).
int64_t image_dims(const uint8_t* buf, int64_t n, int64_t* hw) {
  Image im;
  int ch = 0;
  Bmp bm;
  int64_t err = png_header(buf, n, &im, &ch);
  if (err == kBadFormat) err = bmp_header(buf, n, &im, &bm);
  if (err) return err;
  hw[0] = im.h;
  hw[1] = im.w;
  return 0;
}

// Decode into `out` (h, w, out_ch) uint8, out_ch 1 (gray) or 3 (BGR).
int64_t image_decode(const uint8_t* buf, int64_t n, uint8_t* out, int out_ch) {
  int64_t err = png_decode(buf, n, out, out_ch);
  if (err == kBadFormat) err = bmp_decode(buf, n, out, out_ch);
  return err;
}

}  // extern "C"
