// The host data-loader core of tpu_unet_torch: a copy of the JAX package's
// loader core with the same code, built by tpu_unet_torch/data/native.py.
//
// Multi-threaded, GIL-free uint8 resize (area-weighted triangle filter with
// PIL BILINEAR semantics, 4-tap bilinear, nearest) and a scanline polygon
// rasterizer, exposed as a plain C ABI consumed via ctypes. A change that
// moves a pixel must bump tu_version(): disk packs name the resampler's
// version in their fingerprints (tpu_unet_torch/data/transforms.py).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libloader_core.so loader_core.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Bilinear resize, half-pixel-center convention (align_corners=false), uint8 HWC.
void resize_bilinear_rows(const uint8_t* src, int sh, int sw, int c,
                          uint8_t* dst, int dh, int dw, int row0, int row1) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int oy = row0; oy < row1; ++oy) {
    float fy = clampf((oy + 0.5f) * sy - 0.5f, 0.0f, sh - 1.0f);
    int y0 = static_cast<int>(fy);
    int y1 = std::min(y0 + 1, sh - 1);
    float wy = fy - y0;
    for (int ox = 0; ox < dw; ++ox) {
      float fx = clampf((ox + 0.5f) * sx - 0.5f, 0.0f, sw - 1.0f);
      int x0 = static_cast<int>(fx);
      int x1 = std::min(x0 + 1, sw - 1);
      float wx = fx - x0;
      const uint8_t* p00 = src + (static_cast<size_t>(y0) * sw + x0) * c;
      const uint8_t* p01 = src + (static_cast<size_t>(y0) * sw + x1) * c;
      const uint8_t* p10 = src + (static_cast<size_t>(y1) * sw + x0) * c;
      const uint8_t* p11 = src + (static_cast<size_t>(y1) * sw + x1) * c;
      uint8_t* out = dst + (static_cast<size_t>(oy) * dw + ox) * c;
      for (int ch = 0; ch < c; ++ch) {
        float top = p00[ch] + (p01[ch] - p00[ch]) * wx;
        float bot = p10[ch] + (p11[ch] - p10[ch]) * wx;
        float v = top + (bot - top) * wy;
        out[ch] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

void resize_nearest_rows(const uint8_t* src, int sh, int sw, int c,
                         uint8_t* dst, int dh, int dw, int row0, int row1) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int oy = row0; oy < row1; ++oy) {
    int iy = std::min(static_cast<int>(oy * sy), sh - 1);
    for (int ox = 0; ox < dw; ++ox) {
      int ix = std::min(static_cast<int>(ox * sx), sw - 1);
      std::memcpy(dst + (static_cast<size_t>(oy) * dw + ox) * c,
                  src + (static_cast<size_t>(iy) * sw + ix) * c, c);
    }
  }
}

// --- Area-weighted (triangle-filter) resampling, PIL BILINEAR semantics. ---
//
// PIL's BILINEAR resize widens the triangle filter by the downscale factor
// (support = max(scale, 1)), i.e. proper area-weighted downsampling rather than
// 4-tap point sampling — this is what makes it alias-free on the 3-4x downscales
// of MVTec-sized inputs (the reference's dataset resizes with it).
// Separable: precomputed per-output-pixel coefficient tables, horizontal pass to
// a float intermediate, then vertical pass with round-to-nearest.

struct ResampleCoeffs {
  std::vector<int> xmin;    // first source index per output pixel
  std::vector<int> xcount;  // number of taps per output pixel
  std::vector<float> k;     // ksize coefficients per output pixel (normalized)
  int ksize = 0;
};

ResampleCoeffs triangle_coeffs(int in_size, int out_size) {
  ResampleCoeffs rc;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // triangle filter radius
  rc.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  rc.xmin.resize(out_size);
  rc.xcount.resize(out_size);
  rc.k.assign(static_cast<size_t>(out_size) * rc.ksize, 0.0f);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    double total = 0.0;
    float* kk = rc.k.data() + static_cast<size_t>(xx) * rc.ksize;
    for (int x = xmin; x < xmax; ++x) {
      double t = std::abs((x - center + 0.5) / filterscale);
      double w = t < 1.0 ? 1.0 - t : 0.0;
      kk[x - xmin] = static_cast<float>(w);
      total += w;
    }
    if (total > 0.0) {
      for (int x = 0; x < xmax - xmin; ++x) kk[x] /= static_cast<float>(total);
    }
    rc.xmin[xx] = xmin;
    rc.xcount[xx] = xmax - xmin;
  }
  return rc;
}

template <typename Fn>
void run_rows(int rows, int n_threads, Fn fn) {
  int nt = std::max(1, std::min(n_threads, rows));
  if (nt == 1) {
    fn(0, rows);
    return;
  }
  std::vector<std::thread> ws;
  int chunk = (rows + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int r0 = t * chunk, r1 = std::min(rows, r0 + chunk);
    if (r0 >= r1) break;
    ws.emplace_back([=] { fn(r0, r1); });
  }
  for (auto& w : ws) w.join();
}

// Full area-weighted resize of one image. Vertical pass FIRST (u8 rows combine
// with contiguous, auto-vectorizable accesses into a float (dh, sw, c) buffer),
// then the strided horizontal pass over only dh output rows — for the common
// downscale this is ~3x less strided work than horizontal-first.
void resize_area_u8(const uint8_t* src, int sh, int sw, int c,
                    uint8_t* dst, int dh, int dw, int n_threads,
                    std::vector<float>* scratch) {
  const ResampleCoeffs cx = triangle_coeffs(sw, dw);
  const ResampleCoeffs cy = triangle_coeffs(sh, dh);
  std::vector<float> local;
  std::vector<float>& mid = scratch ? *scratch : local;
  const int rowlen = sw * c;
  mid.resize(static_cast<size_t>(dh) * rowlen);

  run_rows(dh, n_threads, [&](int r0, int r1) {
    for (int oy = r0; oy < r1; ++oy) {
      const float* kk = cy.k.data() + static_cast<size_t>(oy) * cy.ksize;
      const int y0 = cy.xmin[oy], cnt = cy.xcount[oy];
      float* drow = mid.data() + static_cast<size_t>(oy) * rowlen;
      const uint8_t* s0 = src + static_cast<size_t>(y0) * rowlen;
      for (int i = 0; i < rowlen; ++i) drow[i] = kk[0] * s0[i];
      for (int t = 1; t < cnt; ++t) {
        const float w = kk[t];
        const uint8_t* srow = src + static_cast<size_t>(y0 + t) * rowlen;
        for (int i = 0; i < rowlen; ++i) drow[i] += w * srow[i];
      }
    }
  });

  run_rows(dh, n_threads, [&](int r0, int r1) {
    for (int oy = r0; oy < r1; ++oy) {
      const float* srow = mid.data() + static_cast<size_t>(oy) * rowlen;
      uint8_t* drow = dst + static_cast<size_t>(oy) * dw * c;
      for (int ox = 0; ox < dw; ++ox) {
        const float* kk = cx.k.data() + static_cast<size_t>(ox) * cx.ksize;
        const int x0 = cx.xmin[ox], cnt = cx.xcount[ox];
        for (int ch = 0; ch < c; ++ch) {
          float acc = 0.0f;
          const float* p = srow + static_cast<size_t>(x0) * c + ch;
          for (int t = 0; t < cnt; ++t) acc += kk[t] * p[static_cast<size_t>(t) * c];
          drow[static_cast<size_t>(ox) * c + ch] =
              static_cast<uint8_t>(clampf(acc + 0.5f, 0.0f, 255.0f));
        }
      }
    }
  });
}

}  // namespace

extern "C" {

// Resize uint8 HWC image. mode: 0 = nearest, 1 = bilinear (4-tap),
// 2 = area-weighted triangle filter (PIL BILINEAR semantics; alias-free downscale).
void tu_resize_u8(const uint8_t* src, int sh, int sw, int c,
                  uint8_t* dst, int dh, int dw, int mode, int n_threads) {
  if (mode == 2) {
    resize_area_u8(src, sh, sw, c, dst, dh, dw, n_threads, nullptr);
  } else if (mode == 1) {
    run_rows(dh, n_threads, [&](int r0, int r1) {
      resize_bilinear_rows(src, sh, sw, c, dst, dh, dw, r0, r1);
    });
  } else {
    run_rows(dh, n_threads, [&](int r0, int r1) {
      resize_nearest_rows(src, sh, sw, c, dst, dh, dw, r0, r1);
    });
  }
}

// Batch resize: n images with identical source dims packed contiguously.
void tu_resize_u8_batch(const uint8_t* src, int n, int sh, int sw, int c,
                        uint8_t* dst, int dh, int dw, int mode, int n_threads) {
  std::atomic<int> next(0);
  int workers = std::max(1, n_threads);
  std::vector<std::thread> pool;
  for (int t = 0; t < std::min(workers, n); ++t) {
    pool.emplace_back([&] {
      int i;
      while ((i = next.fetch_add(1)) < n) {
        tu_resize_u8(src + static_cast<size_t>(i) * sh * sw * c, sh, sw, c,
                     dst + static_cast<size_t>(i) * dh * dw * c, dh, dw, mode, 1);
      }
    });
  }
  for (auto& w : pool) w.join();
}

// Even-odd scanline polygon fill (integer pixel-center rule): sets mask[y*w+x]=value
// for pixels whose centers lie inside the polygon. points: (x0,y0,x1,y1,...).
void tu_fill_polygon(uint8_t* mask, int h, int w,
                     const float* points, int n_points, uint8_t value) {
  if (n_points < 3) return;
  std::vector<float> xs;
  for (int y = 0; y < h; ++y) {
    float cy = y + 0.0f;  // integer scanline (PIL-style): test at y itself
    xs.clear();
    for (int i = 0; i < n_points; ++i) {
      float x0 = points[2 * i], y0 = points[2 * i + 1];
      float x1 = points[2 * ((i + 1) % n_points)];
      float y1 = points[2 * ((i + 1) % n_points) + 1];
      if ((y0 <= cy && y1 > cy) || (y1 <= cy && y0 > cy)) {
        xs.push_back(x0 + (cy - y0) * (x1 - x0) / (y1 - y0));
      }
    }
    std::sort(xs.begin(), xs.end());
    for (size_t i = 0; i + 1 < xs.size(); i += 2) {
      int xa = static_cast<int>(std::ceil(xs[i]));
      int xb = static_cast<int>(std::floor(xs[i + 1]));
      xa = std::max(xa, 0);
      xb = std::min(xb, w - 1);
      for (int x = xa; x <= xb; ++x) mask[static_cast<size_t>(y) * w + x] = value;
    }
  }
}

int tu_version() { return 2; }

}  // extern "C"
