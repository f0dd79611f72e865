// Native bilinear forward-splat for visibility-mask generation.
//
// Port of simplenerf_tpu/native/warp.cpp: the scatter-accumulate of
// qa/masks.bilinear_splat (reference semantics:
// src/qa/00_Common/src/mask_generators/Warper.py:99-181, depth weights
// exp(log1p(d)/max*50) at :142-149), the same O(h*w*4*(c+1)) adds as the
// numpy plain version's np.add.at scatters without their per-element
// dispatch.
//
// Semantics are replicated EXACTLY, including the reference quirks:
// - floor/ceil are taken from the unclipped positions, then positions and
//   corner indices are clipped independently to the padded canvas;
// - integral positions land on all four coincident corners (4x weight);
// - the depth-weight normalizer divides by max(log1p(depth)) without a
//   zero guard.
//
// Built at first use with g++ into build/native/ and bound with ctypes
// (see native/__init__.py); a failed build raises.

#include <cmath>
#include <cstdint>
#include <algorithm>

extern "C" {

// values:   (h, w, c) float64
// trans_pos:(h, w, 2) float64  (x, y) target positions in view 2
// depth:    (h, w)    float64  per-source-pixel depth (splat priority)
// mask:     (h, w)    uint8 or nullptr (1 = use source pixel)
// acc:      (h+2, w+2, c) float64, zero-initialized by caller
// acc_w:    (h+2, w+2)    float64, zero-initialized by caller
void bilinear_splat(const double* values, const double* trans_pos,
                    const double* depth, const std::uint8_t* mask,
                    long h, long w, long c, double* acc, double* acc_w) {
  const long W2 = w + 2;

  // depth_weights = exp(log1p(clip(depth, 0, 1000)) / max_log * 50)
  double max_log = 0.0;
  for (long i = 0; i < h * w; ++i) {
    double d = std::min(std::max(depth[i], 0.0), 1000.0);
    max_log = std::max(max_log, std::log1p(d));
  }

  for (long y = 0; y < h; ++y) {
    for (long x = 0; x < w; ++x) {
      const long i = y * w + x;
      if (mask && !mask[i]) continue;

      double px = trans_pos[i * 2 + 0] + 1.0;
      double py = trans_pos[i * 2 + 1] + 1.0;
      double fxf = std::floor(px), fyf = std::floor(py);
      double cxf = std::ceil(px), cyf = std::ceil(py);
      px = std::min(std::max(px, 0.0), double(w + 1));
      py = std::min(std::max(py, 0.0), double(h + 1));
      long flx = std::min(std::max(long(fxf), 0L), w + 1);
      long fly = std::min(std::max(long(fyf), 0L), h + 1);
      long clx = std::min(std::max(long(cxf), 0L), w + 1);
      long cly = std::min(std::max(long(cyf), 0L), h + 1);

      const double fx = px - double(flx);
      const double fy = py - double(fly);
      const double cx = double(clx) - px;
      const double cy = double(cly) - py;

      double d = std::min(std::max(depth[i], 0.0), 1000.0);
      const double dw = std::exp(std::log1p(d) / max_log * 50.0);

      const double prox[4] = {
          (1.0 - fy) * (1.0 - fx),  // nw
          (1.0 - cy) * (1.0 - fx),  // sw
          (1.0 - fy) * (1.0 - cx),  // ne
          (1.0 - cy) * (1.0 - cx),  // se
      };
      const long cys[4] = {fly, cly, fly, cly};
      const long cxs[4] = {flx, flx, clx, clx};

      for (int k = 0; k < 4; ++k) {
        const double wgt = prox[k] / dw;
        const long j = cys[k] * W2 + cxs[k];
        acc_w[j] += wgt;
        double* dst = acc + j * c;
        const double* src = values + i * c;
        for (long ch = 0; ch < c; ++ch) dst[ch] += src[ch] * wgt;
      }
    }
  }
}

}  // extern "C"
