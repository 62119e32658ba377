// Host image routines for `data/imgproc.py`: the OpenCV 5.0.0 calls of
// the training augmentation, repeated in their float arithmetic so that
// each leaves the same values as the cv2 call it stands for:
//   * `warp_affine_*` (cv2.warpAffine, INTER_LINEAR, BORDER_CONSTANT) on
//     uint8 and float32 images of 1-4 channels.  OpenCV 5 inverts the
//     2x3 matrix in double, rounds it to float and maps each output pixel
//     in float32: blocks of 16 pixels as its SIMD loop does (two AVX2
//     registers of 8 floats),
//     fma(M0, x, float(y*M1 + M2)), the rest of the row as its scalar
//     loop compiled with contraction, fma(x, M0, y*M1) + M2.  The taps
//     are floor(sx), floor(sy); outside the source they take the border
//     value; the lerp is fma(a, p1 - p0, p0) along x, then along y.
//     uint8 results round half to even and saturate.
//   * `resize_linear_f32` (cv2.resize, INTER_LINEAR, float32): the
//     source position (dx + 0.5) * scale - 0.5 in double, its fraction
//     rounded to float, taps clamped to the image, the same lerp.
//   * `rgb2hsv_f32` / `hsv2rgb_f32` (cv2.cvtColor COLOR_RGB2HSV /
//     COLOR_HSV2RGB on float32, H in [0, 360)): blocks of 8 pixels of a
//     row (one AVX2 register) take the SIMD form of the hue, fma(delta, 60 / (diff + eps),
//     offset) with 360 in the offset where the hue would be negative,
//     the rest of the row the scalar form, fma(delta, 60 / (diff + eps),
//     offset) then + 360 where negative; the way back evaluates
//     1 - s*h as one fma.
// The block widths are those of the AVX2 dispatch that the yardstick
// (cv2 5.0.0's wheel on an x86-64 host with AVX2 and FMA) takes, found by
// testing against it; built with -ffp-contract=off, so that only the
// written fma() calls fuse.

#include <cmath>
#include <cstdint>

namespace {

const int WARP_BLOCK = 16;   // pixels a step of the warp's SIMD loop
const int HSV_BLOCK = 8;     // pixels a step of RGB2HSV's SIMD loop

inline float lerp(float a, float p0, float p1) {
  return std::fma(a, p1 - p0, p0);
}

inline uint8_t sat_u8(float v) {
  int r = static_cast<int>(std::nearbyint(v));
  return static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
}

template <typename T> inline float to_f(T v) { return static_cast<float>(v); }

template <typename T> inline T from_f(float v);
template <> inline float from_f<float>(float v) { return v; }
template <> inline uint8_t from_f<uint8_t>(float v) { return sat_u8(v); }

// OpenCV's `invertAffineTransform` in double, then the float copy its
// warp kernels use.
void invert_affine(const double* m, float* out) {
  double D = m[0] * m[4] - m[1] * m[3];
  D = D != 0 ? 1. / D : 0;
  double A11 = m[4] * D, A22 = m[0] * D;
  double A12 = -m[1] * D, A21 = -m[3] * D;
  double b1 = -A11 * m[2] - A12 * m[5];
  double b2 = -A21 * m[2] - A22 * m[5];
  const double inv[6] = {A11, A12, b1, A21, A22, b2};
  for (int i = 0; i < 6; ++i) out[i] = static_cast<float>(inv[i]);
}

template <typename T>
void warp_affine(const T* src, int sh, int sw, int cn, T* dst, int dh,
                 int dw, const double* m, float border) {
  float M[6];
  invert_affine(m, M);
  const int vec_end = (dw / WARP_BLOCK) * WARP_BLOCK;
  for (int y = 0; y < dh; ++y) {
    const float yf = static_cast<float>(y);
    const float mx = yf * M[1] + M[2];
    const float my = yf * M[4] + M[5];
    const float ymx = yf * M[1], ymy = yf * M[4];
    T* out = dst + static_cast<int64_t>(y) * dw * cn;
    for (int x = 0; x < dw; ++x) {
      const float xf = static_cast<float>(x);
      float sx, sy;
      if (x < vec_end) {
        sx = std::fma(M[0], xf, mx);
        sy = std::fma(M[3], xf, my);
      } else {
        sx = std::fma(xf, M[0], ymx) + M[2];
        sy = std::fma(xf, M[3], ymy) + M[5];
      }
      const float fx = std::floor(sx), fy = std::floor(sy);
      const float ax = sx - fx, ay = sy - fy;
      // Far outside (or not finite): every tap is the border.
      const bool far = !(fx > -2.0f && fx < static_cast<float>(sw) + 1.0f &&
                         fy > -2.0f && fy < static_cast<float>(sh) + 1.0f);
      const int ix = far ? -2 : static_cast<int>(fx);
      const int iy = far ? -2 : static_cast<int>(fy);
      const bool in_x0 = ix >= 0 && ix < sw, in_x1 = ix + 1 >= 0 && ix + 1 < sw;
      const bool in_y0 = iy >= 0 && iy < sh, in_y1 = iy + 1 >= 0 && iy + 1 < sh;
      const T* r0 = src + static_cast<int64_t>(in_y0 ? iy : 0) * sw * cn;
      const T* r1 = src + static_cast<int64_t>(in_y1 ? iy + 1 : 0) * sw * cn;
      for (int c = 0; c < cn; ++c) {
        float p00 = border, p01 = border, p10 = border, p11 = border;
        if (in_y0 && in_x0) p00 = to_f(r0[ix * cn + c]);
        if (in_y0 && in_x1) p01 = to_f(r0[(ix + 1) * cn + c]);
        if (in_y1 && in_x0) p10 = to_f(r1[ix * cn + c]);
        if (in_y1 && in_x1) p11 = to_f(r1[(ix + 1) * cn + c]);
        const float a = lerp(ax, p00, p01), b = lerp(ax, p10, p11);
        out[x * cn + c] = from_f<T>(lerp(ay, a, b));
      }
    }
  }
}

inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

}  // namespace

extern "C" {

void warp_affine_f32(const float* src, int sh, int sw, int cn, float* dst,
                     int dh, int dw, const double* m, float border) {
  warp_affine<float>(src, sh, sw, cn, dst, dh, dw, m, border);
}

void warp_affine_u8(const uint8_t* src, int sh, int sw, int cn, uint8_t* dst,
                    int dh, int dw, const double* m, float border) {
  warp_affine<uint8_t>(src, sh, sw, cn, dst, dh, dw, m, border);
}

void resize_linear_f32(const float* src, int sh, int sw, int cn, float* dst,
                       int dh, int dw) {
  const double scale_x = static_cast<double>(sw) / dw;
  const double scale_y = static_cast<double>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    const double fy = (y + 0.5) * scale_y - 0.5;
    const double sy = std::floor(fy);
    const float ay = static_cast<float>(fy - sy);
    const int y0 = clampi(static_cast<int>(sy), 0, sh - 1);
    const int y1 = clampi(static_cast<int>(sy) + 1, 0, sh - 1);
    const float* r0 = src + static_cast<int64_t>(y0) * sw * cn;
    const float* r1 = src + static_cast<int64_t>(y1) * sw * cn;
    float* out = dst + static_cast<int64_t>(y) * dw * cn;
    for (int x = 0; x < dw; ++x) {
      const double fx = (x + 0.5) * scale_x - 0.5;
      const double sx = std::floor(fx);
      const float ax = static_cast<float>(fx - sx);
      const int x0 = clampi(static_cast<int>(sx), 0, sw - 1);
      const int x1 = clampi(static_cast<int>(sx) + 1, 0, sw - 1);
      for (int c = 0; c < cn; ++c) {
        const float a = lerp(ax, r0[x0 * cn + c], r0[x1 * cn + c]);
        const float b = lerp(ax, r1[x0 * cn + c], r1[x1 * cn + c]);
        out[x * cn + c] = lerp(ay, a, b);
      }
    }
  }
}

void rgb2hsv_f32(const float* src, float* dst, int h, int w) {
  const float eps = 1.1920928955078125e-07f;   // FLT_EPSILON
  const int vec_end = (w / HSV_BLOCK) * HSV_BLOCK;
  for (int y = 0; y < h; ++y) {
    const float* s = src + static_cast<int64_t>(y) * w * 3;
    float* d = dst + static_cast<int64_t>(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      const float r = s[3 * x], g = s[3 * x + 1], b = s[3 * x + 2];
      float v = r, vmin = r;
      if (v < g) v = g;
      if (v < b) v = b;
      if (vmin > g) vmin = g;
      if (vmin > b) vmin = b;
      const float diff = v - vmin;
      const float sat = diff / (std::fabs(v) + eps);
      const float rev = 60.0f / (diff + eps);
      float delta, offset;
      if (v == r) {
        delta = g - b;
        offset = 0.0f;
      } else if (v == g) {
        delta = b - r;
        offset = 120.0f;
      } else {
        delta = r - g;
        offset = 240.0f;
      }
      float hue;
      if (x < vec_end) {
        if (v == r && g < b) offset = 360.0f;
        hue = std::fma(delta, rev, offset);
      } else {
        hue = std::fma(delta, rev, offset);
        if (hue < 0) hue += 360.0f;
      }
      d[3 * x] = hue;
      d[3 * x + 1] = sat;
      d[3 * x + 2] = v;
    }
  }
}

void hsv2rgb_f32(const float* src, float* dst, int64_t n) {
  static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                        {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  const float hscale = 6.0f / 360.0f;
  for (int64_t i = 0; i < n; ++i) {
    float h = src[3 * i], s = src[3 * i + 1], v = src[3 * i + 2];
    float b, g, r;
    if (s == 0) {
      b = g = r = v;
    } else {
      h *= hscale;
      h = std::fmod(h, 6.0f);
      if (h < 0) h += 6.0f;
      int sector = static_cast<int>(std::floor(h));
      h -= static_cast<float>(sector);
      if (static_cast<unsigned>(sector) >= 6u) {
        sector = 0;
        h = 0.0f;
      }
      float tab[4];
      tab[0] = v;
      tab[1] = v * (1.0f - s);
      tab[2] = v * std::fma(-s, h, 1.0f);
      tab[3] = v * std::fma(-s, 1.0f - h, 1.0f);
      b = tab[sector_data[sector][0]];
      g = tab[sector_data[sector][1]];
      r = tab[sector_data[sector][2]];
    }
    dst[3 * i] = r;
    dst[3 * i + 1] = g;
    dst[3 * i + 2] = b;
  }
}

}  // extern "C"
