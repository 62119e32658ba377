// YUV 4:2:0 -> BGR24 as OpenCV's FFmpeg backend gets it from swscale
// (9.5, x86), bitwise, for the port's video decoders (`mpeg4_decode.cpp`,
// `h264_decode.cpp`): `yuv420_to_bgr` below.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace yuvbgr {

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// What OpenCV's FFmpeg backend (swscale 9.5, x86) does to turn a 4:2:0
// picture into BGR24 at the same size, SWS_BICUBIC, with the frame's
// chroma siting.  Found by holding each step to cv2's output on random
// planes of every odd height up to 23 (widths 1-8, 17, 18, 63, 64) and
// some large ones.

// The frame's chroma location, numbered as libavutil's AVChromaLocation
// (H.264's chroma_sample_loc_type + 1; MPEG-4's is left).
constexpr int kChromaUnspecified = 0, kChromaLeft = 1;

// The YUV -> RGB coefficients of swscale's table (ff_yuv2rgb_coeffs:
// crv, cbu, cgu, cgv at 16 bits) for a limited-range picture, and the
// 13-bit ones its x86 and full-chroma code derive from them
// (sws_setColorspaceDetails: roundToInt16(c * 2^13) of the 16.16 value).
struct Coeffs {
  int64_t crv, cbu, cgu, cgv;  // cgu, cgv negative
  int y, ub, ug, vg, vr;
  Coeffs(int64_t rv, int64_t bu, int64_t gu, int64_t gv) : crv(rv), cbu(bu), cgu(-gu), cgv(-gv) {
    auto r16 = [](int64_t f) { return int((f * 8192 + (1 << 15)) >> 16); };
    y = r16((int64_t(65536) * 255) / 219);
    ub = r16(cbu);
    ug = r16(cgu);
    vg = r16(cgv);
    vr = r16(crv);
  }
};
// BT.601 (MPEG-4, and H.264 unless its VUI names another matrix)
inline const Coeffs& bt601() {
  static const Coeffs c(104597, 132201, 25675, 53279);
  return c;
}
inline const Coeffs& bt709() {
  static const Coeffs c(117489, 138438, 13975, 34925);
  return c;
}

// One pixel of swscale's x86 (MMX) packed-RGB output from 8x-scaled
// luma and chroma (16-bit pmulhw arithmetic; `yuv420_to_bgr`'s
// formula with 8Y, 8U and 8V replaced by the vertical filter's sums).
inline void mmx_pixel(const Coeffs& k, int y8, int u8, int v8, uint8_t* o) {
  int yy = ((y8 - 128) * k.y) >> 16;
  int u = u8 - 1024, v = v8 - 1024;
  o[0] = clip8(yy + ((u * k.ub) >> 16));
  o[1] = clip8(yy + ((u * k.ug) >> 16) + ((v * k.vg) >> 16));
  o[2] = clip8(yy + ((v * k.vr) >> 16));
}

// A scaling filter of swscale's initFilter (libswscale/utils.c) for the
// bicubic kernel (B = 0, C = 0.6) when upscaling: `size` taps a
// destination sample, its first source sample `pos`, integer
// coefficients summing to `one`.
struct ScaleFilter {
  int size = 0;
  std::vector<int> pos;
  std::vector<int> coef;  // dst x size
};

inline int64_t rounded_div(int64_t a, int64_t b) {
  return a >= 0 ? (a + (b >> 1)) / b : (a - (b >> 1)) / b;
}

inline ScaleFilter bicubic_filter(int64_t inc, int src, int dst, int align, int one,
                           int src_pos, int dst_pos) {
  const int64_t fone = int64_t(1) << 54;  // src <= dst: av_log2(0) = 0
  const int64_t B = 0, C = int64_t(0.6 * (1 << 24));
  const double cutoff = 0.002 * double(fone);
  int fs = std::max(std::min(5, src - 2), 1);
  std::vector<int64_t> f(size_t(dst) * fs);
  std::vector<int> pos(dst);
  int64_t x_dst = ((dst_pos * inc) >> 7) - ((src_pos * int64_t(0x10000)) >> 7);
  for (int i = 0; i < dst; ++i) {
    int xx = int((x_dst - (fs - 2) * (int64_t(1) << 16)) / (1 << 17));
    pos[i] = xx;
    for (int j = 0; j < fs; ++j, ++xx) {
      int64_t d = std::llabs(int64_t(xx) * (1 << 17) - x_dst) << 13;
      int64_t c = 0;
      if (d < (int64_t(1) << 31)) {
        int64_t dd = (d * d) >> 30, ddd = (dd * d) >> 30;
        if (d < (int64_t(1) << 30))
          c = (12 * (1 << 24) - 9 * B - 6 * C) * ddd +
              (-18 * (1 << 24) + 12 * B + 6 * C) * dd +
              (6 * (1 << 24) - 2 * B) * (int64_t(1) << 30);
        else
          c = (-B - 6 * C) * ddd + (6 * B + 30 * C) * dd +
              (-12 * B - 48 * C) * d + (8 * B + 24 * C) * (int64_t(1) << 30);
      }
      f[size_t(i) * fs + j] = c;
    }
    x_dst += 2 * inc;
  }
  // drop near-zero taps: shift left, then count from the right
  int min_fs = 0;
  for (int i = dst - 1; i >= 0; --i) {
    int64_t* fi = &f[size_t(i) * fs];
    int n = fs;
    int64_t cut = 0;
    for (int j = 0; j < fs; ++j) {
      cut += std::llabs(fi[0]);
      if (double(cut) > cutoff) break;
      if (i < dst - 1 && pos[i] >= pos[i + 1]) break;
      for (int k = 1; k < fs; ++k) fi[k - 1] = fi[k];
      fi[fs - 1] = 0;
      pos[i]++;
    }
    cut = 0;
    for (int j = fs - 1; j > 0; --j) {
      cut += std::llabs(fi[j]);
      if (double(cut) > cutoff) break;
      n--;
    }
    min_fs = std::max(min_fs, n);
  }
  if (min_fs == 1 && align == 2) align = 1;
  int size = (min_fs + align - 1) & ~(align - 1);
  std::vector<int64_t> g(size_t(dst) * size, 0);
  for (int i = 0; i < dst; ++i)
    for (int j = 0; j < size && j < fs; ++j)
      g[size_t(i) * size + j] = f[size_t(i) * fs + j];
  // fold taps outside the source onto its edges
  for (int i = 0; i < dst; ++i) {
    int64_t* gi = &g[size_t(i) * size];
    if (pos[i] < 0) {
      for (int j = 1; j < size; ++j) {
        int left = std::max(j + pos[i], 0);
        gi[left] += gi[j];
        gi[j] = 0;
      }
      pos[i] = 0;
    }
    if (pos[i] + size > src) {
      int shift = pos[i] + std::min(size - src, 0);
      int64_t acc = 0;
      for (int j = size - 1; j >= 0; --j)
        if (pos[i] + j >= src) {
          acc += gi[j];
          gi[j] = 0;
        }
      for (int j = size - 1; j >= 0; --j) gi[j] = j < shift ? 0 : gi[j - shift];
      pos[i] -= shift;
      gi[src - 1 - pos[i]] += acc;
    }
  }
  ScaleFilter out;
  out.size = size;
  out.pos = pos;
  out.coef.assign(size_t(dst) * size, 0);
  for (int i = 0; i < dst; ++i) {
    const int64_t* gi = &g[size_t(i) * size];
    int64_t sum = 0, err = 0;
    for (int j = 0; j < size; ++j) sum += gi[j];
    sum = (sum + one / 2) / one;
    if (!sum) sum = 1;
    for (int j = 0; j < size; ++j) {
      int64_t v = gi[j] + err;
      int64_t iv = rounded_div(v, sum);
      out.coef[size_t(i) * size + j] = int(iv);
      err = v - iv * sum;
    }
  }
  return out;
}

// swscale's C tables for 24-bit output (ff_yuv2rgb_c_init_tables): the
// luma ramp and, per chroma value, the offsets into it.
struct RgbTables {
  uint8_t ramp[2048];
  int r_v[256], g_u[256], g_v[256], b_u[256];
  explicit RgbTables(const Coeffs& k) {
    const int64_t cy = (int64_t(65536) * 255) / 219, oy = 16 << 16;
    auto scale = [&](int64_t c) { return (c * 65536 + 0x8000) / cy; };
    int64_t crv = scale(k.crv), cbu = scale(k.cbu), cgu = scale(k.cgu),
            cgv = scale(k.cgv);
    const int yoffs = 326 + 512;
    int64_t yb = -(int64_t(384) << 16) - 512 * cy - oy;
    for (int i = 0; i < 2048; ++i, yb += cy) ramp[i] = clip8(int((yb + 0x8000) >> 16));
    for (int c = 0; c < 256; ++c) {
      r_v[c] = int(yoffs - (crv >> 9) + ((c * crv) >> 16));
      g_u[c] = int(yoffs - (cgu >> 9) + ((c * cgu) >> 16));
      g_v[c] = int(-(cgv >> 9) + ((c * cgv) >> 16));
      b_u[c] = int(yoffs - (cbu >> 9) + ((c * cbu) >> 16));
    }
  }
  void pixel(int y, int u, int v, uint8_t* o) const {
    u = u < 0 ? 0 : u > 255 ? 255 : u;
    v = v < 0 ? 0 : v > 255 ? 255 : v;
    o[0] = ramp[b_u[u] + y];
    o[1] = ramp[g_u[u] + g_v[v] + y];
    o[2] = ramp[r_v[v] + y];
  }
};

// swscale's full-chroma C output (yuv2rgb_write_full): luma and chroma
// at 2^9 per level, 32-bit wrap-around, then 30 bits clipped.
inline void full_pixel(const Coeffs& k, int y, int u, int v, uint8_t* o) {
  uint32_t yy = uint32_t((y - 8192) * k.y + (1 << 21));
  int32_t r = int32_t(yy + uint32_t(v) * uint32_t(k.vr));
  int32_t g = int32_t(yy + uint32_t(v) * uint32_t(k.vg) +
                      uint32_t(u) * uint32_t(k.ug));
  int32_t b = int32_t(yy + uint32_t(u) * uint32_t(k.ub));
  auto out = [](int32_t c) {
    return uint8_t((c < 0 ? 0 : c > (1 << 30) - 1 ? (1 << 30) - 1 : c) >> 22);
  };
  o[0] = out(b);
  o[1] = out(g);
  o[2] = out(r);
}

// swscale's scaling path, which it takes for an odd height: chroma
// scaled horizontally to the luma pairs (to every luma column when the
// width is odd) and vertically to every row by bicubic filters, at 15
// bits; then per row the packed output that the vertical filter's size
// selects, in x86 code except for the last two rows.
// `chroma_loc` gives the chroma sample's position (1/256 of a chroma
// sample: av_chroma_location_enum_to_pos), which swscale turns into the
// source offsets of its filters (get_local_pos: (pos + 128) >> 1; an
// unspecified location is taken as centred).
inline void odd_height_to_bgr(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                       int w, int h, int chroma_loc, const Coeffs& co, uint8_t* bgr) {
  const RgbTables tables(co);
  const int cw = (w + 1) / 2, ch = (h + 1) / 2;
  const bool full = (w & 1) != 0;
  const int dw = full ? w : cw;
  int xpos = 128, ypos = 128;
  if (chroma_loc >= 1 && chroma_loc <= 6) {
    const int k = chroma_loc - 1;
    xpos = (k & 1) * 128;
    ypos = ((k >> 1) ^ (k < 4)) * 128;
  }
  ScaleFilter hf = bicubic_filter(((int64_t(cw) << 16) + (dw >> 1)) / dw, cw,
                                  dw, 4, 1 << 14, (xpos + 128) >> 1, 128);
  ScaleFilter vf = bicubic_filter(((int64_t(ch) << 16) + (h >> 1)) / h, ch, h,
                                  2, 1 << 12, (ypos + 128) >> 1, 128);
  // horizontal pass: hScale8To15
  std::vector<int> u15(size_t(ch) * dw), v15(size_t(ch) * dw);
  for (int k = 0; k < ch; ++k)
    for (int x = 0; x < dw; ++x) {
      int su = 0, sv = 0;
      for (int t = 0; t < hf.size; ++t) {
        int col = hf.pos[x] + t;
        int c = hf.coef[size_t(x) * hf.size + t];
        if (col < cw && c) {
          su += u[size_t(k) * cw + col] * c;
          sv += v[size_t(k) * cw + col] * c;
        }
      }
      u15[size_t(k) * dw + x] = std::min(su >> 7, 32767);
      v15[size_t(k) * dw + x] = std::min(sv >> 7, 32767);
    }
  const int fs = vf.size;
  for (int r = 0; r < h; ++r) {
    const int* c = &vf.coef[size_t(r) * fs];
    const int k = vf.pos[r];
    auto row = [&](const std::vector<int>& p, int j) {
      return &p[size_t(std::min(k + j, ch - 1)) * dw];
    };
    // the vertical scaler's choice: one or two rows blended by `a`
    // (yuv2packed1), else the general filter (yuv2packedX)
    int a = -1;
    if (fs == 1) a = 0;
    if (fs == 2 && c[0] >= 0 && c[1] >= 0 && c[0] + c[1] == 4096) a = c[1];
    const bool mmx = !full && r < h - 2;
    const uint8_t* yr = y + size_t(r) * w;
    uint8_t* o = bgr + size_t(r) * w * 3;
    for (int x = 0; x < w; ++x) {
      const int cx = full ? x : x / 2;
      int cu, cv;  // the row's chroma, in each output's own scale
      if (a == 0) {
        cu = row(u15, 0)[cx];
        cv = row(v15, 0)[cx];
      } else if (a > 0) {
        int u0 = row(u15, 0)[cx], u1 = row(u15, 1)[cx];
        int v0 = row(v15, 0)[cx], v1 = row(v15, 1)[cx];
        if (mmx && a >= 2048) {  // paddw, psrlw 5
          cu = ((u0 + u1) & 0xFFFF) >> 5;
          cv = ((v0 + v1) & 0xFFFF) >> 5;
        } else if (mmx) {
          cu = u0 >> 4;
          cv = v0 >> 4;
        } else if (full) {
          cu = (u0 * (4096 - a) + u1 * a - (128 << 19)) >> 10;
          cv = (v0 * (4096 - a) + v1 * a - (128 << 19)) >> 10;
        } else {
          cu = (u0 * (4096 - a) + u1 * a + (1 << 18)) >> 19;
          cv = (v0 * (4096 - a) + v1 * a + (1 << 18)) >> 19;
        }
      } else {
        int su = 0, sv = 0;
        for (int j = 0; j < fs; ++j) {
          if (!c[j]) continue;
          if (mmx) {  // pmulhw a tap, vRounder 4
            su += (row(u15, j)[cx] * c[j]) >> 16;
            sv += (row(v15, j)[cx] * c[j]) >> 16;
          } else {
            su += row(u15, j)[cx] * c[j];
            sv += row(v15, j)[cx] * c[j];
          }
        }
        if (mmx) {
          cu = su + 4;
          cv = sv + 4;
        } else if (full) {
          cu = ((1 << 9) - (128 << 19) + su) >> 10;
          cv = ((1 << 9) - (128 << 19) + sv) >> 10;
        } else {
          cu = ((1 << 18) + su) >> 19;
          cv = ((1 << 18) + sv) >> 19;
        }
      }
      if (full) {
        if (a == 0) {
          cu = (cu - (128 << 7)) * 4;
          cv = (cv - (128 << 7)) * 4;
        }
        full_pixel(co, yr[x] * 512, cu, cv, o + 3 * x);
      } else if (mmx) {
        if (a == 0) {
          cu >>= 4;
          cv >>= 4;
        }
        mmx_pixel(co, 8 * yr[x] + (a < 0 ? 4 : 0), cu, cv, o + 3 * x);
      } else {
        if (a == 0) {
          cu = (cu + 64) >> 7;
          cv = (cv + 64) >> 7;
        }
        tables.pixel(yr[x], cu, cv, o + 3 * x);
      }
    }
  }
}

// 4:2:0 planes (rows w, (w+1)/2 and (w+1)/2 bytes) to BGR (h, w, 3).
// Even heights: Y' = ((8Y - 128) * 9539) >> 16, U' = 8U - 1024, V' = 8V
// - 1024, then B = Y' + (U' * 16525 >> 16), G = Y' + (U' * -3209 >> 16)
// + (V' * -6660 >> 16), R = Y' + (V' * 13075 >> 16), each clipped to
// 0..255 (the coefficients are swscale's at 13 bits, here BT.601's, its
// pmulhw arithmetic).  Odd heights: `odd_height_to_bgr`.
inline void yuv420_to_bgr(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                          int w, int h, int chroma_loc, const Coeffs& k,
                          uint8_t* bgr) {
  if (h & 1) {
    odd_height_to_bgr(y, u, v, w, h, chroma_loc, k, bgr);
    return;
  }
  int cw = (w + 1) / 2;
  int ub[256], ug[256], vg[256], vr[256], yy[256];
  for (int i = 0; i < 256; ++i) {
    int c = 8 * i - 1024;
    ub[i] = (c * k.ub) >> 16;
    ug[i] = (c * k.ug) >> 16;
    vg[i] = (c * k.vg) >> 16;
    vr[i] = (c * k.vr) >> 16;
    yy[i] = ((8 * i - 128) * k.y) >> 16;
  }
  for (int r = 0; r < h; ++r) {
    const uint8_t* yr = y + size_t(r) * w;
    const uint8_t* ur = u + size_t(r / 2) * cw;
    const uint8_t* vrow = v + size_t(r / 2) * cw;
    uint8_t* o = bgr + size_t(r) * w * 3;
    for (int x = 0; x < w; ++x) {
      int Y = yy[yr[x]], U = ur[x / 2], V = vrow[x / 2];
      o[3 * x] = clip8(Y + ub[U]);
      o[3 * x + 1] = clip8(Y + ug[U] + vg[V]);
      o[3 * x + 2] = clip8(Y + vr[V]);
    }
  }
}

}  // namespace yuvbgr
