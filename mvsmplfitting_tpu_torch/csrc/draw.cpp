// Host drawing for `viz/draw.py`: OpenCV's raster primitives on
// (H, W, 3) uint8 images, in place, in OpenCV's own integer arithmetic
// (`imgproc/src/drawing.cpp`), so that each call leaves the same bytes
// as the cv2 call it stands for:
//   * `line` (cv2.line at LINE_8 or LINE_AA, integer points): for
//     thickness 1 the 8-connected Bresenham or the anti-aliased `LineAA`
//     (slope-corrected 3-pixel filter with its end-point table); for
//     thickness > 1 `ThickLine` (a filled quadrilateral plus round
//     caps), the end points first clipped to the image grown by the
//     thickness;
//   * `fill_convex_poly` (cv2.fillConvexPoly): the outline first (Line
//     at integer points, the 16.16 fixed-point Line2 for ThickLine's
//     and the circles' polygons, or LineAA), then the scanline fill
//     between the two edge walkers;
//   * `circle` (cv2.circle): the integer midpoint circle for thin or
//     filled LINE_8 circles, otherwise a polygon from `ellipse2Poly`
//     through `EllipseEx`;
//   * `rectangle` (cv2.rectangle), `ellipse2poly` (cv2.ellipse2Poly),
//     `add_weighted` (cv2.addWeighted on uint8: float multiply-adds and
//     saturation with round-half-even);
//   * `fill_faces`: the painter's loop of the mesh overlay, one
//     anti-aliased `fill_convex_poly` per face in the given order;
//   * `blend_changed`: the overlay's float64 alpha blend where the
//     painted layer differs from the image.
//
// Built with g++ (-ffp-contract=off, so that the float64 blend rounds
// as numpy does) into a shared library and called through ctypes.
// Colors are BGR bytes; points are int32 pairs.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

typedef int64_t i64;

const int XY_SHIFT = 16;
const i64 XY_ONE = (i64)1 << XY_SHIFT;
const int LINE_AA = 16;
const int MAX_THICKNESS = 32767;

struct Img {
  uint8_t* p;
  int h, w;
  i64 step;
  uint8_t* row(i64 y) const { return p + y * step; }
};

struct Pt {
  i64 x, y;
  bool operator!=(const Pt& o) const { return x != o.x || y != o.y; }
};

inline int cv_round(double v) { return (int)std::lrint(v); }

inline void hline(const Img& im, i64 y, int x1, int x2, const uint8_t* c) {
  uint8_t* r = im.row(y);
  for (int x = x1; x <= x2; ++x) {
    r[3 * x] = c[0];
    r[3 * x + 1] = c[1];
    r[3 * x + 2] = c[2];
  }
}

inline void put(const Img& im, i64 y, i64 x, const uint8_t* c) {
  uint8_t* t = im.row(y) + 3 * x;
  t[0] = c[0];
  t[1] = c[1];
  t[2] = c[2];
}

const float kSinTable[451] = {
    0.0000000f, 0.0174524f, 0.0348995f, 0.0523360f, 0.0697565f, 0.0871557f, 0.1045285f,
    0.1218693f, 0.1391731f, 0.1564345f, 0.1736482f, 0.1908090f, 0.2079117f, 0.2249511f,
    0.2419219f, 0.2588190f, 0.2756374f, 0.2923717f, 0.3090170f, 0.3255682f, 0.3420201f,
    0.3583679f, 0.3746066f, 0.3907311f, 0.4067366f, 0.4226183f, 0.4383711f, 0.4539905f,
    0.4694716f, 0.4848096f, 0.5000000f, 0.5150381f, 0.5299193f, 0.5446390f, 0.5591929f,
    0.5735764f, 0.5877853f, 0.6018150f, 0.6156615f, 0.6293204f, 0.6427876f, 0.6560590f,
    0.6691306f, 0.6819984f, 0.6946584f, 0.7071068f, 0.7193398f, 0.7313537f, 0.7431448f,
    0.7547096f, 0.7660444f, 0.7771460f, 0.7880108f, 0.7986355f, 0.8090170f, 0.8191520f,
    0.8290376f, 0.8386706f, 0.8480481f, 0.8571673f, 0.8660254f, 0.8746197f, 0.8829476f,
    0.8910065f, 0.8987940f, 0.9063078f, 0.9135455f, 0.9205049f, 0.9271839f, 0.9335804f,
    0.9396926f, 0.9455186f, 0.9510565f, 0.9563048f, 0.9612617f, 0.9659258f, 0.9702957f,
    0.9743701f, 0.9781476f, 0.9816272f, 0.9848078f, 0.9876883f, 0.9902681f, 0.9925462f,
    0.9945219f, 0.9961947f, 0.9975641f, 0.9986295f, 0.9993908f, 0.9998477f, 1.0000000f,
    0.9998477f, 0.9993908f, 0.9986295f, 0.9975641f, 0.9961947f, 0.9945219f, 0.9925462f,
    0.9902681f, 0.9876883f, 0.9848078f, 0.9816272f, 0.9781476f, 0.9743701f, 0.9702957f,
    0.9659258f, 0.9612617f, 0.9563048f, 0.9510565f, 0.9455186f, 0.9396926f, 0.9335804f,
    0.9271839f, 0.9205049f, 0.9135455f, 0.9063078f, 0.8987940f, 0.8910065f, 0.8829476f,
    0.8746197f, 0.8660254f, 0.8571673f, 0.8480481f, 0.8386706f, 0.8290376f, 0.8191520f,
    0.8090170f, 0.7986355f, 0.7880108f, 0.7771460f, 0.7660444f, 0.7547096f, 0.7431448f,
    0.7313537f, 0.7193398f, 0.7071068f, 0.6946584f, 0.6819984f, 0.6691306f, 0.6560590f,
    0.6427876f, 0.6293204f, 0.6156615f, 0.6018150f, 0.5877853f, 0.5735764f, 0.5591929f,
    0.5446390f, 0.5299193f, 0.5150381f, 0.5000000f, 0.4848096f, 0.4694716f, 0.4539905f,
    0.4383711f, 0.4226183f, 0.4067366f, 0.3907311f, 0.3746066f, 0.3583679f, 0.3420201f,
    0.3255682f, 0.3090170f, 0.2923717f, 0.2756374f, 0.2588190f, 0.2419219f, 0.2249511f,
    0.2079117f, 0.1908090f, 0.1736482f, 0.1564345f, 0.1391731f, 0.1218693f, 0.1045285f,
    0.0871557f, 0.0697565f, 0.0523360f, 0.0348995f, 0.0174524f, 0.0000000f, -0.0174524f,
    -0.0348995f, -0.0523360f, -0.0697565f, -0.0871557f, -0.1045285f, -0.1218693f, -0.1391731f,
    -0.1564345f, -0.1736482f, -0.1908090f, -0.2079117f, -0.2249511f, -0.2419219f, -0.2588190f,
    -0.2756374f, -0.2923717f, -0.3090170f, -0.3255682f, -0.3420201f, -0.3583679f, -0.3746066f,
    -0.3907311f, -0.4067366f, -0.4226183f, -0.4383711f, -0.4539905f, -0.4694716f, -0.4848096f,
    -0.5000000f, -0.5150381f, -0.5299193f, -0.5446390f, -0.5591929f, -0.5735764f, -0.5877853f,
    -0.6018150f, -0.6156615f, -0.6293204f, -0.6427876f, -0.6560590f, -0.6691306f, -0.6819984f,
    -0.6946584f, -0.7071068f, -0.7193398f, -0.7313537f, -0.7431448f, -0.7547096f, -0.7660444f,
    -0.7771460f, -0.7880108f, -0.7986355f, -0.8090170f, -0.8191520f, -0.8290376f, -0.8386706f,
    -0.8480481f, -0.8571673f, -0.8660254f, -0.8746197f, -0.8829476f, -0.8910065f, -0.8987940f,
    -0.9063078f, -0.9135455f, -0.9205049f, -0.9271839f, -0.9335804f, -0.9396926f, -0.9455186f,
    -0.9510565f, -0.9563048f, -0.9612617f, -0.9659258f, -0.9702957f, -0.9743701f, -0.9781476f,
    -0.9816272f, -0.9848078f, -0.9876883f, -0.9902681f, -0.9925462f, -0.9945219f, -0.9961947f,
    -0.9975641f, -0.9986295f, -0.9993908f, -0.9998477f, -1.0000000f, -0.9998477f, -0.9993908f,
    -0.9986295f, -0.9975641f, -0.9961947f, -0.9945219f, -0.9925462f, -0.9902681f, -0.9876883f,
    -0.9848078f, -0.9816272f, -0.9781476f, -0.9743701f, -0.9702957f, -0.9659258f, -0.9612617f,
    -0.9563048f, -0.9510565f, -0.9455186f, -0.9396926f, -0.9335804f, -0.9271839f, -0.9205049f,
    -0.9135455f, -0.9063078f, -0.8987940f, -0.8910065f, -0.8829476f, -0.8746197f, -0.8660254f,
    -0.8571673f, -0.8480481f, -0.8386706f, -0.8290376f, -0.8191520f, -0.8090170f, -0.7986355f,
    -0.7880108f, -0.7771460f, -0.7660444f, -0.7547096f, -0.7431448f, -0.7313537f, -0.7193398f,
    -0.7071068f, -0.6946584f, -0.6819984f, -0.6691306f, -0.6560590f, -0.6427876f, -0.6293204f,
    -0.6156615f, -0.6018150f, -0.5877853f, -0.5735764f, -0.5591929f, -0.5446390f, -0.5299193f,
    -0.5150381f, -0.5000000f, -0.4848096f, -0.4694716f, -0.4539905f, -0.4383711f, -0.4226183f,
    -0.4067366f, -0.3907311f, -0.3746066f, -0.3583679f, -0.3420201f, -0.3255682f, -0.3090170f,
    -0.2923717f, -0.2756374f, -0.2588190f, -0.2419219f, -0.2249511f, -0.2079117f, -0.1908090f,
    -0.1736482f, -0.1564345f, -0.1391731f, -0.1218693f, -0.1045285f, -0.0871557f, -0.0697565f,
    -0.0523360f, -0.0348995f, -0.0174524f, 0.0000000f, 0.0174524f, 0.0348995f, 0.0523360f,
    0.0697565f, 0.0871557f, 0.1045285f, 0.1218693f, 0.1391731f, 0.1564345f, 0.1736482f,
    0.1908090f, 0.2079117f, 0.2249511f, 0.2419219f, 0.2588190f, 0.2756374f, 0.2923717f,
    0.3090170f, 0.3255682f, 0.3420201f, 0.3583679f, 0.3746066f, 0.3907311f, 0.4067366f,
    0.4226183f, 0.4383711f, 0.4539905f, 0.4694716f, 0.4848096f, 0.5000000f, 0.5150381f,
    0.5299193f, 0.5446390f, 0.5591929f, 0.5735764f, 0.5877853f, 0.6018150f, 0.6156615f,
    0.6293204f, 0.6427876f, 0.6560590f, 0.6691306f, 0.6819984f, 0.6946584f, 0.7071068f,
    0.7193398f, 0.7313537f, 0.7431448f, 0.7547096f, 0.7660444f, 0.7771460f, 0.7880108f,
    0.7986355f, 0.8090170f, 0.8191520f, 0.8290376f, 0.8386706f, 0.8480481f, 0.8571673f,
    0.8660254f, 0.8746197f, 0.8829476f, 0.8910065f, 0.8987940f, 0.9063078f, 0.9135455f,
    0.9205049f, 0.9271839f, 0.9335804f, 0.9396926f, 0.9455186f, 0.9510565f, 0.9563048f,
    0.9612617f, 0.9659258f, 0.9702957f, 0.9743701f, 0.9781476f, 0.9816272f, 0.9848078f,
    0.9876883f, 0.9902681f, 0.9925462f, 0.9945219f, 0.9961947f, 0.9975641f, 0.9986295f,
    0.9993908f, 0.9998477f, 1.0000000f,};

const int kSlopeCorrTable[] = {
    181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196, 198, 201,
    203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238, 242, 246, 250, 254};

const int kFilterTable[] = {
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252, 254, 254,
    254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202, 194, 185, 177, 168,
    158, 149, 140, 131, 122, 114, 105, 97,  89,  82,  75,  68,  62,  56,  50,  45,
    40,  36,  32,  28,  25,  22,  19,  16,  14,  12,  11,  9,   8,   7,   5,   5};

// Cohen-Sutherland clipping to [0, w-1] x [0, h-1] (clipLine).
bool clip_line(i64 w, i64 h, Pt& p1, Pt& p2) {
  if (w <= 0 || h <= 0) return false;
  i64 right = w - 1, bottom = h - 1;
  i64 &x1 = p1.x, &y1 = p1.y, &x2 = p2.x, &y2 = p2.y;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    i64 a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (i64)((double)(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (i64)((double)(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (i64)((double)(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (i64)((double)(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// 8-connected Bresenham between integer points, left to right
// (Line/LineIterator).
void line_int(const Img& im, Pt p1, Pt p2, const uint8_t* c) {
  if ((uint64_t)p1.x >= (uint64_t)im.w || (uint64_t)p2.x >= (uint64_t)im.w ||
      (uint64_t)p1.y >= (uint64_t)im.h || (uint64_t)p2.y >= (uint64_t)im.h) {
    // The int overload of clipLine: coordinates are int there.
    p1 = {(int)p1.x, (int)p1.y};
    p2 = {(int)p2.x, (int)p2.y};
    if (!clip_line(im.w, im.h, p1, p2)) return;
    p1 = {(int)p1.x, (int)p1.y};
    p2 = {(int)p2.x, (int)p2.y};
  }
  int dx = (int)(p2.x - p1.x), dy = (int)(p2.y - p1.y);
  int delta_x = 1, delta_y = 1;
  if (dx < 0) {
    dx = -dx;
    dy = -dy;
    std::swap(p1, p2);
  }
  if (dy < 0) {
    dy = -dy;
    delta_y = -1;
  }
  bool vert = dy > dx;
  if (vert) {
    std::swap(dx, dy);
    std::swap(delta_x, delta_y);
  }
  int err = dx - (dy + dy), plus_delta = dx + dx, minus_delta = -(dy + dy);
  int minus_shift = delta_x, plus_shift = 0, minus_step = 0,
      plus_step = delta_y, count = dx + 1;
  if (vert) {
    std::swap(plus_step, plus_shift);
    std::swap(minus_step, minus_shift);
  }
  i64 x = p1.x, y = p1.y;
  for (int i = 0; i < count; ++i) {
    put(im, y, x, c);
    int mask = err < 0 ? -1 : 0;
    err += minus_delta + (plus_delta & mask);
    x += minus_shift + (plus_shift & mask);
    y += minus_step + (plus_step & mask);
  }
}

// 8-connected line between 16.16 fixed-point points (Line2): the
// outline of fill_convex's LINE_8 polygons at XY_SHIFT.
void line2(const Img& im, Pt pt1, Pt pt2, const uint8_t* c) {
  if (!clip_line((i64)im.w << XY_SHIFT, (i64)im.h << XY_SHIFT, pt1, pt2))
    return;
  i64 dx = pt2.x - pt1.x, dy = pt2.y - pt1.y;
  i64 j = dx < 0 ? -1 : 0;
  i64 ax = (dx ^ j) - j;
  i64 i = dy < 0 ? -1 : 0;
  i64 ay = (dy ^ i) - i;
  i64 x_step, y_step;
  int ecount;
  if (ax > ay) {
    dy = (dy ^ j) - j;
    pt1.x ^= pt2.x & j;
    pt2.x ^= pt1.x & j;
    pt1.x ^= pt2.x & j;
    pt1.y ^= pt2.y & j;
    pt2.y ^= pt1.y & j;
    pt1.y ^= pt2.y & j;
    x_step = XY_ONE;
    y_step = (dy * XY_ONE) / (ax | 1);
    ecount = (int)((pt2.x - pt1.x) >> XY_SHIFT);
  } else {
    dx = (dx ^ i) - i;
    pt1.x ^= pt2.x & i;
    pt2.x ^= pt1.x & i;
    pt1.x ^= pt2.x & i;
    pt1.y ^= pt2.y & i;
    pt2.y ^= pt1.y & i;
    pt1.y ^= pt2.y & i;
    x_step = (dx * XY_ONE) / (ay | 1);
    y_step = XY_ONE;
    ecount = (int)((pt2.y - pt1.y) >> XY_SHIFT);
  }
  pt1.x += XY_ONE >> 1;
  pt1.y += XY_ONE >> 1;
  auto plot = [&](int x, int y) {
    if (0 <= x && x < im.w && 0 <= y && y < im.h) put(im, y, x, c);
  };
  plot((int)((pt2.x + (XY_ONE >> 1)) >> XY_SHIFT),
       (int)((pt2.y + (XY_ONE >> 1)) >> XY_SHIFT));
  if (ax > ay) {
    pt1.x >>= XY_SHIFT;
    while (ecount >= 0) {
      plot((int)pt1.x, (int)(pt1.y >> XY_SHIFT));
      pt1.x++;
      pt1.y += y_step;
      ecount--;
    }
  } else {
    pt1.y >>= XY_SHIFT;
    while (ecount >= 0) {
      plot((int)(pt1.x >> XY_SHIFT), (int)pt1.y);
      pt1.x += x_step;
      pt1.y++;
      ecount--;
    }
  }
}

inline void blend_aa(const Img& im, i64 x, i64 y, int a, const uint8_t* c) {
  uint8_t* t = im.row(y) + 3 * x;
  for (int k = 0; k < 3; ++k) {
    // OpenCV applies the 3-channel blend twice.
    int v = t[k];
    v += ((c[k] - v) * a + 127) >> 8;
    v += ((c[k] - v) * a + 127) >> 8;
    t[k] = (uint8_t)v;
  }
}

// Anti-aliased line between 16.16 fixed-point points (LineAA).
void line_aa(const Img& im, Pt pt1, Pt pt2, const uint8_t* c) {
  i64 W = im.w, H = im.h;
  if (!clip_line(W << XY_SHIFT, H << XY_SHIFT, pt1, pt2)) return;
  i64 dx = pt2.x - pt1.x, dy = pt2.y - pt1.y;
  i64 j = dx < 0 ? -1 : 0;
  i64 ax = (dx ^ j) - j;
  i64 i = dy < 0 ? -1 : 0;
  i64 ay = (dy ^ i) - i;
  i64 x_step, y_step;
  int ecount, scount = 0, slope;
  if (ax > ay) {
    dy = (dy ^ j) - j;
    pt1.x ^= pt2.x & j;
    pt2.x ^= pt1.x & j;
    pt1.x ^= pt2.x & j;
    pt1.y ^= pt2.y & j;
    pt2.y ^= pt1.y & j;
    pt1.y ^= pt2.y & j;
    x_step = XY_ONE;
    y_step = (dy * XY_ONE) / (ax | 1);
    pt2.x += XY_ONE;
    ecount = (int)((pt2.x >> XY_SHIFT) - (pt1.x >> XY_SHIFT));
    j = -(pt1.x & (XY_ONE - 1));
    pt1.y += ((y_step * j) >> XY_SHIFT) + (XY_ONE >> 1);
    slope = (int)((y_step >> (XY_SHIFT - 5)) & 0x3f);
    slope ^= (y_step < 0 ? 0x3f : 0);
    i = (pt1.x >> (XY_SHIFT - 7)) & 0x78;
    j = (pt2.x >> (XY_SHIFT - 7)) & 0x78;
  } else {
    dx = (dx ^ i) - i;
    pt1.x ^= pt2.x & i;
    pt2.x ^= pt1.x & i;
    pt1.x ^= pt2.x & i;
    pt1.y ^= pt2.y & i;
    pt2.y ^= pt1.y & i;
    pt1.y ^= pt2.y & i;
    x_step = (dx * XY_ONE) / (ay | 1);
    y_step = XY_ONE;
    pt2.y += XY_ONE;
    ecount = (int)((pt2.y >> XY_SHIFT) - (pt1.y >> XY_SHIFT));
    j = -(pt1.y & (XY_ONE - 1));
    pt1.x += ((x_step * j) >> XY_SHIFT) + (XY_ONE >> 1);
    slope = (int)((x_step >> (XY_SHIFT - 5)) & 0x3f);
    slope ^= (x_step < 0 ? 0x3f : 0);
    i = (pt1.y >> (XY_SHIFT - 7)) & 0x78;
    j = (pt2.y >> (XY_SHIFT - 7)) & 0x78;
  }
  slope = (slope & 0x20) ? 0x100 : kSlopeCorrTable[slope];
  int ep_table[9];
  {
    int t0 = slope << 7;
    int t1 = ((0x78 - (int)i) | 4) * slope;
    int t2 = ((int)j | 4) * slope;
    ep_table[0] = 0;
    ep_table[8] = slope;
    ep_table[1] = ep_table[3] = ((((int)(j - i) & 0x78) | 4) * slope >> 8) & 0x1ff;
    ep_table[2] = (t1 >> 8) & 0x1ff;
    ep_table[4] = ((((int)(j - i) + 0x80) | 4) * slope >> 8) & 0x1ff;
    ep_table[5] = ((t1 + t0) >> 8) & 0x1ff;
    ep_table[6] = (t2 >> 8) & 0x1ff;
    ep_table[7] = ((t2 + t0) >> 8) & 0x1ff;
  }
  if (ax > ay) {
    int x = (int)(pt1.x >> XY_SHIFT);
    for (; ecount >= 0; x++, pt1.y += y_step, scount++, ecount--) {
      if ((unsigned)x >= (unsigned)W) continue;
      int y = (int)((pt1.y >> XY_SHIFT) - 1);
      int ep_corr = ep_table[(((scount >= 2) + 1) & (scount | 2)) * 3 +
                             (((ecount >= 2) + 1) & (ecount | 2))];
      int dist = (int)((pt1.y >> (XY_SHIFT - 5)) & 31);
      int a = (ep_corr * kFilterTable[dist + 32] >> 8) & 0xff;
      if ((unsigned)y < (unsigned)H) blend_aa(im, x, y, a, c);
      a = (ep_corr * kFilterTable[dist] >> 8) & 0xff;
      if ((unsigned)(y + 1) < (unsigned)H) blend_aa(im, x, y + 1, a, c);
      a = (ep_corr * kFilterTable[63 - dist] >> 8) & 0xff;
      if ((unsigned)(y + 2) < (unsigned)H) blend_aa(im, x, y + 2, a, c);
    }
  } else {
    int y = (int)(pt1.y >> XY_SHIFT);
    for (; ecount >= 0; y++, pt1.x += x_step, scount++, ecount--) {
      if ((unsigned)y >= (unsigned)H) continue;
      int x = (int)((pt1.x >> XY_SHIFT) - 1);
      int ep_corr = ep_table[(((scount >= 2) + 1) & (scount | 2)) * 3 +
                             (((ecount >= 2) + 1) & (ecount | 2))];
      int dist = (int)((pt1.x >> (XY_SHIFT - 5)) & 31);
      int a = (ep_corr * kFilterTable[dist + 32] >> 8) & 0xff;
      if ((unsigned)x < (unsigned)W) blend_aa(im, x, y, a, c);
      a = (ep_corr * kFilterTable[dist] >> 8) & 0xff;
      if ((unsigned)(x + 1) < (unsigned)W) blend_aa(im, x + 1, y, a, c);
      a = (ep_corr * kFilterTable[63 - dist] >> 8) & 0xff;
      if ((unsigned)(x + 2) < (unsigned)W) blend_aa(im, x + 2, y, a, c);
    }
  }
}

// Convex polygon fill, outline first (FillConvexPoly).  `shift` is 0 for
// the caller's integer points or XY_SHIFT for the 16.16 points of
// ThickLine's quadrilaterals and the circles' polygons.
void fill_convex(const Img& im, const Pt* v, int npts, const uint8_t* c,
                 int line_type, int shift) {
  struct {
    int idx, di;
    i64 x, dx;
    int ye;
  } edge[2];
  int delta = 1 << shift >> 1;
  int i, y, imin = 0;
  int edges = npts;
  i64 xmin, xmax, ymin, ymax;
  int delta1, delta2;
  if (line_type < LINE_AA)
    delta1 = delta2 = XY_ONE >> 1;
  else
    delta1 = XY_ONE - 1, delta2 = 0;
  Pt p0 = v[npts - 1];
  p0.x <<= XY_SHIFT - shift;
  p0.y <<= XY_SHIFT - shift;
  xmin = xmax = v[0].x;
  ymin = ymax = v[0].y;
  for (i = 0; i < npts; i++) {
    Pt p = v[i];
    if (p.y < ymin) {
      ymin = p.y;
      imin = i;
    }
    ymax = std::max(ymax, p.y);
    xmax = std::max(xmax, p.x);
    xmin = std::min(xmin, p.x);
    p.x <<= XY_SHIFT - shift;
    p.y <<= XY_SHIFT - shift;
    if (line_type < LINE_AA) {
      if (shift == 0)
        line_int(im, {p0.x >> XY_SHIFT, p0.y >> XY_SHIFT},
                 {p.x >> XY_SHIFT, p.y >> XY_SHIFT}, c);
      else
        line2(im, p0, p, c);
    } else {
      line_aa(im, p0, p, c);
    }
    p0 = p;
  }
  xmin = (xmin + delta) >> shift;
  xmax = (xmax + delta) >> shift;
  ymin = (ymin + delta) >> shift;
  ymax = (ymax + delta) >> shift;
  if (npts < 3 || (int)xmax < 0 || (int)ymax < 0 || (int)xmin >= im.w ||
      (int)ymin >= im.h)
    return;
  ymax = std::min<i64>(ymax, im.h - 1);
  edge[0].idx = edge[1].idx = imin;
  edge[0].ye = edge[1].ye = y = (int)ymin;
  edge[0].di = 1;
  edge[1].di = npts - 1;
  edge[0].x = edge[1].x = -XY_ONE;
  edge[0].dx = edge[1].dx = 0;
  do {
    if (line_type < LINE_AA || y < (int)ymax || y == (int)ymin) {
      for (i = 0; i < 2; i++) {
        if (y >= edge[i].ye) {
          int idx0 = edge[i].idx, di = edge[i].di;
          int idx = idx0 + di;
          if (idx >= npts) idx -= npts;
          int ty = 0;
          for (; edges-- > 0;) {
            ty = (int)((v[idx].y + delta) >> shift);
            if (ty > y) {
              i64 xs = v[idx0].x;
              i64 xe = v[idx].x;
              if (shift != XY_SHIFT) {
                xs <<= XY_SHIFT - shift;
                xe <<= XY_SHIFT - shift;
              }
              edge[i].ye = ty;
              edge[i].dx = ((xe - xs) * 2 + ((i64)ty - y)) / (2 * ((i64)ty - y));
              edge[i].x = xs;
              edge[i].idx = idx;
              break;
            }
            idx0 = idx;
            idx += di;
            if (idx >= npts) idx -= npts;
          }
        }
      }
    }
    if (edges < 0) break;
    if (y >= 0) {
      int left = 0, right = 1;
      if (edge[0].x > edge[1].x) left = 1, right = 0;
      int xx1 = (int)((edge[left].x + delta1) >> XY_SHIFT);
      int xx2 = (int)((edge[right].x + delta2) >> XY_SHIFT);
      if (xx2 >= 0 && xx1 < im.w) {
        if (xx1 < 0) xx1 = 0;
        if (xx2 >= im.w) xx2 = im.w - 1;
        hline(im, y, xx1, xx2, c);
      }
    }
    edge[0].x += edge[0].dx;
    edge[1].x += edge[1].dx;
  } while (++y <= (int)ymax);
}

// Integer midpoint circle, thin or filled (Circle).
void circle_int(const Img& im, int cx, int cy, int radius, const uint8_t* c,
                int fill) {
  int W = im.w, H = im.h;
  int err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
  int inside = cx >= radius && cx < W - radius && cy >= radius &&
               cy < H - radius;
  while (dx >= dy) {
    int mask;
    int y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
    int x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
    if (inside) {
      if (!fill) {
        put(im, y11, x11, c);
        put(im, y12, x11, c);
        put(im, y11, x12, c);
        put(im, y12, x12, c);
        put(im, y21, x21, c);
        put(im, y22, x21, c);
        put(im, y21, x22, c);
        put(im, y22, x22, c);
      } else {
        hline(im, y11, x11, x12, c);
        hline(im, y12, x11, x12, c);
        hline(im, y21, x21, x22, c);
        hline(im, y22, x21, x22, c);
      }
    } else if (x11 < W && x12 >= 0 && y21 < H && y22 >= 0) {
      if (fill) {
        x11 = std::max(x11, 0);
        x12 = std::min(x12, W - 1);
      }
      if ((unsigned)y11 < (unsigned)H) {
        if (!fill) {
          if (x11 >= 0) put(im, y11, x11, c);
          if (x12 < W) put(im, y11, x12, c);
        } else {
          hline(im, y11, x11, x12, c);
        }
      }
      if ((unsigned)y12 < (unsigned)H) {
        if (!fill) {
          if (x11 >= 0) put(im, y12, x11, c);
          if (x12 < W) put(im, y12, x12, c);
        } else {
          hline(im, y12, x11, x12, c);
        }
      }
      if (x21 < W && x22 >= 0) {
        if (fill) {
          x21 = std::max(x21, 0);
          x22 = std::min(x22, W - 1);
        }
        if ((unsigned)y21 < (unsigned)H) {
          if (!fill) {
            if (x21 >= 0) put(im, y21, x21, c);
            if (x22 < W) put(im, y21, x22, c);
          } else {
            hline(im, y21, x21, x22, c);
          }
        }
        if ((unsigned)y22 < (unsigned)H) {
          if (!fill) {
            if (x21 >= 0) put(im, y22, x21, c);
            if (x22 < W) put(im, y22, x22, c);
          } else {
            hline(im, y22, x21, x22, c);
          }
        }
      }
    }
    dy++;
    err += plus;
    plus += 2;
    mask = (err <= 0) - 1;
    err -= minus & mask;
    dx += mask;
    minus -= mask & 2;
  }
}

// The double-precision ellipse2Poly.
void ellipse_poly_d(double cx, double cy, double aw, double ah, int angle,
                    int arc_start, int arc_end, int delta,
                    std::vector<double>& pts) {
  while (angle < 0) angle += 360;
  while (angle > 360) angle -= 360;
  if (arc_start > arc_end) std::swap(arc_start, arc_end);
  while (arc_start < 0) {
    arc_start += 360;
    arc_end += 360;
  }
  while (arc_end > 360) {
    arc_end -= 360;
    arc_start -= 360;
  }
  if (arc_end - arc_start > 360) {
    arc_start = 0;
    arc_end = 360;
  }
  int a0 = angle + (angle < 0 ? 360 : 0);
  float beta = kSinTable[a0];
  float alpha = kSinTable[450 - a0];
  pts.clear();
  for (int i = arc_start; i < arc_end + delta; i += delta) {
    int ang = i;
    if (ang > arc_end) ang = arc_end;
    if (ang < 0) ang += 360;
    double x = aw * kSinTable[450 - ang];
    double y = ah * kSinTable[ang];
    pts.push_back(cx + x * alpha - y * beta);
    pts.push_back(cy + x * beta + y * alpha);
  }
  if (pts.size() == 2) {
    pts.assign({cx, cy, cx, cy});
  }
}

void thick_line(const Img& im, Pt p0, Pt p1, const uint8_t* c, int thickness,
                int line_type, int flags, int shift);

void ellipse_ex(const Img& im, Pt center, Pt axes, int angle, int arc_start,
                int arc_end, const uint8_t* c, int thickness, int line_type) {
  axes.x = std::abs(axes.x), axes.y = std::abs(axes.y);
  int delta = (int)((std::max(axes.x, axes.y) + (XY_ONE >> 1)) >> XY_SHIFT);
  delta = delta < 3 ? 90 : delta < 10 ? 30 : delta < 15 ? 18 : 5;
  std::vector<double> d;
  ellipse_poly_d((double)center.x, (double)center.y, (double)axes.x,
                 (double)axes.y, angle, arc_start, arc_end, delta, d);
  std::vector<Pt> v;
  Pt prev{(i64)0xFFFFFFFFFFFFFFFFULL, (i64)0xFFFFFFFFFFFFFFFFULL};
  for (size_t k = 0; k < d.size(); k += 2) {
    Pt pt;
    pt.x = (i64)cv_round(d[k] / XY_ONE) << XY_SHIFT;
    pt.y = (i64)cv_round(d[k + 1] / XY_ONE) << XY_SHIFT;
    pt.x += cv_round(d[k] - pt.x);
    pt.y += cv_round(d[k + 1] - pt.y);
    if (pt != prev) {
      v.push_back(pt);
      prev = pt;
    }
  }
  if (v.size() == 1) v.assign(2, center);
  if (thickness >= 0) {
    // PolyLine, open.
    int flags = 3;
    Pt q0 = v[0];
    for (size_t k = 1; k < v.size(); ++k) {
      thick_line(im, q0, v[k], c, thickness, line_type, flags, XY_SHIFT);
      q0 = v[k];
      flags = 2;
    }
  } else {
    // Only full ellipses are drawn filled here.
    fill_convex(im, v.data(), (int)v.size(), c, line_type, XY_SHIFT);
  }
}

void thick_line(const Img& im, Pt p0, Pt p1, const uint8_t* c, int thickness,
                int line_type, int flags, int shift) {
  const double INV_XY_ONE = 1. / XY_ONE;
  p0.x <<= XY_SHIFT - shift;
  p0.y <<= XY_SHIFT - shift;
  p1.x <<= XY_SHIFT - shift;
  p1.y <<= XY_SHIFT - shift;
  if (thickness <= 1) {
    if (line_type < LINE_AA) {
      // A thin LINE_8 line comes only from integer points (line,
      // rectangle): the rounded end points, integer Bresenham.
      p0.x = (p0.x + (XY_ONE >> 1)) >> XY_SHIFT;
      p0.y = (p0.y + (XY_ONE >> 1)) >> XY_SHIFT;
      p1.x = (p1.x + (XY_ONE >> 1)) >> XY_SHIFT;
      p1.y = (p1.y + (XY_ONE >> 1)) >> XY_SHIFT;
      line_int(im, p0, p1, c);
    } else {
      line_aa(im, p0, p1, c);
    }
    return;
  }
  Pt pt[4], dp{0, 0};
  double dx = (p0.x - p1.x) * INV_XY_ONE, dy = (p1.y - p0.y) * INV_XY_ONE;
  double r = dx * dx + dy * dy;
  int odd = thickness & 1;
  thickness <<= XY_SHIFT - 1;
  if (std::fabs(r) > 2.220446049250313e-16) {
    r = (thickness + odd * XY_ONE * 0.5) / std::sqrt(r);
    dp.x = cv_round(dy * r);
    dp.y = cv_round(dx * r);
    pt[0] = {p0.x + dp.x, p0.y + dp.y};
    pt[1] = {p0.x - dp.x, p0.y - dp.y};
    pt[2] = {p1.x - dp.x, p1.y - dp.y};
    pt[3] = {p1.x + dp.x, p1.y + dp.y};
    fill_convex(im, pt, 4, c, line_type, XY_SHIFT);
  }
  for (int k = 0; k < 2; k++) {
    if (flags & (k + 1)) {
      if (line_type < LINE_AA) {
        int ccx = (int)((p0.x + (XY_ONE >> 1)) >> XY_SHIFT);
        int ccy = (int)((p0.y + (XY_ONE >> 1)) >> XY_SHIFT);
        circle_int(im, ccx, ccy, (int)((thickness + (XY_ONE >> 1)) >> XY_SHIFT),
                   c, 1);
      } else {
        ellipse_ex(im, p0, {thickness, thickness}, 0, 0, 360, c, -1,
                   line_type);
      }
    }
    p0 = p1;
  }
}

inline uint8_t sat_u8(double v) {
  int r = cv_round(v);
  return (uint8_t)std::min(255, std::max(0, r));
}

}  // namespace

extern "C" {

// cv2.line(img, p1, p2, color, thickness, line_type).
void draw_line(uint8_t* img, int h, int w, int x1, int y1, int x2, int y2,
               const uint8_t* color, int thickness, int line_type) {
  Img im{img, h, w, (i64)w * 3};
  Pt p1{x1, y1}, p2{x2, y2};
  if (thickness > 1) {
    // cv::line first clips a thick line to the image grown by the
    // thickness on every side.
    p1 = {p1.x + thickness, p1.y + thickness};
    p2 = {p2.x + thickness, p2.y + thickness};
    if (!clip_line((i64)w + 2 * thickness, (i64)h + 2 * thickness, p1, p2))
      return;
    p1 = {p1.x - thickness, p1.y - thickness};
    p2 = {p2.x - thickness, p2.y - thickness};
  }
  thick_line(im, p1, p2, color, thickness, line_type, 3, 0);
}

// cv2.fillConvexPoly(img, pts (n, 2) int32, color, line_type).
void draw_fill_convex_poly(uint8_t* img, int h, int w, const int32_t* pts,
                           int n, const uint8_t* color, int line_type) {
  if (n <= 0) return;
  Img im{img, h, w, (i64)w * 3};
  std::vector<Pt> v(n);
  for (int k = 0; k < n; ++k) v[k] = {pts[2 * k], pts[2 * k + 1]};
  fill_convex(im, v.data(), n, color, line_type, 0);
}

// cv2.circle(img, center, radius, color, thickness, line_type).
void draw_circle(uint8_t* img, int h, int w, int cx, int cy, int radius,
                 const uint8_t* color, int thickness, int line_type) {
  Img im{img, h, w, (i64)w * 3};
  if (thickness > 1 || line_type != 8) {
    Pt center{(i64)cx << XY_SHIFT, (i64)cy << XY_SHIFT};
    i64 r = (i64)radius << XY_SHIFT;
    ellipse_ex(im, center, {r, r}, 0, 0, 360, color, thickness, line_type);
  } else {
    circle_int(im, cx, cy, radius, color, thickness < 0);
  }
}

// cv2.rectangle(img, p1, p2, color, thickness, line_type).
void draw_rectangle(uint8_t* img, int h, int w, int x1, int y1, int x2,
                    int y2, const uint8_t* color, int thickness,
                    int line_type) {
  Img im{img, h, w, (i64)w * 3};
  Pt pt[4] = {{x1, y1}, {x2, y1}, {x2, y2}, {x1, y2}};
  if (thickness >= 0) {
    // PolyLine, closed.
    Pt p0 = pt[3];
    for (int k = 0; k < 4; ++k) {
      thick_line(im, p0, pt[k], color, thickness, line_type, 2, 0);
      p0 = pt[k];
    }
  } else {
    fill_convex(im, pt, 4, color, line_type, 0);
  }
}

// cv2.ellipse2Poly(center, axes, angle, arc_start, arc_end, delta): the
// points into `out` (room for `cap` pairs); returns their count.
int draw_ellipse2poly(int cx, int cy, int aw, int ah, int angle,
                      int arc_start, int arc_end, int delta, int32_t* out,
                      int cap) {
  std::vector<double> d;
  ellipse_poly_d(cx, cy, aw, ah, angle, arc_start, arc_end, delta, d);
  int n = 0;
  int px = INT32_MIN, py = INT32_MIN;
  for (size_t k = 0; k < d.size(); k += 2) {
    int x = cv_round(d[k]), y = cv_round(d[k + 1]);
    if (x != px || y != py) {
      if (n < cap) {
        out[2 * n] = x;
        out[2 * n + 1] = y;
      }
      n++;
      px = x;
      py = y;
    }
  }
  if (n == 1 && cap >= 2) {
    out[0] = out[2] = cx;
    out[1] = out[3] = cy;
    n = 2;
  }
  return n;
}

// cv2.addWeighted(src1, alpha, src2, beta, gamma) on uint8 data of n
// values: fma(a, alpha, fma(b, beta, gamma)) in float, rounded half to
// even and saturated.
void draw_add_weighted(const uint8_t* src1, double alpha,
                       const uint8_t* src2, double beta, double gamma,
                       uint8_t* dst, int64_t n) {
  float fa = (float)alpha, fb = (float)beta, fg = (float)gamma;
  for (int64_t k = 0; k < n; ++k) {
    float v = std::fma((float)src1[k], fa, std::fma((float)src2[k], fb, fg));
    int r = (int)std::lrint(v);
    dst[k] = (uint8_t)std::min(255, std::max(0, r));
  }
}

// The overlay's painter's loop: for each face index in `order`, the
// anti-aliased fillConvexPoly of its three points `pts[f]` in the color
// (int(c) for c in colors[f]) on `layer`.
void draw_fill_faces(uint8_t* layer, int h, int w, const int32_t* pts,
                     const double* colors, const int64_t* order,
                     int64_t n_order) {
  Img im{layer, h, w, (i64)w * 3};
  for (int64_t k = 0; k < n_order; ++k) {
    int64_t f = order[k];
    const int32_t* p = pts + 6 * f;
    Pt v[3] = {{p[0], p[1]}, {p[2], p[3]}, {p[4], p[5]}};
    uint8_t c[3];
    for (int q = 0; q < 3; ++q) c[q] = sat_u8((double)(int64_t)colors[3 * f + q]);
    fill_convex(im, v, 3, c, LINE_AA, 0);
  }
}

// The overlay's blend: where any channel of `layer` differs from `img`,
// out = uint8(alpha * layer + (1 - alpha) * img) in float64 (truncated,
// as numpy's astype); elsewhere out = img.
void draw_blend_changed(const uint8_t* img, const uint8_t* layer,
                        double alpha, uint8_t* out, int64_t n_pixels) {
  double beta = 1.0 - alpha;
  for (int64_t k = 0; k < n_pixels; ++k) {
    const uint8_t* a = img + 3 * k;
    const uint8_t* l = layer + 3 * k;
    uint8_t* o = out + 3 * k;
    if (a[0] != l[0] || a[1] != l[1] || a[2] != l[2]) {
      for (int q = 0; q < 3; ++q) {
        double v = alpha * (double)l[q] + beta * (double)a[q];
        o[q] = (uint8_t)(int)v;
      }
    } else {
      o[0] = a[0];
      o[1] = a[1];
      o[2] = a[2];
    }
  }
}

}  // extern "C"
