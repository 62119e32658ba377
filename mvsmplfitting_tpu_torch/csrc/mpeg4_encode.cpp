// MPEG-4 Part 2 Simple Profile video encoding for `data/mpeg4.py`
// (ISO/IEC 14496-2): the role libavcodec's mpeg4 encoder plays for
// `cv2.VideoWriter` with fourcc `mp4v`.
//   * headers: visual object sequence (profile_and_level 0x01), visual
//     object, video object and a version-1 Simple Profile VOL
//     (rectangular, progressive, H.263 quantisation, vol_control with
//     low_delay, resync markers enabled, no user data); `with_headers`
//     puts them before a VOP (AVI), `mvsf_m4v_enc_config` returns them
//     alone (the MP4 esds);
//   * an I-VOP every kGop = 12 frames, P-VOPs in between with
//     vop_rounding_type flipping on every P-VOP, as libavcodec does;
//     intra_dc_vlc_thr 0 (the DC always by its VLC); one fixed
//     quantiser, kQscale = 3, for every macroblock (cv2's writer, rate
//     controlled by FFmpeg, lands near quantiser 4 on the repo's clips;
//     3 keeps the files within a few percent of cv2's sizes and above
//     their PSNR);
//   * P macroblocks: a predictive search on luma (the zero vector, the
//     median predictor and the neighbours' vectors, a small diamond at
//     full pel, then the eight half-pel positions), intra when the
//     block's own variance is cheaper, not coded when the vector is
//     zero and every block quantises to zero;
//   * AC prediction decided per macroblock (on when it lowers the sum
//     of the predicted first-row/column levels);
//   * the forward DCT in double precision, H.263 quantisation with
//     libavcodec's biases (none for intra, -1/4 step for inter), and
//     the reconstruction through the decoder's own inverse quantiser,
//     IDCT and motion compensation (mpeg4_common.h).
// A test mode (`tools` bits, see kTool*) also forces four-vector
// macroblocks, intra macroblocks in P-VOPs, not-coded macroblocks,
// dquant, video packets with resync markers (some with the header
// extension), vectors that point out of the picture, VOPs with
// vop_coded = 0 and intra_dc_vlc_thr 13, so that a decoder can be held
// to FFmpeg on the tools cv2's writer never emits.
//
// Input frames are BGR (H, W, 3) uint8, converted to 4:2:0 with the
// BT.601 limited-range matrix (chroma from each 2x2 block's mean).
// Built with g++ into a shared library and called through ctypes.

#include <cmath>
#include <cstdio>

#include "mpeg4_common.h"

namespace {

using namespace m4v;

const uint32_t kToolFourMv = 1;
const uint32_t kToolIntraInP = 2;
const uint32_t kToolNotCoded = 4;
const uint32_t kToolDquant = 8;
const uint32_t kToolPackets = 16;
const uint32_t kToolOutside = 32;
const uint32_t kToolNvop = 64;
const uint32_t kToolDcThr = 128;

const int kQscale = 3;
const int kGop = 12;

struct Encoder {
  int width = 0, height = 0, mbw = 0, mbh = 0;
  int res = 30, inc = 1;  // vop_time_increment_resolution, per frame
  int time_bits = 1;
  uint32_t tools = 0;
  uint32_t rng = 1;
  int frame = 0;
  int64_t last_seconds = 0;
  bool no_rounding = false;
  bool have_ref = false;
  Picture src, cur, ref;
  MbState st;
  float dct[8][8];

  uint32_t rand() {
    rng = rng * 1664525u + 1013904223u;
    return rng >> 8;
  }
  bool chance(int one_in) { return rand() % one_in == 0; }
};

// ---------------------------------------------------------------- bits

void put_vlc(BitWriter& bw, uint32_t code, int len) { bw.put(len, code); }

// Codes one (last, run, level) of a TCOEF table with the escapes.
void put_coef(BitWriter& bw, const RunLevel& rl, int last, int run, int level) {
  int a = std::abs(level), sign = level < 0;
  auto direct = [&](int r, int l) -> int {
    if (r < 0 || r > 63 || l <= 0 || l > 63) return 0;
    return rl.index[last][r][l];
  };
  int i = direct(run, a);
  const uint16_t* esc = rl.codes[102];
  if (i) {
    put_vlc(bw, rl.codes[i - 1][0], rl.codes[i - 1][1]);
    bw.put(1, sign);
    return;
  }
  if (run < 64 && rl.max_level[last][run] > 0) {
    i = direct(run, a - rl.max_level[last][run]);
    if (i) {
      put_vlc(bw, esc[0], esc[1]);
      bw.put(1, 0);
      put_vlc(bw, rl.codes[i - 1][0], rl.codes[i - 1][1]);
      bw.put(1, sign);
      return;
    }
  }
  if (a < 64) {
    i = direct(run - rl.max_run[last][a] - 1, a);
    if (i) {
      put_vlc(bw, esc[0], esc[1]);
      bw.put(2, 2);
      put_vlc(bw, rl.codes[i - 1][0], rl.codes[i - 1][1]);
      bw.put(1, sign);
      return;
    }
  }
  put_vlc(bw, esc[0], esc[1]);
  bw.put(2, 3);
  bw.put(1, last);
  bw.put(6, run);
  bw.put(1, 1);
  bw.put_signed(12, level);
  bw.put(1, 1);
}

// The levels `lv` (row-major) along `scan` from position `start`.
void put_coefs(BitWriter& bw, bool intra, const uint8_t* scan, int start,
               const int* lv) {
  const RunLevel& rl = intra ? tables().intra : tables().inter;
  int lastpos = -1;
  for (int i = start; i < 64; ++i)
    if (lv[scan[i]]) lastpos = i;
  int run = 0;
  for (int i = start; i <= lastpos; ++i) {
    int l = lv[scan[i]];
    if (!l) {
      ++run;
      continue;
    }
    put_coef(bw, rl, i == lastpos, run, l);
    run = 0;
  }
}

bool any_coef(const int* lv, const uint8_t* scan, int start) {
  for (int i = start; i < 64; ++i)
    if (lv[scan[i]]) return true;
  return false;
}

void put_mv_component(BitWriter& bw, int diff, int fcode) {
  int range = 16 << fcode;  // half-pel values wrap over [-range, range)
  diff = ((diff + range) % (2 * range) + 2 * range) % (2 * range) - range;
  if (diff == 0) {
    put_vlc(bw, kMv[0][0], kMv[0][1]);
    return;
  }
  int a = std::abs(diff) - 1;
  int shift = fcode - 1;
  int code = (a >> shift) + 1;
  put_vlc(bw, kMv[code][0], kMv[code][1]);
  bw.put(1, diff < 0);
  if (shift) bw.put(shift, a & ((1 << shift) - 1));
}

// ---------------------------------------------------------------- DCT

void init_dct(Encoder& e) {
  for (int u = 0; u < 8; ++u)
    for (int x = 0; x < 8; ++x)
      e.dct[u][x] = (float)((u ? 0.5 : std::sqrt(0.125)) *
                            std::cos((2 * x + 1) * u * M_PI / 16.0));
}

// Forward DCT scaled as MPEG's: F(0,0) = 8 x the block mean.
void fdct(const Encoder& e, const int* in, float* out) {
  float src[64], tmp[64];
  for (int i = 0; i < 64; ++i) src[i] = (float)in[i];
  for (int y = 0; y < 8; ++y)
    for (int u = 0; u < 8; ++u) {
      float s = 0;
      for (int x = 0; x < 8; ++x) s += e.dct[u][x] * src[y * 8 + x];
      tmp[u * 8 + y] = s;
    }
  for (int v = 0; v < 8; ++v)
    for (int u = 0; u < 8; ++u) {
      float s = 0;
      for (int y = 0; y < 8; ++y) s += e.dct[v][y] * tmp[u * 8 + y];
      out[v * 8 + u] = s;
    }
}

int clip_level(int l) { return l < -2047 ? -2047 : l > 2047 ? 2047 : l; }

// ---------------------------------------------------------------- input

void load_frame(Encoder& e, const uint8_t* bgr, int64_t stride) {
  // BT.601 limited range, 8-bit fixed point (x 2^16); the planes' padding
  // past the picture repeats its last column and row
  int W = e.width, H = e.height;
  Plane& Y = e.src.p[0];
  for (int y = 0; y < Y.h; ++y) {
    uint8_t* d = Y.at(0, y);
    if (y >= H) {
      std::memcpy(d, Y.at(0, H - 1), Y.w);
      continue;
    }
    const uint8_t* p = bgr + y * stride;
    for (int x = 0; x < W; ++x, p += 3)
      d[x] = clip8((16 * 65536 + 16829 * p[2] + 33039 * p[1] + 6416 * p[0] +
                    32768) >> 16);
    for (int x = W; x < Y.w; ++x) d[x] = d[W - 1];
  }
  int cw = (W + 1) / 2, ch = (H + 1) / 2;
  for (int y = 0; y < e.src.p[1].h; ++y) {
    uint8_t* du = e.src.p[1].at(0, y);
    uint8_t* dv = e.src.p[2].at(0, y);
    if (y >= ch) {
      std::memcpy(du, e.src.p[1].at(0, ch - 1), e.src.p[1].w);
      std::memcpy(dv, e.src.p[2].at(0, ch - 1), e.src.p[2].w);
      continue;
    }
    const uint8_t* r0 = bgr + std::min(2 * y, H - 1) * stride;
    const uint8_t* r1 = bgr + std::min(2 * y + 1, H - 1) * stride;
    for (int x = 0; x < cw; ++x) {
      int x0 = 3 * (2 * x), x1 = 3 * std::min(2 * x + 1, W - 1);
      int b = r0[x0] + r0[x1] + r1[x0] + r1[x1];
      int g = r0[x0 + 1] + r0[x1 + 1] + r1[x0 + 1] + r1[x1 + 1];
      int r = r0[x0 + 2] + r0[x1 + 2] + r1[x0 + 2] + r1[x1 + 2];
      du[x] = clip8((128 * 262144 - 9714 * r - 19070 * g + 28784 * b +
                     131072) >> 18);
      dv[x] = clip8((128 * 262144 + 28784 * r - 24103 * g - 4681 * b +
                     131072) >> 18);
    }
    for (int x = cw; x < e.src.p[1].w; ++x) {
      du[x] = du[cw - 1];
      dv[x] = dv[cw - 1];
    }
  }
}

// ---------------------------------------------------------------- headers

void put_headers(Encoder& e, BitWriter& bw) {
  bw.put(32, 0x1B0);
  bw.put(8, 0x01);  // profile_and_level_indication
  bw.put(32, 0x1B5);
  bw.put(1, 1);     // is_visual_object_identifier
  bw.put(4, 1);     // visual_object_verid
  bw.put(3, 1);     // visual_object_priority
  bw.put(4, 1);     // video
  bw.put(1, 0);     // video_signal_type
  bw.stuff();
  bw.put(32, 0x100);
  bw.put(32, 0x120);
  bw.put(1, 0);     // random_accessible_vol
  bw.put(8, 1);     // Simple Object Type
  bw.put(1, 1);     // is_object_layer_identifier
  bw.put(4, 1);     // video_object_layer_verid
  bw.put(3, 1);     // priority
  bw.put(4, 1);     // aspect_ratio_info: square
  bw.put(1, 1);     // vol_control_parameters
  bw.put(2, 1);     // 4:2:0
  bw.put(1, 1);     // low_delay
  bw.put(1, 0);     // vbv_parameters
  bw.put(2, 0);     // rectangular
  bw.put(1, 1);
  bw.put(16, e.res);
  bw.put(1, 1);
  bw.put(1, 0);     // fixed_vop_rate
  bw.put(1, 1);
  bw.put(13, e.width);
  bw.put(1, 1);
  bw.put(13, e.height);
  bw.put(1, 1);
  bw.put(1, 0);     // interlaced
  bw.put(1, 1);     // obmc_disable
  bw.put(1, 0);     // sprite_enable
  bw.put(1, 0);     // not_8_bit
  bw.put(1, 0);     // quant_type: H.263
  bw.put(1, 1);     // complexity_estimation_disable
  bw.put(1, 0);     // resync_marker_disable
  bw.put(1, 0);     // data_partitioned
  bw.put(1, 0);     // scalability
  bw.stuff();
}

// ---------------------------------------------------------------- MBs

struct Ctx {
  Encoder* e;
  BitWriter* bw;
  bool p_vop;
  int fcode;
  int qscale;
  int dc_thr;
  int packet, rx, ry;
};

int sad16(const Plane& src, const Plane& ref, int mbx, int mby, int mx,
          int my, bool no_rounding, int best) {
  int dxy = ((my & 1) << 1) | (mx & 1);
  int sx = mbx * 16 + (mx >> 1), sy = mby * 16 + (my >> 1);
  const uint8_t* a = src.px.data() + size_t(mby * 16) * src.w + mbx * 16;
  if (sx < 0 || sy < 0 || sx + 17 > ref.w || sy + 17 > ref.h) {
    uint8_t pred[256];
    hpel(ref, sx, sy, dxy, 16, 16, no_rounding, pred, 16);
    int s = 0;
    for (int y = 0; y < 16; ++y, a += src.w) {
      for (int x = 0; x < 16; ++x) s += std::abs(a[x] - pred[y * 16 + x]);
      if (s >= best) return s;
    }
    return s;
  }
  // inside the plane: the half-pel sample computed in place
  const uint8_t* b = ref.px.data() + size_t(sy) * ref.w + sx;
  int w = ref.w, r1 = no_rounding ? 0 : 1, r2 = no_rounding ? 1 : 2;
  int s = 0;
  for (int y = 0; y < 16; ++y, a += src.w, b += w) {
    switch (dxy) {
      case 0:
        for (int x = 0; x < 16; ++x) s += std::abs(a[x] - b[x]);
        break;
      case 1:
        for (int x = 0; x < 16; ++x)
          s += std::abs(a[x] - ((b[x] + b[x + 1] + r1) >> 1));
        break;
      case 2:
        for (int x = 0; x < 16; ++x)
          s += std::abs(a[x] - ((b[x] + b[x + w] + r1) >> 1));
        break;
      default:
        for (int x = 0; x < 16; ++x)
          s += std::abs(a[x] - ((b[x] + b[x + 1] + b[x + w] + b[x + w + 1] +
                                 r2) >> 2));
        break;
    }
    if (s >= best) return s;
  }
  return s;
}

int sad8(const Plane& src, const Plane& ref, int bx, int by, int mx, int my,
         bool no_rounding) {
  uint8_t pred[64];
  int dxy = ((my & 1) << 1) | (mx & 1);
  hpel(ref, bx * 8 + (mx >> 1), by * 8 + (my >> 1), dxy, 8, 8, no_rounding,
       pred, 8);
  int s = 0;
  for (int y = 0; y < 8; ++y) {
    const uint8_t* a = src.px.data() + size_t(by * 8 + y) * src.w + bx * 8;
    for (int x = 0; x < 8; ++x) s += std::abs(a[x] - pred[y * 8 + x]);
  }
  return s;
}

// The luma search of MB (mbx, mby): best vector (half-pel) and its SAD.
int search(Ctx& c, int mbx, int mby, int& bmx, int& bmy) {
  Encoder& e = *c.e;
  int lim = (16 << c.fcode) - 1;
  // keep the whole block within 16 pixels of the picture
  int lo_x = std::max(-lim, -2 * (16 * mbx + 16)),
      hi_x = std::min(lim, 2 * (e.src.p[0].w - 16 * mbx));
  int lo_y = std::max(-lim, -2 * (16 * mby + 16)),
      hi_y = std::min(lim, 2 * (e.src.p[0].h - 16 * mby));
  auto ok = [&](int x, int y) {
    return x >= lo_x && x <= hi_x && y >= lo_y && y <= hi_y;
  };
  int best = 1 << 30;
  bmx = bmy = 0;
  auto test = [&](int x, int y) {
    if (!ok(x, y)) return;
    int s = sad16(e.src.p[0], e.ref.p[0], mbx, mby, x, y, e.no_rounding, best);
    if (s < best) {
      best = s;
      bmx = x;
      bmy = y;
    }
  };
  test(0, 0);
  int px, py;
  predict_mv(e.st, mbx, mby, 0, c.rx, c.ry, px, py);
  test(px & ~1, py & ~1);
  int ax, ay;
  e.st.mv_at(2 * mbx - 1, 2 * mby, ax, ay);
  test(ax & ~1, ay & ~1);
  e.st.mv_at(2 * mbx, 2 * mby - 1, ax, ay);
  test(ax & ~1, ay & ~1);
  e.st.mv_at(2 * mbx + 2, 2 * mby - 1, ax, ay);
  test(ax & ~1, ay & ~1);
  // full-pel diamond, step 4 then 2 then 1 pixel
  for (int step = 8; step >= 2; step /= 2) {
    for (int it = 0; it < 8; ++it) {
      int cx = bmx, cy = bmy;
      test(cx + step, cy);
      test(cx - step, cy);
      test(cx, cy + step);
      test(cx, cy - step);
      if (bmx == cx && bmy == cy) break;
    }
  }
  int cx = bmx, cy = bmy;
  for (int dy = -1; dy <= 1; ++dy)
    for (int dx = -1; dx <= 1; ++dx)
      if (dx || dy) test(cx + dx, cy + dy);
  return best;
}

// Quantised levels of an inter residual block.  |F(u, v)| is at most
// a quarter of the residual's absolute sum, and a level is nonzero
// only from |F| = 2.5 q: blocks below 10 q skip the transform.
void quant_inter(const Encoder& e, const int* res, int q, int* lv) {
  int sum = 0;
  for (int i = 0; i < 64; ++i) sum += std::abs(res[i]);
  if (sum < 10 * q) {
    std::memset(lv, 0, 64 * sizeof(int));
    return;
  }
  float f[64];
  fdct(e, res, f);
  for (int i = 0; i < 64; ++i) {
    float a = std::fabs(f[i]);
    int l = (int)std::floor((a - 0.5f * q) / (2.0f * q));
    if (l < 0) l = 0;
    lv[i] = clip_level(f[i] < 0 ? -l : l);
  }
}

// Intra levels (DC level in lv[0], AC by the H.263 intra quantiser).
void quant_intra(const Encoder& e, const int* px, int q, int scale, int* lv) {
  float f[64];
  fdct(e, px, f);
  int dc = (int)std::floor(f[0] + 0.5f);
  lv[0] = (dc + (scale >> 1)) / scale;
  for (int i = 1; i < 64; ++i) {
    int l = (int)std::floor(std::fabs(f[i]) / (2.0f * q));
    lv[i] = clip_level(f[i] < 0 ? -l : l);
  }
}

void block_pixels(Picture& pic, int mbx, int mby, int k, int* out) {
  int stride;
  uint8_t* p = block_dst(pic, mbx, mby, k, stride);
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) out[y * 8 + x] = p[y * stride + x];
}

void code_intra_mb(Ctx& c, int mbx, int mby, int dquant_code) {
  Encoder& e = *c.e;
  BitWriter& bw = *c.bw;
  MbState& st = e.st;
  size_t mi = size_t(mby) * st.mbw + mbx;
  bool use_dc_vlc = c.qscale < c.dc_thr;
  if (dquant_code >= 0) c.qscale += kDquant[dquant_code];
  int q = c.qscale;
  st.intra[mi] = 1;
  st.packet[mi] = c.packet;
  st.qscale[mi] = (int8_t)q;
  for (int k = 0; k < 4; ++k) {
    int16_t* p = st.mvp(2 * mbx + (k & 1), 2 * mby + (k >> 1));
    p[0] = p[1] = 0;
  }
  int lv[6][64], coded[6][64], dir[6], pred_dc[6];
  // quantise, predict DC and record the AC of every block (the
  // predictors of later blocks of this MB read the stored values)
  for (int k = 0; k < 6; ++k) {
    int px[64];
    block_pixels(e.src, mbx, mby, k, px);
    int scale = k < 4 ? y_dc_scale(q) : c_dc_scale(q);
    quant_intra(e, px, q, scale, lv[k]);
    pred_dc[k] = predict_dc(st, mbx, mby, k, c.packet, scale, dir[k]);
    int stored = lv[k][0] * scale;
    if (stored & ~2047) stored = stored < 0 ? 0 : 2047;
    st.dc[mi * 6 + k] = stored;
    store_ac(st, mbx, mby, k, lv[k]);
  }
  // AC prediction: residual levels with and without it
  int with[6][64];
  int gain = 0;
  for (int k = 0; k < 6; ++k) {
    std::memcpy(with[k], lv[k], sizeof(with[k]));
    predict_ac(st, mbx, mby, k, c.packet, dir[k], q, -1, with[k]);
    for (int i = 1; i < 8; ++i) {
      int idx = dir[k] == 0 ? 8 * i : i;
      gain += std::abs(lv[k][idx]) - std::abs(with[k][idx]);
    }
  }
  bool ac_pred = gain > 0;
  int cbp = 0;
  for (int k = 0; k < 6; ++k) {
    std::memcpy(coded[k], ac_pred ? with[k] : lv[k], sizeof(coded[k]));
    coded[k][0] = lv[k][0] - pred_dc[k];
    const uint8_t* scan =
        !ac_pred ? kZigzag : dir[k] == 0 ? kAltVertical : kAltHorizontal;
    if (any_coef(coded[k], scan, use_dc_vlc ? 1 : 0)) cbp |= 32 >> k;
  }
  int dq = dquant_code >= 0;
  if (c.p_vop) {
    int idx = (cbp & 3) | 4 | (dq ? 8 : 0);
    bw.put(1, 0);  // coded
    put_vlc(bw, kInterMcbpcCode[idx], kInterMcbpcLen[idx]);
  } else {
    int idx = (cbp & 3) | (dq ? 4 : 0);
    put_vlc(bw, kIntraMcbpcCode[idx], kIntraMcbpcLen[idx]);
  }
  bw.put(1, ac_pred);
  put_vlc(bw, kCbpy[cbp >> 2][0], kCbpy[cbp >> 2][1]);
  if (dq) bw.put(2, dquant_code);
  for (int k = 0; k < 6; ++k) {
    const uint8_t* scan =
        !ac_pred ? kZigzag : dir[k] == 0 ? kAltVertical : kAltHorizontal;
    int* v = coded[k];
    int diff = v[0];
    if (use_dc_vlc) {
      int a = std::abs(diff), size = 0;
      while (a >> size) ++size;
      const uint8_t(*tab)[2] = k < 4 ? kDcLum : kDcChrom;
      put_vlc(bw, tab[size][0], tab[size][1]);
      if (size) {
        bw.put(size, diff > 0 ? diff : diff + (1 << size) - 1);
        if (size > 8) bw.put(1, 1);
      }
      if (cbp & (32 >> k)) put_coefs(bw, true, scan, 1, v);
    } else {
      if (cbp & (32 >> k)) put_coefs(bw, true, scan, 0, v);
    }
    // reconstruct exactly as a decoder does
    int scale = k < 4 ? y_dc_scale(q) : c_dc_scale(q);
    int16_t blk[64];
    blk[0] = (int16_t)(lv[k][0] * scale);
    for (int i = 1; i < 64; ++i) blk[i] = (int16_t)dequant(lv[k][i], q);
    int stride;
    uint8_t* dst = block_dst(e.cur, mbx, mby, k, stride);
    idct(blk, dst, stride, false);
  }
}

// Codes a P macroblock with vectors `mv` (four when `four`); returns
// after writing it (not coded when `allow_skip`, the vector is zero and
// nothing is left after quantisation).
void code_inter_mb(Ctx& c, int mbx, int mby, bool four, int (*mv)[2],
                   int dquant_code, bool force_skip) {
  Encoder& e = *c.e;
  BitWriter& bw = *c.bw;
  MbState& st = e.st;
  size_t mi = size_t(mby) * st.mbw + mbx;
  st.intra[mi] = 0;
  st.packet[mi] = c.packet;
  if (force_skip) {
    four = false;
    mv[0][0] = mv[0][1] = 0;
    dquant_code = -1;
  }
  int vec[4][2];
  for (int k = 0; k < 4; ++k) {
    vec[k][0] = mv[four ? k : 0][0];
    vec[k][1] = mv[four ? k : 0][1];
  }
  motion_compensate(e.cur, e.ref, mbx, mby, four, vec, e.no_rounding,
                    e.width, e.height);
  int q = c.qscale + (dquant_code >= 0 ? kDquant[dquant_code] : 0);
  int lv[6][64];
  int cbp = 0;
  for (int k = 0; k < 6; ++k) {
    int a[64], b[64], res[64];
    block_pixels(e.src, mbx, mby, k, a);
    block_pixels(e.cur, mbx, mby, k, b);
    for (int i = 0; i < 64; ++i) res[i] = a[i] - b[i];
    quant_inter(e, res, q, lv[k]);
    if (force_skip) std::memset(lv[k], 0, sizeof(lv[k]));
    if (any_coef(lv[k], kZigzag, 0)) cbp |= 32 >> k;
  }
  if (!four && vec[0][0] == 0 && vec[0][1] == 0 && cbp == 0 &&
      dquant_code < 0) {
    bw.put(1, 1);  // not coded
    st.qscale[mi] = (int8_t)c.qscale;
    for (int k = 0; k < 4; ++k) {
      int16_t* p = st.mvp(2 * mbx + (k & 1), 2 * mby + (k >> 1));
      p[0] = p[1] = 0;
    }
    return;
  }
  c.qscale = q;
  st.qscale[mi] = (int8_t)q;
  int idx = (cbp & 3) | (dquant_code >= 0 ? 8 : 0) | (four ? 16 : 0);
  bw.put(1, 0);
  put_vlc(bw, kInterMcbpcCode[idx], kInterMcbpcLen[idx]);
  int cbpy = (cbp >> 2) ^ 15;
  put_vlc(bw, kCbpy[cbpy][0], kCbpy[cbpy][1]);
  if (dquant_code >= 0) bw.put(2, dquant_code);
  for (int k = 0; k < (four ? 4 : 1); ++k) {
    int px, py;
    predict_mv(st, mbx, mby, k, c.rx, c.ry, px, py);
    put_mv_component(bw, vec[k][0] - px, c.fcode);
    put_mv_component(bw, vec[k][1] - py, c.fcode);
    if (four) {
      int16_t* p = st.mvp(2 * mbx + (k & 1), 2 * mby + (k >> 1));
      p[0] = (int16_t)vec[k][0];
      p[1] = (int16_t)vec[k][1];
    }
  }
  if (!four)
    for (int k = 0; k < 4; ++k) {
      int16_t* p = st.mvp(2 * mbx + (k & 1), 2 * mby + (k >> 1));
      p[0] = (int16_t)vec[0][0];
      p[1] = (int16_t)vec[0][1];
    }
  for (int k = 0; k < 6; ++k) {
    if (!(cbp & (32 >> k))) continue;
    put_coefs(bw, false, kZigzag, 0, lv[k]);
    int16_t blk[64];
    for (int i = 0; i < 64; ++i) blk[i] = (int16_t)dequant(lv[k][i], q);
    int stride;
    uint8_t* dst = block_dst(e.cur, mbx, mby, k, stride);
    idct(blk, dst, stride, true);
  }
}

// The intra cost of MB (mbx, mby): the luma's sum of absolute
// deviations from its mean.
int intra_cost(const Encoder& e, int mbx, int mby) {
  const Plane& Y = e.src.p[0];
  int sum = 0;
  for (int y = 0; y < 16; ++y)
    for (int x = 0; x < 16; ++x)
      sum += Y.px[size_t(mby * 16 + y) * Y.w + mbx * 16 + x];
  int mean = (sum + 128) >> 8, dev = 0;
  for (int y = 0; y < 16; ++y)
    for (int x = 0; x < 16; ++x)
      dev += std::abs(Y.px[size_t(mby * 16 + y) * Y.w + mbx * 16 + x] - mean);
  return dev;
}

void put_packet_header(Ctx& c, int mb, bool hec) {
  Encoder& e = *c.e;
  BitWriter& bw = *c.bw;
  bw.stuff();
  int zeros = c.p_vop ? 15 + c.fcode : 16;
  bw.put(zeros, 0);
  bw.put(1, 1);
  int mb_num = e.mbw * e.mbh, bits = 0;
  while ((1 << bits) < mb_num) ++bits;
  bw.put(std::max(bits, 1), mb);
  bw.put(5, c.qscale);
  bw.put(1, hec);
  if (hec) {
    int64_t t = int64_t(e.frame) * e.inc;
    for (int64_t s = 0; s < t / e.res - e.last_seconds; ++s) bw.put(1, 1);
    bw.put(1, 0);
    bw.put(1, 1);
    bw.put(e.time_bits, uint32_t(t % e.res));
    bw.put(1, 1);
    bw.put(2, c.p_vop ? 1 : 0);
    bw.put(3, c.dc_thr == 99 ? 0 : 1);
    if (c.p_vop) bw.put(3, c.fcode);
  }
  c.packet++;
  c.rx = mb % e.mbw;
  c.ry = mb / e.mbw;
}

// Encodes one frame (already in e.src); returns the VOP's bytes.
void encode_vop(Encoder& e, BitWriter& bw, bool* key) {
  bool p_vop = e.have_ref && e.frame % kGop != 0;
  *key = !p_vop;
  int64_t t = int64_t(e.frame) * e.inc;
  int64_t seconds = t / e.res;
  bool nvop = p_vop && (e.tools & kToolNvop) && e.frame % kGop == 5;
  bw.put(32, 0x1B6);
  bw.put(2, p_vop ? 1 : 0);
  for (int64_t s = e.last_seconds; s < seconds; ++s) bw.put(1, 1);
  bw.put(1, 0);
  bw.put(1, 1);
  bw.put(e.time_bits, uint32_t(t % e.res));
  bw.put(1, 1);
  if (nvop) {
    bw.put(1, 0);  // vop_coded
    bw.stuff();
    e.last_seconds = seconds;
    return;
  }
  bw.put(1, 1);
  if (p_vop) {
    e.no_rounding = !e.no_rounding;
    bw.put(1, e.no_rounding);
  } else {
    e.no_rounding = false;
  }
  Ctx c{};
  c.e = &e;
  c.bw = &bw;
  c.p_vop = p_vop;
  c.fcode = 2;
  bool dcthr = (e.tools & kToolDcThr) != 0;
  c.dc_thr = dcthr ? 13 : 99;
  c.qscale = kQscale;
  bw.put(3, dcthr ? 1 : 0);
  bw.put(5, c.qscale);
  if (p_vop) bw.put(3, c.fcode);
  c.packet = 0;
  c.rx = c.ry = 0;
  e.st.new_vop();
  int mb_num = e.mbw * e.mbh;
  for (int mb = 0; mb < mb_num; ++mb) {
    int mbx = mb % e.mbw, mby = mb / e.mbw;
    if (mb > 0 && (e.tools & kToolPackets) && e.chance(9)) {
      if (dcthr) c.qscale = 10 + int(e.rand() % 7);
      put_packet_header(c, mb, e.chance(2));
    }
    int dq = -1;
    if ((e.tools & kToolDquant) && e.chance(4)) {
      dq = int(e.rand() % 4);
      int nq = c.qscale + kDquant[dq];
      if (nq < 1 || nq > 31) dq = -1;
    }
    if (!p_vop) {
      code_intra_mb(c, mbx, mby, dq);
      continue;
    }
    if ((e.tools & kToolIntraInP) && e.chance(7)) {
      code_intra_mb(c, mbx, mby, dq);
      continue;
    }
    if ((e.tools & kToolNotCoded) && e.chance(6)) {
      int mv[4][2] = {};
      code_inter_mb(c, mbx, mby, false, mv, -1, true);
      continue;
    }
    int mv[4][2] = {};
    int best = search(c, mbx, mby, mv[0][0], mv[0][1]);
    bool four = false;
    if ((e.tools & kToolOutside) && (mbx == 0 || mby == 0 ||
                                      mbx == e.mbw - 1 || mby == e.mbh - 1) &&
        e.chance(2)) {
      int lim = (16 << c.fcode) - 1;
      mv[0][0] = mbx == 0 ? -lim + int(e.rand() % 9)
                          : mbx == e.mbw - 1 ? lim - int(e.rand() % 9) : 0;
      mv[0][1] = mby == 0 ? -lim + int(e.rand() % 9)
                          : mby == e.mbh - 1 ? lim - int(e.rand() % 9) : 0;
      if (e.chance(2)) {
        four = true;
        for (int k = 1; k < 4; ++k) {
          mv[k][0] = std::max(-lim, std::min(lim, mv[0][0] + int(e.rand() % 7) - 3));
          mv[k][1] = std::max(-lim, std::min(lim, mv[0][1] + int(e.rand() % 7) - 3));
        }
      }
    } else if ((e.tools & kToolFourMv) && e.chance(3)) {
      four = true;
      int lim = (16 << c.fcode) - 1;
      for (int k = 0; k < 4; ++k) {
        int bx = 2 * mbx + (k & 1), by = 2 * mby + (k >> 1);
        int bs = 1 << 30, bmx = mv[0][0], bmy = mv[0][1];
        for (int dy = -2; dy <= 2; ++dy)
          for (int dx = -2; dx <= 2; ++dx) {
            int x = std::max(-lim, std::min(lim, mv[0][0] + dx));
            int y = std::max(-lim, std::min(lim, mv[0][1] + dy));
            int s = sad8(e.src.p[0], e.ref.p[0], bx, by, x, y, e.no_rounding);
            if (s < bs) {
              bs = s;
              bmx = x;
              bmy = y;
            }
          }
        mv[k][0] = bmx;
        mv[k][1] = bmy;
      }
    } else if (intra_cost(e, mbx, mby) + 500 < best) {
      code_intra_mb(c, mbx, mby, dq);
      continue;
    }
    if (four) dq = -1;  // no inter4v+q in MPEG-4
    code_inter_mb(c, mbx, mby, four, mv, dq, false);
  }
  bw.stuff();
  e.last_seconds = seconds;
  std::swap(e.cur, e.ref);
  e.have_ref = true;
}

void set_err(char* err, int len, const std::string& msg) {
  if (err && len > 0) std::snprintf(err, len, "%s", msg.c_str());
}

int64_t emit(BitWriter& bw, uint8_t* out, int64_t cap) {
  auto& b = bw.buf();
  if (int64_t(b.size()) > cap) return -int64_t(b.size());
  std::memcpy(out, b.data(), b.size());
  return int64_t(b.size());
}

}  // namespace

extern "C" {

// A new encoder of width x height frames at `res`/`inc` frames a second
// with test `tools` (0 for normal output) drawn with `seed`.
void* mvsf_m4v_enc_new(int width, int height, int res, int inc,
                       uint32_t tools, uint32_t seed) {
  if (width <= 0 || height <= 0 || width > 8191 || height > 8191 ||
      res <= 0 || res > 65535 || inc <= 0 || inc > res)
    return nullptr;
  Encoder* e = new Encoder();
  e->width = width;
  e->height = height;
  e->mbw = (width + 15) / 16;
  e->mbh = (height + 15) / 16;
  e->res = res;
  e->inc = inc;
  int bits = 0;
  while ((1 << bits) < res) ++bits;
  e->time_bits = std::max(bits, 1);
  e->tools = tools;
  e->rng = seed * 2654435761u + 1;
  e->src.init(e->mbw, e->mbh);
  e->cur.init(e->mbw, e->mbh);
  e->ref.init(e->mbw, e->mbh);
  e->st.init(e->mbw, e->mbh);
  init_dct(*e);
  return e;
}

void mvsf_m4v_enc_free(void* h) { delete static_cast<Encoder*>(h); }

// The VOS/VO/VOL headers (the decoder configuration of an MP4 esds).
// Returns their size, or minus the size needed when `cap` is short.
int64_t mvsf_m4v_enc_config(void* h, uint8_t* out, int64_t cap) {
  Encoder& e = *static_cast<Encoder*>(h);
  BitWriter bw;
  put_headers(e, bw);
  return emit(bw, out, cap);
}

// Encodes one BGR frame (rows `stride` bytes apart) into `out`, with the
// headers first when `with_headers`; `key` says whether it is an
// I-VOP.  Returns the size, minus the size needed when `cap` is short
// (the frame is then lost), or 0 with a message.
int64_t mvsf_m4v_encode(void* h, const uint8_t* bgr, int64_t stride,
                        int with_headers, uint8_t* out, int64_t cap,
                        int* key, char* err, int errlen) {
  Encoder& e = *static_cast<Encoder*>(h);
  try {
    load_frame(e, bgr, stride);
    BitWriter bw;
    if (with_headers) put_headers(e, bw);
    bool k = false;
    encode_vop(e, bw, &k);
    *key = k;
    e.frame++;
    return emit(bw, out, cap);
  } catch (const Error& x) {
    set_err(err, errlen, x.msg);
    return 0;
  }
}

}  // extern "C"
