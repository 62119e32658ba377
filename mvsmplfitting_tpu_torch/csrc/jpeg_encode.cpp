// Host JPEG encoding for `data/images.py:encode_jpeg`: BGR bytes to a
// baseline JPEG, byte for byte what OpenCV's `imencode(".jpg")` and
// `imwrite` produce with their defaults through the bundled
// libjpeg-turbo:
//   * markers SOI, a JFIF 1.01 APP0 (no density unit, 1:1), one DQT per
//     table, SOF0, one DHT per table (DC0, AC0, DC1, AC1), SOS, EOI; no
//     restart markers, no optimised Huffman tables, no progressive mode;
//   * the Annex K quantization tables scaled by `jpeg_quality_scaling`
//     and limited to 1-255 (jcparam.c);
//   * the fixed-point RGB -> YCbCr tables (jccolor.c, 16-bit scale, the
//     chroma rounding of one half less one);
//   * 4:2:0 chroma by `h2v2_downsample` (the 1, 2, 1, 2 bias) with the
//     edge replication of jcprepct.c and jcsample.c;
//   * the "islow" integer forward DCT (jfdctint.c) and quantization by
//     libjpeg-turbo's reciprocal multiply (jcdctmgr.c);
//   * dummy blocks past the image edge with zero AC and the previous
//     block's DC (jccoefct.c), and the standard Huffman tables (Annex
//     K.3) with 0xFF byte stuffing and a final byte padded with ones.
//
// Built with g++ into a shared library and called through ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "jpeg_std_tables.h"

namespace {

using namespace jpeg_std;

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const int kLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

const int kChromQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// A Huffman table as (code, length) per symbol (jpeg_make_c_derived_tbl).
struct HuffCodes {
  uint32_t code[256];
  uint8_t size[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    uint32_t c = 0;
    int k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k) {
        code[vals[k]] = c++;
        size[vals[k]] = (uint8_t)l;
      }
      c <<= 1;
    }
  }
};

struct Tables {
  HuffCodes dc[2], ac[2];
  Tables() {
    dc[0].build(kDcLumBits, kDcLumVals);
    ac[0].build(kAcLumBits, kAcLumVals);
    dc[1].build(kDcChromBits, kDcChromVals);
    ac[1].build(kAcChromBits, kAcChromVals);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// libjpeg-turbo's reciprocal, correction and shift for one divisor
// (compute_reciprocal, 16-bit DCTELEM).
struct Divisor {
  uint32_t recip, corr;
  int shift;  // total right shift of the product
};

Divisor reciprocal(uint32_t divisor) {
  int b = 0;
  while ((1u << (b + 1)) <= divisor) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint64_t fq = ((uint64_t)1 << r) / divisor;
  uint64_t fr = ((uint64_t)1 << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2u) {
    c++;
  } else {
    fq++;
  }
  return {(uint32_t)fq, c, r};
}

// Entropy-coded bytes, most significant bit first, with 0xFF stuffing.
class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}
  void put(uint32_t code, int size) {
    acc_ = (acc_ << size) | (code & ((1u << size) - 1));
    bits_ += size;
    while (bits_ >= 8) {
      bits_ -= 8;
      emit((uint8_t)(acc_ >> bits_));
    }
    acc_ &= (1ull << bits_) - 1;
  }
  void flush() {
    if (bits_) emit((uint8_t)((acc_ << (8 - bits_)) | (0xFF >> bits_)));
    acc_ = 0;
    bits_ = 0;
  }

 private:
  void emit(uint8_t b) {
    out_.push_back(b);
    if (b == 0xFF) out_.push_back(0);
  }
  std::vector<uint8_t>& out_;
  uint64_t acc_ = 0;
  int bits_ = 0;
};

inline int nbits(int v) { return v ? 32 - __builtin_clz((unsigned)v) : 0; }

void encode_block(BitWriter& bw, const int16_t* blk, int& last_dc,
                  const HuffCodes& dc, const HuffCodes& ac) {
  int temp = blk[0] - last_dc, temp2 = temp;
  last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int n = nbits(temp);
  bw.put(dc.code[n], dc.size[n]);
  if (n) bw.put((uint32_t)temp2, n);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = blk[kNatural[k]];
    if (temp == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    n = nbits(temp);
    int i = (r << 4) + n;
    bw.put(ac.code[i], ac.size[i]);
    bw.put((uint32_t)temp2, n);
    r = 0;
  }
  if (r > 0) bw.put(ac.code[0], ac.size[0]);
}

// jpeg_fdct_islow on a block of level-shifted samples, in place.
void fdct_islow(int32_t* data) {
  const int CONST_BITS = 13, PASS1_BITS = 2;
  const int32_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433,
                F_0_765 = 6270, F_0_899 = 7373, F_1_175 = 9633,
                F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069,
                F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;
  auto descale = [](int64_t x, int n) {
    return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n);
  };
  for (int pass = 0; pass < 2; ++pass) {
    int stride = pass == 0 ? 1 : 8, step = pass == 0 ? 8 : 1;
    int shift = pass == 0 ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS;
    for (int ctr = 0; ctr < 8; ++ctr) {
      int32_t* d = data + ctr * step;
      int64_t tmp0 = d[0 * stride] + d[7 * stride];
      int64_t tmp7 = d[0 * stride] - d[7 * stride];
      int64_t tmp1 = d[1 * stride] + d[6 * stride];
      int64_t tmp6 = d[1 * stride] - d[6 * stride];
      int64_t tmp2 = d[2 * stride] + d[5 * stride];
      int64_t tmp5 = d[2 * stride] - d[5 * stride];
      int64_t tmp3 = d[3 * stride] + d[4 * stride];
      int64_t tmp4 = d[3 * stride] - d[4 * stride];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        d[0] = (int32_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
        d[4 * stride] = (int32_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
      } else {
        d[0] = descale(tmp10 + tmp11, PASS1_BITS);
        d[4 * stride] = descale(tmp10 - tmp11, PASS1_BITS);
      }
      int64_t z1 = (tmp12 + tmp13) * F_0_541;
      d[2 * stride] = descale(z1 + tmp13 * F_0_765, shift);
      d[6 * stride] = descale(z1 + tmp12 * -F_1_847, shift);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F_1_175;
      tmp4 *= F_0_298;
      tmp5 *= F_2_053;
      tmp6 *= F_3_072;
      tmp7 *= F_1_501;
      z1 *= -F_0_899;
      z2 *= -F_2_562;
      z3 *= -F_1_961;
      z4 *= -F_0_390;
      z3 += z5;
      z4 += z5;
      d[7 * stride] = descale(tmp4 + z1 + z3, shift);
      d[5 * stride] = descale(tmp5 + z2 + z4, shift);
      d[3 * stride] = descale(tmp6 + z2 + z3, shift);
      d[1 * stride] = descale(tmp7 + z1 + z4, shift);
    }
  }
}

// A component plane padded to whole blocks.
struct Plane {
  int w, h;  // padded size
  std::vector<uint8_t> v;
  const uint8_t* row(int y) const { return v.data() + (size_t)y * w; }
};

// One 8x8 block at (bx, by) of `p`: forward DCT and quantization.
void dct_block(const Plane& p, int bx, int by, const Divisor* div,
               int16_t* out) {
  int32_t ws[64];
  for (int y = 0; y < 8; ++y) {
    const uint8_t* r = p.row(by * 8 + y) + bx * 8;
    for (int x = 0; x < 8; ++x) ws[y * 8 + x] = (int32_t)r[x] - 128;
  }
  fdct_islow(ws);
  for (int i = 0; i < 64; ++i) {
    int32_t t = ws[i];
    bool neg = t < 0;
    uint64_t a = (uint64_t)(neg ? -t : t);
    uint64_t q = ((a + div[i].corr) * div[i].recip) >> div[i].shift;
    out[i] = (int16_t)(neg ? -(int64_t)q : (int64_t)q);
  }
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)v);
}

void put_dht(std::vector<uint8_t>& o, int index, const uint8_t* bits,
             const uint8_t* vals) {
  int count = 0;
  for (int l = 1; l <= 16; ++l) count += bits[l];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + count);
  o.push_back((uint8_t)index);
  for (int l = 1; l <= 16; ++l) o.push_back(bits[l]);
  o.insert(o.end(), vals, vals + count);
}

std::vector<uint8_t> encode(const uint8_t* bgr, int W, int H, int quality) {
  quality = std::min(std::max(quality, 0), 100);
  int scale = quality <= 0 ? 5000 : quality < 50 ? 5000 / quality
                                                 : 200 - quality * 2;
  int qt[2][64];
  for (int i = 0; i < 64; ++i) {
    for (int t = 0; t < 2; ++t) {
      long v = ((long)(t ? kChromQuant[i] : kLumQuant[i]) * scale + 50L) / 100L;
      qt[t][i] = (int)std::min(255L, std::max(1L, v));
    }
  }
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal((uint32_t)qt[t][i] << 3);

  // Color conversion (jccolor.c rgb_ycc_convert).
  const int32_t ONE_HALF = 1 << 15, CBCR_OFFSET = 128 << 16;
  const int32_t FIX_R_Y = 19595, FIX_G_Y = 38470, FIX_B_Y = 7471,
                FIX_R_CB = 11059, FIX_G_CB = 21709, FIX_HALF = 32768,
                FIX_G_CR = 27439, FIX_B_CR = 5329;
  int wb_y = (W + 7) / 8, hb_y = (H + 7) / 8;     // Y blocks
  int wb_c = (W + 15) / 16, hb_c = (H + 15) / 16; // chroma blocks
  int mcux = (W + 15) / 16, mcuy = (H + 15) / 16;
  Plane Y{wb_y * 8, hb_y * 8, {}};
  Y.v.resize((size_t)Y.w * Y.h);
  // Full-resolution chroma, padded to an even row count and to the
  // columns the downsampler reads (jcprepct.c, expand_right_edge).
  int cw = wb_c * 16, ch = ((H + 1) / 2) * 2;
  std::vector<uint8_t> cb((size_t)cw * ch), cr((size_t)cw * ch);
  for (int y = 0; y < H; ++y) {
    const uint8_t* s = bgr + (size_t)y * W * 3;
    uint8_t* yr = Y.v.data() + (size_t)y * Y.w;
    uint8_t* br = cb.data() + (size_t)y * cw;
    uint8_t* rr = cr.data() + (size_t)y * cw;
    for (int x = 0; x < W; ++x) {
      int32_t b = s[3 * x], g = s[3 * x + 1], r = s[3 * x + 2];
      yr[x] = (uint8_t)((FIX_R_Y * r + FIX_G_Y * g + FIX_B_Y * b + ONE_HALF) >> 16);
      br[x] = (uint8_t)((-FIX_R_CB * r - FIX_G_CB * g + FIX_HALF * b +
                         CBCR_OFFSET + ONE_HALF - 1) >> 16);
      rr[x] = (uint8_t)((FIX_HALF * r - FIX_G_CR * g - FIX_B_CR * b +
                         CBCR_OFFSET + ONE_HALF - 1) >> 16);
    }
    for (int x = W; x < Y.w; ++x) yr[x] = yr[W - 1];
    for (int x = W; x < cw; ++x) {
      br[x] = br[W - 1];
      rr[x] = rr[W - 1];
    }
  }
  for (int y = H; y < Y.h; ++y)
    std::memcpy(Y.v.data() + (size_t)y * Y.w, Y.row(H - 1), Y.w);
  if (ch > H) {
    std::memcpy(cb.data() + (size_t)H * cw, cb.data() + (size_t)(H - 1) * cw, cw);
    std::memcpy(cr.data() + (size_t)H * cw, cr.data() + (size_t)(H - 1) * cw, cw);
  }
  // h2v2_downsample, then the last row repeated to whole blocks.
  Plane C[2] = {{wb_c * 8, hb_c * 8, {}}, {wb_c * 8, hb_c * 8, {}}};
  const std::vector<uint8_t>* full[2] = {&cb, &cr};
  int crow = ch / 2;
  for (int k = 0; k < 2; ++k) {
    C[k].v.resize((size_t)C[k].w * C[k].h);
    for (int y = 0; y < crow; ++y) {
      const uint8_t* i0 = full[k]->data() + (size_t)(2 * y) * cw;
      const uint8_t* i1 = i0 + cw;
      uint8_t* o = C[k].v.data() + (size_t)y * C[k].w;
      int bias = 1;
      for (int x = 0; x < C[k].w; ++x) {
        o[x] = (uint8_t)((i0[2 * x] + i0[2 * x + 1] + i1[2 * x] +
                          i1[2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
    for (int y = crow; y < C[k].h; ++y)
      std::memcpy(C[k].v.data() + (size_t)y * C[k].w, C[k].row(crow - 1),
                  C[k].w);
  }

  std::vector<uint8_t> out;
  out.reserve((size_t)W * H / 2 + 1024);
  const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I',
                          'F',  0x00, 0x01, 0x01, 0x00, 0x00, 0x01, 0x00,
                          0x01, 0x00, 0x00};
  out.insert(out.end(), head, head + sizeof(head));
  for (int t = 0; t < 2; ++t) {
    out.push_back(0xFF);
    out.push_back(0xDB);
    put16(out, 64 + 1 + 2);
    out.push_back((uint8_t)t);
    for (int i = 0; i < 64; ++i) out.push_back((uint8_t)qt[t][kNatural[i]]);
  }
  const uint8_t sof[] = {0xFF, 0xC0, 0x00, 17, 8};
  out.insert(out.end(), sof, sof + sizeof(sof));
  put16(out, H);
  put16(out, W);
  const uint8_t comps[] = {3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  out.insert(out.end(), comps, comps + sizeof(comps));
  put_dht(out, 0x00, kDcLumBits, kDcLumVals);
  put_dht(out, 0x10, kAcLumBits, kAcLumVals);
  put_dht(out, 0x01, kDcChromBits, kDcChromVals);
  put_dht(out, 0x11, kAcChromBits, kAcChromVals);
  const uint8_t sos[] = {0xFF, 0xDA, 0x00, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11,
                         0, 63, 0};
  out.insert(out.end(), sos, sos + sizeof(sos));

  // Interleaved MCUs: four Y blocks, Cb, Cr (jccoefct.c compress_data).
  const Tables& T = tables();
  BitWriter bw(out);
  int last_dc[3] = {0, 0, 0};
  int16_t blk[6][64];
  int last_col_w = wb_y % 2 ? wb_y % 2 : 2;
  int last_row_h = hb_y % 2 ? hb_y % 2 : 2;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      int blockcnt = mx < mcux - 1 ? 2 : last_col_w;
      for (int yi = 0; yi < 2; ++yi) {
        if (my < mcuy - 1 || yi < last_row_h) {
          for (int bi = 0; bi < blockcnt; ++bi)
            dct_block(Y, 2 * mx + bi, 2 * my + yi, div[0], blk[2 * yi + bi]);
          for (int bi = blockcnt; bi < 2; ++bi) {
            std::memset(blk[2 * yi + bi], 0, sizeof(blk[0]));
            blk[2 * yi + bi][0] = blk[2 * yi + bi - 1][0];
          }
        } else {
          for (int bi = 0; bi < 2; ++bi) {
            std::memset(blk[2 * yi + bi], 0, sizeof(blk[0]));
            blk[2 * yi + bi][0] = blk[2 * yi - 1][0];
          }
        }
      }
      dct_block(C[0], mx, my, div[1], blk[4]);
      dct_block(C[1], mx, my, div[1], blk[5]);
      for (int b = 0; b < 4; ++b)
        encode_block(bw, blk[b], last_dc[0], T.dc[0], T.ac[0]);
      encode_block(bw, blk[4], last_dc[1], T.dc[1], T.ac[1]);
      encode_block(bw, blk[5], last_dc[2], T.dc[1], T.ac[1]);
    }
  }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
  return out;
}

}  // namespace

extern "C" {

// Encodes an (h, w, 3) BGR image at `quality` into `out` (room for `cap`
// bytes).  Returns the encoded size; when it exceeds `cap` nothing is
// copied and the caller retries with that much room.  Returns -1 for an
// empty image.
int64_t jpeg_encode_bgr(const uint8_t* bgr, int w, int h, int quality,
                        uint8_t* out, int64_t cap) {
  if (w <= 0 || h <= 0 || w > 65535 || h > 65535) return -1;
  std::vector<uint8_t> data = encode(bgr, w, h, quality);
  if ((int64_t)data.size() <= cap) std::memcpy(out, data.data(), data.size());
  return (int64_t)data.size();
}

}  // extern "C"
