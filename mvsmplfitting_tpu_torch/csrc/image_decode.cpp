// Host image decoding for `data/images.py`: baseline and progressive
// Huffman JPEG to BGR, and the PNG row filters.
//
// The JPEG path follows libjpeg's default decompression, which
// OpenCV's `imread` runs through its bundled libjpeg-turbo, step by step
// and in the same integer arithmetic, so that the output is the same
// bytes:
//   * Huffman decoding of sequential scans (interleaved or not), with
//     restart intervals; a scan without a DHT segment takes the standard
//     tables of Annex K.3 (`jpeg_std_tables.h`), as libjpeg does for the
//     Motion-JPEG frames that leave them out;
//   * progressive files (SOF2): every scan (DC first and refine, AC
//     first and refine with EOB runs, restart intervals) is decoded into
//     a whole-image coefficient buffer as jdphuff.c does, and the
//     buffer then goes through the steps below, as libjpeg's
//     decompress_data does once the file is read.  A file that leaves a
//     coefficient unsent or not fully refined is refused: libjpeg would
//     smooth such blocks (jdcoefct.c, decompress_smooth_data);
//   * dequantization and the "islow" integer inverse DCT
//     (jidctint.c: 13-bit constants, 2 extra bits in the first pass,
//     the masked range-limit table);
//   * fancy upsampling of subsampled chroma (jdsample.c: h2v1, h2v2
//     and h1v2 triangle filters with libjpeg's edge and context rows;
//     other integral ratios replicate samples);
//   * the fixed-point YCbCr -> BGR tables (jdcolor.c, 16-bit scale).
// Lossless, hierarchical and arithmetic-coded files, precisions other
// than 8 bits and files of more than one frame are refused with a
// message.
//
// Built with g++ into a shared library and called through ctypes; every
// entry point returns 0 on success, or a nonzero code with a message in
// `err`.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "jpeg_std_tables.h"

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
  bool present = false;
  // Canonical decoding tables (JPEG Annex F.2.2.3).
  int32_t mincode[17];
  int32_t maxcode[18];
  int32_t valptr[17];
  uint8_t vals[256];
  // Codes of up to kLookBits bits: (length << 8) | value, 0 when longer.
  static const int kLookBits = 9;
  uint16_t look[1 << kLookBits];

  void build(const uint8_t* counts, const uint8_t* values, int nvals) {
    std::memcpy(vals, values, nvals);
    std::memset(look, 0, sizeof(look));
    int32_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      valptr[len] = k;
      mincode[len] = code;
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        if (code >= (1 << len)) fail("bad Huffman table");
        if (len <= kLookBits) {
          int shift = kLookBits - len;
          for (int f = 0; f < (1 << shift); ++f)
            look[(code << shift) | f] = uint16_t((len << 8) | values[k]);
        }
      }
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;            // tables of the current scan
  int dw = 0, dh = 0;            // downsampled width and height
  int bw = 0, bh = 0;            // blocks per row / column in the plane
  int pred = 0;                  // DC predictor
  // The quantization table, latched at the component's first scan as
  // libjpeg latches it (jdinput.c, latch_quant_tables).
  uint16_t q[64];
  bool q_latched = false;
  std::vector<uint8_t> plane;    // bw*8 x bh*8 samples
  // Progressive files: bw x bh blocks of 64 coefficients (natural
  // order), and per coefficient the Al of its last scan, -1 if unsent
  // (libjpeg's coef_bits).
  std::vector<int16_t> coef;
  int coef_bits[64];
};

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t n, size_t pos)
      : d_(data), n_(n), pos_(pos) {}

  size_t pos() const { return pos_; }

  // The next 16 bits, most significant first, without consuming them.
  uint32_t peek16() {
    fill();
    return uint32_t(acc_ >> (bits_ - 16)) & 0xffff;
  }
  void skip(int n) { bits_ -= n; }
  int get(int n) {
    if (n == 0) return 0;
    fill();
    bits_ -= n;
    return int(acc_ >> bits_) & ((1 << n) - 1);
  }
  // Discards the bits left in the current byte and reads an RSTn marker.
  void restart(int expected) {
    bits_ = 0;
    acc_ = 0;
    if (marker_ < 0) {
      // The marker was not reached while filling: find it.
      while (pos_ + 1 < n_ && !(d_[pos_] == 0xFF && d_[pos_ + 1] != 0 &&
                                d_[pos_ + 1] != 0xFF))
        ++pos_;
      if (pos_ + 1 >= n_) fail("missing restart marker");
      marker_ = d_[pos_ + 1];
      pos_ += 2;
    }
    if (marker_ != 0xD0 + expected) fail("bad restart marker sequence");
    marker_ = -1;
  }
  // Position just past the scan's entropy-coded data, before any marker.
  size_t end_of_scan() {
    if (marker_ >= 0) return pos_ - 2;
    size_t p = pos_;
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0 &&
                           !(d_[p + 1] >= 0xD0 && d_[p + 1] <= 0xD7)))
      ++p;
    return p;
  }

 private:
  void fill() {
    while (bits_ <= 48) {
      uint32_t byte = 0;
      if (marker_ < 0 && pos_ < n_) {
        byte = d_[pos_];
        if (byte == 0xFF) {
          // Skip fill bytes 0xFF 0xFF ... before a marker or a stuffed 0.
          size_t q = pos_ + 1;
          while (q < n_ && d_[q] == 0xFF) ++q;
          if (q < n_ && d_[q] == 0) {
            pos_ = q + 1;
          } else {
            // A marker ends the data: feed zeros from here on, as
            // libjpeg does.
            marker_ = q < n_ ? d_[q] : 0xD9;
            pos_ = q + 1;
            byte = 0;
          }
        } else {
          ++pos_;
        }
      }
      acc_ = (acc_ << 8) | byte;
      bits_ += 8;
    }
  }

  const uint8_t* d_;
  size_t n_;
  size_t pos_;
  uint64_t acc_ = 0;
  int bits_ = 0;
  int marker_ = -1;
};

inline int decode_huff(BitReader& br, const Huffman& t) {
  uint32_t p = br.peek16();
  uint16_t e = t.look[p >> (16 - Huffman::kLookBits)];
  if (e) {
    br.skip(e >> 8);
    return e & 0xff;
  }
  for (int len = Huffman::kLookBits + 1; len <= 16; ++len) {
    int32_t code = int32_t(p >> (16 - len));
    if (code <= t.maxcode[len]) {
      br.skip(len);
      return t.vals[t.valptr[len] + code - t.mincode[len]];
    }
  }
  fail("corrupt Huffman code");
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ---- islow inverse DCT (jidctint.c) ---------------------------------
const int CONST_BITS = 13;
const int PASS1_BITS = 2;
const int64_t FIX_0_298631336 = 2446;
const int64_t FIX_0_390180644 = 3196;
const int64_t FIX_0_541196100 = 4433;
const int64_t FIX_0_765366865 = 6270;
const int64_t FIX_0_899976223 = 7373;
const int64_t FIX_1_175875602 = 9633;
const int64_t FIX_1_501321110 = 12299;
const int64_t FIX_1_847759065 = 15137;
const int64_t FIX_1_961570560 = 16069;
const int64_t FIX_2_053119869 = 16819;
const int64_t FIX_2_562915447 = 20995;
const int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// libjpeg's post-IDCT range-limit table, indexed by (x & 1023) where x
// is the centred sample: clamps x + 128 to [0, 255] for |x| < 512 and
// wraps beyond, exactly as `IDCT_range_limit(cinfo)[x & RANGE_MASK]`.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int v;
      if (i < 128) v = i + 128;
      else if (i < 512) v = 255;
      else if (i < 896) v = 0;
      else v = i - 896;
      t[i] = uint8_t(v);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qq = q + c;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11,
        tmp12, tmp13;
    z2 = int64_t(in[16]) * qq[16];
    z3 = int64_t(in[48]) * qq[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(in[0]) * qq[0];
    z3 = int64_t(in[32]) * qq[32];
    tmp0 = (z2 + z3) * (int64_t(1) << CONST_BITS);
    tmp1 = (z2 - z3) * (int64_t(1) << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * qq[56];
    tmp1 = int64_t(in[40]) * qq[40];
    tmp2 = int64_t(in[24]) * qq[24];
    tmp3 = int64_t(in[8]) * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS - PASS1_BITS;
    ws[c + 0] = int(descale(tmp10 + tmp3, n));
    ws[c + 56] = int(descale(tmp10 - tmp3, n));
    ws[c + 8] = int(descale(tmp11 + tmp2, n));
    ws[c + 48] = int(descale(tmp11 - tmp2, n));
    ws[c + 16] = int(descale(tmp12 + tmp1, n));
    ws[c + 40] = int(descale(tmp12 - tmp1, n));
    ws[c + 24] = int(descale(tmp13 + tmp0, n));
    ws[c + 32] = int(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11,
        tmp12, tmp13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << CONST_BITS);
    tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS + PASS1_BITS + 3;
    o[0] = kRange.t[int(descale(tmp10 + tmp3, n)) & 1023];
    o[7] = kRange.t[int(descale(tmp10 - tmp3, n)) & 1023];
    o[1] = kRange.t[int(descale(tmp11 + tmp2, n)) & 1023];
    o[6] = kRange.t[int(descale(tmp11 - tmp2, n)) & 1023];
    o[2] = kRange.t[int(descale(tmp12 + tmp1, n)) & 1023];
    o[5] = kRange.t[int(descale(tmp12 - tmp1, n)) & 1023];
    o[3] = kRange.t[int(descale(tmp13 + tmp0, n)) & 1023];
    o[4] = kRange.t[int(descale(tmp13 - tmp0, n)) & 1023];
  }
}

// ---- the decoder ------------------------------------------------------
enum ColorSpace { kGray, kYCbCr, kRGB };

struct Jpeg {
  const uint8_t* d;
  size_t n;
  int width = 0, height = 0;
  int hmax = 1, vmax = 1;
  int restart_interval = 0;
  bool progressive = false;
  int ss = 0, se = 63, ah = 0, al = 0;  // the current scan's parameters
  int eobrun = 0;                       // progressive AC scans
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  bool frame_seen = false;
  std::vector<Component> comps;
  uint16_t qt[4][64];  // natural order
  bool qt_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];

  Jpeg(const uint8_t* data, size_t size) : d(data), n(size) {}

  int u16(size_t p) const {
    if (p + 1 >= n) fail("truncated file");
    return (d[p] << 8) | d[p + 1];
  }

  void read_sof(size_t p, int len, int marker) {
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB ||
        marker == 0xCF)
      fail("lossless JPEG is not supported (Huffman baseline and "
           "progressive only)");
    if (marker >= 0xC9)
      fail("arithmetic-coded JPEG is not supported (Huffman baseline and "
           "progressive only)");
    if (marker == 0xC5 || marker == 0xC6)
      fail("hierarchical JPEG is not supported (Huffman baseline and "
           "progressive only)");
    if (frame_seen) fail("more than one frame");
    progressive = marker == 0xC2;
    if (len < 6) fail("bad SOF length");
    frame_seen = true;
    int precision = d[p];
    if (precision != 8)
      fail(std::to_string(precision) +
           "-bit JPEG is not supported (8-bit only)");
    height = u16(p + 1);
    width = u16(p + 3);
    int nc = d[p + 5];
    if (height <= 0 || width <= 0)
      fail("image height 0 (DNL marker) is not supported");
    if (nc != 1 && nc != 3)
      fail(std::to_string(nc) + "-component JPEG is not supported");
    if (len < 6 + 3 * nc) fail("bad SOF length");
    comps.resize(nc);
    for (int i = 0; i < nc; ++i) {
      Component& c = comps[i];
      c.id = d[p + 6 + 3 * i];
      c.h = d[p + 7 + 3 * i] >> 4;
      c.v = d[p + 7 + 3 * i] & 15;
      c.tq = d[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad sampling factors or table index");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (Component& c : comps) {
      if (hmax % c.h || vmax % c.v)
        fail("non-integral sampling ratios are not supported");
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.plane.assign(size_t(c.bw) * 8 * c.bh * 8, 0);
      if (progressive) {
        c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
        std::fill(c.coef_bits, c.coef_bits + 64, -1);
      }
    }
  }

  void read_dqt(size_t p, size_t end) {
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      if (tq > 3) fail("bad quantization table index");
      ++p;
      if (p + (pq ? 128 : 64) > end) fail("truncated quantization table");
      for (int k = 0; k < 64; ++k) {
        int v = pq ? u16(p + 2 * k) : d[p + k];
        qt[tq][kZigzag[k]] = uint16_t(v);
      }
      p += pq ? 128 : 64;
      qt_present[tq] = true;
    }
  }

  void read_dht(size_t p, size_t end) {
    while (p < end) {
      int tc = d[p] >> 4, th = d[p] & 15;
      if (th > 3 || tc > 1) fail("bad Huffman table index");
      if (p + 17 > end) fail("truncated Huffman table");
      const uint8_t* counts = d + p + 1;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i];
      if (total > 256 || p + 17 + total > end) fail("bad Huffman table");
      (tc ? ac[th] : dc[th]).build(counts, d + p + 17, total);
      p += 17 + total;
    }
  }

  // A sequential block: its DC and AC coefficients as a progressive
  // file's first scans code them with Al = 0, then the inverse DCT.
  void decode_block(BitReader& br, Component& c, int bx, int by) {
    int16_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    dc_first(br, c, coef);
    ac_first(br, c, coef, 1);
    eobrun = 0;  // a sequential block ends at its end-of-block code
    idct_block(c, coef, bx, by);
  }

  void idct_block(Component& c, const int16_t* coef, int bx, int by) {
    int stride = c.bw * 8;
    idct_islow(coef, c.q,
               c.plane.data() + size_t(by) * 8 * stride + size_t(bx) * 8,
               stride);
  }

  // ---- progressive scans (jdphuff.c) --------------------------------
  int16_t* coefs(Component& c, int bx, int by) {
    return c.coef.data() + (size_t(by) * c.bw + bx) * 64;
  }

  void dc_first(BitReader& br, Component& c, int16_t* b) {
    int s = decode_huff(br, dc[c.td]);
    int diff = s ? extend(br.get(s), s) : 0;
    c.pred += diff;
    b[0] = int16_t(uint32_t(c.pred) << al);
  }

  void dc_refine(BitReader& br, int16_t* b) {
    if (br.get(1)) b[0] = int16_t(b[0] | (1 << al));
  }

  // The AC coefficients start..se of a block.
  void ac_first(BitReader& br, Component& c, int16_t* b, int start) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huffman& t = ac[c.ta];
    for (int k = start; k <= se; ++k) {
      int rs = decode_huff(br, t);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt AC coefficients");
        b[kZigzag[k]] = int16_t(uint32_t(extend(br.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = (1 << r) - 1;
        if (r) eobrun += br.get(r);
        break;
      }
    }
  }

  // One correction bit for an already-nonzero coefficient.
  void refine_bit(BitReader& br, int16_t* coef) {
    int p1 = 1 << al;
    if (br.get(1) && (*coef & p1) == 0)
      *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef - p1);
  }

  void ac_refine(BitReader& br, Component& c, int16_t* b) {
    int p1 = 1 << al;
    int k = ss;
    if (eobrun == 0) {
      const Huffman& t = ac[c.ta];
      for (; k <= se; ++k) {
        int rs = decode_huff(br, t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail("corrupt AC refinement");
          s = br.get(1) ? p1 : -p1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;  // the rest of the band goes through the EOB run
        }
        // Advance over the nonzero coefficients, refining each, and
        // over r zero coefficients; a new coefficient lands on the next
        // zero one.
        for (; k <= se; ++k) {
          int16_t* coef = b + kZigzag[k];
          if (*coef != 0) {
            refine_bit(br, coef);
          } else {
            if (--r < 0) break;
          }
        }
        if (s) {
          if (k > se) fail("corrupt AC refinement");
          b[kZigzag[k]] = int16_t(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = b + kZigzag[k];
        if (*coef != 0) refine_bit(br, coef);
      }
      --eobrun;
    }
  }

  void decode_progressive(BitReader& br, Component& c, int bx, int by) {
    int16_t* b = coefs(c, bx, by);
    if (ss == 0)
      ah == 0 ? dc_first(br, c, b) : dc_refine(br, b);
    else
      ah == 0 ? ac_first(br, c, b, ss) : ac_refine(br, c, b);
  }

  // libjpeg's checks of a progressive scan's parameters and of the
  // order of the scans (jdphuff.c, start_pass_phuff_decoder); where
  // libjpeg only warns of a bad order, the file is refused.
  void start_progressive_scan(const std::vector<int>& members) {
    bool bad = false;
    if (ss == 0) {
      if (se != 0) bad = true;
    } else {
      if (ss > se || se > 63) bad = true;
      if (members.size() != 1) bad = true;
    }
    if (ah != 0 && al != ah - 1) bad = true;
    if (al > 13) bad = true;
    if (bad) fail("bad progressive scan parameters");
    for (int ci : members) {
      int* bits = comps[ci].coef_bits;
      if (ss != 0 && bits[0] < 0)
        fail("an AC scan before the component's first DC scan");
      for (int k = ss; k <= se; ++k) {
        if (ah != (bits[k] < 0 ? 0 : bits[k]))
          fail("progressive scans out of order");
        bits[k] = al;
      }
    }
    eobrun = 0;
  }

  // After the last scan: every coefficient fully refined, then the
  // blocks the output reads go through the inverse DCT.
  void finish_progressive() {
    for (size_t ci = 0; ci < comps.size(); ++ci) {
      Component& c = comps[ci];
      for (int k = 0; k < 64; ++k)
        if (c.coef_bits[k] != 0)
          fail("incomplete progressive JPEG: coefficient " +
               std::to_string(k) + " of component " + std::to_string(ci) +
               (c.coef_bits[k] < 0 ? " was never sent"
                                   : " is not fully refined") +
               " (libjpeg would smooth the blocks)");
      int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
      for (int by = 0; by < nby; ++by)
        for (int bx = 0; bx < nbx; ++bx)
          idct_block(c, coefs(c, bx, by), bx, by);
    }
  }

  // Decodes one scan starting at `p` (just past its SOS header); returns
  // the position after its entropy-coded data.
  size_t decode_scan(size_t p, const std::vector<int>& members) {
    if (progressive) start_progressive_scan(members);
    // Which tables the scan reads: DC refinement reads none, AC scans of
    // a progressive file only their AC table.
    bool needs_dc = !progressive || (ss == 0 && ah == 0);
    bool needs_ac = !progressive || ss != 0;
    for (int ci : members) {
      Component& c = comps[ci];
      if (!c.q_latched) {
        if (!qt_present[c.tq]) fail("missing quantization table");
        std::memcpy(c.q, qt[c.tq], sizeof(c.q));
        c.q_latched = true;
      }
      // A scan whose table was never defined (Motion-JPEG frames leave
      // out DHT) takes the standard table of its index, as libjpeg's
      // jpeg_make_d_derived_tbl does through jpeg_std_huff_table; there
      // are standard tables for indices 0 and 1 only.
      if (needs_dc && !dc[c.td].present) {
        if (c.td > 1) fail("missing Huffman table");
        dc[c.td].build(c.td ? jpeg_std::kDcChromBits + 1
                            : jpeg_std::kDcLumBits + 1,
                       c.td ? jpeg_std::kDcChromVals : jpeg_std::kDcLumVals,
                       12);
      }
      if (needs_ac && !ac[c.ta].present) {
        if (c.ta > 1) fail("missing Huffman table");
        ac[c.ta].build(c.ta ? jpeg_std::kAcChromBits + 1
                            : jpeg_std::kAcLumBits + 1,
                       c.ta ? jpeg_std::kAcChromVals : jpeg_std::kAcLumVals,
                       162);
      }
      c.pred = 0;
    }
    BitReader br(d, n, p);
    int restarts = 0;
    int todo = restart_interval;
    auto restart_if_due = [&](bool last) {
      if (restart_interval == 0 || last) return;
      if (--todo == 0) {
        br.restart(restarts & 7);
        ++restarts;
        todo = restart_interval;
        for (int ci : members) comps[ci].pred = 0;
        eobrun = 0;
      }
    };
    auto block = [&](Component& c, int bx, int by) {
      if (progressive)
        decode_progressive(br, c, bx, by);
      else
        decode_block(br, c, bx, by);
    };
    if (members.size() == 1) {
      Component& c = comps[members[0]];
      int nbx = (c.dw + 7) / 8, nby = (c.dh + 7) / 8;
      for (int by = 0; by < nby; ++by)
        for (int bx = 0; bx < nbx; ++bx) {
          block(c, bx, by);
          restart_if_due(by == nby - 1 && bx == nbx - 1);
        }
    } else {
      int mcux = (width + 8 * hmax - 1) / (8 * hmax);
      int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          for (int ci : members) {
            Component& c = comps[ci];
            for (int v = 0; v < c.v; ++v)
              for (int h = 0; h < c.h; ++h)
                block(c, mx * c.h + h, my * c.v + v);
          }
          restart_if_due(my == mcuy - 1 && mx == mcux - 1);
        }
    }
    return br.end_of_scan();
  }

  void decode() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    size_t p = 2;
    std::vector<bool> scanned;
    bool done = false;
    while (!done) {
      while (p < n && d[p] != 0xFF) ++p;  // tolerate junk between segments
      while (p < n && d[p] == 0xFF) ++p;
      if (p >= n) fail("truncated file (no EOI)");
      int marker = d[p++];
      if (marker == 0xD9) break;
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      int len = u16(p);
      if (len < 2 || p + len > n) fail("truncated segment");
      size_t body = p + 2, end = p + len;
      switch (marker) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC5: case 0xC6:
        case 0xC7: case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE:
        case 0xCF:
          read_sof(body, len - 2, marker);
          scanned.assign(comps.size(), false);
          break;
        case 0xCC:
          fail("arithmetic-coded JPEG is not supported (Huffman baseline "
             "and progressive only)");
        case 0xC4:
          read_dht(body, end);
          break;
        case 0xDB:
          read_dqt(body, end);
          break;
        case 0xDD:
          if (len < 4) fail("bad DRI length");
          restart_interval = u16(body);
          break;
        case 0xDC:
          fail("DNL marker is not supported");
        case 0xE0:
          if (len >= 7 && std::memcmp(d + body, "JFIF\0", 5) == 0)
            jfif = true;
          break;
        case 0xEE:
          if (len >= 14 && std::memcmp(d + body, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = d[body + 11];
          }
          break;
        case 0xDA: {
          if (!frame_seen) fail("scan before frame header");
          int ns = d[body];
          if (ns < 1 || ns > 4 || len < 6 + 2 * ns) fail("bad SOS");
          std::vector<int> members;
          for (int i = 0; i < ns; ++i) {
            int cid = d[body + 1 + 2 * i];
            int tables = d[body + 2 + 2 * i];
            int ci = -1;
            for (size_t k = 0; k < comps.size(); ++k)
              if (comps[k].id == cid) ci = int(k);
            if (ci < 0) fail("scan names an unknown component");
            comps[ci].td = tables >> 4;
            comps[ci].ta = tables & 15;
            if (comps[ci].td > 3 || comps[ci].ta > 3)
              fail("bad Huffman table index");
            members.push_back(ci);
            scanned[ci] = true;
          }
          size_t q = body + 1 + 2 * ns;
          ss = d[q];
          se = d[q + 1];
          ah = d[q + 2] >> 4;
          al = d[q + 2] & 15;
          if (!progressive && (ss != 0 || se != 63 || ah != 0 || al != 0))
            fail("progressive scan parameters in a sequential file");
          p = decode_scan(end, members);
          continue;
        }
        default:
          break;
      }
      p = end;
    }
    if (!frame_seen) fail("no frame header");
    for (bool s : scanned)
      if (!s) fail("a component has no scan");
    if (progressive) finish_progressive();
  }

  ColorSpace color_space() const {
    if (comps.size() == 1) return kGray;
    if (jfif) return kYCbCr;
    if (adobe) return adobe_transform == 0 ? kRGB : kYCbCr;
    if (comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66)
      return kRGB;
    return kYCbCr;
  }

  // Row `r` of component `c`'s sample rows as libjpeg's context sees
  // them: rows past the downsampled height repeat its last row, rows
  // above the top repeat row 0.
  const uint8_t* row(const Component& c, int r) const {
    if (r < 0) r = 0;
    if (r > c.dh - 1) r = c.dh - 1;
    return c.plane.data() + size_t(r) * c.bw * 8;
  }

  // Upsamples output row `y` (full resolution) of component `c` into
  // `out` (at least width + 8 samples).
  void upsample_row(const Component& c, int y, uint8_t* out) const {
    int hr = hmax / c.h, vr = vmax / c.v;
    int dw = c.dw;
    if (hr == 1 && vr == 1) {
      std::memcpy(out, row(c, y), width);
      return;
    }
    if (hr == 2 && vr == 1 && dw > 2) {  // h2v1_fancy_upsample
      const uint8_t* in = row(c, y);
      int o = 0;
      int inv = in[0];
      out[o++] = uint8_t(inv);
      out[o++] = uint8_t((inv * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; ++i) {
        inv = in[i] * 3;
        out[o++] = uint8_t((inv + in[i - 1] + 1) >> 2);
        out[o++] = uint8_t((inv + in[i + 1] + 2) >> 2);
      }
      inv = in[dw - 1];
      out[o++] = uint8_t((inv * 3 + in[dw - 2] + 1) >> 2);
      out[o++] = uint8_t(inv);
      return;
    }
    if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
      int r = y >> 1;
      bool below = y & 1;
      const uint8_t* in0 = row(c, r);
      const uint8_t* in1 = row(c, below ? r + 1 : r - 1);
      int bias = below ? 2 : 1;
      for (int i = 0; i < dw; ++i)
        out[i] = uint8_t((in0[i] * 3 + in1[i] + bias) >> 2);
      return;
    }
    if (hr == 2 && vr == 2 && dw > 2) {  // h2v2_fancy_upsample
      int r = y >> 1;
      bool below = y & 1;
      const uint8_t* in0 = row(c, r);
      const uint8_t* in1 = row(c, below ? r + 1 : r - 1);
      int o = 0;
      int thiscolsum = in0[0] * 3 + in1[0];
      int nextcolsum = in0[1] * 3 + in1[1];
      out[o++] = uint8_t((thiscolsum * 4 + 8) >> 4);
      out[o++] = uint8_t((thiscolsum * 3 + nextcolsum + 7) >> 4);
      int lastcolsum = thiscolsum;
      thiscolsum = nextcolsum;
      for (int i = 2; i < dw; ++i) {
        nextcolsum = in0[i] * 3 + in1[i];
        out[o++] = uint8_t((thiscolsum * 3 + lastcolsum + 8) >> 4);
        out[o++] = uint8_t((thiscolsum * 3 + nextcolsum + 7) >> 4);
        lastcolsum = thiscolsum;
        thiscolsum = nextcolsum;
      }
      out[o++] = uint8_t((thiscolsum * 3 + lastcolsum + 8) >> 4);
      out[o++] = uint8_t((thiscolsum * 4 + 7) >> 4);
      return;
    }
    // int_upsample / h2v1_upsample / h2v2_upsample: replicate samples.
    const uint8_t* in = row(c, y / vr);
    for (int i = 0; i < dw; ++i)
      for (int k = 0; k < hr; ++k) out[i * hr + k] = in[i];
  }

  void to_bgr(uint8_t* out) const {
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
    auto FIX = [](double x) {
      return int64_t(x * double(int64_t(1) << 16) + 0.5);
    };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = int((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = int((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -FIX(0.71414) * x;
      cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) {
      return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    ColorSpace cs = color_space();
    size_t nc = comps.size();
    std::vector<std::vector<uint8_t>> rows(
        nc, std::vector<uint8_t>(size_t(width) + 8 * hmax + 8));
    for (int y = 0; y < height; ++y) {
      for (size_t k = 0; k < nc; ++k) upsample_row(comps[k], y, rows[k].data());
      uint8_t* o = out + size_t(y) * width * 3;
      if (cs == kGray) {
        const uint8_t* g = rows[0].data();
        for (int x = 0; x < width; ++x) o[3 * x] = o[3 * x + 1] =
            o[3 * x + 2] = g[x];
      } else if (cs == kRGB) {
        for (int x = 0; x < width; ++x) {
          o[3 * x] = rows[2][x];
          o[3 * x + 1] = rows[1][x];
          o[3 * x + 2] = rows[0][x];
        }
      } else {
        const uint8_t* Y = rows[0].data();
        const uint8_t* Cb = rows[1].data();
        const uint8_t* Cr = rows[2].data();
        for (int x = 0; x < width; ++x) {
          int yy = Y[x], cb = Cb[x], cr = Cr[x];
          o[3 * x + 2] = clamp(yy + cr_r[cr]);
          o[3 * x + 1] =
              clamp(yy + int((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
          o[3 * x] = clamp(yy + cb_b[cb]);
        }
      }
    }
  }
};

int report(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s",
                                       e.msg.c_str());
  return 1;
}

}  // namespace

extern "C" {

// Reads the frame header: width, height and component count.
int jpeg_info(const uint8_t* data, size_t n, int* width, int* height,
              int* components, char* err, int errlen) {
  try {
    Jpeg j(data, n);
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    size_t p = 2;
    while (true) {
      while (p < n && data[p] != 0xFF) ++p;
      while (p < n && data[p] == 0xFF) ++p;
      if (p >= n) fail("no frame header");
      int marker = data[p++];
      if (marker == 0xD9 || marker == 0xDA) fail("no frame header");
      if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
      int len = j.u16(p);
      if (len < 2 || p + len > n) fail("truncated segment");
      if ((marker >= 0xC0 && marker <= 0xCF) && marker != 0xC4 &&
          marker != 0xC8 && marker != 0xCC) {
        j.read_sof(p + 2, len - 2, marker);
        break;
      }
      if (marker == 0xCC)
        fail("arithmetic-coded JPEG is not supported (Huffman baseline "
             "and progressive only)");
      p += len;
    }
    *width = j.width;
    *height = j.height;
    *components = int(j.comps.size());
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{e.what()}, err, errlen);
  }
}

// Decodes a baseline or progressive JPEG into `out` (height x width x 3,
// BGR).
int jpeg_decode_bgr(const uint8_t* data, size_t n, uint8_t* out,
                    int width, int height, char* err, int errlen) {
  try {
    Jpeg j(data, n);
    j.decode();
    if (j.width != width || j.height != height)
      fail("output buffer does not match the frame size");
    j.to_bgr(out);
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::exception& e) {
    return report(Error{e.what()}, err, errlen);
  }
}

// Undoes the PNG row filters (types 0-4) of one non-interlaced image:
// `in` holds `height` rows of one filter byte and `rowbytes` bytes,
// `bpp` is the bytes per complete pixel (1 for sub-byte depths).
int png_unfilter(const uint8_t* in, uint8_t* out, int height, int rowbytes,
                 int bpp, char* err, int errlen) {
  try {
    std::vector<uint8_t> zero(size_t(rowbytes), 0);
    for (int y = 0; y < height; ++y) {
      const uint8_t* src = in + size_t(y) * (rowbytes + 1);
      int ft = src[0];
      ++src;
      uint8_t* dst = out + size_t(y) * rowbytes;
      const uint8_t* up = y ? out + size_t(y - 1) * rowbytes : zero.data();
      switch (ft) {
        case 0:
          std::memcpy(dst, src, rowbytes);
          break;
        case 1:
          for (int i = 0; i < rowbytes; ++i)
            dst[i] = uint8_t(src[i] + (i >= bpp ? dst[i - bpp] : 0));
          break;
        case 2:
          for (int i = 0; i < rowbytes; ++i) dst[i] = uint8_t(src[i] + up[i]);
          break;
        case 3:
          for (int i = 0; i < rowbytes; ++i) {
            int a = i >= bpp ? dst[i - bpp] : 0;
            dst[i] = uint8_t(src[i] + ((a + up[i]) >> 1));
          }
          break;
        case 4:
          for (int i = 0; i < rowbytes; ++i) {
            int a = i >= bpp ? dst[i - bpp] : 0;
            int b = up[i];
            int c = i >= bpp ? up[i - bpp] : 0;
            int pp = a + b - c;
            int pa = pp > a ? pp - a : a - pp;
            int pb = pp > b ? pp - b : b - pp;
            int pc = pp > c ? pp - c : c - pp;
            int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
            dst[i] = uint8_t(src[i] + pred);
          }
          break;
        default:
          fail("bad PNG filter type " + std::to_string(ft) + " in row " +
               std::to_string(y));
      }
    }
    return 0;
  } catch (const Error& e) {
    return report(e, err, errlen);
  }
}

}  // extern "C"
