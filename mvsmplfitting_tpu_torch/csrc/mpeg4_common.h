// Shared parts of the MPEG-4 Part 2 Simple Profile decoder
// (`mpeg4_decode.cpp`) and encoder (`mpeg4_encode.cpp`): the bit
// reader and writer, the variable-length code tables of ISO/IEC
// 14496-2 Annex B, the 8-bit integer "simple" inverse DCT that
// libavcodec picks for streams that are not marked as Xvid's, the
// half-pel motion compensation over edge-extended references, and the
// intra DC/AC and motion-vector predictors.  The encoder reconstructs
// its references with these same functions, so that what it predicts
// from is what any decoder of the stream holds.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace m4v {

struct Error {
  std::string msg;
};

[[noreturn]] inline void fail(const std::string& msg) { throw Error{msg}; }

// ---------------------------------------------------------------- bits

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t n) : d_(data), n_(n), pos_(0) {}
  // Bits past the end read as 0; `overrun()` tells.
  uint32_t peek(int k) const {
    uint32_t v = 0;
    size_t p = pos_;
    for (int i = 0; i < k; ++i, ++p) {
      size_t byte = p >> 3;
      uint32_t b = byte < n_ ? (d_[byte] >> (7 - (p & 7))) & 1 : 0;
      v = (v << 1) | b;
    }
    return v;
  }
  uint32_t get(int k) {
    uint32_t v = peek(k);
    pos_ += k;
    return v;
  }
  int get1() { return (int)get(1); }
  int sget(int k) {  // two's complement
    uint32_t v = get(k);
    return (v & (1u << (k - 1))) ? (int)v - (1 << k) : (int)v;
  }
  void skip(int k) { pos_ += k; }
  size_t pos() const { return pos_; }
  size_t size_bits() const { return n_ * 8; }
  bool overrun() const { return pos_ > n_ * 8; }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_;
};

class BitWriter {
 public:
  void put(int k, uint32_t v) {
    for (int i = k - 1; i >= 0; --i) {
      acc_ = (acc_ << 1) | ((v >> i) & 1);
      if (++nacc_ == 8) {
        buf_.push_back((uint8_t)acc_);
        acc_ = 0;
        nacc_ = 0;
      }
    }
  }
  void put_signed(int k, int v) { put(k, (uint32_t)v & ((1u << k) - 1)); }
  // MPEG-4 stuffing: a 0 then 1s up to the byte boundary.
  void stuff() {
    put(1, 0);
    while (nacc_) put(1, 1);
  }
  std::vector<uint8_t>& buf() { return buf_; }

 private:
  std::vector<uint8_t> buf_;
  uint32_t acc_ = 0;
  int nacc_ = 0;
};

// ---------------------------------------------------------------- VLC tables

// Table B-6/B-7: intra and inter mcbpc.  Inter index bits: &3 the
// chroma cbp, &4 intra, &8 dquant, &16 four vectors; 20 is stuffing.
static const uint8_t kIntraMcbpcCode[9] = {1, 1, 2, 3, 1, 1, 2, 3, 1};
static const uint8_t kIntraMcbpcLen[9] = {1, 3, 3, 3, 4, 6, 6, 6, 9};
static const uint8_t kInterMcbpcCode[21] = {1, 3, 2, 5, 3, 4, 3, 3, 3, 7, 6,
                                            5, 4, 4, 3, 2, 2, 5, 4, 5, 1};
static const uint8_t kInterMcbpcLen[21] = {1, 4, 4, 6, 5, 8, 8, 7, 3, 7, 7,
                                           9, 6, 9, 9, 9, 3, 7, 7, 8, 9};
// Table B-8: cbpy of intra macroblocks (inter ones are its complement).
static const uint8_t kCbpy[16][2] = {
    {3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
    {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
// Table B-12: motion vector difference magnitudes (a sign bit follows).
static const uint8_t kMv[33][2] = {
    {1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},
    {3, 7},   {11, 9},  {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10},
    {14, 10}, {13, 10}, {12, 10}, {11, 10}, {10, 10}, {9, 10},  {8, 10},
    {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},  {5, 11},
    {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};
// Tables B-13/B-14: dct_dc_size of luminance and chrominance.
static const uint8_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},
                                      {1, 4}, {1, 5}, {1, 6}, {1, 7}, {1, 8},
                                      {1, 9}, {1, 10}, {1, 11}};
static const uint8_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3},
                                        {1, 4}, {1, 5}, {1, 6}, {1, 7},
                                        {1, 8}, {1, 9}, {1, 10}, {1, 11},
                                        {1, 12}};
static const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
static const int kDquant[4] = {-1, -2, 1, 2};

// Tables B-16 (intra) and B-17 (inter) TCOEF: codes (the last is the
// escape), then run and level of each; entries from kIntraLast /
// kInterLast on have last = 1.
static const uint16_t kIntraVlc[103][2] = {
    {0x2, 2}, {0x6, 3}, {0xf, 4}, {0xd, 5}, {0xc, 5}, {0x15, 6},
    {0x13, 6}, {0x12, 6}, {0x17, 7}, {0x1f, 8}, {0x1e, 8}, {0x1d, 8},
    {0x25, 9}, {0x24, 9}, {0x23, 9}, {0x21, 9}, {0x21, 10}, {0x20, 10},
    {0xf, 10}, {0xe, 10}, {0x7, 11}, {0x6, 11}, {0x20, 11}, {0x21, 11},
    {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4}, {0x14, 6}, {0x16, 7},
    {0x1c, 8}, {0x20, 9}, {0x1f, 9}, {0xd, 10}, {0x22, 11}, {0x53, 12},
    {0x55, 12}, {0xb, 5}, {0x15, 7}, {0x1e, 9}, {0xc, 10}, {0x56, 12},
    {0x11, 6}, {0x1b, 8}, {0x1d, 9}, {0xb, 10}, {0x10, 6}, {0x22, 9},
    {0xa, 10}, {0xd, 6}, {0x1c, 9}, {0x8, 10}, {0x12, 7}, {0x1b, 9},
    {0x54, 12}, {0x14, 7}, {0x1a, 9}, {0x57, 12}, {0x19, 8}, {0x9, 10},
    {0x18, 8}, {0x23, 11}, {0x17, 8}, {0x19, 9}, {0x18, 9}, {0x7, 10},
    {0x58, 12}, {0x7, 4}, {0xc, 6}, {0x16, 8}, {0x17, 9}, {0x6, 10},
    {0x5, 11}, {0x4, 11}, {0x59, 12}, {0xf, 6}, {0x16, 9}, {0x5, 10},
    {0xe, 6}, {0x4, 10}, {0x11, 7}, {0x24, 11}, {0x10, 7}, {0x25, 11},
    {0x13, 7}, {0x5a, 12}, {0x15, 8}, {0x5b, 12}, {0x14, 8}, {0x13, 8},
    {0x1a, 8}, {0x15, 9}, {0x14, 9}, {0x13, 9}, {0x12, 9}, {0x11, 9},
    {0x26, 11}, {0x27, 11}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12},
    {0x3, 7},
};
static const uint8_t kIntraRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4,
    4, 5, 5, 5, 6, 6, 6, 7, 7, 7, 8, 8, 9, 9, 10, 11,
    12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2,
    3, 3, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14,
    15, 16, 17, 18, 19, 20,
};
static const uint8_t kIntraLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 1, 2, 3, 4, 5,
    6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2,
    3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 1,
    1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 1, 2,
    1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1,
};
static const uint16_t kInterVlc[103][2] = {
    {0x2, 2}, {0xf, 4}, {0x15, 6}, {0x17, 7}, {0x1f, 8}, {0x25, 9},
    {0x24, 9}, {0x21, 10}, {0x20, 10}, {0x7, 11}, {0x6, 11}, {0x20, 11},
    {0x6, 3}, {0x14, 6}, {0x1e, 8}, {0xf, 10}, {0x21, 11}, {0x50, 12},
    {0xe, 4}, {0x1d, 8}, {0xe, 10}, {0x51, 12}, {0xd, 5}, {0x23, 9},
    {0xd, 10}, {0xc, 5}, {0x22, 9}, {0x52, 12}, {0xb, 5}, {0xc, 10},
    {0x53, 12}, {0x13, 6}, {0xb, 10}, {0x54, 12}, {0x12, 6}, {0xa, 10},
    {0x11, 6}, {0x9, 10}, {0x10, 6}, {0x8, 10}, {0x16, 7}, {0x55, 12},
    {0x15, 7}, {0x14, 7}, {0x1c, 8}, {0x1b, 8}, {0x21, 9}, {0x20, 9},
    {0x1f, 9}, {0x1e, 9}, {0x1d, 9}, {0x1c, 9}, {0x1b, 9}, {0x1a, 9},
    {0x22, 11}, {0x23, 11}, {0x56, 12}, {0x57, 12}, {0x7, 4}, {0x19, 9},
    {0x5, 11}, {0xf, 6}, {0x4, 11}, {0xe, 6}, {0xd, 6}, {0xc, 6},
    {0x13, 7}, {0x12, 7}, {0x11, 7}, {0x10, 7}, {0x1a, 8}, {0x19, 8},
    {0x18, 8}, {0x17, 8}, {0x16, 8}, {0x15, 8}, {0x14, 8}, {0x13, 8},
    {0x18, 9}, {0x17, 9}, {0x16, 9}, {0x15, 9}, {0x14, 9}, {0x13, 9},
    {0x12, 9}, {0x11, 9}, {0x7, 10}, {0x6, 10}, {0x5, 10}, {0x4, 10},
    {0x24, 11}, {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12},
    {0x5a, 12}, {0x5b, 12}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12},
    {0x3, 7},
};
static const uint8_t kInterRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6,
    6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0, 0, 0, 1, 1, 2,
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 38, 39, 40,
};
static const uint8_t kInterLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4,
    5, 6, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1,
    2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1,
};
static const int kIntraLast = 67;
static const int kInterLast = 58;

static const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
static const uint8_t kAltHorizontal[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
static const uint8_t kAltVertical[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};

// A prefix code decoded through a table of 2^maxlen entries.
struct Vlc {
  int maxlen = 0;
  std::vector<int16_t> sym;  // -1: no code
  std::vector<uint8_t> len;
  void build(int n, const uint8_t (*tab)[2]) {  // {code, len}
    std::vector<std::pair<uint32_t, int>> c(n);
    for (int i = 0; i < n; ++i) c[i] = {tab[i][0], tab[i][1]};
    build(c);
  }
  void build(const std::vector<std::pair<uint32_t, int>>& c) {
    maxlen = 0;
    for (auto& e : c) maxlen = std::max(maxlen, e.second);
    sym.assign(size_t(1) << maxlen, -1);
    len.assign(size_t(1) << maxlen, 0);
    for (size_t i = 0; i < c.size(); ++i) {
      if (c[i].second == 0) continue;
      int shift = maxlen - c[i].second;
      uint32_t base = c[i].first << shift;
      for (uint32_t f = 0; f < (1u << shift); ++f) {
        sym[base + f] = (int16_t)i;
        len[base + f] = (uint8_t)c[i].second;
      }
    }
  }
  int read(BitReader& br) const {  // -1 on an invalid code
    uint32_t v = br.peek(maxlen);
    int s = sym[v];
    if (s >= 0) br.skip(len[v]);
    return s;
  }
};

struct RunLevel {
  Vlc vlc;
  const uint16_t (*codes)[2];
  const uint8_t* run;
  const uint8_t* level;
  int nlast;  // index of the first last = 1 entry
  int max_level[2][64];
  int max_run[2][64];
  // index + 1 of (last, run, level), 0 when there is no code
  int16_t index[2][64][64];
  void build(const uint16_t (*c)[2], const uint8_t* r, const uint8_t* l,
             int last_from) {
    codes = c;
    run = r;
    level = l;
    nlast = last_from;
    std::vector<std::pair<uint32_t, int>> v(103);
    for (int i = 0; i < 103; ++i) v[i] = {c[i][0], c[i][1]};
    vlc.build(v);
    std::memset(max_level, 0, sizeof(max_level));
    std::memset(max_run, 0, sizeof(max_run));
    std::memset(index, 0, sizeof(index));
    for (int i = 0; i < 102; ++i) {
      int last = i >= last_from;
      max_level[last][r[i]] = std::max(max_level[last][r[i]], (int)l[i]);
      max_run[last][l[i]] = std::max(max_run[last][l[i]], (int)r[i]);
      index[last][r[i]][l[i]] = (int16_t)(i + 1);
    }
  }
};

struct Tables {
  Vlc intra_mcbpc, inter_mcbpc, cbpy, mv, dc_lum, dc_chrom;
  RunLevel intra, inter;
  Tables() {
    intra_mcbpc.build(std::vector<std::pair<uint32_t, int>>(
        {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4}, {1, 6}, {2, 6}, {3, 6},
         {1, 9}}));
    std::vector<std::pair<uint32_t, int>> im(21);
    for (int i = 0; i < 21; ++i) im[i] = {kInterMcbpcCode[i], kInterMcbpcLen[i]};
    inter_mcbpc.build(im);
    std::vector<std::pair<uint32_t, int>> cb(16);
    for (int i = 0; i < 16; ++i) cb[i] = {kCbpy[i][0], kCbpy[i][1]};
    cbpy.build(cb);
    mv.build(33, kMv);
    dc_lum.build(13, kDcLum);
    dc_chrom.build(13, kDcChrom);
    intra.build(kIntraVlc, kIntraRun, kIntraLevel, kIntraLast);
    inter.build(kInterVlc, kInterRun, kInterLevel, kInterLast);
  }
};

inline const Tables& tables() {
  static const Tables t;
  return t;
}

inline int y_dc_scale(int q) {
  return q < 5 ? 8 : q < 9 ? 2 * q : q < 25 ? q + 8 : 2 * q - 16;
}
inline int c_dc_scale(int q) {
  return q < 5 ? 8 : q < 25 ? (q + 13) / 2 : q - 6;
}
inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// ---------------------------------------------------------------- IDCT
// libavcodec's simple_idct_template.c at 8 bits: 14-bit constants, a
// row pass (a row with only a DC term is scaled by 8 instead) then a
// column pass, in 32-bit arithmetic.

namespace idct_detail {
const int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873,
          W6 = 8867, W7 = 4520;
const int ROW_SHIFT = 11, COL_SHIFT = 20;

inline void row(int16_t* r) {
  if (!(r[1] | r[2] | r[3] | r[4] | r[5] | r[6] | r[7])) {
    int16_t v = (int16_t)(uint16_t)((uint32_t)r[0] << 3);
    for (int i = 0; i < 8; ++i) r[i] = v;
    return;
  }
  uint32_t a0 = (uint32_t)W4 * r[0] + (1u << (ROW_SHIFT - 1));
  uint32_t a1 = a0, a2 = a0, a3 = a0;
  a0 += (uint32_t)W2 * r[2];
  a1 += (uint32_t)W6 * r[2];
  a2 -= (uint32_t)W6 * r[2];
  a3 -= (uint32_t)W2 * r[2];
  uint32_t b0 = (uint32_t)W1 * r[1] + (uint32_t)W3 * r[3];
  uint32_t b1 = (uint32_t)W3 * r[1] - (uint32_t)W7 * r[3];
  uint32_t b2 = (uint32_t)W5 * r[1] - (uint32_t)W1 * r[3];
  uint32_t b3 = (uint32_t)W7 * r[1] - (uint32_t)W5 * r[3];
  a0 += (uint32_t)W4 * r[4] + (uint32_t)W6 * r[6];
  a1 += -(uint32_t)W4 * r[4] - (uint32_t)W2 * r[6];
  a2 += -(uint32_t)W4 * r[4] + (uint32_t)W2 * r[6];
  a3 += (uint32_t)W4 * r[4] - (uint32_t)W6 * r[6];
  b0 += (uint32_t)W5 * r[5] + (uint32_t)W7 * r[7];
  b1 += -(uint32_t)W1 * r[5] - (uint32_t)W5 * r[7];
  b2 += (uint32_t)W7 * r[5] + (uint32_t)W3 * r[7];
  b3 += (uint32_t)W3 * r[5] - (uint32_t)W1 * r[7];
  r[0] = (int16_t)((int32_t)(a0 + b0) >> ROW_SHIFT);
  r[7] = (int16_t)((int32_t)(a0 - b0) >> ROW_SHIFT);
  r[1] = (int16_t)((int32_t)(a1 + b1) >> ROW_SHIFT);
  r[6] = (int16_t)((int32_t)(a1 - b1) >> ROW_SHIFT);
  r[2] = (int16_t)((int32_t)(a2 + b2) >> ROW_SHIFT);
  r[5] = (int16_t)((int32_t)(a2 - b2) >> ROW_SHIFT);
  r[3] = (int16_t)((int32_t)(a3 + b3) >> ROW_SHIFT);
  r[4] = (int16_t)((int32_t)(a3 - b3) >> ROW_SHIFT);
}

inline void col(const int16_t* c, int out[8]) {
  uint32_t a0 = (uint32_t)W4 * (c[0] + ((1 << (COL_SHIFT - 1)) / W4));
  uint32_t a1 = a0, a2 = a0, a3 = a0;
  a0 += (uint32_t)W2 * c[16];
  a1 += (uint32_t)W6 * c[16];
  a2 += -(uint32_t)W6 * c[16];
  a3 += -(uint32_t)W2 * c[16];
  uint32_t b0 = (uint32_t)W1 * c[8] + (uint32_t)W3 * c[24];
  uint32_t b1 = (uint32_t)W3 * c[8] - (uint32_t)W7 * c[24];
  uint32_t b2 = (uint32_t)W5 * c[8] - (uint32_t)W1 * c[24];
  uint32_t b3 = (uint32_t)W7 * c[8] - (uint32_t)W5 * c[24];
  a0 += (uint32_t)W4 * c[32];
  a1 += -(uint32_t)W4 * c[32];
  a2 += -(uint32_t)W4 * c[32];
  a3 += (uint32_t)W4 * c[32];
  b0 += (uint32_t)W5 * c[40];
  b1 += -(uint32_t)W1 * c[40];
  b2 += (uint32_t)W7 * c[40];
  b3 += (uint32_t)W3 * c[40];
  a0 += (uint32_t)W6 * c[48];
  a1 += -(uint32_t)W2 * c[48];
  a2 += (uint32_t)W2 * c[48];
  a3 += -(uint32_t)W6 * c[48];
  b0 += (uint32_t)W7 * c[56];
  b1 += -(uint32_t)W5 * c[56];
  b2 += (uint32_t)W3 * c[56];
  b3 += -(uint32_t)W1 * c[56];
  out[0] = (int32_t)(a0 + b0) >> COL_SHIFT;
  out[1] = (int32_t)(a1 + b1) >> COL_SHIFT;
  out[2] = (int32_t)(a2 + b2) >> COL_SHIFT;
  out[3] = (int32_t)(a3 + b3) >> COL_SHIFT;
  out[4] = (int32_t)(a3 - b3) >> COL_SHIFT;
  out[5] = (int32_t)(a2 - b2) >> COL_SHIFT;
  out[6] = (int32_t)(a1 - b1) >> COL_SHIFT;
  out[7] = (int32_t)(a0 - b0) >> COL_SHIFT;
}
}  // namespace idct_detail

// The inverse transform of `blk` (row-major, modified) written to
// `dst` (put) or added to it (add), clipped to 0..255.
inline void idct(int16_t* blk, uint8_t* dst, int stride, bool add) {
  for (int i = 0; i < 8; ++i) idct_detail::row(blk + 8 * i);
  for (int x = 0; x < 8; ++x) {
    int out[8];
    idct_detail::col(blk + x, out);
    for (int y = 0; y < 8; ++y) {
      uint8_t* p = dst + y * stride + x;
      *p = clip8(add ? *p + out[y] : out[y]);
    }
  }
}

// ---------------------------------------------------------------- pictures

struct Plane {
  int w = 0, h = 0;  // macroblock-aligned
  std::vector<uint8_t> px;
  void init(int w_, int h_) {
    w = w_;
    h = h_;
    px.assign(size_t(w) * h, 0);
  }
  uint8_t* at(int x, int y) { return px.data() + size_t(y) * w + x; }
  // The pixel at (x, y) with both clamped into the plane: the edge
  // extension of unrestricted motion vectors.
  uint8_t ext(int x, int y) const {
    x = x < 0 ? 0 : x >= w ? w - 1 : x;
    y = y < 0 ? 0 : y >= h ? h - 1 : y;
    return px[size_t(y) * w + x];
  }
};

struct Picture {
  Plane p[3];
  void init(int mbw, int mbh) {
    p[0].init(16 * mbw, 16 * mbh);
    p[1].init(8 * mbw, 8 * mbh);
    p[2].init(8 * mbw, 8 * mbh);
  }
};

// Half-pel prediction of a bw x bh block at integer position (sx, sy)
// of `ref` with the half-pel flags of `dxy` (bit 0: x, bit 1: y) and
// the rounding control `rnd` (1: round half up, 0: vop_rounding_type
// 1, down).  Pixels outside the plane repeat its edge.
inline void hpel(const Plane& ref, int sx, int sy, int dxy, int bw, int bh,
                 bool no_rounding, uint8_t* dst, int dstride) {
  int r1 = no_rounding ? 0 : 1, r2 = no_rounding ? 1 : 2;
  bool inside = sx >= 0 && sy >= 0 && sx + bw + 1 <= ref.w &&
                sy + bh + 1 <= ref.h;
  for (int y = 0; y < bh; ++y) {
    for (int x = 0; x < bw; ++x) {
      int a, b, c, d;
      if (inside) {
        const uint8_t* s = ref.px.data() + size_t(sy + y) * ref.w + sx + x;
        a = s[0];
        b = s[1];
        c = s[ref.w];
        d = s[ref.w + 1];
      } else {
        a = ref.ext(sx + x, sy + y);
        b = ref.ext(sx + x + 1, sy + y);
        c = ref.ext(sx + x, sy + y + 1);
        d = ref.ext(sx + x + 1, sy + y + 1);
      }
      int v;
      switch (dxy) {
        case 0: v = a; break;
        case 1: v = (a + b + r1) >> 1; break;
        case 2: v = (a + c + r1) >> 1; break;
        default: v = (a + b + c + d + r2) >> 2; break;
      }
      dst[y * dstride + x] = (uint8_t)v;
    }
  }
}

// The chroma vector of four luma vectors summed (`s`, half-pel units):
// Table 7-9's rounding of the sixteenths.
inline int chroma_4mv(int s) {
  static const int tab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
  return tab[s & 15] + ((s >> 3) & ~1);
}

// ---------------------------------------------------------------- state

// Per-VOP macroblock state shared by the predictors: which macroblocks
// are intra, in which video packet each was coded, their quantisers,
// the DC and AC values of intra blocks and the vectors of every 8x8
// luma block.
struct MbState {
  int mbw = 0, mbh = 0;
  std::vector<int> packet;     // video packet of each coded MB, -1 before
  std::vector<uint8_t> intra;  // per MB
  std::vector<int8_t> qscale;  // per MB
  // DC (scaled, clipped to 0..2047) and AC (quantised: [1..7] first
  // column, [9..15] first row) of the 4 luma blocks and 2 chroma
  // blocks of each MB
  std::vector<int> dc;
  std::vector<int16_t> ac;
  std::vector<int16_t> mv;  // (2mbw) x (2mbh) blocks, x and y

  void init(int w, int h) {
    mbw = w;
    mbh = h;
    packet.assign(size_t(w) * h, -1);
    intra.assign(size_t(w) * h, 0);
    qscale.assign(size_t(w) * h, 0);
    dc.assign(size_t(w) * h * 6, 1024);
    ac.assign(size_t(w) * h * 6 * 16, 0);
    mv.assign(size_t(4) * w * h * 2, 0);
  }
  void new_vop() {
    std::fill(packet.begin(), packet.end(), -1);
    std::fill(intra.begin(), intra.end(), 0);
  }
  // Whether MB (x, y) is intra and coded in packet `pk` (so that its
  // blocks predict the current one).
  bool usable(int x, int y, int pk) const {
    if (x < 0 || y < 0 || x >= mbw || y >= mbh) return false;
    size_t i = size_t(y) * mbw + x;
    return packet[i] == pk && intra[i];
  }
  int16_t* mvp(int bx, int by) { return &mv[(size_t(by) * 2 * mbw + bx) * 2]; }
  // The vector of luma block (bx, by); 0 outside the picture.
  void mv_at(int bx, int by, int& x, int& y) const {
    if (bx < 0 || by < 0 || bx >= 2 * mbw || by >= 2 * mbh) {
      x = y = 0;
      return;
    }
    const int16_t* p = &mv[(size_t(by) * 2 * mbw + bx) * 2];
    x = p[0];
    y = p[1];
  }
};

// The block (x, y, k) of MB-relative block k (0-3 luma, 4 Cb, 5 Cr)
// seen from MB (mx, my) at offset (dx, dy) in its plane's blocks.
struct BlockRef {
  int mbx, mby, k;
};

inline BlockRef neighbour(int mbx, int mby, int k, int dx, int dy) {
  if (k >= 4) return {mbx + dx, mby + dy, k};
  int bx = 2 * mbx + (k & 1) + dx, by = 2 * mby + (k >> 1) + dy;
  int nx = bx >= 0 ? bx / 2 : -1, ny = by >= 0 ? by / 2 : -1;
  return {nx, ny, (bx & 1) | ((by & 1) << 1)};
}

inline int median3(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// Intra DC prediction (7.4.3.1): the direction (0: from the left, 1:
// from above) and the predicted DC level for block k of MB (mbx, mby)
// in packet `pk` at the DC scaler `scale`.
inline int predict_dc(const MbState& st, int mbx, int mby, int k, int pk,
                      int scale, int& dir) {
  auto dcv = [&](int dx, int dy) {
    BlockRef r = neighbour(mbx, mby, k, dx, dy);
    if (!(r.mbx == mbx && r.mby == mby) && !st.usable(r.mbx, r.mby, pk))
      return 1024;
    return st.dc[(size_t(r.mby) * st.mbw + r.mbx) * 6 + r.k];
  };
  int a = dcv(-1, 0), b = dcv(-1, -1), c = dcv(0, -1);
  int pred;
  if (std::abs(a - b) < std::abs(b - c)) {
    pred = c;
    dir = 1;
  } else {
    pred = a;
    dir = 0;
  }
  return (pred + (scale >> 1)) / scale;
}

// AC prediction (7.4.3.3) of the quantised levels `lv` (row-major) of
// block k from the neighbour in direction `dir`, rescaled when that
// MB's quantiser differs (rounded division, half away from zero).
inline void predict_ac(const MbState& st, int mbx, int mby, int k, int pk,
                       int dir, int qscale, int sign, int* lv) {
  int dx = dir == 0 ? -1 : 0, dy = dir == 0 ? 0 : -1;
  BlockRef r = neighbour(mbx, mby, k, dx, dy);
  bool same_mb = r.mbx == mbx && r.mby == mby;
  if (!same_mb && !st.usable(r.mbx, r.mby, pk)) return;
  const int16_t* a = &st.ac[((size_t(r.mby) * st.mbw + r.mbx) * 6 + r.k) * 16];
  int nq = st.qscale[size_t(r.mby) * st.mbw + r.mbx];
  for (int i = 1; i < 8; ++i) {
    int v = dir == 0 ? a[i] : a[8 + i];
    if (!same_mb && nq != qscale) {
      int num = v * nq;
      v = (num >= 0 ? num + (qscale >> 1) : num - (qscale >> 1)) / qscale;
    }
    if (dir == 0)
      lv[8 * i] += sign * v;
    else
      lv[i] += sign * v;
  }
}

// Stores the first column and row of the levels of block k.
inline void store_ac(MbState& st, int mbx, int mby, int k, const int* lv) {
  int16_t* a = &st.ac[((size_t(mby) * st.mbw + mbx) * 6 + k) * 16];
  for (int i = 1; i < 8; ++i) {
    a[i] = (int16_t)lv[8 * i];
    a[8 + i] = (int16_t)lv[i];
  }
}

// Motion vector prediction (7.6.5) of luma block k (0-3) of MB (mbx,
// mby), as libavcodec's h263_pred_motion does it: the candidates out of
// the picture count as zero vectors, and in the first row of a video
// packet those above it are not candidates.  (rx, ry) is the MB at
// which the packet starts.
inline void predict_mv(const MbState& st, int mbx, int mby, int k, int rx,
                       int ry, int& px, int& py) {
  int bx = 2 * mbx + (k & 1), by = 2 * mby + (k >> 1);
  static const int off[4] = {2, 1, 1, -1};
  int ax, ay, bx_, by_, cx, cy;
  // the left candidate: the vector left of the block; for block 0/2 at
  // column 0 it is the zero vector outside the picture
  st.mv_at(bx - 1, by, ax, ay);
  bool first_line = mby == ry || (mby == ry + 1 && mbx < rx);
  if (first_line && k < 3) {
    if (k == 0) {
      if (mbx == rx && mby == ry) {
        px = py = 0;
      } else if (mbx + 1 == rx && mby == ry + 1) {
        int cbx = bx + off[k], cby = by - 1;
        st.mv_at(cbx, cby, cx, cy);
        if (mbx == 0) {
          px = cx;
          py = cy;
        } else {
          px = median3(ax, 0, cx);
          py = median3(ay, 0, cy);
        }
      } else {
        px = ax;
        py = ay;
      }
    } else if (k == 1) {
      if (mbx + 1 == rx && mby == ry + 1) {
        st.mv_at(bx + off[k], by - 1, cx, cy);
        px = median3(ax, 0, cx);
        py = median3(ay, 0, cy);
      } else {
        px = ax;
        py = ay;
      }
    } else {
      st.mv_at(bx, by - 1, bx_, by_);
      st.mv_at(bx + off[k], by - 1, cx, cy);
      if (mbx == rx && mby == ry) ax = ay = 0;
      px = median3(ax, bx_, cx);
      py = median3(ay, by_, cy);
    }
    return;
  }
  st.mv_at(bx, by - 1, bx_, by_);
  st.mv_at(bx + off[k], by - 1, cx, cy);
  px = median3(ax, bx_, cx);
  py = median3(ay, by_, cy);
}

// ---------------------------------------------------------------- MC
// libavcodec's h263 motion compensation for one MB into `cur` from
// `ref`: one vector for the 16x16 luma block and its chroma, or four
// for the 8x8 luma blocks with their sum's rounded chroma vector.
// `width`/`height` are the VOP's own sizes (the four-vector paths
// clip a source position to them).
inline void motion_compensate(Picture& cur, const Picture& ref, int mbx,
                              int mby, bool four, const int (*mv)[2],
                              bool no_rounding, int width, int height) {
  Plane& Y = cur.p[0];
  if (!four) {
    int mx = mv[0][0], my = mv[0][1];
    int dxy = ((my & 1) << 1) | (mx & 1);
    int sx = mbx * 16 + (mx >> 1), sy = mby * 16 + (my >> 1);
    hpel(ref.p[0], sx, sy, dxy, 16, 16, no_rounding, Y.at(16 * mbx, 16 * mby),
         Y.w);
    int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
    int ux = sx >> 1, uy = sy >> 1;
    for (int c = 1; c < 3; ++c)
      hpel(ref.p[c], ux, uy, uvdxy, 8, 8, no_rounding,
           cur.p[c].at(8 * mbx, 8 * mby), cur.p[c].w);
    return;
  }
  int sumx = 0, sumy = 0;
  for (int i = 0; i < 4; ++i) {
    int mx = mv[i][0], my = mv[i][1];
    int sx = mbx * 16 + (i & 1) * 8 + (mx >> 1);
    int sy = mby * 16 + (i >> 1) * 8 + (my >> 1);
    int dxy = 0;
    sx = std::min(std::max(sx, -16), width);
    if (sx != width) dxy |= mx & 1;
    sy = std::min(std::max(sy, -16), height);
    if (sy != height) dxy |= (my & 1) << 1;
    hpel(ref.p[0], sx, sy, dxy, 8, 8, no_rounding,
         Y.at(16 * mbx + (i & 1) * 8, 16 * mby + (i >> 1) * 8), Y.w);
    sumx += mx;
    sumy += my;
  }
  int cx = chroma_4mv(sumx), cy = chroma_4mv(sumy);
  int dxy = ((cy & 1) << 1) | (cx & 1);
  cx >>= 1;
  cy >>= 1;
  int sx = mbx * 8 + cx, sy = mby * 8 + cy;
  sx = std::min(std::max(sx, -8), width >> 1);
  if (sx == (width >> 1)) dxy &= ~1;
  sy = std::min(std::max(sy, -8), height >> 1);
  if (sy == (height >> 1)) dxy &= ~2;
  for (int c = 1; c < 3; ++c)
    hpel(ref.p[c], sx, sy, dxy, 8, 8, no_rounding,
         cur.p[c].at(8 * mbx, 8 * mby), cur.p[c].w);
}

// The plane and position of block k of MB (mbx, mby).
inline uint8_t* block_dst(Picture& pic, int mbx, int mby, int k, int& stride) {
  if (k < 4) {
    stride = pic.p[0].w;
    return pic.p[0].at(16 * mbx + (k & 1) * 8, 16 * mby + (k >> 1) * 8);
  }
  stride = pic.p[k - 3].w;
  return pic.p[k - 3].at(8 * mbx, 8 * mby);
}

// H.263 inverse quantisation of an AC or inter level.
inline int dequant(int level, int q) {
  if (!level) return 0;
  int qadd = (q - 1) | 1;
  return level < 0 ? level * 2 * q - qadd : level * 2 * q + qadd;
}

}  // namespace m4v
