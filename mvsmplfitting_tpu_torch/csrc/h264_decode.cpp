// H.264 video decoding for `data/h264.py` (ITU-T Rec. H.264 clauses 7-8),
// written to give the pictures libavcodec's h264 decoder gives, which
// OpenCV's FFmpeg backend runs for `cv2.VideoCapture`:
//   * NAL units in Annex B byte streams or with 1-, 2- or 4-byte length
//     prefixes (MP4 `avcC`), emulation prevention removed; SPS (VUI
//     included), PPS (transform_8x8_mode_flag, scaling lists with the
//     fall-back rules A and B, second_chroma_qp_index_offset), AUD, SEI,
//     end of sequence/stream and filler are read or skipped; the NAL
//     types libavcodec skips (14, 15, 20, ...) are skipped alike;
//   * progressive frames, 8-bit 4:2:0, profile_idc 66, 77 and 100, I
//     and P slices (several a picture) with CAVLC or CABAC: I_NxN (4x4,
//     and 8x8 under transform_size_8x8_flag), I_16x16, I_PCM, P_L0
//     16x16/16x8/8x16/8x8/8x8ref0 with every sub-partition, P_Skip;
//   * POC types 0-2, reference list initialisation and modification,
//     explicit weighted prediction, the sliding window and MMCO 1-6,
//     frame_num gaps (gaps_in_frame_num_allowed_flag), quarter-pel luma
//     and eighth-pel chroma prediction over clamped edges, the
//     deblocking filter with disable_deblocking_filter_idc 0-2;
//   * frame cropping as libavcodec applies it (a container's smaller
//     size crops the right and bottom when the SPS crops neither the top
//     nor the left); a left crop that is not a multiple of 64 columns,
//     which libavcodec keeps for alignment and OpenCV then rescales
//     away, is refused.
// Pictures come out in decoding order: a stream whose picture order
// count does not rise between IDR pictures (and memory_management_
// control_operation 5), where libavcodec would reorder or drop
// pictures, is refused.  So are B, SP and SI slices, interlace (field
// pictures, MBAFF), chroma formats other than 4:2:0, more than 8 bits,
// separate colour planes, the transform bypass, slice groups (FMO),
// arbitrary slice order, redundant pictures, data partitioning, other
// profiles, a change of picture size, and any syntax error or missing
// reference (libavcodec conceals those): each with a message naming
// what was refused.
//
// Built with g++ into a shared library and called through ctypes; the
// entry points return 0 (or a count) on success and -1 with a message
// in `err` otherwise.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "h264_common.h"
#include "yuv420_bgr.h"

namespace {

using namespace h264;

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }
[[noreturn]] void refuse(const std::string& tool) {
  fail("unsupported H.264 tool: " + tool);
}

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline uint8_t clip1(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int median3(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// ------------------------------------------------------------ bits

struct Bits {
  const uint8_t* p = nullptr;
  size_t n = 0;      // bytes
  size_t pos = 0;    // bits
  size_t end = 0;    // bits (the rbsp_stop_one_bit's position)

  uint32_t peek(int k) const {  // k <= 25
    uint64_t v = 0;
    size_t b = pos >> 3;
    for (int i = 0; i < 5; ++i)
      v = (v << 8) | (b + i < n ? p[b + i] : 0);
    return uint32_t((v >> (40 - (pos & 7) - k)) & ((1u << k) - 1));
  }
  uint32_t u(int k) {
    if (k == 0) return 0;
    if (k > 24) {
      uint32_t hi = u(k - 16);
      return (hi << 16) | u(16);
    }
    uint32_t v = peek(k);
    pos += k;
    if (pos > n * 8) fail("slice data ends early");
    return v;
  }
  bool flag() { return u(1) != 0; }
  uint32_t ue() {
    int zeros = 0;
    while (peek(1) == 0) {
      ++pos;
      if (++zeros > 31 || pos > n * 8) fail("bad Exp-Golomb code");
    }
    ++pos;
    if (zeros == 0) return 0;
    uint64_t v = (uint64_t(1) << zeros) - 1 + u(zeros);
    if (v > 0xFFFFFFFEu) fail("bad Exp-Golomb code");
    return uint32_t(v);
  }
  int se() {
    uint32_t k = ue();
    return (k & 1) ? int((k + 1) / 2) : -int(k / 2);
  }
  bool more_rbsp_data() const { return pos < end; }
  bool aligned() const { return (pos & 7) == 0; }
};

// RBSP of a NAL unit's payload (emulation_prevention_three_byte removed)
// with the position of its stop bit.
void to_rbsp(const uint8_t* d, size_t n, std::vector<uint8_t>& out) {
  out.clear();
  out.reserve(n + 8);
  int zeros = 0;
  for (size_t i = 0; i < n; ++i) {
    if (zeros >= 2 && d[i] == 3) {
      zeros = 0;
      continue;
    }
    out.push_back(d[i]);
    zeros = d[i] == 0 ? zeros + 1 : 0;
  }
}

Bits rbsp_bits(const std::vector<uint8_t>& r, size_t start_byte) {
  Bits b;
  b.p = r.data();
  b.n = r.size();
  b.pos = start_byte * 8;
  size_t last = r.size();
  while (last > start_byte && r[last - 1] == 0) --last;
  if (last == start_byte) {
    b.end = b.pos;
  } else {
    int tz = 0;
    while (!((r[last - 1] >> tz) & 1)) ++tz;
    b.end = last * 8 - tz - 1;
  }
  return b;
}

// ------------------------------------------------------------ parameter sets

struct Sps {
  bool have = false;
  int profile_idc = 0, level_idc = 0, id = 0;
  int log2_max_frame_num = 4, poc_type = 0, log2_max_poc_lsb = 4;
  bool delta_pic_order_always_zero = false;
  int offset_for_non_ref_pic = 0, offset_for_top_to_bottom_field = 0;
  int num_ref_frames_in_poc_cycle = 0;
  int offset_for_ref_frame[256] = {};
  int max_num_ref_frames = 0;
  bool gaps_allowed = false;
  int mbw = 0, mbh = 0;
  bool direct_8x8_inference = false;
  int crop_left = 0, crop_right = 0, crop_top = 0, crop_bottom = 0;  // luma
  bool scaling_present = false;
  uint8_t sl4[6][16];  // zig-zag order
  uint8_t sl8[2][64];
  // libavcodec's: unspecified without a VUI, left with one that does not
  // say (h2645_vui.c), else chroma_sample_loc_type_top_field + 1
  int chroma_loc = yuvbgr::kChromaUnspecified;
  bool full_range = false;
  int matrix = 2;  // matrix_coefficients (2: unspecified)
  std::vector<uint8_t> raw;
};

struct Pps {
  bool have = false;
  int id = 0, sps_id = 0;
  bool cabac = false, bottom_field_pic_order_in_frame_present = false;
  int num_ref_idx_l0_default = 1;
  bool weighted_pred = false;
  int pic_init_qp = 26;
  int chroma_qp_index_offset = 0, second_chroma_qp_index_offset = 0;
  bool deblocking_filter_control_present = false;
  bool constrained_intra_pred = false, redundant_pic_cnt_present = false;
  bool transform_8x8_mode = false;
  bool scaling_present = false;
  int list_present[8] = {};  // 0 absent, 1 read, 2 default (useDefault)
  uint8_t sl4[6][16];
  uint8_t sl8[2][64];
  std::vector<uint8_t> raw;
};

// scaling_list(): returns 1 with the list read, or 2 when the list says
// "use the default"
int read_scaling_list(Bits& b, uint8_t* list, int size) {
  int last = 8, next = 8;
  bool use_default = false;
  for (int j = 0; j < size; ++j) {
    if (next != 0) {
      int delta = b.se();
      if (delta < -128 || delta > 127) fail("delta_scale out of range");
      next = (last + delta + 256) % 256;
      use_default = (j == 0 && next == 0);
    }
    list[j] = uint8_t(next == 0 ? last : next);
    last = list[j];
  }
  return use_default ? 2 : 1;
}

void skip_hrd(Bits& b) {
  int cnt = int(b.ue()) + 1;
  if (cnt > 32) fail("bad HRD parameters");
  b.u(4);
  b.u(4);
  for (int i = 0; i < cnt; ++i) {
    b.ue();
    b.ue();
    b.u(1);
  }
  b.u(5);
  b.u(5);
  b.u(5);
  b.u(5);
}

void parse_vui(Bits& b, Sps& s) {
  s.chroma_loc = yuvbgr::kChromaLeft;
  if (b.flag()) {  // aspect_ratio_info_present_flag
    if (b.u(8) == 255) {
      b.u(16);
      b.u(16);
    }
  }
  if (b.flag()) b.u(1);  // overscan
  if (b.flag()) {        // video_signal_type_present_flag
    b.u(3);
    s.full_range = b.flag();
    if (b.flag()) {  // colour_description_present_flag
      b.u(8);
      b.u(8);
      s.matrix = int(b.u(8));
    }
  }
  if (b.flag()) {  // chroma_loc_info_present_flag
    int top = int(b.ue());
    b.ue();
    s.chroma_loc = top <= 5 ? top + 1 : yuvbgr::kChromaUnspecified;
  }
  if (b.flag()) {  // timing_info_present_flag
    b.u(32);
    b.u(32);
    b.u(1);
  }
  bool nal_hrd = b.flag();
  if (nal_hrd) skip_hrd(b);
  bool vcl_hrd = b.flag();
  if (vcl_hrd) skip_hrd(b);
  if (nal_hrd || vcl_hrd) b.u(1);  // low_delay_hrd_flag
  b.u(1);                          // pic_struct_present_flag
  // bitstream_restriction: max_num_reorder_frames only sets how long
  // libavcodec holds pictures; the order is checked per picture
}

void parse_sps(const std::vector<uint8_t>& r, Sps& s) {
  Bits b = rbsp_bits(r, 1);
  s = Sps();
  s.profile_idc = int(b.u(8));
  b.u(8);  // constraint flags
  s.level_idc = int(b.u(8));
  s.id = int(b.ue());
  if (s.id > 31) fail("seq_parameter_set_id out of range");
  if (s.profile_idc != 66 && s.profile_idc != 77 && s.profile_idc != 100)
    refuse("profile_idc " + std::to_string(s.profile_idc) +
           " (only Constrained Baseline/Baseline 66, Main 77 and High 100)");
  for (int i = 0; i < 6; ++i) std::memset(s.sl4[i], 16, 16);
  for (int i = 0; i < 2; ++i) std::memset(s.sl8[i], 16, 64);
  if (s.profile_idc == 100) {
    int chroma_format_idc = int(b.ue());
    if (chroma_format_idc == 3 && b.flag()) refuse("separate_colour_plane_flag");
    if (chroma_format_idc != 1)
      refuse("chroma_format_idc " + std::to_string(chroma_format_idc) +
             " (only 4:2:0)");
    int bdl = int(b.ue()), bdc = int(b.ue());
    if (bdl != 0 || bdc != 0) refuse("bit depth above 8");
    if (b.flag()) refuse("qpprime_y_zero_transform_bypass_flag");
    s.scaling_present = b.flag();
    if (s.scaling_present) {
      for (int i = 0; i < 8; ++i) {
        int got = b.flag() ? 0 : -1;  // -1: absent
        uint8_t* list = i < 6 ? s.sl4[i] : s.sl8[i - 6];
        int size = i < 6 ? 16 : 64;
        if (got == 0) got = read_scaling_list(b, list, size);
        if (got == 2 || (got == -1 && (i == 0 || i == 3 || i >= 6))) {
          // the default (fall-back rule A for lists 0, 3, 6, 7)
          if (i < 6) std::memcpy(list, kDefault4x4[i < 3 ? 0 : 1], 16);
          else std::memcpy(list, kDefault8x8[i - 6], 64);
        } else if (got == -1) {
          std::memcpy(list, s.sl4[i - 1], 16);  // previous list
        }
      }
    }
  }
  s.log2_max_frame_num = int(b.ue()) + 4;
  if (s.log2_max_frame_num > 16) fail("log2_max_frame_num out of range");
  s.poc_type = int(b.ue());
  if (s.poc_type == 0) {
    s.log2_max_poc_lsb = int(b.ue()) + 4;
    if (s.log2_max_poc_lsb > 16) fail("log2_max_pic_order_cnt_lsb out of range");
  } else if (s.poc_type == 1) {
    s.delta_pic_order_always_zero = b.flag();
    s.offset_for_non_ref_pic = b.se();
    s.offset_for_top_to_bottom_field = b.se();
    s.num_ref_frames_in_poc_cycle = int(b.ue());
    if (s.num_ref_frames_in_poc_cycle > 255) fail("POC cycle too long");
    for (int i = 0; i < s.num_ref_frames_in_poc_cycle; ++i)
      s.offset_for_ref_frame[i] = b.se();
  } else if (s.poc_type != 2) {
    fail("pic_order_cnt_type " + std::to_string(s.poc_type));
  }
  s.max_num_ref_frames = int(b.ue());
  if (s.max_num_ref_frames > 16) fail("max_num_ref_frames above 16");
  s.gaps_allowed = b.flag();
  s.mbw = int(b.ue()) + 1;
  s.mbh = int(b.ue()) + 1;
  if (s.mbw > 512 || s.mbh > 512) fail("picture too large");
  if (!b.flag()) refuse("interlaced coding (frame_mbs_only_flag 0)");
  s.direct_8x8_inference = b.flag();
  if (b.flag()) {  // frame_cropping_flag
    s.crop_left = int(b.ue()) * 2;
    s.crop_right = int(b.ue()) * 2;
    s.crop_top = int(b.ue()) * 2;
    s.crop_bottom = int(b.ue()) * 2;
    if (s.crop_left + s.crop_right >= s.mbw * 16 ||
        s.crop_top + s.crop_bottom >= s.mbh * 16)
      fail("frame cropping larger than the picture");
  }
  if (b.flag()) parse_vui(b, s);
  s.raw = r;
  s.have = true;
}

void parse_pps(const std::vector<uint8_t>& r, Pps& p, const Sps* all_sps) {
  Bits b = rbsp_bits(r, 1);
  p = Pps();
  p.id = int(b.ue());
  if (p.id > 255) fail("pic_parameter_set_id out of range");
  p.sps_id = int(b.ue());
  if (p.sps_id > 31 || !all_sps[p.sps_id].have)
    fail("PPS names a missing SPS " + std::to_string(p.sps_id));
  p.cabac = b.flag();
  p.bottom_field_pic_order_in_frame_present = b.flag();
  if (b.ue() != 0) refuse("slice groups (FMO)");
  p.num_ref_idx_l0_default = int(b.ue()) + 1;
  int l1 = int(b.ue()) + 1;
  if (p.num_ref_idx_l0_default > 32 || l1 > 32)
    fail("num_ref_idx_default_active out of range");
  p.weighted_pred = b.flag();
  b.u(2);  // weighted_bipred_idc (B slices are refused)
  p.pic_init_qp = 26 + b.se();
  b.se();  // pic_init_qs
  p.chroma_qp_index_offset = b.se();
  if (p.pic_init_qp < 0 || p.pic_init_qp > 51 ||
      p.chroma_qp_index_offset < -12 || p.chroma_qp_index_offset > 12)
    fail("PPS QP out of range");
  p.deblocking_filter_control_present = b.flag();
  p.constrained_intra_pred = b.flag();
  p.redundant_pic_cnt_present = b.flag();
  p.second_chroma_qp_index_offset = p.chroma_qp_index_offset;
  if (b.more_rbsp_data()) {
    p.transform_8x8_mode = b.flag();
    p.scaling_present = b.flag();
    if (p.scaling_present) {
      int count = 6 + (p.transform_8x8_mode ? 2 : 0);
      for (int i = 0; i < count; ++i) {
        if (b.flag())
          p.list_present[i] = read_scaling_list(
              b, i < 6 ? p.sl4[i] : p.sl8[i - 6], i < 6 ? 16 : 64);
      }
    }
    p.second_chroma_qp_index_offset = b.se();
    if (p.second_chroma_qp_index_offset < -12 ||
        p.second_chroma_qp_index_offset > 12)
      fail("second_chroma_qp_index_offset out of range");
  }
  p.raw = r;
  p.have = true;
}

// The scaling matrices in force for a picture (SPS, then the PPS with
// fall-back rule A or B), as LevelScale factors: ls4[list][qp%6][raster]
// and ls8[list][qp%6][raster].
struct Dequant {
  int ls4[6][6][16];
  int ls8[2][6][64];
};

void make_dequant(const Sps& s, const Pps& p, Dequant& dq) {
  uint8_t w4[6][16], w8[2][64];
  std::memcpy(w4, s.sl4, sizeof w4);
  std::memcpy(w8, s.sl8, sizeof w8);
  if (p.scaling_present) {
    for (int i = 0; i < 8; ++i) {
      uint8_t* dst = i < 6 ? w4[i] : w8[i - 6];
      int size = i < 6 ? 16 : 64;
      const uint8_t* src = nullptr;
      if (p.list_present[i] == 1) {
        src = i < 6 ? p.sl4[i] : p.sl8[i - 6];
      } else if (p.list_present[i] == 2) {
        src = i < 6 ? kDefault4x4[i < 3 ? 0 : 1] : kDefault8x8[i - 6];
      } else if (i == 0 || i == 3 || i >= 6) {
        // rule A: the default; rule B: the sequence's list
        if (s.scaling_present) src = i < 6 ? s.sl4[i] : s.sl8[i - 6];
        else src = i < 6 ? kDefault4x4[i < 3 ? 0 : 1] : kDefault8x8[i - 6];
        if (i >= 6 && !p.transform_8x8_mode) src = nullptr;
      } else {
        src = w4[i - 1];
      }
      if (src) std::memcpy(dst, src, size);
    }
  }
  for (int m = 0; m < 6; ++m) {
    for (int k = 0; k < 16; ++k) {
      int r = kZigzag4x4[k], i = r >> 2, j = r & 3;
      int v = (i & 1) == 0 && (j & 1) == 0 ? kNormAdjust4x4[m][0]
              : (i & 1) && (j & 1)         ? kNormAdjust4x4[m][1]
                                           : kNormAdjust4x4[m][2];
      for (int l = 0; l < 6; ++l) dq.ls4[l][m][r] = w4[l][k] * v;
    }
    for (int k = 0; k < 64; ++k) {
      int r = kZigzag8x8[k], i = r >> 3, j = r & 7;
      int c;
      if (i % 4 == 0 && j % 4 == 0) c = 0;
      else if (i % 2 == 1 && j % 2 == 1) c = 1;
      else if (i % 4 == 2 && j % 4 == 2) c = 2;
      else if ((i % 4 == 0 && j % 2 == 1) || (i % 2 == 1 && j % 4 == 0)) c = 3;
      else if ((i % 4 == 0 && j % 4 == 2) || (i % 4 == 2 && j % 4 == 0)) c = 4;
      else c = 5;
      for (int l = 0; l < 2; ++l) dq.ls8[l][m][r] = w8[l][k] * kNormAdjust8x8[m][c];
    }
  }
}

// ------------------------------------------------------------ pictures

struct Frame {
  std::vector<uint8_t> y, u, v;
  int frame_num = 0, long_term_frame_idx = -1;
  bool short_ref = false, long_ref = false, non_existing = false;
  int id = 0;
};
using FramePtr = std::shared_ptr<Frame>;

enum MbKind : uint8_t { kI4, kI8, kI16, kPcm, kInter, kSkip };

struct Mb {
  int slice = -1;
  uint8_t kind = kI4;
  bool t8 = false;
  int qp = 0;
  int cbp = 0;          // luma bits 0-3, chroma (0-2) << 4
  int chroma_mode = 0;  // intra_chroma_pred_mode
  int8_t ipm[16];       // intra 4x4/8x8 modes per 4x4 (raster), 2 if none
  uint8_t tc[16];       // luma total_coeff (CAVLC) / coded_block_flag (CABAC)
  uint8_t tcc[2][4];    // chroma AC, the same
  uint8_t dc_cbf = 0;   // CABAC coded_block_flag: 1 luma DC, 2 Cb DC, 4 Cr DC
  uint8_t nzd[16];      // non-zero coefficients per 4x4 for the deblocking
  int8_t ref[4];        // per 8x8, -1 intra
  int refpic[4];        // the reference picture's id per 8x8
  int16_t mv[16][2];
  uint8_t mvd[16][2];   // |mvd| (capped) for CABAC contexts
  bool intra() const { return kind <= kPcm; }
};

struct SliceInfo {
  int dbk_idc = 0, alpha_off = 0, beta_off = 0;
  int cb_off = 0, cr_off = 0;
};

struct WeightEntry {
  int lw = 1, lo = 0, cw[2] = {1, 1}, co[2] = {0, 0};
  bool luma = false, chroma = false;
};

struct Mmco {
  int op = 0, diff = 0, long_num = 0, idx = 0;
};

// ------------------------------------------------------------ CAVLC VLCs

struct Vlc {
  // lookup on the longest code's bits: (len << 8) | symbol, 0 for an
  // invalid code
  int bits = 16;
  std::vector<uint16_t> table;
  void add(int len, int code, int sym) {
    int shift = bits - len;
    for (int k = 0; k < (1 << shift); ++k)
      table[(code << shift) | k] = uint16_t((len << 8) | sym);
  }
  explicit Vlc(int nbits = 16) : bits(nbits), table(size_t(1) << nbits, 0) {}
  int read(Bits& b) const {
    uint16_t e = table[b.peek(bits)];
    if (!e) fail("bad CAVLC code");
    b.pos += e >> 8;
    return e & 0xFF;
  }
};

struct CavlcTables {
  Vlc coeff_token[4], chroma_dc_token{8}, total_zeros[15], chroma_dc_tz[3], run[7];
  CavlcTables() {
    for (auto& v : total_zeros) v = Vlc(9);
    for (auto& v : chroma_dc_tz) v = Vlc(3);
    for (auto& v : run) v = Vlc(11);
    for (int t = 0; t < 4; ++t)
      for (int i = 0; i < 68; ++i)
        if (kCoeffTokenLen[t][i]) coeff_token[t].add(kCoeffTokenLen[t][i], kCoeffTokenBits[t][i], i);
    for (int i = 0; i < 20; ++i)
      if (kChromaDcCoeffTokenLen[i])
        chroma_dc_token.add(kChromaDcCoeffTokenLen[i], kChromaDcCoeffTokenBits[i], i);
    for (int t = 0; t < 15; ++t)
      for (int i = 0; i < 16; ++i)
        if (kTotalZerosLen[t][i]) total_zeros[t].add(kTotalZerosLen[t][i], kTotalZerosBits[t][i], i);
    for (int t = 0; t < 3; ++t)
      for (int i = 0; i < 4; ++i)
        if (kChromaDcTotalZerosLen[t][i])
          chroma_dc_tz[t].add(kChromaDcTotalZerosLen[t][i], kChromaDcTotalZerosBits[t][i], i);
    for (int t = 0; t < 7; ++t)
      for (int i = 0; i < 16; ++i)
        if (kRunLen[t][i]) run[t].add(kRunLen[t][i], kRunBits[t][i], i);
  }
};

const CavlcTables& cavlc() {
  static const CavlcTables t;
  return t;
}

// ------------------------------------------------------------ CABAC

struct Cabac {
  Bits* b = nullptr;
  uint32_t range = 510, offset = 0;
  uint8_t state[460], mps[460];

  void init_contexts(int slice_qp, int table) {
    int qp = clip3(0, 51, slice_qp);
    for (int i = 0; i < 460; ++i) {
      int m = kCabacInit[table][i][0], n = kCabacInit[table][i][1];
      int pre = clip3(1, 126, ((m * qp) >> 4) + n);
      if (pre <= 63) {
        state[i] = uint8_t(63 - pre);
        mps[i] = 0;
      } else {
        state[i] = uint8_t(pre - 64);
        mps[i] = 1;
      }
    }
  }
  void init_engine() {
    range = 510;
    offset = b->u(9);
    if (offset >= 510) fail("bad CABAC start");
  }
  int bit() {
    int v = b->pos < b->n * 8 ? (b->p[b->pos >> 3] >> (7 - (b->pos & 7))) & 1 : 0;
    ++b->pos;
    return v;
  }
  int decision(int ctx) {
    int s = state[ctx];
    uint32_t lps = kRangeTabLps[s][(range >> 6) & 3];
    range -= lps;
    int bin;
    if (offset >= range) {
      bin = !mps[ctx];
      offset -= range;
      range = lps;
      if (s == 0) mps[ctx] = uint8_t(1 - mps[ctx]);
      state[ctx] = kTransIdxLps[s];
    } else {
      bin = mps[ctx];
      if (s < 62) state[ctx] = uint8_t(s + 1);
    }
    while (range < 256) {
      range <<= 1;
      offset = (offset << 1) | bit();
    }
    return bin;
  }
  int bypass() {
    offset = (offset << 1) | bit();
    if (offset >= range) {
      offset -= range;
      return 1;
    }
    return 0;
  }
  int terminate() {
    range -= 2;
    if (offset >= range) return 1;
    while (range < 256) {
      range <<= 1;
      offset = (offset << 1) | bit();
    }
    return 0;
  }
};

// ------------------------------------------------------------ decoder

struct Decoder {
  Sps sps[32];
  Pps pps[256];
  int container_w = 0, container_h = 0;
  int nal_length_size = 0;

  // the active sequence
  const Sps* act = nullptr;
  int mbw = 0, mbh = 0, W = 0, H = 0;
  int out_w = 0, out_h = 0, crop_x = 0, crop_y = 0, chroma_loc = 1, matrix = 2;

  // DPB
  std::vector<FramePtr> refs;  // reference frames (short and long)
  int max_long_term_frame_idx = -1;  // "no long-term frame indices"
  int next_id = 1;

  // POC state
  int prev_poc_msb = 0, prev_poc_lsb = 0;
  int prev_frame_num_offset = 0, prev_frame_num = 0;
  bool prev_mmco5 = false;
  bool seen_idr = false;
  int last_poc = 0;
  bool have_last_poc = false;

  // the current picture
  FramePtr cur;
  bool in_picture = false;
  int pictures = 0;  // pictures finished (the next one's decode-order number)
  bool cur_idr = false, cur_ref = false;
  int cur_frame_num = 0;
  int cur_poc = 0, cur_top = 0, cur_bottom = 0;
  int cur_poc_msb = 0, cur_poc_lsb = 0, cur_frame_num_offset = 0;
  bool cur_adaptive = false, cur_long_term_reference = false;
  std::vector<Mmco> cur_mmco;
  int cur_pps = -1;
  std::vector<Mb> mbs;
  std::vector<SliceInfo> slices;
  int decoded_mbs = 0;

  std::vector<FramePtr> out;  // frames ready, in order
  std::vector<uint8_t> rbsp;
};

// ---------------------------------------------------------- slice context

struct Slice {
  Decoder* d = nullptr;
  const Pps* p = nullptr;
  Bits b;
  Cabac cabac;
  bool is_p = false;
  int slice_num = 0;
  int qp = 0;
  int num_ref = 0;
  std::vector<FramePtr> list0;
  std::vector<WeightEntry> weights;
  bool weighted = false;
  int luma_log2_wd = 0, chroma_log2_wd = 0;
  Dequant dq;
  int last_dqp = 0;  // mb_qp_delta of the previous macroblock (CABAC ctx)
  uint8_t* Y = nullptr;
  uint8_t* U = nullptr;
  uint8_t* V = nullptr;

  // the current macroblock
  int mbx = 0, mby = 0;
  Mb* m = nullptr;
  uint16_t done = 0;  // 4x4 blocks (raster) whose motion is set

  Mb* mb_at(int x, int y) {
    if (x < 0 || y < 0 || x >= d->mbw || y >= d->mbh) return nullptr;
    Mb* n = &d->mbs[size_t(y) * d->mbw + x];
    return n->slice == slice_num ? n : nullptr;
  }
  Mb* mbA() { return mb_at(mbx - 1, mby); }
  Mb* mbB() { return mb_at(mbx, mby - 1); }
  // for intra prediction: inter neighbours are unavailable under
  // constrained_intra_pred_flag
  Mb* intra_nb(Mb* n) { return n && (!p->constrained_intra_pred || n->intra()) ? n : nullptr; }
};

// The 4x4 block (x4, y4) relative to the current macroblock (-1..4):
// its macroblock (or null) and raster index.
Mb* block_nb(Slice& c, int x4, int y4, int& idx) {
  if (y4 >= 0 && y4 < 4 && x4 >= 0 && x4 < 4) {
    idx = y4 * 4 + x4;
    return c.m;
  }
  Mb* n;
  if (y4 < 0) {
    n = x4 < 0 ? c.mb_at(c.mbx - 1, c.mby - 1)
        : x4 > 3 ? c.mb_at(c.mbx + 1, c.mby - 1)
                 : c.mb_at(c.mbx, c.mby - 1);
  } else if (x4 < 0) {
    n = c.mb_at(c.mbx - 1, c.mby);
  } else {
    n = nullptr;  // right of the macroblock: not yet decoded
  }
  idx = ((y4 + 4) & 3) * 4 + ((x4 + 4) & 3);
  return n;
}

// ---------------------------------------------------------- residual data

struct Residual {
  int luma[16][16];    // per 4x4 block (raster index), coefficient raster
  int luma8[4][64];    // per 8x8 block
  int dc[16];          // Intra16x16DCLevel, raster of the 4x4 DC matrix
  int cdc[2][4];
  int cac[2][4][16];
  bool has_luma[16], has_luma8[4], has_dc, has_cdc[2], has_cac[2][4];
  void clear() {
    std::memset(this, 0, sizeof(*this));
  }
};

// CAVLC residual_block: coefLevel[startIdx..] in scan order, returns
// TotalCoeff.
int cavlc_block(Slice& c, int nc, int max_coeff, int* coef) {
  const CavlcTables& t = cavlc();
  int sym;
  if (nc == -1) sym = t.chroma_dc_token.read(c.b);
  else if (nc < 2) sym = t.coeff_token[0].read(c.b);
  else if (nc < 4) sym = t.coeff_token[1].read(c.b);
  else if (nc < 8) sym = t.coeff_token[2].read(c.b);
  else sym = t.coeff_token[3].read(c.b);
  int total = sym >> 2, t1 = sym & 3;
  for (int i = 0; i < max_coeff; ++i) coef[i] = 0;
  if (total == 0) return 0;
  if (total > max_coeff) fail("TotalCoeff above maxNumCoeff");
  int level[16];
  int suffix_length = (total > 10 && t1 < 3) ? 1 : 0;
  for (int i = 0; i < total; ++i) {
    if (i < t1) {
      level[i] = c.b.flag() ? -1 : 1;
      continue;
    }
    int prefix = 0;
    while (!c.b.flag()) {
      if (++prefix > 31) fail("bad level_prefix");
    }
    int code = (std::min(15, prefix) << suffix_length);
    if (suffix_length > 0 || prefix >= 14) {
      int size = (prefix == 14 && suffix_length == 0) ? 4
                 : prefix >= 15 ? prefix - 3 : suffix_length;
      if (size > 0) code += int(c.b.u(size));
    }
    if (prefix >= 15 && suffix_length == 0) code += 15;
    if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
    if (i == t1 && t1 < 3) code += 2;
    level[i] = (code % 2 == 0) ? (code + 2) >> 1 : (-code - 1) >> 1;
    if (std::abs(level[i]) > (1 << 15)) fail("coefficient level out of range");
    if (suffix_length == 0) suffix_length = 1;
    if (std::abs(level[i]) > (3 << (suffix_length - 1)) && suffix_length < 6) ++suffix_length;
  }
  int zeros_left = 0;
  if (total < max_coeff) {
    if (nc == -1) zeros_left = t.chroma_dc_tz[total - 1].read(c.b);
    else zeros_left = t.total_zeros[total - 1].read(c.b);
  }
  if (zeros_left + total > max_coeff) fail("total_zeros too large");
  int run[16];
  for (int i = 0; i < total - 1; ++i) {
    if (zeros_left > 0) {
      run[i] = t.run[std::min(zeros_left, 7) - 1].read(c.b);
      if (run[i] > zeros_left) fail("run_before too large");
      zeros_left -= run[i];
    } else {
      run[i] = 0;
    }
  }
  run[total - 1] = zeros_left;
  int k = -1;
  for (int i = total - 1; i >= 0; --i) {
    k += run[i] + 1;
    coef[k] = level[i];
  }
  return total;
}

// nC of a luma 4x4 block (raster blk) or chroma (comp 0/1, blk 0-3)
int total_coeff_nb(Slice& c, int comp, int blk, bool& avail, int dx, int dy) {
  int w = comp < 0 ? 4 : 2;
  int x = (blk % w) + dx, y = (blk / w) + dy;
  Mb* n;
  int idx;
  if (x >= 0 && y >= 0) {
    n = c.m;
    idx = y * w + x;
  } else {
    n = x < 0 ? c.mbA() : c.mbB();
    idx = ((y + w) % w) * w + ((x + w) % w);
  }
  avail = n != nullptr;
  if (!n) return 0;
  if (n->kind == kSkip) return 0;
  if (n->kind == kPcm) return 16;
  return comp < 0 ? n->tc[idx] : n->tcc[comp][idx];
}

int cavlc_nc(Slice& c, int comp, int blk) {
  bool aa, ab;
  int na = total_coeff_nb(c, comp, blk, aa, -1, 0);
  int nb = total_coeff_nb(c, comp, blk, ab, 0, -1);
  if (aa && ab) return (na + nb + 1) >> 1;
  if (aa) return na;
  if (ab) return nb;
  return 0;
}

// ---------------------------------------------------------- CABAC syntax

enum { kCatLumaDc = 0, kCatLumaAc = 1, kCatLuma4x4 = 2, kCatChromaDc = 3,
       kCatChromaAc = 4, kCatLuma8x8 = 5 };

// coded_block_flag ctxIdxInc condition of a neighbour block
int cbf_cond(Slice& c, int cat, int comp, int blk, int dx, int dy) {
  bool cur_intra = c.m->intra();
  Mb* n;
  int idx = 0;
  if (cat == kCatLumaDc || cat == kCatChromaDc) {
    n = dx < 0 ? c.mbA() : c.mbB();
    if (!n) return cur_intra ? 1 : 0;
    if (n->kind == kPcm) return 1;
    if (n->kind == kSkip) return 0;
    if (cat == kCatLumaDc) return n->kind == kI16 ? (n->dc_cbf & 1) : 0;
    if ((n->cbp >> 4) == 0) return 0;
    return (n->dc_cbf >> (1 + comp)) & 1;
  }
  int w = cat == kCatChromaAc ? 2 : 4;
  int x = (blk % w) + dx, y = (blk / w) + dy;
  if (x >= 0 && y >= 0) {
    n = c.m;
    idx = y * w + x;
  } else {
    n = x < 0 ? c.mbA() : c.mbB();
    idx = ((y + w) % w) * w + ((x + w) % w);
    if (!n) return cur_intra ? 1 : 0;
    if (n->kind == kPcm) return 1;
    if (n->kind == kSkip) return 0;
  }
  if (cat == kCatChromaAc) {
    if ((n->cbp >> 4) != 2) return 0;
    return n->tcc[comp][idx] ? 1 : 0;
  }
  int b8 = ((idx >> 3) << 1) | ((idx & 3) >> 1);
  if (!((n->cbp >> b8) & 1)) return 0;
  if (n->t8) return 1;  // an 8x8 block (its coded_block_flag is inferred 1)
  return n->tc[idx] ? 1 : 0;
}

int cabac_block(Slice& c, int cat, int comp, int blk, int max_coeff, int* coef) {
  Cabac& a = c.cabac;
  static const int cbf_off[5] = {0, 4, 8, 12, 16};
  static const int sig_off[5] = {0, 15, 29, 44, 47};
  static const int abs_off[5] = {0, 10, 20, 30, 39};
  for (int i = 0; i < max_coeff; ++i) coef[i] = 0;
  if (cat != kCatLuma8x8) {
    int inc = cbf_cond(c, cat, comp, blk, -1, 0) + 2 * cbf_cond(c, cat, comp, blk, 0, -1);
    if (!a.decision(85 + cbf_off[cat] + inc)) return 0;
  }
  int sig_base = cat == kCatLuma8x8 ? 402 : 105 + sig_off[cat];
  int last_base = cat == kCatLuma8x8 ? 417 : 166 + sig_off[cat];
  int abs_base = cat == kCatLuma8x8 ? 426 : 227 + abs_off[cat];
  int sig[64];
  int n = 0;
  int i = 0;
  for (; i < max_coeff - 1; ++i) {
    int si, li;
    if (cat == kCatLuma8x8) {
      si = kSigCoeffOffset8x8[i];
      li = kLastCoeffOffset8x8[i];
    } else if (cat == kCatChromaDc) {
      si = li = std::min(i, 2);
    } else {
      si = li = i;
    }
    if (a.decision(sig_base + si)) {
      sig[n++] = i;
      if (a.decision(last_base + li)) break;
    }
  }
  if (i == max_coeff - 1) sig[n++] = i;
  int gt1 = 0, eq1 = 0;
  for (int k = n - 1; k >= 0; --k) {
    int inc = gt1 ? 0 : std::min(4, 1 + eq1);
    int v;
    if (!a.decision(abs_base + inc)) {
      v = 1;
    } else {
      int inc2 = 5 + std::min(4 - (cat == kCatChromaDc ? 1 : 0), gt1);
      int prefix = 1;
      while (prefix < 14 && a.decision(abs_base + inc2)) ++prefix;
      v = prefix + 1;
      if (prefix == 14) {  // UEG0 suffix, k = 0
        int suf = 0, kk = 0;
        while (a.bypass()) {
          suf += 1 << kk;
          if (++kk > 20) fail("bad coeff_abs_level_minus1");
        }
        while (kk--) suf += a.bypass() << kk;
        v = 15 + suf;
        if (v > (1 << 15)) fail("coefficient level out of range");
      }
    }
    coef[sig[k]] = a.bypass() ? -v : v;
    if (v == 1) ++eq1;
    else ++gt1;
  }
  return n;
}


// ---------------------------------------------------------- transforms

// 8.5.12: the 4x4 inverse transform of d (raster), added to dst
void idct4_add(const int* d, uint8_t* dst, int stride) {
  int f[16], g[16];
  for (int i = 0; i < 4; ++i) {  // rows
    const int* r = d + 4 * i;
    int e0 = r[0] + r[2], e1 = r[0] - r[2];
    int e2 = (r[1] >> 1) - r[3], e3 = r[1] + (r[3] >> 1);
    f[4 * i + 0] = e0 + e3;
    f[4 * i + 1] = e1 + e2;
    f[4 * i + 2] = e1 - e2;
    f[4 * i + 3] = e0 - e3;
  }
  for (int j = 0; j < 4; ++j) {  // columns
    int e0 = f[j] + f[8 + j], e1 = f[j] - f[8 + j];
    int e2 = (f[4 + j] >> 1) - f[12 + j], e3 = f[4 + j] + (f[12 + j] >> 1);
    g[j] = e0 + e3;
    g[4 + j] = e1 + e2;
    g[8 + j] = e1 - e2;
    g[12 + j] = e0 - e3;
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      dst[i * stride + j] = clip1(dst[i * stride + j] + ((g[4 * i + j] + 32) >> 6));
}

void idct8_1d(const int* in, int step, int* out, int ostep) {
  int d0 = in[0], d1 = in[step], d2 = in[2 * step], d3 = in[3 * step];
  int d4 = in[4 * step], d5 = in[5 * step], d6 = in[6 * step], d7 = in[7 * step];
  int e0 = d0 + d4, e1 = -d3 + d5 - d7 - (d7 >> 1);
  int e2 = d0 - d4, e3 = d1 + d7 - d3 - (d3 >> 1);
  int e4 = (d2 >> 1) - d6, e5 = -d1 + d7 + d5 + (d5 >> 1);
  int e6 = d2 + (d6 >> 1), e7 = d3 + d5 + d1 + (d1 >> 1);
  int f0 = e0 + e6, f1 = e1 + (e7 >> 2), f2 = e2 + e4, f3 = e3 + (e5 >> 2);
  int f4 = e2 - e4, f5 = (e3 >> 2) - e5, f6 = e0 - e6, f7 = e7 - (e1 >> 2);
  out[0] = f0 + f7;
  out[ostep] = f2 + f5;
  out[2 * ostep] = f4 + f3;
  out[3 * ostep] = f6 + f1;
  out[4 * ostep] = f6 - f1;
  out[5 * ostep] = f4 - f3;
  out[6 * ostep] = f2 - f5;
  out[7 * ostep] = f0 - f7;
}

void idct8_add(const int* d, uint8_t* dst, int stride) {
  int f[64], g[64];
  for (int i = 0; i < 8; ++i) idct8_1d(d + 8 * i, 1, f + 8 * i, 1);
  for (int j = 0; j < 8; ++j) idct8_1d(f + j, 8, g + j, 8);
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j)
      dst[i * stride + j] = clip1(dst[i * stride + j] + ((g[8 * i + j] + 32) >> 6));
}

// A scaled coefficient, in 64 bits and then held to +-2^20: a
// conforming stream's are within 16 bits, a corrupt one's then cannot
// overflow the transforms.
inline int scaled(int64_t v) { return int(v < -(1 << 20) ? -(1 << 20) : v > (1 << 20) ? (1 << 20) : v); }

// 8.5.12.1: scaling of a 4x4 block (raster), the DC left alone when
// `ac_only`
void dequant4(int* c, const int* ls, int qp, bool ac_only) {
  int q6 = qp / 6;
  for (int i = ac_only ? 1 : 0; i < 16; ++i) {
    if (!c[i]) continue;
    int64_t v = int64_t(c[i]) * ls[i];
    c[i] = scaled(qp >= 24 ? v * (1 << (q6 - 4)) : (v + (1 << (3 - q6))) >> (4 - q6));
  }
}

void dequant8(int* c, const int* ls, int qp) {
  int q6 = qp / 6;
  for (int i = 0; i < 64; ++i) {
    if (!c[i]) continue;
    int64_t v = int64_t(c[i]) * ls[i];
    c[i] = scaled(qp >= 36 ? v * (1 << (q6 - 6)) : (v + (1 << (5 - q6))) >> (6 - q6));
  }
}

// ---------------------------------------------------------- intra

// 8.3.1.2: Intra_4x4 prediction into pred[16]; t[0] = p[-1,-1],
// t[1 + x] = p[x,-1] (x = 0..7), l[y] = p[-1,y]
void pred4x4(int mode, const int* t, const int* l, bool has_t, bool has_l,
             uint8_t* pr) {
  auto T = [&](int x) { return t[x + 1]; };  // x = -1..7
  auto L = [&](int y) { return y < 0 ? t[0] : l[y]; };
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) {
      int v = 0;
      switch (mode) {
        case 0: v = T(x); break;
        case 1: v = L(y); break;
        case 2: {
          int st = T(0) + T(1) + T(2) + T(3), sl = L(0) + L(1) + L(2) + L(3);
          v = has_t && has_l ? (st + sl + 4) >> 3 : has_l ? (sl + 2) >> 2
              : has_t ? (st + 2) >> 2 : 128;
          break;
        }
        case 3:
          v = (x == 3 && y == 3) ? (T(6) + 3 * T(7) + 2) >> 2
                                 : (T(x + y) + 2 * T(x + y + 1) + T(x + y + 2) + 2) >> 2;
          break;
        case 4:
          if (x > y) v = (T(x - y - 2) + 2 * T(x - y - 1) + T(x - y) + 2) >> 2;
          else if (x < y) v = (L(y - x - 2) + 2 * L(y - x - 1) + L(y - x) + 2) >> 2;
          else v = (T(0) + 2 * T(-1) + L(0) + 2) >> 2;
          break;
        case 5: {
          int z = 2 * x - y;
          if (z >= 0 && !(z & 1)) v = (T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 1) >> 1;
          else if (z >= 0) v = (T(x - (y >> 1) - 2) + 2 * T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 2) >> 2;
          else if (z == -1) v = (L(0) + 2 * L(-1) + T(0) + 2) >> 2;
          else v = (L(y - 1) + 2 * L(y - 2) + L(y - 3) + 2) >> 2;
          break;
        }
        case 6: {
          int z = 2 * y - x;
          if (z >= 0 && !(z & 1)) v = (L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 1) >> 1;
          else if (z >= 0) v = (L(y - (x >> 1) - 2) + 2 * L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 2) >> 2;
          else if (z == -1) v = (L(0) + 2 * L(-1) + T(0) + 2) >> 2;
          else v = (T(x - 1) + 2 * T(x - 2) + T(x - 3) + 2) >> 2;
          break;
        }
        case 7:
          if (!(y & 1)) v = (T(x + (y >> 1)) + T(x + (y >> 1) + 1) + 1) >> 1;
          else v = (T(x + (y >> 1)) + 2 * T(x + (y >> 1) + 1) + T(x + (y >> 1) + 2) + 2) >> 2;
          break;
        case 8: {
          int z = x + 2 * y;
          if (z > 5) v = L(3);
          else if (z == 5) v = (L(2) + 3 * L(3) + 2) >> 2;
          else if (!(z & 1)) v = (L(y + (x >> 1)) + L(y + (x >> 1) + 1) + 1) >> 1;
          else v = (L(y + (x >> 1)) + 2 * L(y + (x >> 1) + 1) + L(y + (x >> 1) + 2) + 2) >> 2;
          break;
        }
      }
      pr[4 * y + x] = uint8_t(v);
    }
}

// 8.3.2.2: Intra_8x8 prediction with the reference sample filter; t[0] =
// p[-1,-1], t[1 + x] = p[x,-1] (x = 0..15), l[y] = p[-1,y]
void pred8x8l(int mode, const int* t0, const int* l0, bool has_tl, bool has_t,
              bool has_l, uint8_t* pr) {
  int t[17], l[8];
  if (has_t) {
    t[1] = has_tl ? (t0[0] + 2 * t0[1] + t0[2] + 2) >> 2 : (3 * t0[1] + t0[2] + 2) >> 2;
    for (int x = 1; x < 15; ++x) t[1 + x] = (t0[x] + 2 * t0[x + 1] + t0[x + 2] + 2) >> 2;
    t[16] = (t0[15] + 3 * t0[16] + 2) >> 2;
  }
  if (has_tl) {
    if (has_t && has_l) t[0] = (t0[1] + 2 * t0[0] + l0[0] + 2) >> 2;
    else if (has_t) t[0] = (3 * t0[0] + t0[1] + 2) >> 2;
    else if (has_l) t[0] = (3 * t0[0] + l0[0] + 2) >> 2;
    else t[0] = t0[0];
  }
  if (has_l) {
    l[0] = has_tl ? (t0[0] + 2 * l0[0] + l0[1] + 2) >> 2 : (3 * l0[0] + l0[1] + 2) >> 2;
    for (int y = 1; y < 7; ++y) l[y] = (l0[y - 1] + 2 * l0[y] + l0[y + 1] + 2) >> 2;
    l[7] = (l0[6] + 3 * l0[7] + 2) >> 2;
  }
  auto T = [&](int x) { return t[x + 1]; };
  auto L = [&](int y) { return y < 0 ? t[0] : l[y]; };
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) {
      int v = 0;
      switch (mode) {
        case 0: v = T(x); break;
        case 1: v = L(y); break;
        case 2: {
          int st = 0, sl = 0;
          for (int k = 0; k < 8; ++k) {
            if (has_t) st += T(k);
            if (has_l) sl += L(k);
          }
          v = has_t && has_l ? (st + sl + 8) >> 4 : has_l ? (sl + 4) >> 3
              : has_t ? (st + 4) >> 3 : 128;
          break;
        }
        case 3:
          v = (x == 7 && y == 7) ? (T(14) + 3 * T(15) + 2) >> 2
                                 : (T(x + y) + 2 * T(x + y + 1) + T(x + y + 2) + 2) >> 2;
          break;
        case 4:
          if (x > y) v = (T(x - y - 2) + 2 * T(x - y - 1) + T(x - y) + 2) >> 2;
          else if (x < y) v = (L(y - x - 2) + 2 * L(y - x - 1) + L(y - x) + 2) >> 2;
          else v = (T(0) + 2 * T(-1) + L(0) + 2) >> 2;
          break;
        case 5: {
          int z = 2 * x - y;
          if (z >= 0 && !(z & 1)) v = (T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 1) >> 1;
          else if (z >= 0) v = (T(x - (y >> 1) - 2) + 2 * T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 2) >> 2;
          else if (z == -1) v = (L(0) + 2 * L(-1) + T(0) + 2) >> 2;
          else v = (L(y - 2 * x - 1) + 2 * L(y - 2 * x - 2) + L(y - 2 * x - 3) + 2) >> 2;
          break;
        }
        case 6: {
          int z = 2 * y - x;
          if (z >= 0 && !(z & 1)) v = (L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 1) >> 1;
          else if (z >= 0) v = (L(y - (x >> 1) - 2) + 2 * L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 2) >> 2;
          else if (z == -1) v = (L(0) + 2 * L(-1) + T(0) + 2) >> 2;
          else v = (T(x - 2 * y - 1) + 2 * T(x - 2 * y - 2) + T(x - 2 * y - 3) + 2) >> 2;
          break;
        }
        case 7:
          if (!(y & 1)) v = (T(x + (y >> 1)) + T(x + (y >> 1) + 1) + 1) >> 1;
          else v = (T(x + (y >> 1)) + 2 * T(x + (y >> 1) + 1) + T(x + (y >> 1) + 2) + 2) >> 2;
          break;
        case 8: {
          int z = x + 2 * y;
          if (z > 13) v = L(7);
          else if (z == 13) v = (L(6) + 3 * L(7) + 2) >> 2;
          else if (!(z & 1)) v = (L(y + (x >> 1)) + L(y + (x >> 1) + 1) + 1) >> 1;
          else v = (L(y + (x >> 1)) + 2 * L(y + (x >> 1) + 1) + L(y + (x >> 1) + 2) + 2) >> 2;
          break;
        }
      }
      pr[8 * y + x] = uint8_t(v);
    }
}

// Intra_16x16 (n = 16) and chroma (n = 8) prediction modes V/H/DC/plane
// of a plane at `dst`; the chroma DC is per 4x4 block (8.3.4.1-3).
void pred_large(uint8_t* dst, int stride, int n, int mode, bool has_t,
                bool has_l, bool has_tl, bool chroma) {
  const uint8_t* top = dst - stride;
  auto P = [&](int x, int y) -> int {  // p[x,-1], p[-1,y], p[-1,-1]
    return dst[y * stride + x];
  };
  if (mode == 0) {  // V
    if (!has_t) fail("intra prediction from an unavailable top");
    for (int y = 0; y < n; ++y) std::memcpy(dst + y * stride, top, n);
  } else if (mode == 1) {  // H
    if (!has_l) fail("intra prediction from an unavailable left");
    for (int y = 0; y < n; ++y) std::memset(dst + y * stride, P(-1, y), n);
  } else if (mode == 2) {  // DC
    if (!chroma) {
      int st = 0, sl = 0;
      for (int k = 0; k < 16; ++k) {
        if (has_t) st += top[k];
        if (has_l) sl += P(-1, k);
      }
      int v = has_t && has_l ? (st + sl + 16) >> 5 : has_l ? (sl + 8) >> 4
              : has_t ? (st + 8) >> 4 : 128;
      for (int y = 0; y < 16; ++y) std::memset(dst + y * stride, v, 16);
    } else {
      for (int by = 0; by < 2; ++by)
        for (int bx = 0; bx < 2; ++bx) {
          int st = 0, sl = 0;
          for (int k = 0; k < 4; ++k) {
            if (has_t) st += top[4 * bx + k];
            if (has_l) sl += P(-1, 4 * by + k);
          }
          int v;
          bool both_first = (bx == by);  // blocks (0,0) and (1,1)
          if (both_first) {
            v = has_t && has_l ? (st + sl + 4) >> 3 : has_l ? (sl + 2) >> 2
                : has_t ? (st + 2) >> 2 : 128;
          } else if (bx == 1) {  // (4, 0): top first
            v = has_t ? (st + 2) >> 2 : has_l ? (sl + 2) >> 2 : 128;
          } else {  // (0, 4): left first
            v = has_l ? (sl + 2) >> 2 : has_t ? (st + 2) >> 2 : 128;
          }
          for (int y = 0; y < 4; ++y)
            std::memset(dst + (4 * by + y) * stride + 4 * bx, v, 4);
        }
    }
  } else {  // plane
    if (!has_t || !has_l || !has_tl) fail("plane prediction without its neighbours");
    int h = 0, v = 0, half = n / 2;
    for (int k = 0; k < half; ++k) {
      h += (k + 1) * (P(half + k, -1) - P(half - 2 - k, -1));
      v += (k + 1) * (P(-1, half + k) - P(-1, half - 2 - k));
    }
    int a = 16 * (P(-1, n - 1) + P(n - 1, -1));
    int b, c;
    if (n == 16) {
      b = (5 * h + 32) >> 6;
      c = (5 * v + 32) >> 6;
    } else {
      b = (34 * h + 32) >> 6;
      c = (34 * v + 32) >> 6;
    }
    int mid = half - 1;
    for (int y = 0; y < n; ++y)
      for (int x = 0; x < n; ++x)
        dst[y * stride + x] = clip1((a + b * (x - mid) + c * (y - mid) + 16) >> 5);
  }
}

// ---------------------------------------------------------- inter

// The samples a block's interpolation reads: rows y0-2 .. y0+h+2 and
// columns x0-2 .. x0+w+2 of a plane, in place when they lie inside it,
// else copied with the coordinates clamped to its edges (8.4.2.2).
struct Window {
  const uint8_t* p;  // the sample at (x0, y0)
  int stride;
  uint8_t buf[26 * 26];
  Window(const uint8_t* ref, int W, int H, int x0, int y0, int w, int h, int margin) {
    if (x0 - margin >= 0 && y0 - margin >= 0 && x0 + w + margin < W && y0 + h + margin < H) {
      p = ref + size_t(y0) * W + x0;
      stride = W;
      return;
    }
    stride = w + 2 * margin + 1;
    for (int y = 0; y < h + 2 * margin + 1; ++y) {
      const uint8_t* row = ref + size_t(clip3(0, H - 1, y0 + y - margin)) * W;
      for (int x = 0; x < stride; ++x) buf[y * stride + x] = row[clip3(0, W - 1, x0 + x - margin)];
    }
    p = buf + margin * stride + margin;
  }
};

inline int tap6(const uint8_t* s, int step) {
  return s[-2 * step] - 5 * s[-step] + 20 * s[0] + 20 * s[step] - 5 * s[2 * step] + s[3 * step];
}

// 8.4.2.2.1: luma sample interpolation of a w x h block at integer
// position (x0, y0) + quarter-pel (fx, fy) of plane `ref` (W x H): the
// half-sample planes b (x + 1/2), h (y + 1/2) and j (both) that the
// position needs, then the average of two of them (or of one and a
// full sample) for the quarter positions.
void mc_luma(const uint8_t* ref, int W, int H, int x0, int y0, int fx, int fy,
             int w, int h, uint8_t* out, int ostride) {
  Window win(ref, W, H, x0, y0, w, h, 2);
  const uint8_t* G = win.p;
  const int gs = win.stride;
  if (!fx && !fy) {
    for (int y = 0; y < h; ++y) std::memcpy(out + y * ostride, G + y * gs, size_t(w));
    return;
  }
  const int pos = fy * 4 + fx;
  // b at rows 0..h (row h for s), h at columns 0..w (column w for m)
  const bool need_b = fx != 0 && pos != 8 && pos != 10 && pos != 9 && pos != 11;
  const bool need_s = pos == 13 || pos == 14 || pos == 15;
  const bool need_h = fy != 0 && pos != 2 && pos != 10 && pos != 6 && pos != 14;
  const bool need_m = pos == 7 || pos == 11 || pos == 15;
  const bool need_j = pos == 6 || pos == 9 || pos == 10 || pos == 11 || pos == 14;
  uint8_t B[17 * 16], Hh[16 * 17], J[16 * 16];
  if (need_b || need_s) {
    for (int y = 0; y < h + (need_s ? 1 : 0); ++y)
      for (int x = 0; x < w; ++x) B[y * 16 + x] = clip1((tap6(G + y * gs + x, 1) + 16) >> 5);
  }
  if (need_h || need_m) {
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w + (need_m ? 1 : 0); ++x)
        Hh[y * 17 + x] = clip1((tap6(G + y * gs + x, gs) + 16) >> 5);
  }
  if (need_j) {
    int b1[21 * 16];  // rows -2 .. h+2
    for (int y = -2; y < h + 3; ++y)
      for (int x = 0; x < w; ++x) b1[(y + 2) * 16 + x] = tap6(G + y * gs + x, 1);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const int* c = b1 + (y + 2) * 16 + x;
        int j1 = c[-32] - 5 * c[-16] + 20 * c[0] + 20 * c[16] - 5 * c[32] + c[48];
        J[y * 16 + x] = clip1((j1 + 512) >> 10);
      }
  }
  for (int y = 0; y < h; ++y) {
    const uint8_t* g = G + y * gs;
    const uint8_t* b = B + y * 16;
    const uint8_t* sr = B + (y + 1) * 16;
    const uint8_t* hh = Hh + y * 17;
    const uint8_t* j = J + y * 16;
    uint8_t* o = out + y * ostride;
    for (int x = 0; x < w; ++x) {
      int v;
      switch (pos) {
        case 1: v = (g[x] + b[x] + 1) >> 1; break;                    // a
        case 2: v = b[x]; break;                                      // b
        case 3: v = (b[x] + g[x + 1] + 1) >> 1; break;                // c
        case 4: v = (g[x] + hh[x] + 1) >> 1; break;                   // d
        case 5: v = (b[x] + hh[x] + 1) >> 1; break;                   // e
        case 6: v = (b[x] + j[x] + 1) >> 1; break;                    // f
        case 7: v = (b[x] + hh[x + 1] + 1) >> 1; break;               // g
        case 8: v = hh[x]; break;                                     // h
        case 9: v = (hh[x] + j[x] + 1) >> 1; break;                   // i
        case 10: v = j[x]; break;                                     // j
        case 11: v = (j[x] + hh[x + 1] + 1) >> 1; break;              // k
        case 12: v = (g[x + gs] + hh[x] + 1) >> 1; break;             // n
        case 13: v = (hh[x] + sr[x] + 1) >> 1; break;                 // p
        case 14: v = (j[x] + sr[x] + 1) >> 1; break;                  // q
        default: v = (hh[x + 1] + sr[x] + 1) >> 1; break;             // r
      }
      o[x] = uint8_t(v);
    }
  }
}

// 8.4.2.2.2: chroma sample interpolation (eighth-pel)
void mc_chroma(const uint8_t* ref, int W, int H, int x0, int y0, int fx, int fy,
               int w, int h, uint8_t* out, int ostride) {
  Window win(ref, W, H, x0, y0, w, h, 0);
  const uint8_t* s = win.p;
  const int ss = win.stride;
  const int a = (8 - fx) * (8 - fy), b = fx * (8 - fy), c = (8 - fx) * fy, d = fx * fy;
  for (int y = 0; y < h; ++y) {
    const uint8_t* r0 = s + y * ss;
    const uint8_t* r1 = r0 + ss;
    for (int x = 0; x < w; ++x)
      out[y * ostride + x] =
          uint8_t((a * r0[x] + b * r0[x + 1] + c * r1[x] + d * r1[x + 1] + 32) >> 6);
  }
}

inline uint8_t weigh(int v, int w, int o, int logwd) {
  if (logwd >= 1) return clip1(((v * w + (1 << (logwd - 1))) >> logwd) + o);
  return clip1(v * w + o);
}

// ---------------------------------------------------------- macroblocks

// luma4x4BlkIdx -> raster index of the 4x4 block
const int kBlkRaster[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};
int kRasterBlk[16];  // the inverse
struct InitRasterBlk {
  InitRasterBlk() {
    for (int i = 0; i < 16; ++i) kRasterBlk[kBlkRaster[i]] = i;
  }
} init_raster_blk;

inline int b8_of(int r) { return ((r >> 3) << 1) | ((r & 3) >> 1); }

struct Nb {
  int ref = -2;  // -2 not available, -1 intra (or not predicted)
  int mx = 0, my = 0;
};

Nb motion_nb(Slice& c, int x4, int y4) {
  Nb o;
  int idx;
  Mb* n = block_nb(c, x4, y4, idx);
  if (!n) return o;
  if (n == c.m && !((c.done >> idx) & 1)) return o;
  if (n->intra()) {
    o.ref = -1;
    return o;
  }
  o.ref = n->ref[b8_of(idx)];
  o.mx = n->mv[idx][0];
  o.my = n->mv[idx][1];
  return o;
}

// 8.4.1.3: the motion vector predictor of a partition (4x4 units);
// shape 1/2: 16x8 top/bottom, 3/4: 8x16 left/right, 0 otherwise
void mv_pred(Slice& c, int x4, int y4, int w4, int ref, int shape, int& mx, int& my) {
  Nb A = motion_nb(c, x4 - 1, y4), B = motion_nb(c, x4, y4 - 1);
  Nb C = motion_nb(c, x4 + w4, y4 - 1);
  if (C.ref == -2) C = motion_nb(c, x4 - 1, y4 - 1);
  if ((shape == 1 && B.ref == ref) ) { mx = B.mx; my = B.my; return; }
  if ((shape == 2 || shape == 3) && A.ref == ref) { mx = A.mx; my = A.my; return; }
  if (shape == 4 && C.ref == ref) { mx = C.mx; my = C.my; return; }
  int match = (A.ref == ref) + (B.ref == ref) + (C.ref == ref);
  if (match == 1) {
    const Nb& n = A.ref == ref ? A : B.ref == ref ? B : C;
    mx = n.mx;
    my = n.my;
  } else if (match == 0 && B.ref == -2 && C.ref == -2 && A.ref != -2) {
    mx = A.mx;
    my = A.my;
  } else {
    mx = median3(A.mx, B.mx, C.mx);
    my = median3(A.my, B.my, C.my);
  }
}

void set_motion(Slice& c, int x4, int y4, int w4, int h4, int mx, int my) {
  if (mx < -32768 || mx > 32767 || my < -32768 || my > 32767)
    fail("motion vector out of range");
  for (int y = y4; y < y4 + h4; ++y)
    for (int x = x4; x < x4 + w4; ++x) {
      c.m->mv[y * 4 + x][0] = int16_t(mx);
      c.m->mv[y * 4 + x][1] = int16_t(my);
      c.done |= uint16_t(1 << (y * 4 + x));
    }
}

// motion-compensated prediction of a partition into the picture
void predict_part(Slice& c, int x4, int y4, int w4, int h4) {
  Decoder& d = *c.d;
  int idx = y4 * 4 + x4;
  int ref = c.m->ref[b8_of(idx)];
  if (ref < 0 || ref >= int(c.list0.size()) || !c.list0[ref] || c.list0[ref]->non_existing)
    fail("missing reference picture (ref_idx " + std::to_string(ref) + ")");
  const Frame& f = *c.list0[ref];
  int mx = c.m->mv[idx][0], my = c.m->mv[idx][1];
  int px = 16 * c.mbx + 4 * x4, py = 16 * c.mby + 4 * y4;
  int w = 4 * w4, h = 4 * h4;
  uint8_t* dy = c.Y + size_t(py) * d.W + px;
  mc_luma(f.y.data(), d.W, d.H, px + (mx >> 2), py + (my >> 2), mx & 3, my & 3, w, h,
          dy, d.W);
  int cw = d.W / 2, chh = d.H / 2;
  uint8_t* du = c.U + size_t(py / 2) * cw + px / 2;
  uint8_t* dv = c.V + size_t(py / 2) * cw + px / 2;
  mc_chroma(f.u.data(), cw, chh, px / 2 + (mx >> 3), py / 2 + (my >> 3), mx & 7, my & 7,
            w / 2, h / 2, du, cw);
  mc_chroma(f.v.data(), cw, chh, px / 2 + (mx >> 3), py / 2 + (my >> 3), mx & 7, my & 7,
            w / 2, h / 2, dv, cw);
  if (c.weighted) {
    const WeightEntry& we = c.weights[ref];
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        dy[y * d.W + x] = weigh(dy[y * d.W + x], we.lw, we.lo, c.luma_log2_wd);
    for (int y = 0; y < h / 2; ++y)
      for (int x = 0; x < w / 2; ++x) {
        du[y * cw + x] = weigh(du[y * cw + x], we.cw[0], we.co[0], c.chroma_log2_wd);
        dv[y * cw + x] = weigh(dv[y * cw + x], we.cw[1], we.co[1], c.chroma_log2_wd);
      }
  }
}

// -- CABAC syntax elements (9.3.3.1.1)

int cabac_mb_skip(Slice& c) {
  Mb* a = c.mbA();
  Mb* b = c.mbB();
  int inc = (a && a->kind != kSkip) + (b && b->kind != kSkip);
  return c.cabac.decision(11 + inc);
}

// I mb_type (0 I_NxN, 1-24 I_16x16, 25 I_PCM) with the prefix at `base`
int cabac_intra_type(Slice& c, bool islice) {
  Cabac& a = c.cabac;
  int base = islice ? 3 : 17;
  if (islice) {
    Mb* na = c.mbA();
    Mb* nb = c.mbB();
    int inc = (na && na->kind != kI4 && na->kind != kI8) +
              (nb && nb->kind != kI4 && nb->kind != kI8);
    if (!a.decision(base + inc)) return 0;
    base += 2;  // the bins after the first: 5-10
  } else {
    if (!a.decision(base)) return 0;
  }
  if (a.terminate()) return 25;
  int t = 1 + 12 * a.decision(base + 1);
  if (a.decision(base + 2)) t += 4 + 4 * a.decision(base + 2 + (islice ? 1 : 0));
  t += 2 * a.decision(base + 3 + (islice ? 1 : 0));
  t += a.decision(base + 3 + (islice ? 2 : 0));
  return t;
}

int cabac_unary_ref(Slice& c, int x4, int y4) {
  auto cond = [&](int dx, int dy) {
    int idx;
    Mb* n = block_nb(c, x4 + dx, y4 + dy, idx);
    if (!n || n->kind == kSkip || n->intra()) return 0;
    return n->ref[b8_of(idx)] > 0 ? 1 : 0;
  };
  Cabac& a = c.cabac;
  int inc = cond(-1, 0) + 2 * cond(0, -1);
  if (!a.decision(54 + inc)) return 0;
  int v = 1;
  if (!a.decision(58)) return 1;
  ++v;
  while (a.decision(59)) {
    if (++v > 32) fail("bad ref_idx");
  }
  return v;
}

int cabac_mvd(Slice& c, int x4, int y4, int comp) {
  auto absn = [&](int dx, int dy) {
    int idx;
    Mb* n = block_nb(c, x4 + dx, y4 + dy, idx);
    if (!n || n->kind == kSkip || n->intra()) return 0;
    return int(n->mvd[idx][comp]);
  };
  Cabac& a = c.cabac;
  int base = comp ? 47 : 40;
  int sum = absn(-1, 0) + absn(0, -1);
  int inc = sum < 3 ? 0 : sum > 32 ? 2 : 1;
  if (!a.decision(base + inc)) return 0;
  int v = 1;
  while (v < 9 && a.decision(base + 3 + std::min(v - 1, 3))) ++v;
  if (v >= 9) {  // UEG3 suffix
    int k = 3;
    while (a.bypass()) {
      v += 1 << k;
      if (++k > 24) fail("bad mvd");
    }
    while (k--) v += a.bypass() << k;
  }
  return a.bypass() ? -v : v;
}

// -- the macroblock layer

struct Part {
  int x4, y4, w4, h4, shape;
  int mvdx = 0, mvdy = 0;
};

void read_intra_modes(Slice& c, bool t8) {
  Mb& m = *c.m;
  int n = t8 ? 4 : 16;
  for (int k = 0; k < n; ++k) {
    int prev, rem = 0;
    if (c.p->cabac) {
      prev = c.cabac.decision(68);
      if (!prev) {
        rem = c.cabac.decision(69);
        rem |= c.cabac.decision(69) << 1;
        rem |= c.cabac.decision(69) << 2;
      }
    } else {
      prev = c.b.flag();
      if (!prev) rem = int(c.b.u(3));
    }
    int r = t8 ? kBlkRaster[4 * k] : kBlkRaster[k];
    int x4 = r & 3, y4 = r >> 2;
    int ia, ib;
    Mb* na = block_nb(c, x4 - 1, y4, ia);
    Mb* nb = block_nb(c, x4, y4 - 1, ib);
    int pred;
    bool cip = c.p->constrained_intra_pred;
    if (!na || !nb || (cip && !na->intra()) || (cip && !nb->intra())) {
      pred = 2;
    } else {
      int ma = (na->kind == kI4 || na->kind == kI8) ? na->ipm[ia] : 2;
      int mb = (nb->kind == kI4 || nb->kind == kI8) ? nb->ipm[ib] : 2;
      pred = std::min(ma, mb);
    }
    int mode = prev ? pred : (rem < pred ? rem : rem + 1);
    if (t8) {
      for (int dy = 0; dy < 2; ++dy)
        for (int dx = 0; dx < 2; ++dx) m.ipm[(y4 + dy) * 4 + x4 + dx] = int8_t(mode);
    } else {
      m.ipm[r] = int8_t(mode);
    }
  }
}

int read_chroma_mode(Slice& c) {
  if (!c.p->cabac) {
    int v = int(c.b.ue());
    if (v > 3) fail("bad intra_chroma_pred_mode");
    return v;
  }
  auto cond = [&](Mb* n) {
    return n && n->intra() && n->kind != kPcm && n->chroma_mode != 0 ? 1 : 0;
  };
  int inc = cond(c.mbA()) + cond(c.mbB());
  if (!c.cabac.decision(64 + inc)) return 0;
  if (!c.cabac.decision(67)) return 1;
  return c.cabac.decision(67) ? 3 : 2;
}

int read_cbp(Slice& c, bool intra) {
  if (!c.p->cabac) {
    uint32_t k = c.b.ue();
    if (k > 47) fail("bad coded_block_pattern");
    return intra ? kGolombToIntraCbp[k] : kGolombToInterCbp[k];
  }
  Cabac& a = c.cabac;
  int luma = 0;
  for (int b8 = 0; b8 < 4; ++b8) {
    auto cond = [&](int dx, int dy) {  // in 8x8 units
      int x8 = (b8 & 1) + dx, y8 = (b8 >> 1) + dy;
      if (x8 >= 0 && y8 >= 0) return ((luma >> (y8 * 2 + x8)) & 1) ? 0 : 1;
      Mb* n = x8 < 0 ? c.mbA() : c.mbB();
      if (!n || n->kind == kPcm) return 0;
      if (n->kind == kSkip) return 1;
      int nb8 = ((y8 + 2) & 1) * 2 + ((x8 + 2) & 1);
      return ((n->cbp >> nb8) & 1) ? 0 : 1;
    };
    int inc = cond(-1, 0) + 2 * cond(0, -1);
    luma |= a.decision(73 + inc) << b8;
  }
  auto ccond = [&](Mb* n, int bin) -> int {
    if (!n) return 0;
    if (n->kind == kPcm) return 1;
    if (n->kind == kSkip) return 0;
    int cc = n->cbp >> 4;
    return bin == 0 ? (cc != 0) : (cc == 2);
  };
  int chroma = 0;
  if (a.decision(77 + ccond(c.mbA(), 0) + 2 * ccond(c.mbB(), 0)))
    chroma = 1 + a.decision(81 + ccond(c.mbA(), 1) + 2 * ccond(c.mbB(), 1));
  return luma | (chroma << 4);
}

int read_qp_delta(Slice& c) {
  int v;
  if (!c.p->cabac) {
    v = c.b.se();
  } else {
    Cabac& a = c.cabac;
    int k = 0;
    if (a.decision(60 + (c.last_dqp != 0 ? 1 : 0))) {
      k = 1;
      if (a.decision(62)) {
        k = 2;
        while (a.decision(63)) {
          if (++k > 52) fail("bad mb_qp_delta");
        }
      }
    }
    v = (k & 1) ? (k + 1) / 2 : -(k / 2);
  }
  if (v < -26 || v > 25) fail("mb_qp_delta out of range");
  return v;
}

bool read_t8(Slice& c) {
  if (!c.p->cabac) return c.b.flag();
  Mb* a = c.mbA();
  Mb* b = c.mbB();
  return c.cabac.decision(399 + (a && a->t8) + (b && b->t8)) != 0;
}

void parse_residual(Slice& c, Residual& r) {
  Mb& m = *c.m;
  const bool cabac = c.p->cabac, i16 = m.kind == kI16;
  int cbpl = m.cbp & 15, cbpc = m.cbp >> 4;
  int coef[64];
  if (i16) {
    int n = cabac ? cabac_block(c, kCatLumaDc, 0, 0, 16, coef)
                  : cavlc_block(c, cavlc_nc(c, -1, 0), 16, coef);
    if (n) m.dc_cbf |= 1;
    for (int k = 0; k < 16; ++k) r.dc[kZigzag4x4[k]] = coef[k];
    r.has_dc = n > 0;
  }
  for (int b8 = 0; b8 < 4; ++b8) {
    if (!((cbpl >> b8) & 1)) continue;
    if (m.t8) {
      int lv[64] = {};
      bool any = false;
      if (cabac) {
        int n = cabac_block(c, kCatLuma8x8, 0, b8, 64, coef);
        for (int k = 0; k < 64; ++k) lv[k] = coef[k];
        any = n > 0;
        for (int i4 = 0; i4 < 4; ++i4) m.tc[kBlkRaster[4 * b8 + i4]] = any;
      } else {
        for (int i4 = 0; i4 < 4; ++i4) {
          int blk = kBlkRaster[4 * b8 + i4];
          int n = cavlc_block(c, cavlc_nc(c, -1, blk), 16, coef);
          m.tc[blk] = uint8_t(n);
          for (int k = 0; k < 16; ++k) lv[4 * k + i4] = coef[k];
          any |= n > 0;
        }
      }
      for (int k = 0; k < 64; ++k) r.luma8[b8][kZigzag8x8[k]] = lv[k];
      r.has_luma8[b8] = any;
      for (int i4 = 0; i4 < 4; ++i4) m.nzd[kBlkRaster[4 * b8 + i4]] = any;
    } else {
      for (int i4 = 0; i4 < 4; ++i4) {
        int blk = kBlkRaster[4 * b8 + i4];
        int n;
        if (i16) {
          n = cabac ? cabac_block(c, kCatLumaAc, 0, blk, 15, coef)
                    : cavlc_block(c, cavlc_nc(c, -1, blk), 15, coef);
          for (int k = 0; k < 15; ++k) r.luma[blk][kZigzag4x4[k + 1]] = coef[k];
        } else {
          n = cabac ? cabac_block(c, kCatLuma4x4, 0, blk, 16, coef)
                    : cavlc_block(c, cavlc_nc(c, -1, blk), 16, coef);
          for (int k = 0; k < 16; ++k) r.luma[blk][kZigzag4x4[k]] = coef[k];
        }
        m.tc[blk] = uint8_t(cabac ? (n > 0) : n);
        m.nzd[blk] = n > 0;
        r.has_luma[blk] = n > 0;
      }
    }
  }
  if (cbpc) {
    for (int comp = 0; comp < 2; ++comp) {
      int n = cabac ? cabac_block(c, kCatChromaDc, comp, 0, 4, coef)
                    : cavlc_block(c, -1, 4, coef);
      if (n) m.dc_cbf |= uint8_t(2 << comp);
      for (int k = 0; k < 4; ++k) r.cdc[comp][k] = coef[k];
      r.has_cdc[comp] = n > 0;
    }
    if (cbpc == 2) {
      for (int comp = 0; comp < 2; ++comp)
        for (int b = 0; b < 4; ++b) {
          int n = cabac ? cabac_block(c, kCatChromaAc, comp, b, 15, coef)
                        : cavlc_block(c, cavlc_nc(c, comp, b), 15, coef);
          for (int k = 0; k < 15; ++k) r.cac[comp][b][kZigzag4x4[k + 1]] = coef[k];
          m.tcc[comp][b] = uint8_t(cabac ? (n > 0) : n);
          r.has_cac[comp][b] = n > 0;
        }
    }
  }
}

// the residual of the chroma planes (DC and AC), added in place
void add_chroma_residual(Slice& c, Residual& r, bool intra) {
  Decoder& d = *c.d;
  const int cw = d.W / 2;
  for (int comp = 0; comp < 2; ++comp) {
    int off = comp ? d.slices[c.slice_num].cr_off : d.slices[c.slice_num].cb_off;
    int qpc = kChromaQp[clip3(0, 51, c.m->qp + off)];
    const int list = (intra ? 1 : 4) + comp;
    const int* ls = c.dq.ls4[list][qpc % 6];
    int dc[4] = {0, 0, 0, 0};
    if (r.has_cdc[comp]) {
      const int* x = r.cdc[comp];
      int f[4] = {x[0] + x[1] + x[2] + x[3], x[0] - x[1] + x[2] - x[3],
                  x[0] + x[1] - x[2] - x[3], x[0] - x[1] - x[2] + x[3]};
      for (int k = 0; k < 4; ++k) dc[k] = scaled((int64_t(f[k]) * ls[0] * (1 << (qpc / 6))) >> 5);
    }
    uint8_t* plane = comp ? c.V : c.U;
    for (int b = 0; b < 4; ++b) {
      if (!dc[b] && !r.has_cac[comp][b]) continue;
      int* x = r.cac[comp][b];
      dequant4(x, ls, qpc, true);
      x[0] = dc[b];
      int px = 8 * c.mbx + 4 * (b & 1), py = 8 * c.mby + 4 * (b >> 1);
      idct4_add(x, plane + size_t(py) * cw + px, cw);
    }
  }
}

void intra_pred_chroma(Slice& c) {
  Decoder& d = *c.d;
  const int cw = d.W / 2;
  static const int kMap[4] = {2, 1, 0, 3};
  Mb* a = c.intra_nb(c.mbA());
  Mb* b = c.intra_nb(c.mbB());
  Mb* dd = c.intra_nb(c.mb_at(c.mbx - 1, c.mby - 1));
  int mode = kMap[c.m->chroma_mode];
  for (int comp = 0; comp < 2; ++comp) {
    uint8_t* plane = comp ? c.V : c.U;
    uint8_t* dst = plane + size_t(8 * c.mby) * cw + 8 * c.mbx;
    pred_large(dst, cw, 8, mode, b != nullptr, a != nullptr, dd != nullptr, true);
  }
}

// the 4x4 and 8x8 intra neighbour samples of a block at (x, y) pixels in
// the macroblock, `n` wide; tr: the top-right is available
void gather(Slice& c, int x, int y, int n, bool has_tl, bool has_t, bool has_tr,
            bool has_l, int* t, int* l) {
  Decoder& d = *c.d;
  int px = 16 * c.mbx + x, py = 16 * c.mby + y;
  const uint8_t* p = c.Y + size_t(py) * d.W + px;
  t[0] = has_tl ? p[-d.W - 1] : 0;
  for (int k = 0; k < n; ++k) t[1 + k] = has_t ? p[-d.W + k] : 0;
  for (int k = 0; k < n; ++k)
    t[1 + n + k] = has_tr ? p[-d.W + n + k] : t[n];
  for (int k = 0; k < n; ++k) l[k] = has_l ? p[size_t(k) * d.W - 1] : 0;
}

void check_mode(int mode, bool has_tl, bool has_t, bool has_l) {
  bool ok = true;
  switch (mode) {
    case 0: case 3: case 7: ok = has_t; break;
    case 1: case 8: ok = has_l; break;
    case 4: case 5: case 6: ok = has_t && has_l && has_tl; break;
  }
  if (!ok) fail("intra prediction mode " + std::to_string(mode) +
                " from unavailable neighbours");
}

void recon_intra_nxn(Slice& c, Residual& r) {
  Decoder& d = *c.d;
  Mb& m = *c.m;
  Mb* A = c.intra_nb(c.mbA());
  Mb* B = c.intra_nb(c.mbB());
  Mb* C = c.intra_nb(c.mb_at(c.mbx + 1, c.mby - 1));
  Mb* D = c.intra_nb(c.mb_at(c.mbx - 1, c.mby - 1));
  const int qp = m.qp;
  if (m.t8) {
    for (int b8 = 0; b8 < 4; ++b8) {
      int x8 = b8 & 1, y8 = b8 >> 1;
      bool has_l = x8 > 0 || A, has_t = y8 > 0 || B;
      bool has_tl = b8 == 3 ? true : b8 == 0 ? D != nullptr : b8 == 1 ? B != nullptr : A != nullptr;
      bool has_tr = b8 == 0 ? B != nullptr : b8 == 1 ? C != nullptr : b8 == 2;
      int mode = m.ipm[(y8 * 2) * 4 + x8 * 2];
      check_mode(mode, has_tl, has_t, has_l);
      int t[17], l[8];
      gather(c, 8 * x8, 8 * y8, 8, has_tl, has_t, has_tr, has_l, t, l);
      uint8_t pr[64];
      pred8x8l(mode, t, l, has_tl, has_t, has_l, pr);
      uint8_t* dst = c.Y + size_t(16 * c.mby + 8 * y8) * d.W + 16 * c.mbx + 8 * x8;
      for (int y = 0; y < 8; ++y) std::memcpy(dst + y * d.W, pr + 8 * y, 8);
      if (r.has_luma8[b8]) {
        dequant8(r.luma8[b8], c.dq.ls8[0][qp % 6], qp);
        idct8_add(r.luma8[b8], dst, d.W);
      }
    }
    return;
  }
  for (int k = 0; k < 16; ++k) {
    int rr = kBlkRaster[k], bx = rr & 3, by = rr >> 2;
    bool has_l = bx > 0 || A, has_t = by > 0 || B;
    bool has_tl = (bx > 0 && by > 0) ? true : (bx == 0 && by == 0) ? D != nullptr
                  : bx == 0 ? A != nullptr : B != nullptr;
    bool has_tr;
    if (by == 0) has_tr = bx < 3 ? B != nullptr : C != nullptr;
    else has_tr = bx < 3 && kRasterBlk[(by - 1) * 4 + bx + 1] < k;
    int mode = m.ipm[rr];
    check_mode(mode, has_tl, has_t, has_l);
    int t[9], l[4];
    gather(c, 4 * bx, 4 * by, 4, has_tl, has_t, has_tr, has_l, t, l);
    uint8_t pr[16];
    pred4x4(mode, t, l, has_t, has_l, pr);
    uint8_t* dst = c.Y + size_t(16 * c.mby + 4 * by) * d.W + 16 * c.mbx + 4 * bx;
    for (int y = 0; y < 4; ++y) std::memcpy(dst + y * d.W, pr + 4 * y, 4);
    if (r.has_luma[rr]) {
      dequant4(r.luma[rr], c.dq.ls4[0][qp % 6], qp, false);
      idct4_add(r.luma[rr], dst, d.W);
    }
  }
}

void recon_intra16(Slice& c, Residual& r, int mode) {
  Decoder& d = *c.d;
  Mb& m = *c.m;
  Mb* A = c.intra_nb(c.mbA());
  Mb* B = c.intra_nb(c.mbB());
  Mb* D = c.intra_nb(c.mb_at(c.mbx - 1, c.mby - 1));
  uint8_t* dst = c.Y + size_t(16 * c.mby) * d.W + 16 * c.mbx;
  pred_large(dst, d.W, 16, mode, B != nullptr, A != nullptr, D != nullptr, false);
  const int qp = m.qp;
  const int* ls = c.dq.ls4[0][qp % 6];
  int dcy[16] = {};
  if (r.has_dc) {
    int t[16], f[16];
    const int* x = r.dc;
    for (int i = 0; i < 4; ++i) {  // rows
      int a0 = x[4 * i], a1 = x[4 * i + 1], a2 = x[4 * i + 2], a3 = x[4 * i + 3];
      t[4 * i] = a0 + a1 + a2 + a3;
      t[4 * i + 1] = a0 + a1 - a2 - a3;
      t[4 * i + 2] = a0 - a1 - a2 + a3;
      t[4 * i + 3] = a0 - a1 + a2 - a3;
    }
    for (int j = 0; j < 4; ++j) {
      int a0 = t[j], a1 = t[4 + j], a2 = t[8 + j], a3 = t[12 + j];
      f[j] = a0 + a1 + a2 + a3;
      f[4 + j] = a0 + a1 - a2 - a3;
      f[8 + j] = a0 - a1 - a2 + a3;
      f[12 + j] = a0 - a1 + a2 - a3;
    }
    for (int k = 0; k < 16; ++k)
      dcy[k] = scaled(qp >= 36 ? int64_t(f[k]) * ls[0] * (1 << (qp / 6 - 6))
                               : (int64_t(f[k]) * ls[0] + (1 << (5 - qp / 6))) >> (6 - qp / 6));
  }
  for (int rr = 0; rr < 16; ++rr) {
    if (!dcy[rr] && !r.has_luma[rr]) continue;
    int* x = r.luma[rr];
    dequant4(x, ls, qp, true);
    x[0] = dcy[rr];
    int bx = rr & 3, by = rr >> 2;
    idct4_add(x, dst + size_t(4 * by) * d.W + 4 * bx, d.W);
  }
}

void init_mb(Slice& c) {
  Mb& m = *c.m;
  m.slice = c.slice_num;
  m.t8 = false;
  m.cbp = 0;
  m.chroma_mode = 0;
  m.dc_cbf = 0;
  std::memset(m.ipm, 2, sizeof m.ipm);
  std::memset(m.tc, 0, sizeof m.tc);
  std::memset(m.tcc, 0, sizeof m.tcc);
  std::memset(m.nzd, 0, sizeof m.nzd);
  std::memset(m.ref, -1, sizeof m.ref);
  std::memset(m.refpic, 0, sizeof m.refpic);
  std::memset(m.mv, 0, sizeof m.mv);
  std::memset(m.mvd, 0, sizeof m.mvd);
  c.done = 0;
}

void finish_refpics(Slice& c) {
  for (int k = 0; k < 4; ++k)
    c.m->refpic[k] = c.m->ref[k] >= 0 ? c.list0[c.m->ref[k]]->id : 0;
}

void decode_skip(Slice& c) {
  init_mb(c);
  Mb& m = *c.m;
  m.kind = kSkip;
  m.qp = c.qp;
  std::memset(m.ref, 0, sizeof m.ref);
  Nb A = motion_nb(c, -1, 0), B = motion_nb(c, 0, -1);
  int mx = 0, my = 0;
  if (A.ref != -2 && B.ref != -2 && !(A.ref == 0 && A.mx == 0 && A.my == 0) &&
      !(B.ref == 0 && B.mx == 0 && B.my == 0))
    mv_pred(c, 0, 0, 4, 0, 0, mx, my);
  set_motion(c, 0, 0, 4, 4, mx, my);
  predict_part(c, 0, 0, 4, 4);
  finish_refpics(c);
  c.last_dqp = 0;
}

void decode_mb(Slice& c) {
  init_mb(c);
  Mb& m = *c.m;
  const bool cabac = c.p->cabac;
  // mb_type: inter 0-4 (16x16, 16x8, 8x16, 8x8, 8x8ref0) or intra
  int inter = -1, itype = -1;
  if (cabac) {
    if (c.is_p) {
      Cabac& a = c.cabac;
      if (!a.decision(14)) {
        if (!a.decision(15)) inter = a.decision(16) ? 3 : 0;
        else inter = a.decision(17) ? 1 : 2;
      } else {
        itype = cabac_intra_type(c, false);
      }
    } else {
      itype = cabac_intra_type(c, true);
    }
  } else {
    uint32_t t = c.b.ue();
    if (c.is_p) {
      if (t < 5) inter = int(t);
      else itype = int(t) - 5;
    } else {
      itype = int(t);
    }
    if (itype > 25) fail("bad mb_type");
  }
  Residual r;
  r.clear();
  if (itype == 25) {  // I_PCM
    m.kind = kPcm;
    m.qp = c.qp;
    m.cbp = 0x2F;
    std::memset(m.tc, 16, sizeof m.tc);
    std::memset(m.tcc, 16, sizeof m.tcc);
    m.dc_cbf = 7;
    Bits& b = c.b;
    b.pos = (b.pos + 7) & ~size_t(7);
    if (b.pos / 8 + 384 > b.n) fail("I_PCM samples cut short");
    const uint8_t* s = b.p + b.pos / 8;
    Decoder& d = *c.d;
    for (int y = 0; y < 16; ++y)
      std::memcpy(c.Y + size_t(16 * c.mby + y) * d.W + 16 * c.mbx, s + 16 * y, 16);
    const int cw = d.W / 2;
    for (int comp = 0; comp < 2; ++comp)
      for (int y = 0; y < 8; ++y)
        std::memcpy((comp ? c.V : c.U) + size_t(8 * c.mby + y) * cw + 8 * c.mbx,
                    s + 256 + 64 * comp + 8 * y, 8);
    b.pos += 384 * 8;
    if (cabac) c.cabac.init_engine();
    c.last_dqp = 0;
    return;
  }
  int i16_mode = 0;
  std::vector<Part> parts;
  if (itype >= 0) {
    if (itype == 0) {
      m.kind = kI4;
      if (c.p->transform_8x8_mode && read_t8(c)) {
        m.t8 = true;
        m.kind = kI8;
      }
      read_intra_modes(c, m.t8);
    } else {
      m.kind = kI16;
      int t = itype - 1;
      i16_mode = t % 4;
      m.cbp = (((t / 4) % 3) << 4) | (t >= 12 ? 15 : 0);
    }
    m.chroma_mode = read_chroma_mode(c);
  } else {
    m.kind = kInter;
    bool ref0 = inter == 4;
    int sub[4] = {0, 0, 0, 0};
    if (inter >= 3) {
      for (int k = 0; k < 4; ++k) {
        if (cabac) {
          Cabac& a = c.cabac;
          if (a.decision(21)) sub[k] = 0;
          else if (!a.decision(22)) sub[k] = 1;
          else sub[k] = a.decision(23) ? 2 : 3;
        } else {
          uint32_t v = c.b.ue();
          if (v > 3) fail("bad sub_mb_type");
          sub[k] = int(v);
        }
      }
    }
    // partitions (4x4 units) in decoding order; refs per 8x8 partition
    struct RefPart { int x4, y4, w4, h4; };
    std::vector<RefPart> rparts;
    if (inter == 0) {
      rparts = {{0, 0, 4, 4}};
      parts = {{0, 0, 4, 4, 0}};
    } else if (inter == 1) {
      rparts = {{0, 0, 4, 2}, {0, 2, 4, 2}};
      parts = {{0, 0, 4, 2, 1}, {0, 2, 4, 2, 2}};
    } else if (inter == 2) {
      rparts = {{0, 0, 2, 4}, {2, 0, 2, 4}};
      parts = {{0, 0, 2, 4, 3}, {2, 0, 2, 4, 4}};
    } else {
      for (int k = 0; k < 4; ++k) {
        int x = 2 * (k & 1), y = 2 * (k >> 1);
        rparts.push_back({x, y, 2, 2});
        switch (sub[k]) {
          case 0: parts.push_back({x, y, 2, 2, 0}); break;
          case 1:
            parts.push_back({x, y, 2, 1, 0});
            parts.push_back({x, y + 1, 2, 1, 0});
            break;
          case 2:
            parts.push_back({x, y, 1, 2, 0});
            parts.push_back({x + 1, y, 1, 2, 0});
            break;
          default:
            for (int s = 0; s < 4; ++s) parts.push_back({x + (s & 1), y + (s >> 1), 1, 1, 0});
        }
      }
    }
    for (const RefPart& rp : rparts) {
      int ref = 0;
      if (c.num_ref > 1 && !ref0) {
        if (cabac) {
          ref = cabac_unary_ref(c, rp.x4, rp.y4);
        } else if (c.num_ref == 2) {
          ref = c.b.flag() ? 0 : 1;
        } else {
          ref = int(c.b.ue());
        }
      }
      if (ref >= c.num_ref) fail("ref_idx_l0 out of range");
      for (int y = rp.y4; y < rp.y4 + rp.h4; y += 2)
        for (int x = rp.x4; x < rp.x4 + rp.w4; x += 2) m.ref[(y >> 1) * 2 + (x >> 1)] = int8_t(ref);
    }
    for (Part& pt : parts) {
      if (cabac) {
        pt.mvdx = cabac_mvd(c, pt.x4, pt.y4, 0);
        pt.mvdy = cabac_mvd(c, pt.x4, pt.y4, 1);
      } else {
        pt.mvdx = c.b.se();
        pt.mvdy = c.b.se();
      }
      if (std::abs(pt.mvdx) > 65536 || std::abs(pt.mvdy) > 65536)
        fail("motion vector difference out of range");
      for (int y = pt.y4; y < pt.y4 + pt.h4; ++y)
        for (int x = pt.x4; x < pt.x4 + pt.w4; ++x) {
          m.mvd[y * 4 + x][0] = uint8_t(std::min(std::abs(pt.mvdx), 255));
          m.mvd[y * 4 + x][1] = uint8_t(std::min(std::abs(pt.mvdy), 255));
        }
    }
    for (const Part& pt : parts) {
      int mx, my;
      mv_pred(c, pt.x4, pt.y4, pt.w4, m.ref[b8_of(pt.y4 * 4 + pt.x4)], pt.shape, mx, my);
      set_motion(c, pt.x4, pt.y4, pt.w4, pt.h4, mx + pt.mvdx, my + pt.mvdy);
    }
    finish_refpics(c);
    bool small = inter >= 3 && (sub[0] | sub[1] | sub[2] | sub[3]) != 0;
    m.cbp = read_cbp(c, false);
    if ((m.cbp & 15) && c.p->transform_8x8_mode && !small) m.t8 = read_t8(c);
  }
  if (m.kind == kI4 || m.kind == kI8) m.cbp = read_cbp(c, true);
  int dqp = 0;
  if (m.cbp || m.kind == kI16) {
    dqp = read_qp_delta(c);
    c.qp = (c.qp + dqp + 52) % 52;
  }
  c.last_dqp = dqp;
  m.qp = c.qp;
  if (m.cbp || m.kind == kI16) parse_residual(c, r);
  Decoder& d = *c.d;
  if (m.intra()) {
    if (m.kind == kI16) recon_intra16(c, r, i16_mode);
    else recon_intra_nxn(c, r);
    intra_pred_chroma(c);
  } else {
    for (const Part& pt : parts) predict_part(c, pt.x4, pt.y4, pt.w4, pt.h4);
    const int qp = m.qp;
    for (int b8 = 0; b8 < 4; ++b8) {
      if (m.t8) {
        if (!r.has_luma8[b8]) continue;
        dequant8(r.luma8[b8], c.dq.ls8[1][qp % 6], qp);
        idct8_add(r.luma8[b8],
                  c.Y + size_t(16 * c.mby + 8 * (b8 >> 1)) * d.W + 16 * c.mbx + 8 * (b8 & 1), d.W);
        continue;
      }
      for (int i4 = 0; i4 < 4; ++i4) {
        int rr = kBlkRaster[4 * b8 + i4];
        if (!r.has_luma[rr]) continue;
        dequant4(r.luma[rr], c.dq.ls4[3][qp % 6], qp, false);
        idct4_add(r.luma[rr],
                  c.Y + size_t(16 * c.mby + 4 * (rr >> 2)) * d.W + 16 * c.mbx + 4 * (rr & 3), d.W);
      }
    }
  }
  add_chroma_residual(c, r, m.intra());
}

// ---------------------------------------------------------- deblocking

// 8.7.2.3/4: one line of samples across an edge: p[k] = p_k, q[k] = q_k
// at `step` apart from the edge sample pointer `q0`.
inline void filter_line(uint8_t* q0, int step, int bs, int alpha, int beta,
                        int tc0, bool chroma) {
  int p0 = q0[-step], p1 = q0[-2 * step], q0v = q0[0], q1 = q0[step];
  if (!(std::abs(p0 - q0v) < alpha && std::abs(p1 - p0) < beta &&
        std::abs(q1 - q0v) < beta))
    return;
  int p2 = chroma ? 0 : q0[-3 * step], q2 = chroma ? 0 : q0[2 * step];
  if (bs < 4) {
    int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0v);
    int tc = chroma ? tc0 + 1 : tc0 + (ap < beta) + (aq < beta);
    int delta = clip3(-tc, tc, ((q0v - p0) * 4 + (p1 - q1) + 4) >> 3);
    q0[-step] = clip1(p0 + delta);
    q0[0] = clip1(q0v - delta);
    if (!chroma) {
      if (ap < beta)
        q0[-2 * step] = uint8_t(p1 + clip3(-tc0, tc0, (p2 + ((p0 + q0v + 1) >> 1) - (p1 << 1)) >> 1));
      if (aq < beta)
        q0[step] = uint8_t(q1 + clip3(-tc0, tc0, (q2 + ((p0 + q0v + 1) >> 1) - (q1 << 1)) >> 1));
    }
    return;
  }
  if (chroma) {
    q0[-step] = uint8_t((2 * p1 + p0 + q1 + 2) >> 2);
    q0[0] = uint8_t((2 * q1 + q0v + p1 + 2) >> 2);
    return;
  }
  int p3 = q0[-4 * step], q3 = q0[3 * step];
  int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0v);
  bool small = std::abs(p0 - q0v) < ((alpha >> 2) + 2);
  if (ap < beta && small) {
    q0[-step] = uint8_t((p2 + 2 * p1 + 2 * p0 + 2 * q0v + q1 + 4) >> 3);
    q0[-2 * step] = uint8_t((p2 + p1 + p0 + q0v + 2) >> 2);
    q0[-3 * step] = uint8_t((2 * p3 + 3 * p2 + p1 + p0 + q0v + 4) >> 3);
  } else {
    q0[-step] = uint8_t((2 * p1 + p0 + q1 + 2) >> 2);
  }
  if (aq < beta && small) {
    q0[0] = uint8_t((p1 + 2 * p0 + 2 * q0v + 2 * q1 + q2 + 4) >> 3);
    q0[step] = uint8_t((p0 + q0v + q1 + q2 + 2) >> 2);
    q0[2 * step] = uint8_t((2 * q3 + 3 * q2 + q1 + q0v + p0 + 4) >> 3);
  } else {
    q0[0] = uint8_t((2 * q1 + q0v + p1 + 2) >> 2);
  }
}

int boundary_strength(const Mb& p, int pi, const Mb& q, int qi, bool mb_edge) {
  if (p.intra() || q.intra()) return mb_edge ? 4 : 3;
  if (p.nzd[pi] || q.nzd[qi]) return 2;
  if (p.refpic[b8_of(pi)] != q.refpic[b8_of(qi)]) return 1;
  if (std::abs(p.mv[pi][0] - q.mv[qi][0]) >= 4 || std::abs(p.mv[pi][1] - q.mv[qi][1]) >= 4)
    return 1;
  return 0;
}

void deblock_mb(Decoder& d, uint8_t* Y, uint8_t* U, uint8_t* V, int mbx, int mby) {
  const Mb& q = d.mbs[size_t(mby) * d.mbw + mbx];
  const SliceInfo& si = d.slices[q.slice];
  if (si.dbk_idc == 1) return;
  const int W = d.W, cw = d.W / 2;
  const bool fast_8x8 = si.cb_off == si.cr_off && !q.intra() && q.t8 && (q.cbp & 7) == 7;
  for (int dir = 0; dir < 2; ++dir) {
    int nx = dir == 0 ? mbx - 1 : mbx, ny = dir == 0 ? mby : mby - 1;
    const Mb* pn = (nx >= 0 && ny >= 0) ? &d.mbs[size_t(ny) * d.mbw + nx] : nullptr;
    if (pn && si.dbk_idc == 2 && pn->slice != q.slice) pn = nullptr;
    for (int e = 0; e < 4; ++e) {
      if (e == 0 && !pn) continue;
      if ((e & 1) && q.t8) continue;
      const Mb& p = e == 0 ? *pn : q;
      int bs[4];
      bool any = false;
      for (int k = 0; k < 4; ++k) {
        int qi = dir == 0 ? k * 4 + e : e * 4 + k;
        int pi = e == 0 ? (dir == 0 ? k * 4 + 3 : 12 + k) : (dir == 0 ? qi - 1 : qi - 4);
        // libavcodec's x86 filter (h264_filter_mb_fast_internal, taken
        // when both chroma QP offsets are equal) gives an inter 8x8-
        // transform macroblock whose 8x8 blocks 0-2 are all coded bS 2 on
        // its 8x8 edges without looking at the coefficients, which in
        // CAVLC may all be zero
        if (fast_8x8) bs[k] = (e == 0 && p.intra()) ? 4 : 2;
        else bs[k] = boundary_strength(p, pi, q, qi, e == 0);
        any |= bs[k] != 0;
      }
      if (!any) continue;
      int qpp = p.kind == kPcm ? 0 : p.qp, qpq = q.kind == kPcm ? 0 : q.qp;
      // luma
      {
        int qpav = (qpp + qpq + 1) >> 1;
        int ia = clip3(0, 51, qpav + si.alpha_off), ib = clip3(0, 51, qpav + si.beta_off);
        int alpha = kAlpha[ia], beta = kBeta[ib];
        uint8_t* base = Y + size_t(16 * mby) * W + 16 * mbx;
        for (int i = 0; i < 16; ++i) {
          int b = bs[i >> 2];
          if (!b) continue;
          uint8_t* q0 = dir == 0 ? base + size_t(i) * W + 4 * e : base + size_t(4 * e) * W + i;
          filter_line(q0, dir == 0 ? 1 : W, b, alpha, beta, b < 4 ? kTc0[ia][b - 1] : 0, false);
        }
      }
      if (e & 1) continue;
      for (int comp = 0; comp < 2; ++comp) {
        int off = comp ? si.cr_off : si.cb_off;
        int cp = kChromaQp[clip3(0, 51, qpp + off)], cq = kChromaQp[clip3(0, 51, qpq + off)];
        int qpav = (cp + cq + 1) >> 1;
        int ia = clip3(0, 51, qpav + si.alpha_off), ib = clip3(0, 51, qpav + si.beta_off);
        int alpha = kAlpha[ia], beta = kBeta[ib];
        uint8_t* base = (comp ? V : U) + size_t(8 * mby) * cw + 8 * mbx;
        for (int i = 0; i < 8; ++i) {
          int b = bs[i >> 1];
          if (!b) continue;
          uint8_t* q0 = dir == 0 ? base + size_t(i) * cw + 2 * e : base + size_t(2 * e) * cw + i;
          filter_line(q0, dir == 0 ? 1 : cw, b, alpha, beta, b < 4 ? kTc0[ia][b - 1] : 0, true);
        }
      }
    }
  }
}

// ---------------------------------------------------------- pictures

int frame_num_wrap(const Decoder& d, const Frame& f) {
  int max_fn = 1 << d.act->log2_max_frame_num;
  return f.frame_num > d.cur_frame_num ? f.frame_num - max_fn : f.frame_num;
}

void drop_unused(Decoder& d) {
  d.refs.erase(std::remove_if(d.refs.begin(), d.refs.end(),
                              [](const FramePtr& f) { return !f->short_ref && !f->long_ref; }),
               d.refs.end());
}

void sliding_window(Decoder& d) {
  int nshort = 0, nlong = 0;
  for (auto& f : d.refs) {
    nshort += f->short_ref;
    nlong += f->long_ref;
  }
  if (nshort > 0 && nshort + nlong >= std::max(d.act->max_num_ref_frames, 1)) {
    Frame* oldest = nullptr;
    for (auto& f : d.refs)
      if (f->short_ref && (!oldest || frame_num_wrap(d, *f) < frame_num_wrap(d, *oldest)))
        oldest = f.get();
    oldest->short_ref = false;
    drop_unused(d);
  }
}

void check_dpb(Decoder& d) {
  if (int(d.refs.size()) > std::max(d.act->max_num_ref_frames, 1))
    fail("more reference frames than max_num_ref_frames");
}

Frame* short_by_picnum(Decoder& d, int pic_num) {
  for (auto& f : d.refs)
    if (f->short_ref && frame_num_wrap(d, *f) == pic_num) return f.get();
  return nullptr;
}

Frame* long_by_num(Decoder& d, int num) {
  for (auto& f : d.refs)
    if (f->long_ref && f->long_term_frame_idx == num) return f.get();
  return nullptr;
}

void unmark_long_idx(Decoder& d, int idx, const Frame* keep) {
  for (auto& f : d.refs)
    if (f->long_ref && f->long_term_frame_idx == idx && f.get() != keep) f->long_ref = false;
}

// 8.2.5: the marking after a reference picture; returns whether it had
// memory_management_control_operation 5
bool mark_references(Decoder& d) {
  Frame& cur = *d.cur;
  bool mmco5 = false;
  if (d.cur_idr) {
    if (d.cur_long_term_reference) {
      cur.long_ref = true;
      cur.long_term_frame_idx = 0;
      d.max_long_term_frame_idx = 0;
    } else {
      cur.short_ref = true;
      d.max_long_term_frame_idx = -1;
    }
  } else if (d.cur_adaptive) {
    for (const Mmco& op : d.cur_mmco) {
      if (op.op == 1 || op.op == 3) {
        Frame* f = short_by_picnum(d, d.cur_frame_num - (op.diff + 1));
        if (!f) fail("memory_management_control_operation names a missing picture");
        if (op.op == 1) {
          f->short_ref = false;
        } else {
          if (op.idx > d.max_long_term_frame_idx) fail("long_term_frame_idx above the maximum");
          unmark_long_idx(d, op.idx, f);
          f->short_ref = false;
          f->long_ref = true;
          f->long_term_frame_idx = op.idx;
        }
      } else if (op.op == 2) {
        Frame* f = long_by_num(d, op.long_num);
        if (!f) fail("memory_management_control_operation names a missing picture");
        f->long_ref = false;
      } else if (op.op == 4) {
        d.max_long_term_frame_idx = op.idx - 1;
        for (auto& f : d.refs)
          if (f->long_ref && f->long_term_frame_idx > d.max_long_term_frame_idx)
            f->long_ref = false;
      } else if (op.op == 5) {
        for (auto& f : d.refs) f->short_ref = f->long_ref = false;
        d.max_long_term_frame_idx = -1;
        mmco5 = true;
      } else if (op.op == 6) {
        if (op.idx > d.max_long_term_frame_idx) fail("long_term_frame_idx above the maximum");
        unmark_long_idx(d, op.idx, &cur);
        cur.long_ref = true;
        cur.long_term_frame_idx = op.idx;
      }
      drop_unused(d);
    }
    if (!cur.long_ref) cur.short_ref = true;
  } else {
    sliding_window(d);
    cur.short_ref = true;
  }
  drop_unused(d);
  d.refs.push_back(d.cur);
  check_dpb(d);
  return mmco5;
}

void finish_picture(Decoder& d) {
  if (!d.in_picture) return;
  d.in_picture = false;
  if (d.decoded_mbs != d.mbw * d.mbh) fail("picture with missing slices");
  Frame& cur = *d.cur;
  for (int y = 0; y < d.mbh; ++y)
    for (int x = 0; x < d.mbw; ++x) deblock_mb(d, cur.y.data(), cur.u.data(), cur.v.data(), x, y);
  bool mmco5 = false;
  if (d.cur_ref) mmco5 = mark_references(d);
  cur.frame_num = mmco5 ? 0 : d.cur_frame_num;
  if (d.cur_ref) {
    d.prev_poc_msb = mmco5 ? 0 : d.cur_poc_msb;
    d.prev_poc_lsb = mmco5 ? d.cur_top - std::min(d.cur_top, d.cur_bottom) : d.cur_poc_lsb;
  }
  d.prev_frame_num_offset = mmco5 ? 0 : d.cur_frame_num_offset;
  d.prev_frame_num = cur.frame_num;
  d.prev_mmco5 = mmco5;
  d.out.push_back(d.cur);
  d.cur.reset();
  ++d.pictures;
}

struct SliceHeader {
  int nal_type = 0, nal_ref_idc = 0;
  int first_mb = 0, slice_type = 0, pps_id = 0, frame_num = 0;
  int poc_lsb = 0, delta_bottom = 0, delta_poc[2] = {0, 0};
  int num_ref = 0;
  struct Mod { int idc, val; };
  std::vector<Mod> mods;
  bool long_term_reference = false, adaptive = false;
  std::vector<Mmco> mmco;
  int cabac_init_idc = 0, qp_delta = 0;
  int dbk_idc = 0, alpha = 0, beta = 0;
};

void start_picture(Decoder& d, const SliceHeader& h, const Sps& s, const Pps& p) {
  const bool idr = h.nal_type == 5;
  if (!d.act || d.act != &s) {
    if (d.act && (s.mbw != d.mbw || s.mbh != d.mbh))
      refuse("a change of picture size mid-stream");
    if (d.act && !idr) fail("a new SPS outside an IDR picture");
    d.act = &s;
    d.mbw = s.mbw;
    d.mbh = s.mbh;
    d.W = 16 * s.mbw;
    d.H = 16 * s.mbh;
    // libavcodec keeps a left crop that would misalign the planes (not
    // a multiple of 64 columns) and OpenCV then rescales the picture to
    // the cropped width: refused
    // OpenCV converts with the matrix the VUI names (sws_getCoefficients)
    if (s.full_range) refuse("full-range video (video_full_range_flag 1)");
    if (s.matrix != 1 && s.matrix != 2 && s.matrix != 5 && s.matrix != 6)
      refuse("matrix_coefficients " + std::to_string(s.matrix) +
             " (only BT.601 and BT.709)");
    if (s.crop_left % 64)
      refuse("frame cropping of " + std::to_string(s.crop_left) +
             " columns on the left (not a multiple of 64)");
    int cl = s.crop_left, cr = s.crop_right, ct = s.crop_top, cb = s.crop_bottom;
    int w = d.W - s.crop_left - s.crop_right, hh = d.H - s.crop_top - s.crop_bottom;
    auto a16 = [](int v) { return (v + 15) & ~15; };
    if (d.container_w > 0 && d.container_h > 0 && !s.crop_top && !s.crop_left &&
        a16(d.container_w) == a16(w) && a16(d.container_h) == a16(hh) &&
        d.container_w <= w && d.container_h <= hh) {
      cl = ct = 0;
      cr = d.W - d.container_w;
      cb = d.H - d.container_h;
    }
    d.crop_x = cl;
    d.crop_y = ct;
    d.out_w = d.W - cl - cr;
    d.out_h = d.H - ct - cb;
    d.chroma_loc = s.chroma_loc;
    d.matrix = s.matrix;
    d.mbs.assign(size_t(d.mbw) * d.mbh, Mb());
  }
  if (!d.seen_idr && !idr) fail("the stream does not start with an IDR picture");
  const int max_fn = 1 << s.log2_max_frame_num;
  d.cur_idr = idr;
  d.cur_ref = h.nal_ref_idc != 0;
  d.cur_frame_num = h.frame_num;
  bool segment_start = idr || d.prev_mmco5;
  if (idr) {
    for (auto& f : d.refs) f->short_ref = f->long_ref = false;
    d.refs.clear();
    d.prev_frame_num = d.prev_frame_num_offset = 0;
    d.prev_poc_msb = d.prev_poc_lsb = 0;
    d.prev_mmco5 = false;
    d.seen_idr = true;
    if (h.frame_num != 0) fail("an IDR picture with frame_num " + std::to_string(h.frame_num));
  } else if (h.frame_num != d.prev_frame_num &&
             h.frame_num != (d.prev_frame_num + 1) % max_fn) {
    // a gap after the previous picture, reference or not, as libavcodec
    // counts it (h264_field_start; the standard counts from the previous
    // reference picture, which differs after a non-reference one)
    if (!s.gaps_allowed)
      fail("missing pictures: a frame_num gap without gaps_in_frame_num_allowed_flag");
    int first = (d.prev_frame_num + 1) % max_fn;
    int count = (h.frame_num - first + max_fn) % max_fn;
    int keep = std::min(count, std::max(s.max_num_ref_frames, 1));
    for (int k = count - keep; k < count; ++k) {
      int fn = (first + k) % max_fn;
      d.cur_frame_num = fn;
      auto f = std::make_shared<Frame>();
      f->frame_num = fn;
      f->non_existing = true;
      f->id = d.next_id++;
      sliding_window(d);
      f->short_ref = true;
      d.refs.push_back(f);
      check_dpb(d);
      d.prev_frame_num = fn;
    }
    d.cur_frame_num = h.frame_num;
  }
  // 8.2.1: picture order count
  int fno = 0;
  if (s.poc_type != 0 && !idr)
    fno = d.prev_frame_num > h.frame_num ? d.prev_frame_num_offset + max_fn
                                          : d.prev_frame_num_offset;
  d.cur_frame_num_offset = fno;
  int top = 0, bottom = 0;
  if (s.poc_type == 0) {
    int max_lsb = 1 << s.log2_max_poc_lsb, lsb = h.poc_lsb;
    int msb;
    if (lsb < d.prev_poc_lsb && d.prev_poc_lsb - lsb >= max_lsb / 2) msb = d.prev_poc_msb + max_lsb;
    else if (lsb > d.prev_poc_lsb && lsb - d.prev_poc_lsb > max_lsb / 2) msb = d.prev_poc_msb - max_lsb;
    else msb = d.prev_poc_msb;
    d.cur_poc_msb = msb;
    d.cur_poc_lsb = lsb;
    top = msb + lsb;
    bottom = top + h.delta_bottom;
  } else if (s.poc_type == 1) {
    int abs_fn = s.num_ref_frames_in_poc_cycle ? fno + h.frame_num : 0;
    if (!d.cur_ref && abs_fn > 0) --abs_fn;
    int expected = 0;
    if (abs_fn > 0) {
      int delta_cycle = 0;
      for (int i = 0; i < s.num_ref_frames_in_poc_cycle; ++i) delta_cycle += s.offset_for_ref_frame[i];
      int cycle = (abs_fn - 1) / s.num_ref_frames_in_poc_cycle;
      int in_cycle = (abs_fn - 1) % s.num_ref_frames_in_poc_cycle;
      expected = cycle * delta_cycle;
      for (int i = 0; i <= in_cycle; ++i) expected += s.offset_for_ref_frame[i];
    }
    if (!d.cur_ref) expected += s.offset_for_non_ref_pic;
    top = expected + h.delta_poc[0];
    bottom = top + s.offset_for_top_to_bottom_field + h.delta_poc[1];
  } else {
    int t = idr ? 0 : !d.cur_ref ? 2 * (fno + h.frame_num) - 1 : 2 * (fno + h.frame_num);
    top = bottom = t;
  }
  d.cur_top = top;
  d.cur_bottom = bottom;
  d.cur_poc = std::min(top, bottom);
  if (!segment_start && d.have_last_poc && d.cur_poc <= d.last_poc)
    refuse("pictures out of output order (picture order count " + std::to_string(d.cur_poc) +
           " after " + std::to_string(d.last_poc) + "): reordering is not supported");
  d.last_poc = d.cur_poc;
  d.have_last_poc = true;
  d.cur_adaptive = h.adaptive;
  d.cur_long_term_reference = h.long_term_reference;
  d.cur_mmco = h.mmco;
  d.cur = std::make_shared<Frame>();
  Frame& f = *d.cur;
  f.y.assign(size_t(d.W) * d.H, 0);
  f.u.assign(size_t(d.W / 2) * (d.H / 2), 128);
  f.v.assign(size_t(d.W / 2) * (d.H / 2), 128);
  f.frame_num = h.frame_num;
  f.id = d.next_id++;
  for (Mb& m : d.mbs) m.slice = -1;
  d.slices.clear();
  d.decoded_mbs = 0;
  d.cur_pps = p.id;
  d.in_picture = true;
}

void build_list0(Decoder& d, Slice& c, const SliceHeader& h) {
  std::vector<FramePtr> shorts, longs;
  for (auto& f : d.refs) {
    if (f->short_ref) shorts.push_back(f);
    else if (f->long_ref) longs.push_back(f);
  }
  std::sort(shorts.begin(), shorts.end(), [&](const FramePtr& a, const FramePtr& b) {
    return frame_num_wrap(d, *a) > frame_num_wrap(d, *b);
  });
  std::sort(longs.begin(), longs.end(), [](const FramePtr& a, const FramePtr& b) {
    return a->long_term_frame_idx < b->long_term_frame_idx;
  });
  std::vector<FramePtr> list = shorts;
  list.insert(list.end(), longs.begin(), longs.end());
  list.resize(size_t(c.num_ref));
  const int max_pic = 1 << d.act->log2_max_frame_num, curr = d.cur_frame_num;
  int pred = curr, ref_idx = 0;
  for (const auto& mod : h.mods) {
    FramePtr pic;
    if (mod.idc < 2) {
      int no_wrap = mod.idc == 0 ? pred - (mod.val + 1) : pred + (mod.val + 1);
      if (no_wrap < 0) no_wrap += max_pic;
      if (no_wrap >= max_pic) no_wrap -= max_pic;
      pred = no_wrap;
      int pic_num = no_wrap > curr ? no_wrap - max_pic : no_wrap;
      for (auto& f : d.refs)
        if (f->short_ref && frame_num_wrap(d, *f) == pic_num) pic = f;
    } else {
      for (auto& f : d.refs)
        if (f->long_ref && f->long_term_frame_idx == mod.val) pic = f;
    }
    if (!pic) fail("ref_pic_list_modification names a missing picture");
    if (ref_idx >= c.num_ref) fail("too many ref_pic_list_modification operations");
    list.insert(list.begin() + ref_idx, pic);
    ++ref_idx;
    int n = ref_idx;
    for (size_t k = size_t(ref_idx); k < list.size(); ++k)
      if (list[k] != pic) list[size_t(n++)] = list[k];
    list.resize(size_t(c.num_ref));
  }
  c.list0 = list;
}

void decode_slice(Decoder& d, const std::vector<uint8_t>& r, int nal_type, int nal_ref_idc) {
  Bits b = rbsp_bits(r, 1);
  SliceHeader h;
  h.nal_type = nal_type;
  h.nal_ref_idc = nal_ref_idc;
  h.first_mb = int(b.ue());
  h.slice_type = int(b.ue());
  if (h.slice_type > 9) fail("bad slice_type");
  int st = h.slice_type % 5;
  if (st == 1) refuse("B slices");
  if (st == 3) refuse("SP slices");
  if (st == 4) refuse("SI slices");
  if (nal_type == 5 && st != 2) fail("an IDR picture with a P slice");
  h.pps_id = int(b.ue());
  if (h.pps_id > 255 || !d.pps[h.pps_id].have) fail("slice names a missing PPS");
  const Pps& p = d.pps[h.pps_id];
  const Sps& s = d.sps[p.sps_id];
  if (!s.have) fail("slice names a missing SPS");
  if (d.in_picture && h.first_mb != 0 && d.cur_pps >= 0 &&
      d.pps[d.cur_pps].sps_id != p.sps_id)
    fail("slices of one picture name different SPSs");
  h.frame_num = int(b.u(s.log2_max_frame_num));
  if (nal_type == 5) b.ue();  // idr_pic_id
  if (s.poc_type == 0) {
    h.poc_lsb = int(b.u(s.log2_max_poc_lsb));
    if (p.bottom_field_pic_order_in_frame_present) h.delta_bottom = b.se();
  } else if (s.poc_type == 1 && !s.delta_pic_order_always_zero) {
    h.delta_poc[0] = b.se();
    if (p.bottom_field_pic_order_in_frame_present) h.delta_poc[1] = b.se();
  }
  if (p.redundant_pic_cnt_present && b.ue() != 0) refuse("redundant pictures");
  const bool is_p = st == 0;
  h.num_ref = p.num_ref_idx_l0_default;
  Slice c;
  c.d = &d;
  c.p = &p;
  if (is_p) {
    if (b.flag()) h.num_ref = int(b.ue()) + 1;
    if (h.num_ref > 16) fail("num_ref_idx_l0_active above 16");
    if (b.flag()) {  // ref_pic_list_modification_flag_l0
      for (;;) {
        int idc = int(b.ue());
        if (idc == 3) break;
        if (idc > 2) fail("bad modification_of_pic_nums_idc");
        h.mods.push_back({idc, int(b.ue())});
        if (h.mods.size() > 33) fail("too many ref_pic_list_modification operations");
      }
    }
    if (p.weighted_pred) {
      c.weighted = true;
      c.luma_log2_wd = int(b.ue());
      c.chroma_log2_wd = int(b.ue());
      if (c.luma_log2_wd > 7 || c.chroma_log2_wd > 7) fail("weight denominator above 7");
      c.weights.assign(size_t(h.num_ref), WeightEntry());
      for (auto& w : c.weights) {
        w.lw = 1 << c.luma_log2_wd;
        w.cw[0] = w.cw[1] = 1 << c.chroma_log2_wd;
        auto read = [&](int& v) {
          v = b.se();
          if (v < -128 || v > 127) fail("prediction weight out of range");
        };
        if (b.flag()) {
          read(w.lw);
          read(w.lo);
        }
        if (b.flag()) {
          for (int j = 0; j < 2; ++j) {
            read(w.cw[j]);
            read(w.co[j]);
          }
        }
      }
    }
  } else {
    h.num_ref = 0;
  }
  if (nal_ref_idc) {
    if (nal_type == 5) {
      b.u(1);  // no_output_of_prior_pics_flag: pictures leave as decoded
      h.long_term_reference = b.flag();
    } else if ((h.adaptive = b.flag())) {
      for (;;) {
        Mmco op;
        op.op = int(b.ue());
        if (op.op == 0) break;
        if (op.op > 6) fail("bad memory_management_control_operation");
        if (op.op == 1 || op.op == 3) op.diff = int(b.ue());
        if (op.op == 2) op.long_num = int(b.ue());
        if (op.op == 3 || op.op == 6) op.idx = int(b.ue());
        if (op.op == 4) op.idx = int(b.ue());
        h.mmco.push_back(op);
        if (h.mmco.size() > 66) fail("too many memory_management_control_operations");
      }
    }
  }
  if (p.cabac && is_p) {
    h.cabac_init_idc = int(b.ue());
    if (h.cabac_init_idc > 2) fail("bad cabac_init_idc");
  }
  h.qp_delta = b.se();
  int slice_qp = p.pic_init_qp + h.qp_delta;
  if (slice_qp < 0 || slice_qp > 51) fail("slice QP out of range");
  if (p.deblocking_filter_control_present) {
    h.dbk_idc = int(b.ue());
    if (h.dbk_idc > 2) fail("bad disable_deblocking_filter_idc");
    if (h.dbk_idc != 1) {
      h.alpha = b.se();
      h.beta = b.se();
      if (h.alpha < -6 || h.alpha > 6 || h.beta < -6 || h.beta > 6)
        fail("deblocking filter offsets out of range");
    }
  }
  // the picture (a new one where 7.4.1.2.4's fields differ)
  bool fresh = !d.in_picture || h.first_mb == 0 || h.frame_num != d.cur_frame_num ||
               (nal_type == 5) != d.cur_idr || (nal_ref_idc != 0) != d.cur_ref ||
               (s.poc_type == 0 && h.poc_lsb != d.cur_poc_lsb);
  if (fresh) {
    finish_picture(d);
    if (h.first_mb != 0)
      refuse("arbitrary slice order (a picture's first slice starts at macroblock " +
             std::to_string(h.first_mb) + ")");
    start_picture(d, h, s, p);
  } else {
    if (h.first_mb < d.decoded_mbs) refuse("arbitrary slice order");
    if (h.first_mb > d.decoded_mbs) fail("missing slices");
  }
  if (h.first_mb >= d.mbw * d.mbh) fail("first_mb_in_slice beyond the picture");
  c.slice_num = int(d.slices.size());
  SliceInfo si;
  si.dbk_idc = h.dbk_idc;
  si.alpha_off = 2 * h.alpha;
  si.beta_off = 2 * h.beta;
  si.cb_off = p.chroma_qp_index_offset;
  si.cr_off = p.second_chroma_qp_index_offset;
  d.slices.push_back(si);
  c.is_p = is_p;
  c.qp = slice_qp;
  c.num_ref = h.num_ref;
  if (is_p) build_list0(d, c, h);
  make_dequant(s, p, c.dq);
  c.Y = d.cur->y.data();
  c.U = d.cur->u.data();
  c.V = d.cur->v.data();
  c.b = b;
  const int total = d.mbw * d.mbh;
  int addr = h.first_mb;
  auto at = [&](int a) {
    if (a >= total) fail("slice data runs past the picture");
    c.mbx = a % d.mbw;
    c.mby = a / d.mbw;
    c.m = &d.mbs[size_t(a)];
  };
  if (p.cabac) {
    while (!c.b.aligned()) {
      if (!c.b.flag()) fail("bad cabac_alignment_one_bit");
    }
    c.cabac.b = &c.b;
    c.cabac.init_contexts(slice_qp, is_p ? 1 + h.cabac_init_idc : 0);
    c.cabac.init_engine();
    for (;;) {
      at(addr);
      if (is_p && cabac_mb_skip(c)) decode_skip(c);
      else decode_mb(c);
      ++addr;
      if (c.cabac.terminate()) break;
    }
  } else {
    for (;;) {
      if (is_p) {
        uint32_t run = c.b.ue();
        if (run > uint32_t(total - addr)) fail("mb_skip_run past the picture");
        for (uint32_t k = 0; k < run; ++k) {
          at(addr++);
          decode_skip(c);
        }
        if (run > 0 && !c.b.more_rbsp_data()) break;
      }
      at(addr++);
      decode_mb(c);
      if (!c.b.more_rbsp_data()) break;
    }
  }
  d.decoded_mbs = addr;
}

void decode_nal(Decoder& d, const uint8_t* nal, size_t n) {
  if (n < 1) return;
  if (nal[0] & 0x80) fail("forbidden_zero_bit set");
  int ref_idc = (nal[0] >> 5) & 3, type = nal[0] & 31;
  // a picture whose macroblocks are all decoded ends before the next
  // picture's NAL units (errors there then name the next frame)
  if (type >= 1 && type <= 5 && d.in_picture && d.decoded_mbs == d.mbw * d.mbh) {
    Bits b;
    to_rbsp(nal, n, d.rbsp);
    b = rbsp_bits(d.rbsp, 1);
    if (type < 5 || b.ue() == 0) finish_picture(d);
  }
  switch (type) {
    case 1:
    case 5:
      to_rbsp(nal, n, d.rbsp);
      decode_slice(d, d.rbsp, type, ref_idc);
      break;
    case 2:
    case 3:
    case 4:
      refuse("data partitioning (NAL unit types 2-4)");
    case 7: {
      to_rbsp(nal, n, d.rbsp);
      Sps s;
      parse_sps(d.rbsp, s);
      Sps& slot = d.sps[s.id];
      if (!(slot.have && slot.raw == s.raw)) {
        if (d.act == &slot) {
          finish_picture(d);
          if (s.mbw != d.mbw || s.mbh != d.mbh) refuse("a change of picture size mid-stream");
          d.act = nullptr;
        }
        slot = s;
      }
      break;
    }
    case 8: {
      to_rbsp(nal, n, d.rbsp);
      Pps p;
      parse_pps(d.rbsp, p, d.sps);
      if (d.in_picture && d.cur_pps == p.id && !(d.pps[p.id].raw == p.raw))
        finish_picture(d);
      d.pps[p.id] = p;
      break;
    }
    case 9:
    case 10:
    case 11:
      finish_picture(d);
      break;
    default:  // SEI, filler, extensions, MVC/SVC and reserved types
      break;
  }
}

// Splits `data` into NAL units (Annex B start codes when len_size is 0,
// else big-endian length prefixes) and decodes them.
void decode_units(Decoder& d, const uint8_t* data, size_t n, int len_size) {
  if (len_size == 0) {
    size_t i = 0, start = SIZE_MAX;
    while (i + 3 <= n) {
      if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
        if (start != SIZE_MAX) {
          size_t end = i;
          while (end > start && data[end - 1] == 0) --end;
          decode_nal(d, data + start, end - start);
        }
        i += 3;
        start = i;
      } else {
        ++i;
      }
    }
    if (start != SIZE_MAX) {
      size_t end = n;
      while (end > start && data[end - 1] == 0) --end;
      decode_nal(d, data + start, end - start);
    }
    return;
  }
  size_t i = 0;
  while (i < n) {
    if (i + size_t(len_size) > n) fail("NAL unit length cut short");
    size_t len = 0;
    for (int k = 0; k < len_size; ++k) len = (len << 8) | data[i + k];
    i += size_t(len_size);
    if (len > n - i) fail("NAL unit longer than its sample");
    decode_nal(d, data + i, len);
    i += len;
  }
}

void set_err(char* err, int len, const std::string& msg) {
  if (!err || len <= 0) return;
  std::snprintf(err, size_t(len), "%s", msg.c_str());
}

}  // namespace

extern "C" {

void* mvsf_h264_new(int container_w, int container_h) {
  Decoder* d = new Decoder();
  d->container_w = container_w;
  d->container_h = container_h;
  return d;
}

void mvsf_h264_free(void* h) { delete static_cast<Decoder*>(h); }

// Decodes the NAL units of `data` (Annex B when len_size is 0, else
// length-prefixed; cut anywhere between NAL units).  A picture is
// finished when the next one's first NAL unit comes, or at the flush.
// Returns the number of frames ready, or -1 with a message.
int mvsf_h264_decode(void* h, const uint8_t* data, int64_t n, int len_size, char* err,
                     int errlen) {
  Decoder& d = *static_cast<Decoder*>(h);
  try {
    decode_units(d, data, size_t(n), len_size);
    return int(d.out.size());
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return -1;
  }
}

// Finishes the last picture at the end of the stream; returns the number
// of frames ready, or -1 with a message.
int mvsf_h264_flush(void* h, char* err, int errlen) {
  Decoder& d = *static_cast<Decoder*>(h);
  try {
    finish_picture(d);
    return int(d.out.size());
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return -1;
  }
}

// Pictures finished so far: the decoding-order number of the picture a
// failure was in.
int mvsf_h264_pictures(void* h) { return static_cast<Decoder*>(h)->pictures; }

// Size of the frames, their chroma location (libavutil's numbering) and
// the VUI's matrix_coefficients.
void mvsf_h264_size(void* h, int* w, int* hh, int* chroma_loc, int* matrix) {
  Decoder& d = *static_cast<Decoder*>(h);
  *w = d.out_w;
  *hh = d.out_h;
  *chroma_loc = d.chroma_loc;
  *matrix = d.matrix;
}

// Copies the oldest ready frame's cropped planes into y (w*h), u and v
// (((w+1)/2)*((h+1)/2) each) and drops it; returns 1, or 0 when none.
int mvsf_h264_pop(void* h, uint8_t* y, uint8_t* u, uint8_t* v) {
  Decoder& d = *static_cast<Decoder*>(h);
  if (d.out.empty()) return 0;
  FramePtr f = d.out.front();
  d.out.erase(d.out.begin());
  int w = d.out_w, hh = d.out_h, cw = (w + 1) / 2, ch = (hh + 1) / 2;
  for (int r = 0; r < hh; ++r)
    std::memcpy(y + size_t(r) * w, f->y.data() + size_t(r + d.crop_y) * d.W + d.crop_x, size_t(w));
  const int sw = d.W / 2;
  for (int r = 0; r < ch; ++r) {
    std::memcpy(u + size_t(r) * cw, f->u.data() + size_t(r + d.crop_y / 2) * sw + d.crop_x / 2,
                size_t(cw));
    std::memcpy(v + size_t(r) * cw, f->v.data() + size_t(r + d.crop_y / 2) * sw + d.crop_x / 2,
                size_t(cw));
  }
  return 1;
}

// The cropped size given by the first SPS among the Annex B NAL units of
// `data` (the head of a raw stream).  Returns 0, 1 when there is none,
// or -1 with a message.
int mvsf_h264_probe(const uint8_t* data, int64_t n, int* w, int* hh, char* err,
                    int errlen) {
  try {
    std::vector<uint8_t> r;
    for (int64_t i = 0; i + 3 < n; ++i) {
      if (data[i] || data[i + 1] || data[i + 2] != 1) continue;
      const uint8_t* nal = data + i + 3;
      if ((nal[0] & 31) != 7) continue;
      to_rbsp(nal, size_t(n - (i + 3)), r);
      Sps s;
      parse_sps(r, s);
      *w = 16 * s.mbw - s.crop_left - s.crop_right;
      *hh = 16 * s.mbh - s.crop_top - s.crop_bottom;
      return 0;
    }
    return 1;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return -1;
  }
}

// 4:2:0 planes to BGR as swscale converts them for OpenCV, with the
// given chroma location and VUI matrix_coefficients (`yuv420_bgr.h`).
void mvsf_h264_yuv420_to_bgr(const uint8_t* y, const uint8_t* u, const uint8_t* v, int w,
                             int h, int chroma_loc, int matrix, uint8_t* bgr) {
  yuvbgr::yuv420_to_bgr(y, u, v, w, h, chroma_loc,
                        matrix == 1 ? yuvbgr::bt709() : yuvbgr::bt601(), bgr);
}

}  // extern "C"
