// MPEG-4 Part 2 Simple Profile video decoding for `data/mpeg4.py`
// (ISO/IEC 14496-2), written to give the same pictures as libavcodec's
// mpeg4 decoder (mpeg4videodec.c, h263dec.c), which OpenCV's FFmpeg
// backend runs for `cv2.VideoCapture`:
//   * the visual object sequence, visual object, video object layer
//     (VOL), user data, group of VOP and VOP headers;
//   * I- and P-VOPs: intra DC VLC against intra_dc_vlc_thr, DC/AC
//     prediction (AC rescaled across a change of quantiser), H.263
//     inverse quantisation, one or four vectors a macroblock with the
//     four-vector chroma rounding, half-pel compensation with
//     vop_rounding_type, unrestricted vectors over edge-extended
//     references, not-coded macroblocks, dquant, resync markers and
//     video packets (with header extension);
//   * a VOP with vop_coded = 0 gives no picture, as libavcodec gives
//     none (`mvsf_m4v_decode` says so and the caller repeats nothing);
//   * the 8-bit "simple" integer IDCT (mpeg4_common.h);
//   * `mvsf_yuv420_to_bgr`: the conversion to BGR that OpenCV's FFmpeg
//     backend gets from swscale, bitwise: for even heights its unscaled
//     x86 converter (16-bit fixed point, BT.601 limited range, each
//     chroma sample for its 2x2 pixels); for odd heights its scaling
//     path (bicubic chroma filters, MPEG-4's left-sited chroma, x86
//     vertical filter and output code but C for the last two rows, and
//     full horizontal chroma for odd widths).
// Data partitioning, reversible VLCs, B-VOPs, quarter-pel, sprites and
// GMC, MPEG quantisation (quant_type 1), interlace, the short video
// header, shapes other than rectangular, other than 8 bits, newpred,
// reduced resolution, scalability and complexity estimation are
// refused with a message naming the tool; so is a stream whose user
// data names Xvid or DivX (libavcodec repeats those encoders' IDCT and
// bugs, this decoder does not).
//
// Built with g++ into a shared library and called through ctypes; the
// entry points return 0 (or a count) on success and a negative code
// with a message in `err` otherwise.

#include <cstdio>
#include <cstdlib>

#include "mpeg4_common.h"
#include "yuv420_bgr.h"

namespace {

using namespace m4v;

struct Vol {
  bool have = false;
  int width = 0, height = 0, mbw = 0, mbh = 0;
  int time_inc_bits = 1;
  int vo_type = 0;
  bool vol_control = false;
};

struct Decoder {
  Vol vol;
  bool lavc = false;        // user data of libavcodec seen
  std::string refused_by;   // encoder named by user data we refuse
  bool xvid_tag = false;    // container fourcc says Xvid
  bool divx_tag = false;    // container fourcc says DivX
  Picture cur, ref;
  bool have_ref = false;
  bool last_not_coded = false;
  MbState st;
};

// Parses user data (up to the next start code) for the encoder names
// libavcodec looks for.
void parse_user_data(Decoder& d, const uint8_t* p, size_t n) {
  std::string s(reinterpret_cast<const char*>(p), n);
  if (s.compare(0, 4, "DivX") == 0) d.refused_by = "DivX";
  if (s.compare(0, 4, "XviD") == 0 || s.compare(0, 4, "Xvid") == 0)
    d.refused_by = "Xvid";
  if (s.compare(0, 4, "Lavc") == 0) {
    int a = 0, b = 0, c = 0;
    if (std::sscanf(s.c_str(), "Lavc%d.%d.%d", &a, &b, &c) == 3) {
      d.lavc = true;
      unsigned build = (unsigned(a) << 16) + (unsigned(b) << 8) + unsigned(c);
      // libavcodec works around an intra edge bug of these versions
      if (build > 3621476 && build < 3752552 &&
          (build < 3752037 || build > 3752191))
        d.refused_by = "libavcodec " + std::to_string(a) + "." +
                       std::to_string(b) + "." + std::to_string(c) +
                       " (its intra-edge workaround)";
    }
  }
  if (s.compare(0, 5, "FFmpe") == 0)
    d.refused_by = "an early FFmpeg build (its workarounds)";
}

void refuse(const char* tool) { fail(std::string("unsupported MPEG-4 tool: ") + tool); }

void parse_vol(Decoder& d, BitReader& br) {
  Vol v;
  br.skip(1);  // random_accessible_vol
  v.vo_type = (int)br.get(8);
  int verid = 1;
  if (br.get1()) {
    verid = (int)br.get(4);
    br.skip(3);
  }
  if (br.get(4) == 15) br.skip(16);  // extended PAR
  v.vol_control = br.get1();
  if (v.vol_control) {
    int chroma = (int)br.get(2);
    if (chroma != 1) refuse("chroma format other than 4:2:0");
    br.skip(1);  // low_delay
    if (br.get1()) br.skip(15 + 1 + 15 + 1 + 15 + 1 + 3 + 11 + 1 + 15 + 1);
  }
  int shape = (int)br.get(2);
  if (shape != 0) refuse("non-rectangular shape");
  br.skip(1);
  int res = (int)br.get(16);
  if (res == 0) fail("VOL: vop_time_increment_resolution 0");
  br.skip(1);
  int bits = 0;
  while ((1 << bits) < res) ++bits;  // av_log2(res - 1) + 1
  v.time_inc_bits = std::max(bits, 1);
  if (br.get1()) br.skip(v.time_inc_bits);  // fixed_vop_rate
  br.skip(1);
  v.width = (int)br.get(13);
  br.skip(1);
  v.height = (int)br.get(13);
  br.skip(1);
  if (v.width <= 0 || v.height <= 0) fail("VOL: zero picture size");
  if (br.get1()) refuse("interlace");
  if (!br.get1()) refuse("OBMC");
  int sprite = (int)br.get(verid == 1 ? 1 : 2);
  if (sprite) refuse("sprites/GMC");
  if (br.get1()) refuse("not_8_bit");
  if (br.get1()) refuse("quant_type 1 (MPEG quantisation)");
  if (verid != 1 && br.get1()) refuse("quarter-pel");
  if (!br.get1()) refuse("complexity estimation header");
  br.skip(1);  // resync_marker_disable
  if (br.get1()) refuse("data partitioning");
  if (verid != 1) {
    if (br.get1()) refuse("newpred");
    if (br.get1()) refuse("reduced resolution VOP");
  }
  if (br.get1()) refuse("scalability");
  if (br.overrun()) fail("VOL header cut short");
  v.mbw = (v.width + 15) / 16;
  v.mbh = (v.height + 15) / 16;
  v.have = true;
  if (d.vol.have && (d.vol.width != v.width || d.vol.height != v.height))
    fail("VOL: the picture size changes mid-stream");
  if (!d.vol.have) {
    d.cur.init(v.mbw, v.mbh);
    d.ref.init(v.mbw, v.mbh);
    d.st.init(v.mbw, v.mbh);
  }
  d.vol = v;
}

struct VopCtx {
  Decoder* d;
  BitReader* br;
  bool p_vop;
  bool no_rounding;
  int dc_thr;
  int qscale;
  int fcode;
  int packet;
  int rx, ry;  // first MB of the packet
};

int read_mv_component(VopCtx& c, int pred) {
  const Tables& T = tables();
  int code = T.mv.read(*c.br);
  if (code < 0) fail("invalid motion vector code");
  if (code == 0) return pred;
  int sign = c.br->get1();
  int shift = c.fcode - 1;
  int val = code;
  if (shift) {
    val = (val - 1) << shift;
    val |= (int)c.br->get(shift);
    val++;
  }
  if (sign) val = -val;
  val += pred;
  int bits = 5 + c.fcode;  // sign_extend(val, 5 + f_code)
  int m = 1 << bits;
  val &= m - 1;
  if (val & (m >> 1)) val -= m;
  return val;
}

// The TCOEF run-level decoding of one block: levels into `lv`
// (row-major) along `scan` from position `i`, dequantised inline for
// inter blocks (qmul, qadd) or raw for intra ones.
void read_coefs(VopCtx& c, bool intra, const uint8_t* scan, int i, int* lv) {
  const Tables& T = tables();
  const RunLevel& rl = intra ? T.intra : T.inter;
  int q = c.qscale;
  int qmul = intra ? 1 : 2 * q, qadd = intra ? 0 : (q - 1) | 1;
  BitReader& br = *c.br;
  for (;;) {
    int idx = rl.vlc.read(br);
    if (idx < 0) fail("invalid DCT coefficient code");
    int run, level, last;
    if (idx == 102) {  // escape
      if (!br.get1()) {  // type 1: level offset
        idx = rl.vlc.read(br);
        if (idx < 0 || idx == 102) fail("invalid escaped coefficient");
        last = idx >= rl.nlast;
        run = rl.run[idx];
        level = rl.level[idx] + rl.max_level[last][run];
        level = level * qmul + qadd;
        if (br.get1()) level = -level;
      } else if (!br.get1()) {  // type 2: run offset
        idx = rl.vlc.read(br);
        if (idx < 0 || idx == 102) fail("invalid escaped coefficient");
        last = idx >= rl.nlast;
        level = rl.level[idx];
        run = rl.run[idx] + rl.max_run[last][level] + 1;
        level = level * qmul + qadd;
        if (br.get1()) level = -level;
      } else {  // type 3: fixed length
        last = br.get1();
        run = (int)br.get(6);
        if (!br.get1()) fail("missing marker bit in an escaped coefficient");
        level = br.sget(12);
        if (!br.get1()) fail("missing marker bit in an escaped coefficient");
        if (level == 0) fail("zero escaped coefficient");
        level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
        if (level < -2048) level = -2048;
        if (level > 2047) level = 2047;
      }
    } else {
      last = idx >= rl.nlast;
      run = rl.run[idx];
      level = rl.level[idx] * qmul + qadd;
      if (br.get1()) level = -level;
    }
    i += run;
    if (i > 63) fail("DCT coefficient run past the block");
    lv[scan[i]] = level;
    ++i;
    if (last) return;
  }
}

void decode_intra_block(VopCtx& c, int mbx, int mby, int k, bool coded,
                        bool ac_pred, bool use_dc_vlc, int16_t* blk) {
  Decoder& d = *c.d;
  BitReader& br = *c.br;
  const Tables& T = tables();
  int scale = k < 4 ? y_dc_scale(c.qscale) : c_dc_scale(c.qscale);
  int dir;
  int pred = predict_dc(d.st, mbx, mby, k, c.packet, scale, dir);
  int lv[64] = {0};
  int start = 0;
  if (use_dc_vlc) {
    int size = (k < 4 ? T.dc_lum : T.dc_chrom).read(br);
    if (size < 0 || size > 9) fail("invalid intra DC size code");
    int level = 0;
    if (size) {
      uint32_t v = br.get(size);
      level = (v >> (size - 1)) ? (int)v : (int)v - (1 << size) + 1;
      if (size > 8) br.skip(1);  // marker
    }
    lv[0] = level;
    start = 1;
  }
  if (coded) {
    const uint8_t* scan =
        !ac_pred ? kZigzag : dir == 0 ? kAltVertical : kAltHorizontal;
    read_coefs(c, true, scan, start, lv);
  }
  int level = lv[0] + pred;
  int stored = level * scale;
  if (stored & ~2047) stored = stored < 0 ? 0 : 2047;
  d.st.dc[(size_t(mby) * d.st.mbw + mbx) * 6 + k] = stored;
  lv[0] = level;
  if (ac_pred) predict_ac(d.st, mbx, mby, k, c.packet, dir, c.qscale, 1, lv);
  store_ac(d.st, mbx, mby, k, lv);
  blk[0] = (int16_t)(level * scale);
  for (int i = 1; i < 64; ++i) blk[i] = (int16_t)dequant(lv[i], c.qscale);
}

void set_qscale(VopCtx& c, int q) { c.qscale = q < 1 ? 1 : q > 31 ? 31 : q; }

void decode_mb(VopCtx& c, int mbx, int mby) {
  Decoder& d = *c.d;
  BitReader& br = *c.br;
  const Tables& T = tables();
  MbState& st = d.st;
  size_t mi = size_t(mby) * st.mbw + mbx;
  st.packet[mi] = c.packet;
  bool intra;
  int cbpc, dquant;
  int mv[4][2] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};
  bool four = false;
  if (c.p_vop) {
    do {
      if (br.get1()) {  // not coded
        st.intra[mi] = 0;
        st.qscale[mi] = (int8_t)c.qscale;
        for (int k = 0; k < 4; ++k) {
          int16_t* p = st.mvp(2 * mbx + (k & 1), 2 * mby + (k >> 1));
          p[0] = p[1] = 0;
        }
        motion_compensate(d.cur, d.ref, mbx, mby, false, mv, c.no_rounding,
                          d.vol.width, d.vol.height);
        return;
      }
      cbpc = T.inter_mcbpc.read(br);
      if (cbpc < 0) fail("invalid mcbpc code");
    } while (cbpc == 20);
    dquant = cbpc & 8;
    intra = (cbpc & 4) != 0;
  } else {
    do {
      cbpc = T.intra_mcbpc.read(br);
      if (cbpc < 0) fail("invalid mcbpc code");
    } while (cbpc == 8);
    dquant = cbpc & 4;
    intra = true;
  }
  st.intra[mi] = intra;
  int16_t blocks[6][64];
  if (intra) {
    bool ac_pred = br.get1();
    int cbpy = T.cbpy.read(br);
    if (cbpy < 0) fail("invalid cbpy code");
    int cbp = (cbpc & 3) | (cbpy << 2);
    bool use_dc_vlc = c.qscale < c.dc_thr;
    if (dquant) set_qscale(c, c.qscale + kDquant[br.get(2)]);
    st.qscale[mi] = (int8_t)c.qscale;
    for (int k = 0; k < 4; ++k) {
      int16_t* p = st.mvp(2 * mbx + (k & 1), 2 * mby + (k >> 1));
      p[0] = p[1] = 0;
    }
    for (int k = 0; k < 6; ++k) {
      decode_intra_block(c, mbx, mby, k, (cbp >> (5 - k)) & 1, ac_pred,
                         use_dc_vlc, blocks[k]);
      int stride;
      uint8_t* dst = block_dst(d.cur, mbx, mby, k, stride);
      idct(blocks[k], dst, stride, false);
    }
    return;
  }
  int cbpy = T.cbpy.read(br);
  if (cbpy < 0) fail("invalid cbpy code");
  cbpy ^= 15;
  int cbp = (cbpc & 3) | (cbpy << 2);
  if (dquant) set_qscale(c, c.qscale + kDquant[br.get(2)]);
  st.qscale[mi] = (int8_t)c.qscale;
  // An inter MB predicts no later intra block: libavcodec resets its
  // DC to 1024 and its AC to 0, which MbState::usable gives from `intra`.
  if (!(cbpc & 16)) {
    int px, py;
    predict_mv(st, mbx, mby, 0, c.rx, c.ry, px, py);
    mv[0][0] = read_mv_component(c, px);
    mv[0][1] = read_mv_component(c, py);
    for (int k = 0; k < 4; ++k) {
      int16_t* p = st.mvp(2 * mbx + (k & 1), 2 * mby + (k >> 1));
      p[0] = (int16_t)mv[0][0];
      p[1] = (int16_t)mv[0][1];
    }
  } else {
    four = true;
    for (int k = 0; k < 4; ++k) {
      int px, py;
      predict_mv(st, mbx, mby, k, c.rx, c.ry, px, py);
      mv[k][0] = read_mv_component(c, px);
      mv[k][1] = read_mv_component(c, py);
      int16_t* p = st.mvp(2 * mbx + (k & 1), 2 * mby + (k >> 1));
      p[0] = (int16_t)mv[k][0];
      p[1] = (int16_t)mv[k][1];
    }
  }
  motion_compensate(d.cur, d.ref, mbx, mby, four, mv, c.no_rounding,
                    d.vol.width, d.vol.height);
  for (int k = 0; k < 6; ++k) {
    if (!((cbp >> (5 - k)) & 1)) continue;
    int lv[64] = {0};
    read_coefs(c, false, kZigzag, 0, lv);
    for (int i = 0; i < 64; ++i) blocks[k][i] = (int16_t)lv[i];
    int stride;
    uint8_t* dst = block_dst(d.cur, mbx, mby, k, stride);
    idct(blocks[k], dst, stride, true);
  }
}

// At a macroblock boundary: whether stuffing up to the byte boundary
// and a resync marker follow.
bool at_resync(BitReader& br) {
  size_t p = br.pos();
  int k = 8 - int(p & 7);
  uint32_t stuffing = br.peek(k);
  if (stuffing != (1u << (k - 1)) - 1) return false;
  BitReader b2 = br;
  b2.skip(k);
  return b2.peek(16) == 0 && b2.pos() + 17 <= b2.size_bits();
}

void parse_packet_header(VopCtx& c, int mb_num, int& mb) {
  BitReader& br = *c.br;
  br.skip(8 - int(br.pos() & 7));  // stuffing
  int zeros = 0;
  while (zeros < 32 && !br.get1()) ++zeros;
  int want = c.p_vop ? 15 + c.fcode : 16;
  if (zeros != want) fail("resync marker does not match the VOP's f_code");
  int bits = 0;
  while ((1 << bits) < mb_num) ++bits;
  bits = std::max(bits, 1);
  int n = (int)br.get(bits);
  if (n != mb) fail("video packet starts at MB " + std::to_string(n) +
                    ", expected " + std::to_string(mb));
  int q = (int)br.get(5);
  if (q) c.qscale = q;
  if (br.get1()) {  // header_extension_code
    while (br.get1()) {
    }
    br.skip(1);
    br.skip(c.d->vol.time_inc_bits);
    br.skip(1);
    br.skip(2);  // vop_coding_type
    br.skip(3);  // intra_dc_vlc_thr (ignored, as libavcodec does)
    if (c.p_vop) br.skip(3);
  }
  c.packet++;
  c.rx = mb % c.d->vol.mbw;
  c.ry = mb / c.d->vol.mbw;
}

// Decodes one VOP starting after its start code; returns 1 when it
// gave a picture, 0 for vop_coded = 0.
int decode_vop(Decoder& d, BitReader& br) {
  if (!d.vol.have) fail("a VOP before any VOL header");
  int type = (int)br.get(2);
  if (type == 2) refuse("B-VOP");
  if (type == 3) refuse("S-VOP (sprite/GMC)");
  while (br.get1()) {
  }
  br.skip(1);
  br.skip(d.vol.time_inc_bits);
  br.skip(1);
  if (!br.get1()) {
    d.last_not_coded = true;
    return 0;
  }
  VopCtx c{};
  c.d = &d;
  c.br = &br;
  c.p_vop = type == 1;
  if (c.p_vop && !d.have_ref) fail("a P-VOP with no reference picture");
  c.no_rounding = c.p_vop ? br.get1() : false;
  c.dc_thr = kDcThreshold[br.get(3)];
  c.qscale = (int)br.get(5);
  if (c.qscale == 0) fail("VOP quantiser 0");
  c.fcode = c.p_vop ? (int)br.get(3) : 1;
  if (c.fcode == 0) fail("VOP f_code 0");
  c.packet = 0;
  c.rx = c.ry = 0;
  d.st.new_vop();
  int mb_num = d.vol.mbw * d.vol.mbh;
  for (int mb = 0; mb < mb_num; ++mb) {
    if (mb > 0 && at_resync(br)) parse_packet_header(c, mb_num, mb);
    decode_mb(c, mb % d.vol.mbw, mb / d.vol.mbw);
    if (br.overrun()) fail("VOP data cut short");
  }
  d.last_not_coded = false;
  std::swap(d.cur, d.ref);
  d.have_ref = true;
  return 1;
}

// The start codes (00 00 01 xx) of a chunk: (offset of the code byte
// xx, end of its unit).  MPEG-4 data never emulates one.
std::vector<std::pair<size_t, size_t>> units(const uint8_t* data, size_t n) {
  std::vector<std::pair<size_t, size_t>> u;
  for (size_t i = 0; i + 3 < n; ++i) {
    if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
      if (!u.empty()) u.back().second = i;
      u.push_back({i + 3, n});
      i += 2;
    }
  }
  return u;
}

void check_encoder(const Decoder& d) {
  if (!d.refused_by.empty())
    fail("stream made by " + d.refused_by +
         ": its decoder IDCT/workarounds are not repeated");
  if (d.xvid_tag && !d.lavc)
    fail("an Xvid (fourcc) stream without libavcodec user data: "
         "libavcodec decodes it with Xvid's IDCT, which is not repeated");
  if (d.divx_tag && !d.lavc && d.vol.vo_type == 0 && !d.vol.vol_control)
    fail("a DivX 4 (fourcc) stream: libavcodec's DivX workarounds are not "
         "repeated");
}

// Decodes the start-code units of one chunk (`pictures`: also decode
// VOPs); returns the number of pictures (0 or 1).
int decode_units(Decoder& d, const uint8_t* data, size_t n, bool pictures) {
  int vops = 0, got = 0;
  auto us = units(data, n);
  if (us.empty() && n >= 3) {
    // 22 bits 0000 0000 0000 0000 1000 00: an H.263 picture start
    if (data[0] == 0 && data[1] == 0 && (data[2] & 0xFC) == 0x80)
      refuse("short_video_header (H.263 baseline)");
    fail("no MPEG-4 start code in the chunk");
  }
  for (auto& u : us) {
    uint8_t code = data[u.first];
    const uint8_t* body = data + u.first + 1;
    size_t len = u.second - u.first - 1;
    if (code >= 0x20 && code <= 0x2F) {
      BitReader br(body, len);
      parse_vol(d, br);
    } else if (code == 0xB2) {
      parse_user_data(d, body, len);
    } else if (code == 0xB6) {
      if (!pictures) break;
      if (++vops > 1) fail("more than one VOP in one chunk (packed bitstream)");
      check_encoder(d);
      BitReader br(body, len);
      got += decode_vop(d, br);
    } else if (code >= 0x40 && code <= 0x5F) {
      fail("scalable/still texture object start code");
    }
    // 0x00-0x1F video object, 0xB0/0xB1 visual object sequence, 0xB3
    // group of VOP, 0xB5 visual object: nothing to read
  }
  return got;
}

void copy_out(Decoder& d, uint8_t* y, uint8_t* u, uint8_t* v) {
  int w = d.vol.width, h = d.vol.height;
  int cw = (w + 1) / 2, ch = (h + 1) / 2;
  const Picture& p = d.ref;
  for (int r = 0; r < h; ++r)
    std::memcpy(y + size_t(r) * w, p.p[0].px.data() + size_t(r) * p.p[0].w, w);
  for (int r = 0; r < ch; ++r) {
    std::memcpy(u + size_t(r) * cw, p.p[1].px.data() + size_t(r) * p.p[1].w, cw);
    std::memcpy(v + size_t(r) * cw, p.p[2].px.data() + size_t(r) * p.p[2].w, cw);
  }
}

void set_err(char* err, int len, const std::string& msg) {
  if (!err || len <= 0) return;
  std::snprintf(err, len, "%s", msg.c_str());
}

}  // namespace

extern "C" {

void* mvsf_m4v_dec_new(int xvid_tag, int divx_tag) {
  Decoder* d = new Decoder();
  d->xvid_tag = xvid_tag != 0;
  d->divx_tag = divx_tag != 0;
  return d;
}

void mvsf_m4v_dec_free(void* h) { delete static_cast<Decoder*>(h); }

// Reads the start-code units of a decoder configuration (the VOS/VO/VOL
// headers of an MP4 esds, or of an AVI's first chunk) without decoding
// pictures.  Returns 0, or -1 with a message.
int mvsf_m4v_dec_config(void* h, const uint8_t* data, int64_t n, char* err,
                        int errlen) {
  Decoder& d = *static_cast<Decoder*>(h);
  try {
    decode_units(d, data, size_t(n), false);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return -1;
  }
}

// Width and height of the VOL read so far (0 before one).
void mvsf_m4v_dec_size(void* h, int* w, int* hh) {
  Decoder& d = *static_cast<Decoder*>(h);
  *w = d.vol.have ? d.vol.width : 0;
  *hh = d.vol.have ? d.vol.height : 0;
}

// Decodes one chunk/sample.  Returns 1 with the picture's cropped
// planes in y (w*h), u and v (((w+1)/2)*((h+1)/2) each), 0 when the
// chunk gave no picture (vop_coded = 0, or headers only), -1 with a
// message.
int mvsf_m4v_decode(void* h, const uint8_t* data, int64_t n, uint8_t* y,
                    uint8_t* u, uint8_t* v, char* err, int errlen) {
  Decoder& d = *static_cast<Decoder*>(h);
  try {
    int got = decode_units(d, data, size_t(n), true);
    if (got) copy_out(d, y, u, v);
    return got;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return -1;
  }
}

// At the end of the stream: libavcodec gives the last picture once more
// when the last VOP was not coded.  Returns 1 with the planes, or 0.
int mvsf_m4v_flush(void* h, uint8_t* y, uint8_t* u, uint8_t* v) {
  Decoder& d = *static_cast<Decoder*>(h);
  if (!d.last_not_coded || !d.have_ref) return 0;
  d.last_not_coded = false;
  copy_out(d, y, u, v);
  return 1;
}
// 4:2:0 planes (rows w, (w+1)/2 and (w+1)/2 bytes) to BGR (h, w, 3), as
// swscale converts MPEG-4's left-sited chroma (`yuv420_bgr.h`).
void mvsf_yuv420_to_bgr(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                        int w, int h, uint8_t* bgr) {
  yuvbgr::yuv420_to_bgr(y, u, v, w, h, yuvbgr::kChromaLeft, yuvbgr::bt601(), bgr);
}

}  // extern "C"
