"""Seeded random-syntax H.264 streams for the port's H.264 tests.

    from tools.h264_streams import Spec, write_stream, annexb, write_mp4
    aus = write_stream(Spec(width=50, height=38, cabac=True, seed=3))
    write_mp4("clip.mp4", aus, 49, 37)   # a container may crop further

A writer of syntax, not an encoder: it makes no picture and searches no
motion.  Every choice is drawn from a seeded `random.Random` within what
the standard allows, so the stream conforms and any conforming decoder
(libavcodec through `cv2.VideoCapture`, and the port's) must decode it
to the same pictures, bit for bit:

* SPS/PPS (profile 66, 77 or 100 by the tools used), I and P slices,
  several slices a picture, POC types 0-2, non-reference pictures,
  frame_num gaps, IDR pictures with long_term_reference_flag;
* I_NxN (4x4, 8x8), I_16x16, I_PCM, P_L0 16x16/16x8/8x16/8x8/8x8ref0
  with every sub-partition, P_Skip; intra modes only where their
  neighbours are available (constrained_intra_pred_flag honoured);
  small motion vector differences; random residuals whose scaled
  coefficients stay within the 16-bit range conformance asks;
* CAVLC and CABAC (the context increments from the neighbouring syntax
  elements, as the decoder derives them);
* flat and custom scaling lists (SPS and PPS, fall-back rules A and B),
  explicit weighted prediction, several references with list
  modification and memory management operations 1-4 and 6, deblocking
  idc 0-2 with offsets, chroma QP offsets, cropping (odd sizes).

The tables come from `mvsmplfitting_tpu_torch/csrc/h264_common.h`, read
by name.  `annexb`, `write_mp4` (`avc1`/`avc3`, NAL length 1, 2 or 4)
and `write_avi` wrap a stream's access units.
"""

from __future__ import annotations

import os
import random
import re
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(ROOT, "mvsmplfitting_tpu_torch", "csrc", "h264_common.h")


def _read_tables() -> Dict[str, List[int]]:
    text = open(HEADER).read()
    out = {}
    for m in re.finditer(r"const \w+ (k\w+)(\[[^=]*)=\s*\{(.*?)\};", text, re.S):
        out[m.group(1)] = [int(v) for v in re.findall(r"-?\d+", m.group(3))]
    return out


T = _read_tables()
ZZ4 = T["kZigzag4x4"]
ZZ8 = T["kZigzag8x8"]
CHROMA_QP = T["kChromaQp"]
BLK_RASTER = [0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15]
RASTER_BLK = [BLK_RASTER.index(i) for i in range(16)]
LPS = [T["kRangeTabLps"][4 * i:4 * i + 4] for i in range(64)]
TRANS_LPS = T["kTransIdxLps"]


def b8_of(r: int) -> int:
    return ((r >> 3) << 1) | ((r & 3) >> 1)


# ------------------------------------------------------------ bits

class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def u(self, k: int, v: int) -> None:
        for i in range(k - 1, -1, -1):
            self.bit((v >> i) & 1)

    def bit(self, b: int) -> None:
        self.acc = (self.acc << 1) | b
        self.n += 1
        if self.n == 8:
            self.out.append(self.acc)
            self.acc = self.n = 0

    def ue(self, v: int) -> None:
        v += 1
        k = v.bit_length()
        self.u(k - 1, 0)
        self.u(k, v)

    def se(self, v: int) -> None:
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def align_zero(self) -> None:
        while self.n:
            self.bit(0)

    def trailing(self) -> None:
        self.bit(1)
        self.align_zero()

    @property
    def aligned(self) -> bool:
        return self.n == 0


class CabacEncoder:
    """9.3.4.2: the arithmetic encoder writing into a BitWriter."""

    def __init__(self, bw: BitWriter):
        self.bw = bw
        self.low, self.range, self.outstanding, self.first = 0, 510, 0, True
        self.state = [0] * 460
        self.mps = [0] * 460

    def init_contexts(self, qp: int, table: int) -> None:
        init = T["kCabacInit"]
        qp = min(max(qp, 0), 51)
        for i in range(460):
            m, n = init[(table * 460 + i) * 2], init[(table * 460 + i) * 2 + 1]
            pre = min(max(((m * qp) >> 4) + n, 1), 126)
            if pre <= 63:
                self.state[i], self.mps[i] = 63 - pre, 0
            else:
                self.state[i], self.mps[i] = pre - 64, 1

    def reset_engine(self) -> None:
        self.low, self.range, self.outstanding, self.first = 0, 510, 0, True

    def _put(self, b: int) -> None:
        if self.first:
            self.first = False
        else:
            self.bw.bit(b)
        while self.outstanding:
            self.bw.bit(1 - b)
            self.outstanding -= 1

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx: int, b: int) -> None:
        s = self.state[ctx]
        lps = LPS[s][(self.range >> 6) & 3]
        self.range -= lps
        if b != self.mps[ctx]:
            self.low += self.range
            self.range = lps
            if s == 0:
                self.mps[ctx] = 1 - self.mps[ctx]
            self.state[ctx] = TRANS_LPS[s]
        elif s < 62:
            self.state[ctx] = s + 1
        self._renorm()

    def bypass(self, b: int) -> None:
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def terminate(self, b: int) -> None:
        self.range -= 2
        if b:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._put((self.low >> 9) & 1)
            self.bw.u(2, ((self.low >> 7) & 3) | 1)
        else:
            self._renorm()


def nal(nal_type: int, ref_idc: int, rbsp: bytes) -> bytes:
    """A NAL unit (header and emulation prevention), without start code."""
    out = bytearray([(ref_idc << 5) | nal_type])
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


# ------------------------------------------------------------ the spec

@dataclass
class Spec:
    """What a stream may use; `seed` draws everything else."""
    width: int = 64
    height: int = 48
    frames: int = 5
    seed: int = 0
    cabac: bool = False
    t8: bool = False               # transform_8x8_mode_flag
    scaling: str = ""              # "", "sps", "pps", "both"
    weighted: bool = False
    refs: int = 1                  # max_num_ref_frames
    num_ref_active: int = 1        # num_ref_idx_l0_active (per slice, <=)
    modification: bool = False     # ref_pic_list_modification
    mmco: bool = False             # adaptive marking (ops 1-4, 6)
    mmco5: bool = False            # with op 5 (every reference dropped) too
    long_term_idr: bool = False    # long_term_reference_flag on IDRs
    dbk_idc: Tuple[int, ...] = (0,)
    dbk_offsets: bool = False
    slices: int = 1                # slices a picture (at most)
    poc_type: int = 0
    nonref: bool = False           # some P pictures with nal_ref_idc 0
    gaps: bool = False             # frame_num gaps
    pcm: bool = False
    constrained_intra: bool = False
    chroma_offsets: bool = False
    crop_left: int = 0             # luma columns cropped on the left (even)
    crop_top: int = 0              # luma rows cropped on the top (even)
    chroma_loc: int = -1           # VUI chroma_sample_loc_type, -1 none
    colour: Tuple[int, ...] = ()   # VUI (video_full_range_flag, matrix)
    reorder: int = -1              # VUI max_num_reorder_frames, -1 none
    qp: Tuple[int, int] = (18, 36)
    intra_p: float = 0.15          # intra macroblocks in P slices
    skip_p: float = 0.25           # P_Skip
    coded_p: float = 0.6           # a coded residual block
    i_nonidr: bool = False         # some I pictures that are not IDR
    idr_every: int = 0             # an IDR every n pictures (0: first only)
    light: bool = False            # mostly skipped, sparse residuals (1080p)
    # deviations for refusal tests, (name, value): profile, frame_mbs_only,
    # chroma_format_idc, bit_depth, bypass, separate_planes, slice_groups,
    # slice_type (of the P slices from picture 1 on), redundant (picture 1
    # redundant), poc_swap (picture 2 before picture 1 in output order)
    tamper: Tuple[Tuple[str, int], ...] = ()

    def __post_init__(self):
        # 4:2:0 frame cropping works in units of 2 samples: an odd size
        # comes only from a container that declares it (MP4, AVI)
        if self.width % 2 or self.height % 2:
            raise ValueError(f"H.264 4:2:0 sizes are even, not "
                             f"{self.width}x{self.height}")

    @property
    def mbw(self) -> int:
        return (self.width + self.crop_left + 15) // 16

    @property
    def mbh(self) -> int:
        return (self.height + self.crop_top + 15) // 16

    @property
    def profile(self) -> int:
        if self.t8 or self.scaling:
            return 100
        if self.cabac or self.weighted:
            return 77
        return 66


# ------------------------------------------------------------ scaling

NORM4 = T["kNormAdjust4x4"]
NORM8 = T["kNormAdjust8x8"]


def level_scales(w4: List[List[int]], w8: List[List[int]]):
    """LevelScale4x4[list][m][raster] and LevelScale8x8 (8.5.9)."""
    ls4 = [[[0] * 16 for _ in range(6)] for _ in range(6)]
    ls8 = [[[0] * 64 for _ in range(6)] for _ in range(2)]
    for m in range(6):
        for k in range(16):
            r = ZZ4[k]
            i, j = r >> 2, r & 3
            v = NORM4[3 * m + (0 if i % 2 == 0 and j % 2 == 0 else
                               1 if i % 2 and j % 2 else 2)]
            for lst in range(6):
                ls4[lst][m][r] = w4[lst][k] * v
        for k in range(64):
            r = ZZ8[k]
            i, j = r >> 3, r & 7
            if i % 4 == 0 and j % 4 == 0:
                c = 0
            elif i % 2 == 1 and j % 2 == 1:
                c = 1
            elif i % 4 == 2 and j % 4 == 2:
                c = 2
            elif (i % 4 == 0 and j % 2 == 1) or (i % 2 == 1 and j % 4 == 0):
                c = 3
            elif (i % 4 == 0 and j % 4 == 2) or (i % 4 == 2 and j % 4 == 0):
                c = 4
            else:
                c = 5
            for lst in range(2):
                ls8[lst][m][r] = w8[lst][k] * NORM8[6 * m + c]
    return ls4, ls8


def dq4(c: int, ls: int, qp: int) -> int:
    if qp >= 24:
        return (c * ls) << (qp // 6 - 4)
    return (c * ls + (1 << (3 - qp // 6))) >> (4 - qp // 6)


def dq8(c: int, ls: int, qp: int) -> int:
    if qp >= 36:
        return (c * ls) << (qp // 6 - 6)
    return (c * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)


# ------------------------------------------------------------ macroblocks

class Mb:
    __slots__ = ("slice", "kind", "t8", "cbp", "chroma_mode", "ipm", "tc",
                 "tcc", "dc_cbf", "ref", "mvd")

    def __init__(self):
        self.slice = -1


INTRA = ("I4", "I8", "I16", "PCM")

# the limits of the scaled coefficients of one block (16-bit conformance
# with margin for each transform's growth)
SUM4, SUM8, DC_MAX = 9000, 6000, 3000


class Writer:
    def __init__(self, spec: Spec):
        self.s = spec
        self.rng = random.Random(spec.seed)
        r = self.rng
        self.mbw, self.mbh = spec.mbw, spec.mbh
        self.log2_max_fn = 4 + (r.randint(0, 4) if not spec.gaps else 2)
        self.log2_max_lsb = 4 + r.randint(1, 4)
        self.poc_lsb_step = r.choice((2, 2, 4))
        self.cb_off = r.randint(-6, 6) if spec.chroma_offsets else 0
        self.cr_off = r.randint(-6, 6) if spec.chroma_offsets else 0
        if spec.profile < 100:
            self.cr_off = self.cb_off
        self.pic_init_qp = r.randint(*spec.qp)
        self.bottom_present = r.random() < 0.5
        # POC type 1 cycle
        self.cycle = [r.choice((2, 2, 4)) for _ in range(r.randint(1, 3))]
        self.non_ref_offset = 1
        self.last_nonref = False
        self._scaling_lists()
        self.mbs = [Mb() for _ in range(self.mbw * self.mbh)]
        # DPB model: dicts with frame_num, long (idx or None), exists
        self.refs: List[dict] = []
        self.max_long = -1
        self.prev_ref_fn = 0
        self.frame_num = 0
        self.poc = 0

    # -- parameter sets

    def _scaling_lists(self) -> None:
        r, s = self.rng, self.s
        flat4 = [[16] * 16 for _ in range(6)]
        flat8 = [[16] * 64 for _ in range(2)]
        d4 = [T["kDefault4x4"][:16], T["kDefault4x4"][16:]]
        d8 = [T["kDefault8x8"][:64], T["kDefault8x8"][64:]]

        def draw(n):  # a list and its syntax: (present, use_default, values)
            k = r.random()
            if k < 0.25:
                return (False, False, None)
            if k < 0.4:
                return (True, True, None)
            return (True, False, [r.randint(4, 40) for _ in range(n)])

        self.sps_lists = self.pps_lists = None
        w4, w8 = flat4, flat8
        if s.scaling in ("sps", "both"):
            self.sps_lists = [draw(16) for _ in range(6)] + [draw(64) for _ in range(2)]
            w4, w8 = [], []
            for i in range(8):
                present, default, vals = self.sps_lists[i]
                if i < 6:
                    fb = d4[0 if i < 3 else 1] if i in (0, 3) else w4[i - 1]
                    w4.append(d4[0 if i < 3 else 1] if default else vals if present else fb)
                else:
                    w8.append(d8[i - 6] if default or not present else vals)
        sps4, sps8 = w4, w8
        if s.scaling in ("pps", "both"):
            n = 6 + (2 if s.t8 else 0)
            self.pps_lists = [draw(16) for _ in range(6)] + [draw(64) for _ in range(n - 6)]
            seq = self.sps_lists is not None
            p4, p8 = [], list(sps8)
            for i in range(n):
                present, default, vals = self.pps_lists[i]
                if i < 6:
                    if i in (0, 3):
                        fb = sps4[i] if seq else d4[0 if i < 3 else 1]
                    else:
                        fb = p4[i - 1]
                    p4.append(d4[0 if i < 3 else 1] if default else vals if present else fb)
                else:
                    fb = sps8[i - 6] if seq else d8[i - 6]
                    p8[i - 6] = d8[i - 6] if default else vals if present else fb
            w4, w8 = p4, p8
        self.ls4, self.ls8 = level_scales(w4, w8)

    def _lists(self, bw: BitWriter, lists) -> None:
        for present, default, vals in lists:
            bw.bit(int(present))
            if not present:
                continue
            if default:
                bw.se(-8)  # next = 0 at j = 0: use the default
                continue
            last = 8
            for v in vals:
                delta = (v - last + 128) % 256 - 128
                bw.se(delta)
                last = v

    def sps(self) -> bytes:
        s, r = self.s, self.rng
        t = dict(s.tamper)
        profile = t.get("profile", s.profile)
        bw = BitWriter()
        bw.u(8, profile)
        bw.u(8, 0)
        bw.u(8, 40)
        bw.ue(0)
        if profile in (100, 110, 122, 244):
            cf = t.get("chroma_format_idc", 1)
            bw.ue(cf)
            if cf == 3:
                bw.bit(t.get("separate_planes", 0))
            bw.ue(t.get("bit_depth", 8) - 8)
            bw.ue(t.get("bit_depth", 8) - 8)
            bw.bit(t.get("bypass", 0))
            bw.bit(int(self.sps_lists is not None))
            if self.sps_lists is not None:
                self._lists(bw, self.sps_lists)
        bw.ue(self.log2_max_fn - 4)
        bw.ue(s.poc_type)
        if s.poc_type == 0:
            bw.ue(self.log2_max_lsb - 4)
        elif s.poc_type == 1:
            bw.bit(0)     # delta_pic_order_always_zero_flag
            bw.se(self.non_ref_offset)
            bw.se(0)
            bw.ue(len(self.cycle))
            for c in self.cycle:
                bw.se(c)
        bw.ue(s.refs)
        bw.bit(int(s.gaps))
        bw.ue(self.mbw - 1)
        bw.ue(self.mbh - 1)
        bw.bit(t.get("frame_mbs_only", 1))
        if not t.get("frame_mbs_only", 1):
            bw.bit(1)     # mb_adaptive_frame_field_flag
        bw.bit(1)         # direct_8x8_inference_flag
        cr = 16 * self.mbw - s.width - s.crop_left
        cb = 16 * self.mbh - s.height - s.crop_top
        crop = cr or cb or s.crop_left or s.crop_top
        bw.bit(int(bool(crop)))
        if crop:
            bw.ue(s.crop_left // 2)
            bw.ue(cr // 2)
            bw.ue(s.crop_top // 2)
            bw.ue(cb // 2)
        vui = s.chroma_loc >= 0 or bool(s.colour) or s.reorder >= 0
        bw.bit(int(vui))
        if vui:
            bw.bit(0)     # aspect ratio
            bw.bit(0)     # overscan
            bw.bit(int(bool(s.colour)))  # video signal type
            if s.colour:
                bw.u(3, 5)
                bw.bit(s.colour[0])
                bw.bit(1)
                bw.u(8, s.colour[1])
                bw.u(8, s.colour[1])
                bw.u(8, s.colour[1])
            bw.bit(int(s.chroma_loc >= 0))  # chroma_loc_info_present_flag
            if s.chroma_loc >= 0:
                bw.ue(s.chroma_loc)
                bw.ue(s.chroma_loc)
            bw.bit(0)     # timing
            bw.bit(0)
            bw.bit(0)     # hrd
            bw.bit(0)     # pic_struct
            bw.bit(int(s.reorder >= 0))  # bitstream_restriction_flag
            if s.reorder >= 0:
                bw.bit(1)
                bw.ue(2)
                bw.ue(1)
                bw.ue(16)
                bw.ue(16)
                bw.ue(s.reorder)
                bw.ue(max(s.reorder, s.refs))
        bw.trailing()
        return nal(7, 3, bytes(bw.out))

    def pps(self) -> bytes:
        s = self.s
        bw = BitWriter()
        bw.ue(0)
        bw.ue(0)
        bw.bit(int(s.cabac))
        bw.bit(int(self.bottom_present))
        t = dict(s.tamper)
        bw.ue(t.get("slice_groups", 0))
        if t.get("slice_groups", 0):
            bw.ue(0)                 # slice_group_map_type: interleaved
            for _ in range(t["slice_groups"] + 1):
                bw.ue(0)
        bw.ue(s.num_ref_active - 1)
        bw.ue(0)
        bw.bit(int(s.weighted))
        bw.u(2, 0)
        bw.se(self.pic_init_qp - 26)
        bw.se(0)
        bw.se(self.cb_off)
        bw.bit(1)                    # deblocking_filter_control_present_flag
        bw.bit(int(s.constrained_intra))
        bw.bit(int("redundant" in t))
        if s.profile == 100:
            bw.bit(int(s.t8))
            bw.bit(int(self.pps_lists is not None))
            if self.pps_lists is not None:
                self._lists(bw, self.pps_lists)
            bw.se(self.cr_off)
        bw.trailing()
        return nal(8, 3, bytes(bw.out))

    # -- reference lists

    def _wrap(self, f: dict) -> int:
        return f["fn"] - (1 << self.log2_max_fn) if f["fn"] > self.frame_num else f["fn"]

    def _sliding(self) -> None:
        shorts = [f for f in self.refs if f["long"] is None]
        if shorts and len(self.refs) >= max(self.s.refs, 1):
            old = min(shorts, key=self._wrap)
            self.refs.remove(old)

    def _list0(self, num: int, mods) -> List[Optional[dict]]:
        shorts = sorted((f for f in self.refs if f["long"] is None),
                        key=self._wrap, reverse=True)
        longs = sorted((f for f in self.refs if f["long"] is not None),
                       key=lambda f: f["long"])
        lst = (shorts + longs + [None] * num)[:num]
        idx = 0
        for pic in mods:
            lst.insert(idx, pic)
            idx += 1
            lst = lst[:idx] + [f for f in lst[idx:] if f is not pic]
            lst = (lst + [None] * num)[:num]
        return lst

    # -- one picture

    def picture(self, i: int) -> List[bytes]:
        s, r = self.s, self.rng
        max_fn = 1 << self.log2_max_fn
        idr = i == 0 or (s.idr_every and i % s.idr_every == 0)
        ptype = "I" if idr or (s.i_nonidr and r.random() < 0.2) else "P"
        after_nonref = self.last_nonref
        nonref = s.nonref and not after_nonref and r.random() < 0.3
        ref_idc = 3 if idr else (0 if nonref else r.choice((1, 2, 3)))
        self.last_nonref = ref_idc == 0
        if idr:
            self.refs = []
            self.max_long = -1
            self.frame_num = 0
            self.prev_ref_fn = 0
            self.poc = 0
        else:
            fn = (self.prev_ref_fn + 1) % max_fn
            # libavcodec counts a gap from the previous picture, the
            # standard from the previous reference one: they agree unless
            # the previous picture is not a reference
            if s.gaps and not after_nonref and r.random() < 0.3:
                gap = r.randint(1, 2)
                for k in range(gap):
                    self.frame_num = fn
                    self._sliding()
                    self.refs.append({"fn": fn, "long": None, "exists": False})
                    self.prev_ref_fn = fn
                    fn = (fn + 1) % max_fn
            self.frame_num = fn
        if not idr and ptype == "P" and not any(f["exists"] for f in self.refs):
            ptype = "I"
        # POC fields (rising in decoding order)
        self.poc_fields = {}
        self.index = i
        if s.poc_type == 0:
            lsb = 0 if idr else (self.poc + self.poc_lsb_step) % (1 << self.log2_max_lsb)
            if dict(s.tamper).get("poc_swap") and i == 2:
                lsb = (self.poc - 1) % (1 << self.log2_max_lsb)
            self.poc_fields["lsb"] = lsb
            self.poc = lsb
            self.poc_fields["delta_bottom"] = r.randint(0, 2) if self.bottom_present else 0
        elif s.poc_type == 1:
            self.poc_fields["delta"] = [0, r.randint(0, 1) if self.bottom_present else 0]
        # the reference list and marking of this picture
        num_ref = 1
        mods: List[dict] = []
        if ptype == "P":
            avail = [f for f in self.refs if f["exists"]]
            num_ref = r.randint(1, max(1, min(s.num_ref_active, len(self.refs))))
            if s.modification and r.random() < 0.7:
                pred = self.frame_num
                for _ in range(r.randint(1, num_ref)):
                    pic = r.choice(avail)
                    if pic["long"] is None:
                        num = self._wrap(pic)
                        target = num + max_fn if num < 0 else num
                        if target == pred:  # abs_diff_pic_num cannot be -1
                            continue
                        pred = target
                    mods.append(pic)
            lst = self._list0(num_ref, mods)
            if not any(f is not None and f["exists"] for f in lst):
                mods = [r.choice(avail)]
                lst = self._list0(num_ref, mods)
            self.list0 = lst
        marking = self._marking(idr, ref_idc)
        # slices
        total = self.mbw * self.mbh
        n = r.randint(1, min(s.slices, total))
        cuts = sorted(r.sample(range(1, total), n - 1)) if n > 1 else []
        bounds = [0] + cuts + [total]
        for m in self.mbs:
            m.slice = -1
        out = []
        for k in range(n):
            out.append(self._slice(k, bounds[k], bounds[k + 1], idr, ptype,
                                   ref_idc, num_ref, mods, marking))
        self._apply_marking(idr, ref_idc, marking)
        return out

    def _marking(self, idr: bool, ref_idc: int):
        s, r = self.s, self.rng
        if not ref_idc:
            return None
        if idr:
            return {"long": s.long_term_idr and r.random() < 0.5}
        if not s.mmco or r.random() < 0.4:
            return {"ops": None}
        ops = []
        shorts = [f for f in self.refs if f["long"] is None]
        longs = [f for f in self.refs if f["long"] is not None]
        kind = r.choice((1, 2, 3, 4, 6) + ((5, 5) if s.mmco5 else ()))
        if kind == 5:
            return {"ops": [(5,)]}
        if kind == 4:
            ops.append((4, r.randint(1, 2)))
        elif kind == 1 and shorts:
            f = r.choice(shorts)
            ops.append((1, self.frame_num - self._wrap(f) - 1, f))
        elif kind == 2 and longs:
            f = r.choice(longs)
            ops.append((2, f["long"], f))
        elif kind == 3 and shorts and self.max_long >= 0:
            f = r.choice(shorts)
            ops.append((3, self.frame_num - self._wrap(f) - 1, f, r.randint(0, self.max_long)))
        elif kind == 6 and self.max_long >= 0:
            ops.append((6, r.randint(0, self.max_long)))
        # keep the DPB within max_num_ref_frames: free a short if needed
        after = list(self.refs)
        for op in ops:
            if op[0] in (1, 2):
                after.remove(op[2])
            if op[0] == 4:
                after = [f for f in after if f["long"] is None or f["long"] < op[1]]
            if op[0] == 3:
                after = [f for f in after if f["long"] != op[3]]
            if op[0] == 6:
                after = [f for f in after if f["long"] != op[1]]
        while len(after) + 1 > max(s.refs, 1):
            cand = [f for f in after if f["long"] is None and all(
                len(op) < 3 or op[2] is not f for op in ops)]
            if not cand:
                cand = [f for f in after if f["long"] is not None and all(
                    len(op) < 3 or op[2] is not f for op in ops)]
                if not cand:
                    return {"ops": None}
                f = r.choice(cand)
                ops.append((2, f["long"], f))
            else:
                f = r.choice(cand)
                ops.append((1, self.frame_num - self._wrap(f) - 1, f))
            after.remove(f)
        return {"ops": ops}

    def _apply_marking(self, idr: bool, ref_idc: int, marking) -> None:
        if not ref_idc:
            return
        cur = {"fn": self.frame_num, "long": None, "exists": True}
        if idr:
            if marking["long"]:
                cur["long"] = 0
                self.max_long = 0
            else:
                self.max_long = -1
        elif marking["ops"] is None:
            self._sliding()
        else:
            for op in marking["ops"]:
                if op[0] == 1:
                    self.refs.remove(op[2])
                elif op[0] == 2:
                    self.refs.remove(op[2])
                elif op[0] == 3:
                    self.refs = [f for f in self.refs if f["long"] != op[3] or f is op[2]]
                    op[2]["long"] = op[3]
                elif op[0] == 4:
                    self.max_long = op[1] - 1
                    self.refs = [f for f in self.refs
                                 if f["long"] is None or f["long"] <= self.max_long]
                elif op[0] == 5:
                    # the picture counts as frame_num 0 and POC 0 after it
                    self.refs = []
                    self.max_long = -1
                    cur["fn"] = self.frame_num = 0
                    self.poc = 0
                elif op[0] == 6:
                    self.refs = [f for f in self.refs if f["long"] != op[1]]
                    cur["long"] = op[1]
        self.refs.append(cur)
        self.prev_ref_fn = self.frame_num
        assert len(self.refs) <= max(self.s.refs, 1)

    def _slice(self, k, first, end, idr, ptype, ref_idc, num_ref, mods, marking) -> bytes:
        s, r = self.s, self.rng
        t = dict(s.tamper)
        bw = BitWriter()
        bw.ue(first)
        stype = 0 if ptype == "P" else 2
        if ptype == "P" and "slice_type" in t:
            stype = t["slice_type"]
        bw.ue(stype + (5 if r.random() < 0.5 else 0))
        bw.ue(0)
        bw.u(self.log2_max_fn, self.frame_num)
        if idr:
            bw.ue(0)
        if s.poc_type == 0:
            bw.u(self.log2_max_lsb, self.poc_fields["lsb"])
            if self.bottom_present:
                bw.se(self.poc_fields["delta_bottom"])
        elif s.poc_type == 1:
            bw.se(self.poc_fields["delta"][0])
            if self.bottom_present:
                bw.se(self.poc_fields["delta"][1])
        if "redundant" in t:
            bw.ue(t["redundant"] if self.index == 1 else 0)
        if ptype == "P":
            override = num_ref != s.num_ref_active
            bw.bit(int(override))
            if override:
                bw.ue(num_ref - 1)
            bw.bit(int(bool(mods)))
            if mods:
                pred = self.frame_num
                max_pic = 1 << self.log2_max_fn
                for pic in mods:
                    if pic["long"] is not None:
                        bw.ue(2)
                        bw.ue(pic["long"])
                        continue
                    num = self._wrap(pic)
                    target = num + max_pic if num < 0 else num
                    if target < pred:
                        bw.ue(0)
                        bw.ue(pred - target - 1)
                    else:
                        bw.ue(1)
                        bw.ue(target - pred - 1)
                    pred = target
                bw.ue(3)
            if s.weighted:
                ld, cd = r.randint(0, 7), r.randint(0, 7)
                bw.ue(ld)
                bw.ue(cd)
                for _ in range(num_ref):
                    for denom, reps in ((ld, 1), (cd, 2)):
                        flag = r.random() < 0.6
                        bw.bit(int(flag))
                        for _ in range(reps if flag else 0):
                            wt = (1 << denom) + r.randint(-20, 20) if r.random() < 0.7 \
                                else r.randint(-128, 127)
                            bw.se(min(max(wt, -128), 127))
                            bw.se(r.randint(-20, 20))
        if ref_idc:
            if idr:
                bw.bit(0)
                bw.bit(int(marking["long"]))
            else:
                ops = marking["ops"]
                bw.bit(int(ops is not None))
                if ops is not None:
                    for op in ops:
                        bw.ue(op[0])
                        if op[0] in (1, 3):
                            bw.ue(op[1])
                        if op[0] == 2:
                            bw.ue(op[1])
                        if op[0] == 3:
                            bw.ue(op[3])
                        if op[0] in (4, 6):
                            bw.ue(op[1])
                    bw.ue(0)
        cabac_idc = r.randint(0, 2)
        if s.cabac and ptype == "P":
            bw.ue(cabac_idc)
        qp = r.randint(*s.qp)
        bw.se(qp - self.pic_init_qp)
        idc = r.choice(s.dbk_idc)
        bw.ue(idc)
        if idc != 1:
            a = r.randint(-6, 6) if s.dbk_offsets else 0
            b = r.randint(-6, 6) if s.dbk_offsets else 0
            bw.se(a)
            bw.se(b)
        ctx = SliceCtx(self, bw, k, ptype == "P", qp, num_ref)
        if s.cabac:
            while not bw.aligned:
                bw.bit(1)
            ctx.cabac = CabacEncoder(bw)
            ctx.cabac.init_contexts(qp, 1 + cabac_idc if ptype == "P" else 0)
        ctx.data(first, end)
        return nal(5 if idr else 1, ref_idc, bytes(bw.out))


class SliceCtx:
    """The macroblocks of one slice: draws each, writes its syntax."""

    def __init__(self, w: Writer, bw: BitWriter, num: int, is_p: bool, qp: int,
                 num_ref: int):
        self.w, self.bw, self.num, self.is_p = w, bw, num, is_p
        self.s, self.r = w.s, w.rng
        self.qp, self.num_ref = qp, num_ref
        self.cabac: Optional[CabacEncoder] = None
        self.last_dqp = 0
        self.valid_refs = [k for k, f in enumerate(getattr(w, "list0", []) or [])
                           if f is not None and f["exists"]] if is_p else []

    # -- neighbours

    def mb_at(self, x: int, y: int) -> Optional[Mb]:
        if x < 0 or y < 0 or x >= self.w.mbw or y >= self.w.mbh:
            return None
        m = self.w.mbs[y * self.w.mbw + x]
        return m if m.slice == self.num else None

    def A(self):
        return self.mb_at(self.x - 1, self.y)

    def B(self):
        return self.mb_at(self.x, self.y - 1)

    def intra_nb(self, n):
        return n if n is not None and (not self.s.constrained_intra or n.kind in INTRA) else None

    def block_nb(self, x4: int, y4: int):
        if 0 <= x4 < 4 and 0 <= y4 < 4:
            return self.m, y4 * 4 + x4
        if y4 < 0:
            n = (self.mb_at(self.x - 1, self.y - 1) if x4 < 0 else
                 self.mb_at(self.x + 1, self.y - 1) if x4 > 3 else self.B())
        elif x4 < 0:
            n = self.A()
        else:
            n = None
        return n, ((y4 + 4) & 3) * 4 + ((x4 + 4) & 3)

    # -- the slice data

    def data(self, first: int, end: int) -> None:
        bw, cab = self.bw, self.cabac
        skip_run = 0
        for addr in range(first, end):
            self.x, self.y = addr % self.w.mbw, addr // self.w.mbw
            m = self.m = self.w.mbs[addr]
            self._init_mb()
            skip = self.is_p and self.valid_refs and self.r.random() < self.s.skip_p
            if skip and 0 not in self.valid_refs:
                skip = False
            if cab:
                if self.is_p:
                    a, b = self.A(), self.B()
                    inc = (a is not None and a.kind != "SKIP") + (b is not None and b.kind != "SKIP")
                    cab.decision(11 + inc, int(bool(skip)))
                if skip:
                    self._skip()
                else:
                    self._mb()
                cab.terminate(int(addr == end - 1))
            else:
                if skip:
                    skip_run += 1
                    self._skip()
                    continue
                if self.is_p:
                    bw.ue(skip_run)
                    skip_run = 0
                self._mb()
        if cab is None:
            if skip_run:
                bw.ue(skip_run)
            bw.trailing()
        else:
            bw.align_zero()

    def _init_mb(self) -> None:
        m = self.m
        m.slice = self.num
        m.kind, m.t8, m.cbp, m.chroma_mode, m.dc_cbf = "I4", False, 0, 0, 0
        m.ipm = [2] * 16
        m.tc = [0] * 16
        m.tcc = [[0] * 4, [0] * 4]
        m.ref = [-1] * 4
        m.mvd = [[0, 0] for _ in range(16)]

    def _skip(self) -> None:
        self.m.kind = "SKIP"
        self.m.ref = [0] * 4
        self.last_dqp = 0

    # -- one macroblock

    def _mb(self) -> None:
        s, r, m = self.s, self.r, self.m
        intra = not self.is_p or not self.valid_refs or r.random() < s.intra_p
        if intra:
            k = r.random()
            if s.pcm and k < 0.06:
                kind = "PCM"
            elif s.light or k < 0.4:
                kind = "I16"
            else:
                kind = "I8" if s.t8 and r.random() < 0.5 else "I4"
            self._intra(kind)
        else:
            self._inter()

    def _write_mb_type_intra(self, itype: int) -> None:
        """itype: 0 I_NxN, 1-24 I_16x16, 25 I_PCM."""
        if self.cabac is None:
            self.bw.ue(itype + (5 if self.is_p else 0))
            return
        c = self.cabac
        if self.is_p:
            c.decision(14, 1)
            base = 17
            c.decision(base, int(itype != 0))
        else:
            base = 3
            a, b = self.A(), self.B()
            inc = (a is not None and a.kind not in ("I4", "I8")) + \
                  (b is not None and b.kind not in ("I4", "I8"))
            c.decision(base + inc, int(itype != 0))
            base += 2
        if itype == 0:
            return
        isl = 0 if self.is_p else 1
        c.terminate(int(itype == 25))
        if itype == 25:
            return
        t = itype - 1
        c.decision(base + 1, int(t >= 12))
        cc = (t // 4) % 3
        c.decision(base + 2, int(cc != 0))
        if cc:
            c.decision(base + 2 + isl, int(cc == 2))
        c.decision(base + 3 + isl, (t % 4) >> 1)
        c.decision(base + 3 + 2 * isl, t & 1)

    def _avail_modes(self, n: int, x: int, y: int, A, B, C, D) -> List[int]:
        """Intra NxN modes (n = 4 or 8) of the block at (x, y) blocks."""
        if n == 4:
            has_l, has_t = x > 0 or A is not None, y > 0 or B is not None
            has_tl = True if x > 0 and y > 0 else (D if x == 0 and y == 0 else
                                                   A if x == 0 else B) is not None
        else:
            has_l, has_t = x > 0 or A is not None, y > 0 or B is not None
            b8 = y * 2 + x
            has_tl = True if b8 == 3 else (D, B, A)[b8] is not None
        modes = [2]
        if has_t:
            modes += [0, 3, 7]
        if has_l:
            modes += [1, 8]
        if has_t and has_l and has_tl:
            modes += [4, 5, 6]
        return modes

    def _intra(self, kind: str) -> None:
        s, r, m, bw, cab = self.s, self.r, self.m, self.bw, self.cabac
        m.kind = kind
        if kind == "PCM":
            self._write_mb_type_intra(25)
            if cab is None:
                bw.align_zero()
            else:
                bw.align_zero()
            base = r.randint(0, 255)
            for _ in range(384):
                bw.u(8, min(max(base + r.randint(-40, 40), 0), 255))
            if cab is not None:
                cab.reset_engine()
            m.cbp = 0x2F
            m.tc = [16] * 16
            m.tcc = [[16] * 4, [16] * 4]
            m.dc_cbf = 7
            self.last_dqp = 0
            return
        A = self.intra_nb(self.A())
        B = self.intra_nb(self.B())
        C = self.intra_nb(self.mb_at(self.x + 1, self.y - 1))
        D = self.intra_nb(self.mb_at(self.x - 1, self.y - 1))
        if kind == "I16":
            modes = [2]
            if B is not None:
                modes.append(0)
            if A is not None:
                modes.append(1)
            if A is not None and B is not None and D is not None:
                modes.append(3)
            mode = r.choice(modes)
            cbpl = 15 if (not s.light and r.random() < 0.5) else 0
            cbpc = r.choice((0, 1, 2)) if not s.light else r.choice((0, 0, 1))
            m.cbp = cbpl | (cbpc << 4)
            self._write_mb_type_intra(1 + mode + 4 * cbpc + (12 if cbpl else 0))
        else:
            self._write_mb_type_intra(0)
            if s.t8:
                m.t8 = kind == "I8"
                self._write_t8(m.t8)
            n = 4 if m.t8 else 16
            for k in range(n):
                rr = BLK_RASTER[4 * k] if m.t8 else BLK_RASTER[k]
                x4, y4 = rr & 3, rr >> 2
                if m.t8:
                    modes = self._avail_modes(8, x4 >> 1, y4 >> 1, A, B, C, D)
                else:
                    modes = self._avail_modes(4, x4, y4, A, B, C, D)
                mode = r.choice(modes)
                na, ia = self.block_nb(x4 - 1, y4)
                nb, ib = self.block_nb(x4, y4 - 1)
                cip = s.constrained_intra
                if na is None or nb is None or (cip and na.kind not in INTRA) or \
                        (cip and nb.kind not in INTRA):
                    pred = 2
                else:
                    ma = na.ipm[ia] if na.kind in ("I4", "I8") else 2
                    mb = nb.ipm[ib] if nb.kind in ("I4", "I8") else 2
                    pred = min(ma, mb)
                if mode == pred:
                    if cab is None:
                        bw.bit(1)
                    else:
                        cab.decision(68, 1)
                else:
                    rem = mode if mode < pred else mode - 1
                    if cab is None:
                        bw.bit(0)
                        bw.u(3, rem)
                    else:
                        cab.decision(68, 0)
                        for b in range(3):
                            cab.decision(69, (rem >> b) & 1)
                if m.t8:
                    for dy in range(2):
                        for dx in range(2):
                            m.ipm[(y4 + dy) * 4 + x4 + dx] = mode
                else:
                    m.ipm[rr] = mode
        # chroma prediction mode
        modes = [0]
        if A is not None:
            modes.append(1)
        if B is not None:
            modes.append(2)
        if A is not None and B is not None and D is not None:
            modes.append(3)
        m.chroma_mode = r.choice(modes)
        if cab is None:
            bw.ue(m.chroma_mode)
        else:
            def cond(n):
                return int(n is not None and n.kind in INTRA and n.kind != "PCM"
                           and n.chroma_mode != 0)
            cab.decision(64 + cond(self.A()) + cond(self.B()), int(m.chroma_mode > 0))
            if m.chroma_mode > 0:
                cab.decision(67, int(m.chroma_mode > 1))
                if m.chroma_mode > 1:
                    cab.decision(67, int(m.chroma_mode == 3))
        if kind != "I16":
            m.cbp = self._draw_cbp()
            self._write_cbp(True)
        self._qp_and_residual()

    def _draw_cbp(self) -> int:
        r, s = self.r, self.s
        if s.light:
            return (r.randint(0, 15) if r.random() < 0.2 else 0) | \
                (r.choice((0, 0, 1)) << 4)
        return r.randint(0, 15) | (r.randint(0, 2) << 4)

    def _write_t8(self, v: bool) -> None:
        if self.cabac is None:
            self.bw.bit(int(v))
            return
        a, b = self.A(), self.B()
        self.cabac.decision(399 + int(a is not None and a.t8) + int(b is not None and b.t8), int(v))

    def _write_cbp(self, intra: bool) -> None:
        m = self.m
        if self.cabac is None:
            table = T["kGolombToIntraCbp"] if intra else T["kGolombToInterCbp"]
            self.bw.ue(table.index(m.cbp & 15 | (m.cbp >> 4) << 4))
            return
        c = self.cabac
        luma = m.cbp & 15
        for b8 in range(4):
            def cond(dx, dy):
                x8, y8 = (b8 & 1) + dx, (b8 >> 1) + dy
                if x8 >= 0 and y8 >= 0:
                    return 0 if (luma >> (y8 * 2 + x8)) & 1 else 1
                n = self.A() if x8 < 0 else self.B()
                if n is None or n.kind == "PCM":
                    return 0
                if n.kind == "SKIP":
                    return 1
                nb8 = ((y8 + 2) & 1) * 2 + ((x8 + 2) & 1)
                return 0 if (n.cbp >> nb8) & 1 else 1
            c.decision(73 + cond(-1, 0) + 2 * cond(0, -1), (luma >> b8) & 1)

        def ccond(n, b):
            if n is None:
                return 0
            if n.kind == "PCM":
                return 1
            if n.kind == "SKIP":
                return 0
            cc = n.cbp >> 4
            return int(cc != 0) if b == 0 else int(cc == 2)
        cc = m.cbp >> 4
        c.decision(77 + ccond(self.A(), 0) + 2 * ccond(self.B(), 0), int(cc != 0))
        if cc:
            c.decision(81 + ccond(self.A(), 1) + 2 * ccond(self.B(), 1), int(cc == 2))

    def _inter(self) -> None:
        s, r, m, bw, cab = self.s, self.r, self.m, self.bw, self.cabac
        m.kind = "P"
        part = r.choice((0, 0, 1, 2, 3)) if not s.light else 0
        ref0 = part == 3 and cab is None and 0 in self.valid_refs and r.random() < 0.3
        sub = [0] * 4
        if part == 3:
            sub = [r.randint(0, 3) for _ in range(4)]
        # mb_type
        if cab is None:
            bw.ue(4 if ref0 else part)
        else:
            cab.decision(14, 0)
            if part in (0, 3):
                cab.decision(15, 0)
                cab.decision(16, int(part == 3))
            else:
                cab.decision(15, 1)
                cab.decision(17, int(part == 1))
        if part == 3:
            for k in range(4):
                if cab is None:
                    bw.ue(sub[k])
                else:
                    v = sub[k]
                    cab.decision(21, int(v == 0))
                    if v:
                        cab.decision(22, int(v != 1))
                        if v != 1:
                            cab.decision(23, int(v == 2))
        if part == 0:
            rparts, parts = [(0, 0, 4, 4)], [(0, 0, 4, 4)]
        elif part == 1:
            rparts = parts = [(0, 0, 4, 2), (0, 2, 4, 2)]
        elif part == 2:
            rparts = parts = [(0, 0, 2, 4), (2, 0, 2, 4)]
        else:
            rparts, parts = [], []
            for k in range(4):
                x, y = 2 * (k & 1), 2 * (k >> 1)
                rparts.append((x, y, 2, 2))
                parts += {0: [(x, y, 2, 2)],
                          1: [(x, y, 2, 1), (x, y + 1, 2, 1)],
                          2: [(x, y, 1, 2), (x + 1, y, 1, 2)],
                          3: [(x + (q & 1), y + (q >> 1), 1, 1) for q in range(4)]}[sub[k]]
        for (x4, y4, w4, h4) in rparts:
            ref = 0 if ref0 or 0 in self.valid_refs and (self.num_ref == 1 or r.random() < 0.4) \
                else r.choice(self.valid_refs)
            if self.num_ref > 1 and not ref0:
                if cab is None:
                    if self.num_ref == 2:
                        bw.bit(1 - ref)
                    else:
                        bw.ue(ref)
                else:
                    def cond(dx, dy):
                        n, idx = self.block_nb(x4 + dx, y4 + dy)
                        if n is None or n.kind == "SKIP" or n.kind in INTRA:
                            return 0
                        return int(n.ref[b8_of(idx)] > 0)
                    cab.decision(54 + cond(-1, 0) + 2 * cond(0, -1), int(ref > 0))
                    if ref > 0:
                        cab.decision(58, int(ref > 1))
                        for _ in range(ref - 2):
                            cab.decision(59, 1)
                        if ref > 1:
                            cab.decision(59, 0)
            for yy in range(y4, y4 + h4, 2):
                for xx in range(x4, x4 + w4, 2):
                    m.ref[(yy >> 1) * 2 + (xx >> 1)] = ref
        for (x4, y4, w4, h4) in parts:
            mvd = [self._draw_mvd(), self._draw_mvd()]
            for comp in range(2):
                if cab is None:
                    bw.se(mvd[comp])
                else:
                    self._cabac_mvd(x4, y4, comp, mvd[comp])
            for yy in range(y4, y4 + h4):
                for xx in range(x4, x4 + w4):
                    m.mvd[yy * 4 + xx] = [min(abs(mvd[0]), 255), min(abs(mvd[1]), 255)]
        small = part == 3 and any(sub)
        m.cbp = self._draw_cbp()
        self._write_cbp(False)
        if (m.cbp & 15) and s.t8 and not small:
            m.t8 = r.random() < 0.5
            self._write_t8(m.t8)
        self._qp_and_residual()

    def _draw_mvd(self) -> int:
        k = self.r.random()
        if k < 0.5:
            return self.r.randint(-2, 2)
        if k < 0.9:
            return self.r.randint(-8, 8)
        return self.r.randint(-40, 40)

    def _cabac_mvd(self, x4: int, y4: int, comp: int, v: int) -> None:
        c = self.cabac

        def absn(dx, dy):
            n, idx = self.block_nb(x4 + dx, y4 + dy)
            if n is None or n.kind == "SKIP" or n.kind in INTRA:
                return 0
            return n.mvd[idx][comp]
        base = 47 if comp else 40
        ssum = absn(-1, 0) + absn(0, -1)
        a = abs(v)
        c.decision(base + (0 if ssum < 3 else 2 if ssum > 32 else 1), int(a > 0))
        if a == 0:
            return
        k = 1
        while k < 9:
            c.decision(base + 3 + min(k - 1, 3), int(a > k))
            if a <= k:
                break
            k += 1
        if a >= 9:
            self._ueg(a - 9, 3)
        c.bypass(int(v < 0))

    def _ueg(self, v: int, k: int) -> None:
        c = self.cabac
        while v >= (1 << k):
            c.bypass(1)
            v -= 1 << k
            k += 1
        c.bypass(0)
        while k:
            k -= 1
            c.bypass((v >> k) & 1)

    # -- QP and residual

    def _qp_and_residual(self) -> None:
        m, r, s = self.m, self.r, self.s
        if not (m.cbp or m.kind == "I16"):
            self.last_dqp = 0
            return
        lo, hi = s.qp
        new = min(max(self.qp + r.randint(-4, 4), lo), hi) if r.random() < 0.5 else self.qp
        dqp = new - self.qp
        if r.random() < 0.05:  # a wrap across 0/51
            dqp = r.choice((-26, 25))
            new = (self.qp + dqp + 52) % 52
            if not lo <= new <= hi:
                dqp, new = 0, self.qp
        if self.cabac is None:
            self.bw.se(dqp)
        else:
            c = self.cabac
            k = 2 * dqp - 1 if dqp > 0 else -2 * dqp
            c.decision(60 + int(self.last_dqp != 0), int(k > 0))
            if k > 0:
                c.decision(62, int(k > 1))
                if k > 1:
                    for _ in range(k - 2):
                        c.decision(63, 1)
                    c.decision(63, 0)
        self.qp = new
        self.last_dqp = dqp
        self._residual()

    def _levels(self, n: int, scale, dc=None, needed=False) -> List[int]:
        """`n` coefficients (scan order) of a block whose scaled values
        `scale(k, level)` stay within the conformance range (at least one
        when `needed`)."""
        r, s = self.r, self.s
        out = [0] * n
        if not needed and r.random() > (0.3 if s.light else s.coded_p):
            return out
        count = r.randint(1, max(1, n // (4 if s.light else 2)))
        for k in r.sample(range(n), count):
            v = r.choice((1, 1, 1, 2, 3)) if r.random() < 0.85 else r.randint(4, 40)
            out[k] = v if r.random() < 0.5 else -v
        limit = (SUM8 if n == 64 else SUM4) if dc is None else DC_MAX
        while True:
            total = sum(abs(scale(k, v)) for k, v in enumerate(out) if v)
            if total <= limit:
                return out
            big = max(range(n), key=lambda k: abs(scale(k, out[k])) if out[k] else -1)
            if abs(out[big]) > 1:
                out[big] = out[big] // 2 if out[big] > 0 else -(-out[big] // 2)
            elif needed and sum(1 for v in out if v) == 1:
                return out
            else:
                out[big] = 0

    def _residual(self) -> None:
        m, w = self.m, self.w
        qp = self.qp
        intra = m.kind in INTRA
        cbpl, cbpc = m.cbp & 15, m.cbp >> 4
        if m.kind == "I16":
            ls = w.ls4[0][qp % 6][0]

            def dcs(k, v):  # an upper bound of |dcY| from one level
                f = abs(v)
                return (f * ls) << (qp // 6 - 6) if qp >= 36 else \
                    (f * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)
            dc = self._levels(16, dcs, dc=True)
            n = self._block("LumaDc", 0, 0, dc, 16)
            if n:
                m.dc_cbf |= 1
        for b8 in range(4):
            if not (cbpl >> b8) & 1:
                continue
            if m.t8:
                lst = 0 if intra else 1
                lv = self._levels(64, lambda k, v: dq8(v, w.ls8[lst][qp % 6][ZZ8[k]], qp),
                                  needed=self.cabac is not None)
                if self.cabac is not None:
                    n = self._block("Luma8x8", 0, b8, lv, 64)
                    for i4 in range(4):
                        m.tc[BLK_RASTER[4 * b8 + i4]] = int(n > 0)
                else:
                    for i4 in range(4):
                        blk = BLK_RASTER[4 * b8 + i4]
                        part = [lv[4 * k + i4] for k in range(16)]
                        m.tc[blk] = self._block("Luma4x4", 0, blk, part, 16)
                continue
            for i4 in range(4):
                blk = BLK_RASTER[4 * b8 + i4]
                if m.kind == "I16":
                    ls = w.ls4[0][qp % 6]
                    lv = self._levels(15, lambda k, v: dq4(v, ls[ZZ4[k + 1]], qp))
                    n = self._block("LumaAc", 0, blk, lv, 15)
                else:
                    ls = w.ls4[0 if intra else 3][qp % 6]
                    lv = self._levels(16, lambda k, v: dq4(v, ls[ZZ4[k]], qp))
                    n = self._block("Luma4x4", 0, blk, lv, 16)
                m.tc[blk] = int(n > 0) if self.cabac is not None else n
        if cbpc:
            qpcs = []
            for comp in range(2):
                off = w.cr_off if comp else w.cb_off
                qpc = CHROMA_QP[min(max(qp + off, 0), 51)]
                qpcs.append(qpc)
                ls = w.ls4[(1 if intra else 4) + comp][qpc % 6][0]
                lv = self._levels(4, lambda k, v: ((abs(v) * ls) << (qpc // 6)) >> 5,
                                  dc=True)
                n = self._block("ChromaDc", comp, 0, lv, 4)
                if n:
                    m.dc_cbf |= 2 << comp
            if cbpc == 2:
                for comp in range(2):
                    ls = w.ls4[(1 if intra else 4) + comp][qpcs[comp] % 6]
                    for b in range(4):
                        lv = self._levels(15, lambda k, v: dq4(v, ls[ZZ4[k + 1]], qpcs[comp]))
                        n = self._block("ChromaAc", comp, b, lv, 15)
                        m.tcc[comp][b] = int(n > 0) if self.cabac is not None else n

    # -- residual blocks

    def _block(self, cat: str, comp: int, blk: int, levels: List[int], n: int) -> int:
        if self.cabac is not None:
            return self._cabac_block(cat, comp, blk, levels, n)
        if cat == "ChromaDc":
            nc = -1
        else:
            nc = self._nc(-1 if cat not in ("ChromaAc",) else comp, 0 if cat == "LumaDc" else blk)
        return self._cavlc_block(nc, levels, n)

    def _tc_nb(self, comp: int, blk: int, dx: int, dy: int):
        w = 4 if comp < 0 else 2
        x, y = blk % w + dx, blk // w + dy
        if x >= 0 and y >= 0:
            n, idx = self.m, y * w + x
        else:
            n = self.A() if x < 0 else self.B()
            idx = ((y + w) % w) * w + ((x + w) % w)
        if n is None:
            return None
        if n.kind == "SKIP":
            return 0
        if n.kind == "PCM":
            return 16
        return n.tc[idx] if comp < 0 else n.tcc[comp][idx]

    def _nc(self, comp: int, blk: int) -> int:
        a, b = self._tc_nb(comp, blk, -1, 0), self._tc_nb(comp, blk, 0, -1)
        if a is not None and b is not None:
            return (a + b + 1) >> 1
        return a if a is not None else b if b is not None else 0

    def _cavlc_block(self, nc: int, levels: List[int], n: int) -> int:
        bw = self.bw
        nz = [(k, v) for k, v in enumerate(levels) if v]
        total = len(nz)
        rev = [v for _, v in reversed(nz)]
        t1 = 0
        while t1 < min(3, total) and abs(rev[t1]) == 1:
            t1 += 1
        sym = 4 * total + t1
        if nc == -1:
            bw.u(T["kChromaDcCoeffTokenLen"][sym], T["kChromaDcCoeffTokenBits"][sym])
        else:
            t = 0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3
            bw.u(T["kCoeffTokenLen"][68 * t + sym], T["kCoeffTokenBits"][68 * t + sym])
        if total == 0:
            return 0
        suffix = 1 if total > 10 and t1 < 3 else 0
        for i, v in enumerate(rev):
            if i < t1:
                bw.bit(int(v < 0))
                continue
            code = 2 * v - 2 if v > 0 else -2 * v - 1
            if i == t1 and t1 < 3:
                code -= 2
            if suffix == 0:
                if code < 14:
                    prefix, size, suf = code, 0, 0
                elif code < 30:
                    prefix, size, suf = 14, 4, code - 14
                else:
                    prefix, size, suf = 15, 12, code - 30
            elif code < (15 << suffix):
                prefix, size, suf = code >> suffix, suffix, code & ((1 << suffix) - 1)
            else:
                prefix, size, suf = 15, 12, code - (15 << suffix)
            assert suf < (1 << size) or size == 0, "level too large for CAVLC"
            bw.u(prefix, 0)
            bw.bit(1)
            if size:
                bw.u(size, suf)
            if suffix == 0:
                suffix = 1
            if abs(v) > (3 << (suffix - 1)) and suffix < 6:
                suffix += 1
        last = nz[-1][0]
        zeros = last + 1 - total
        if total < n:
            if nc == -1:
                bw.u(T["kChromaDcTotalZerosLen"][4 * (total - 1) + zeros],
                     T["kChromaDcTotalZerosBits"][4 * (total - 1) + zeros])
            else:
                bw.u(T["kTotalZerosLen"][16 * (total - 1) + zeros],
                     T["kTotalZerosBits"][16 * (total - 1) + zeros])
        pos = [k for k, _ in reversed(nz)]
        left = zeros
        for i in range(total - 1):
            if left == 0:
                break
            run = pos[i] - pos[i + 1] - 1
            t = min(left, 7) - 1
            bw.u(T["kRunLen"][16 * t + run], T["kRunBits"][16 * t + run])
            left -= run
        return total

    def _cbf_cond(self, cat: str, comp: int, blk: int, dx: int, dy: int) -> int:
        cur_intra = self.m.kind in INTRA
        if cat in ("LumaDc", "ChromaDc"):
            n = self.A() if dx < 0 else self.B()
            if n is None:
                return int(cur_intra)
            if n.kind == "PCM":
                return 1
            if n.kind == "SKIP":
                return 0
            if cat == "LumaDc":
                return n.dc_cbf & 1 if n.kind == "I16" else 0
            if (n.cbp >> 4) == 0:
                return 0
            return (n.dc_cbf >> (1 + comp)) & 1
        w = 2 if cat == "ChromaAc" else 4
        x, y = blk % w + dx, blk // w + dy
        if x >= 0 and y >= 0:
            n, idx = self.m, y * w + x
        else:
            n = self.A() if x < 0 else self.B()
            idx = ((y + w) % w) * w + ((x + w) % w)
            if n is None:
                return int(cur_intra)
            if n.kind == "PCM":
                return 1
            if n.kind == "SKIP":
                return 0
        if cat == "ChromaAc":
            return int((n.cbp >> 4) == 2 and n.tcc[comp][idx] > 0)
        if not (n.cbp >> b8_of(idx)) & 1:
            return 0
        if n.t8:
            return 1
        return int(n.tc[idx] > 0)

    def _cabac_block(self, cat: str, comp: int, blk: int, levels: List[int], n: int) -> int:
        c = self.cabac
        ci = ("LumaDc", "LumaAc", "Luma4x4", "ChromaDc", "ChromaAc", "Luma8x8").index(cat)
        nz = [k for k, v in enumerate(levels) if v]
        if ci != 5:
            inc = self._cbf_cond(cat, comp, blk, -1, 0) + 2 * self._cbf_cond(cat, comp, blk, 0, -1)
            c.decision(85 + (0, 4, 8, 12, 16)[ci] + inc, int(bool(nz)))
            if not nz:
                return 0
        sig_base = 402 if ci == 5 else 105 + (0, 15, 29, 44, 47)[ci]
        last_base = 417 if ci == 5 else 166 + (0, 15, 29, 44, 47)[ci]
        abs_base = 426 if ci == 5 else 227 + (0, 10, 20, 30, 39)[ci]
        last = nz[-1]
        for i in range(n - 1):
            if ci == 5:
                si, li = T["kSigCoeffOffset8x8"][i], T["kLastCoeffOffset8x8"][i]
            elif ci == 3:
                si = li = min(i, 2)
            else:
                si = li = i
            sig = int(levels[i] != 0)
            c.decision(sig_base + si, sig)
            if sig:
                c.decision(last_base + li, int(i == last))
                if i == last:
                    break
        gt1 = eq1 = 0
        for k in reversed(nz):
            a = abs(levels[k]) - 1
            c.decision(abs_base + (0 if gt1 else min(4, 1 + eq1)), int(a > 0))
            if a > 0:
                inc2 = 5 + min(4 - (1 if ci == 3 else 0), gt1)
                j = 1
                while j < 14:
                    c.decision(abs_base + inc2, int(a > j))
                    if a <= j:
                        break
                    j += 1
                if a >= 14:
                    self._ueg(a - 14, 0)
            c.bypass(int(levels[k] < 0))
            if a == 0:
                eq1 += 1
            else:
                gt1 += 1
        return len(nz)


# ------------------------------------------------------------ streams

def write_stream(spec: Spec) -> List[List[bytes]]:
    """The access units of a stream, each a list of NAL units (the first
    leads with the SPS and PPS)."""
    w = Writer(spec)
    aus = []
    for i in range(spec.frames):
        units = w.picture(i)
        if i == 0:
            units = [w.sps(), w.pps()] + units
        aus.append(units)
    return aus


def annexb(aus: List[List[bytes]], aud: bool = False) -> List[bytes]:
    """Each access unit as an Annex B byte string (4-byte start codes;
    with an access unit delimiter first when `aud`)."""
    out = []
    for units in aus:
        pre = [nal(9, 0, bytes([0xF0]))] if aud else []
        out.append(b"".join(b"\0\0\0\1" + u for u in pre + units))
    return out


def _avcc(sps: bytes, pps: bytes, length_size: int, with_sets: bool) -> bytes:
    body = bytes([1, sps[1], sps[2], sps[3], 0xFC | (length_size - 1)])
    if with_sets:
        body += bytes([0xE1]) + struct.pack(">H", len(sps)) + sps
        body += bytes([1]) + struct.pack(">H", len(pps)) + pps
    else:
        body += bytes([0xE0, 0])
    return body


def write_mp4(path: str, aus: List[List[bytes]], width: int, height: int,
              entry: bytes = b"avc1", length_size: int = 4, fps: int = 30) -> None:
    """An MP4 of the stream: `avc1` (parameter sets in `avcC` only) or
    `avc3` (in band, `avcC` without them); NAL lengths of `length_size`
    bytes."""
    import sys
    sys.path.insert(0, ROOT)
    from mvsmplfitting_tpu_torch.data import mp4 as M

    sps, pps = aus[0][0], aus[0][1]
    avcc = _avcc(sps, pps, length_size, entry == b"avc1")

    class AvcWriter(M.Mp4Writer):
        def sample_entry(self) -> bytes:
            return M._box(entry, bytes(6), struct.pack(">H", 1), bytes(16),
                          struct.pack(">HHIIIH", self.width, self.height,
                                      0x480000, 0x480000, 0, 1),
                          bytes(32), struct.pack(">Hh", 0x18, -1),
                          M._box(b"avcC", avcc))

    with open(path, "wb") as f:
        mux = AvcWriter(f, b"isom", width, height, fps, 1, b"")
        for i, units in enumerate(aus):
            if entry == b"avc1" and i == 0:
                units = units[2:]
            mux.write(b"".join(len(u).to_bytes(length_size, "big") + u
                               for u in units), i == 0)
        mux.close()


def write_avi(path: str, aus: List[List[bytes]], width: int, height: int,
              fourcc: bytes = b"H264", fps: float = 30.0) -> None:
    """An AVI whose `00dc` chunks are the access units in Annex B."""
    import sys
    sys.path.insert(0, ROOT)
    from mvsmplfitting_tpu_torch.viz.video import AviWriter

    with open(path, "wb") as f:
        avi = AviWriter(f, width, height, fps, fourcc)
        for i, au in enumerate(annexb(aus)):
            avi.write(au, i == 0)
        avi.close()


def write_annexb(path: str, aus: List[List[bytes]], aud: bool = False) -> None:
    with open(path, "wb") as f:
        for au in annexb(aus, aud):
            f.write(au)
