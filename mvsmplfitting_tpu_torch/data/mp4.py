"""ISO base media (MP4, M4V, QuickTime) files without FFmpeg: the
container half of what `cv2.VideoCapture` and `cv2.VideoWriter` do for
the MPEG-4 Part 2 video of JAX's `detect/stream.py` and `viz/video.py`.

Reading (`mp4_info`, `mp4_samples`): the boxes are walked by seeking,
so `mdat` is never held and `moov` may come before or after it (cv2
writes it last).  The first video track (handler `vide`), as OpenCV
picks it, gives its sample entry, the `esds` DecoderSpecificInfo (the
VOS/VO/VOL headers), its samples from `stsz`/`stz2`, `stsc` runs and
`stco`/`co64`, and its frame rate from `mdhd` and `stts`.  An edit list
(`elst`) that starts the presentation after the first sample hides the
samples before it, as FFmpeg's demuxer does; other edit lists (empty
edits, several edits) are refused.  A sample entry other than `mp4v`
(`avc1`, `hvc1`, ...) and an `esds` object type other than 0x20 (MPEG-4
Visual; 0x60-0x65 MPEG-2, 0x6A MPEG-1, 0x6C JPEG, ...) raise
`VideoError` naming the file and the codec.

Writing (`Mp4Writer`): what libavformat's mov muxer writes for cv2's
`mp4v` writer with no faststart: `ftyp` (brand `isom`, `M4V ` or `qt  `
from the name's extension), `free`, one `mdat` written as frames come,
then `moov` with one video track: `tkhd`, an `elst` of one edit,
`mdhd`/`hdlr`/`vmhd`/`dinf`, and `stbl` with the `mp4v` sample entry
and its `esds`, `stts`, `stss` (the I-VOPs), `stsc`, `stsz` and
`stco` (or `co64` past 4 GiB).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import BinaryIO, Dict, Iterator, List, Optional, Tuple

from .video import VideoError

# esds objectTypeIndication -> a name for the refusal message
OBJECT_TYPES = {0x20: "MPEG-4 Part 2", 0x21: "H.264", 0x23: "H.265",
                0x60: "MPEG-2 Simple", 0x61: "MPEG-2 Main",
                0x62: "MPEG-2 SNR", 0x63: "MPEG-2 Spatial",
                0x64: "MPEG-2 High", 0x65: "MPEG-2 4:2:2", 0x6A: "MPEG-1",
                0x6C: "JPEG"}
# sample entries of other codecs -> a name for the refusal message
SAMPLE_ENTRIES = {b"hvc1": "H.265", b"hev1": "H.265", b"av01": "AV1",
                  b"vp09": "VP9", b"vp08": "VP8", b"mjpa": "Motion-JPEG",
                  b"jpeg": "JPEG", b"apch": "ProRes", b"apcn": "ProRes",
                  b"s263": "H.263", b"mp2v": "MPEG-2"}
# the brand libavformat gives a file by its name's extension
BRANDS = {".mp4": b"isom", ".m4v": b"M4V ", ".m4a": b"M4V ",
          ".mov": b"qt  "}


@dataclass
class Mp4Info:
    path: str
    width: int
    height: int
    fps: float
    config: bytes                   # the esds DecoderSpecificInfo
    samples: List[Tuple[int, int]]  # (file offset, size) in decode order
    skip: int = 0                   # samples hidden by the edit list
    codec: str = "mpeg4"            # or "h264"
    nal_length_size: int = 0        # H.264: bytes of each NAL unit's length


def _boxes(data: bytes, start: int = 0, end: Optional[int] = None
           ) -> Iterator[Tuple[bytes, int, int]]:
    """(type, body start, body end) of the boxes in data[start:end]."""
    end = len(data) if end is None else end
    at = start
    while at + 8 <= end:
        size, kind = struct.unpack(">I4s", data[at:at + 8])
        head = 8
        if size == 1:
            size = struct.unpack(">Q", data[at + 8:at + 16])[0]
            head = 16
        elif size == 0:
            size = end - at
        if size < head or at + size > end:
            raise VideoError(f"MP4 box {kind!r} runs past its parent")
        yield kind, at + head, at + size
        at += size


def _top_level(f: BinaryIO, path: str) -> Dict[bytes, Tuple[int, int]]:
    """File offsets (body start, body end) of the first box of each top
    level type, found by seeking."""
    total = os.fstat(f.fileno()).st_size
    found: Dict[bytes, Tuple[int, int]] = {}
    at = 0
    while at + 8 <= total:
        f.seek(at)
        head = f.read(16)
        size, kind = struct.unpack(">I4s", head[:8])
        hl = 8
        if size == 1:
            size = struct.unpack(">Q", head[8:16])[0]
            hl = 16
        elif size == 0:
            size = total - at
        if size < hl:
            raise VideoError(f"{path}: MP4 box {kind!r} of size {size}")
        found.setdefault(kind, (at + hl, min(at + size, total)))
        at += size
    return found


def _full(data: bytes, at: int) -> Tuple[int, int]:
    """(version, flags) of a full box body at `at`."""
    v = data[at]
    return v, int.from_bytes(data[at + 1:at + 4], "big")


def _descriptor(data: bytes, at: int) -> Tuple[int, int, int]:
    """(tag, body start, body end) of an MPEG-4 descriptor."""
    tag = data[at]
    at += 1
    size = 0
    for _ in range(4):
        b = data[at]
        at += 1
        size = (size << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, at, at + size


def _esds(data: bytes, s: int, e: int, path: str) -> bytes:
    """The DecoderSpecificInfo of an `esds` box body; refuses an object
    type other than MPEG-4 Visual."""
    tag, a, b = _descriptor(data, s + 4)
    if tag != 3:
        raise VideoError(f"{path}: esds without an ES descriptor")
    flags = data[a + 2]
    a += 3
    if flags & 0x80:
        a += 2
    if flags & 0x40:
        a += 1 + data[a]
    if flags & 0x20:
        a += 2
    while a < b:
        tag, c, d = _descriptor(data, a)
        if tag == 4:
            oti = data[c]
            if oti != 0x20:
                name = OBJECT_TYPES.get(oti, f"object type 0x{oti:02X}")
                raise VideoError(
                    f"{path}: video codec {name} (esds object type "
                    f"0x{oti:02X}) is not supported; only MPEG-4 Part 2 "
                    "(mp4v) is read from MP4/QuickTime files")
            x = c + 13
            while x < d:
                tag2, g, h = _descriptor(data, x)
                if tag2 == 5:
                    return bytes(data[g:h])
                x = h
            return b""
        a = d
    raise VideoError(f"{path}: esds without a decoder configuration")


def _sample_table(stbl: bytes, path: str):
    boxes = {k: (s, e) for k, s, e in _boxes(stbl)}
    need = [b"stsd", b"stsc", b"stts"]
    for k in need:
        if k not in boxes:
            raise VideoError(f"{path}: MP4 track without {k.decode()}")
    if b"stco" not in boxes and b"co64" not in boxes:
        raise VideoError(f"{path}: MP4 track without stco/co64")
    # sizes
    if b"stsz" in boxes:
        s, _ = boxes[b"stsz"]
        fixed, n = struct.unpack(">II", stbl[s + 4:s + 12])
        sizes = ([fixed] * n if fixed else
                 list(struct.unpack(f">{n}I", stbl[s + 12:s + 12 + 4 * n])))
    elif b"stz2" in boxes:
        s, _ = boxes[b"stz2"]
        bits = stbl[s + 7]
        n = struct.unpack(">I", stbl[s + 8:s + 12])[0]
        raw = stbl[s + 12:]
        if bits == 16:
            sizes = list(struct.unpack(f">{n}H", raw[:2 * n]))
        elif bits == 8:
            sizes = list(raw[:n])
        else:
            sizes = [(raw[i // 2] >> (4 * (1 - i % 2))) & 15
                     for i in range(n)]
    else:
        raise VideoError(f"{path}: MP4 track without stsz/stz2")
    # chunk offsets
    if b"stco" in boxes:
        s, _ = boxes[b"stco"]
        n = struct.unpack(">I", stbl[s + 4:s + 8])[0]
        chunks = struct.unpack(f">{n}I", stbl[s + 8:s + 8 + 4 * n])
    else:
        s, _ = boxes[b"co64"]
        n = struct.unpack(">I", stbl[s + 4:s + 8])[0]
        chunks = struct.unpack(f">{n}Q", stbl[s + 8:s + 8 + 8 * n])
    # sample-to-chunk runs
    s, _ = boxes[b"stsc"]
    n = struct.unpack(">I", stbl[s + 4:s + 8])[0]
    runs = [struct.unpack(">III", stbl[s + 8 + 12 * i:s + 20 + 12 * i])
            for i in range(n)]
    samples = []
    k = 0
    for r, (first, per, _) in enumerate(runs):
        last = runs[r + 1][0] - 1 if r + 1 < len(runs) else len(chunks)
        for c in range(first - 1, last):
            off = chunks[c]
            for _ in range(per):
                if k >= len(sizes):
                    break
                samples.append((off, sizes[k]))
                off += sizes[k]
                k += 1
    if k != len(sizes):
        raise VideoError(f"{path}: stsc/stco give {k} samples, stsz "
                         f"{len(sizes)}")
    # decode times
    s, _ = boxes[b"stts"]
    n = struct.unpack(">I", stbl[s + 4:s + 8])[0]
    stts = [struct.unpack(">II", stbl[s + 8 + 8 * i:s + 16 + 8 * i])
            for i in range(n)]
    return boxes, samples, stts


def mp4_info(path: str) -> Mp4Info:
    """The first video track of the MP4/MOV file at `path`; raises
    `VideoError` naming the file for a file or codec it does not read,
    and for boxes that do not parse."""
    path = os.fspath(path)
    try:
        return _mp4_info(path)
    except (struct.error, IndexError, KeyError, ValueError) as e:
        if isinstance(e, VideoError):
            raise
        raise VideoError(f"{path}: malformed MP4 boxes ({e!r})") from e


def _mp4_info(path: str) -> Mp4Info:
    with open(path, "rb") as f:
        head = f.read(12)
        if head[4:8] != b"ftyp":
            raise VideoError(f"{path}: not an MP4/QuickTime file")
        top = _top_level(f, path)
        if b"moov" not in top:
            raise VideoError(f"{path}: MP4 file without a moov box")
        s, e = top[b"moov"]
        f.seek(s)
        moov = f.read(e - s)
    for kind, ts, te in _boxes(moov):
        if kind != b"trak":
            continue
        trak = {k: (a, b) for k, a, b in _boxes(moov, ts, te)}
        if b"mdia" not in trak:
            continue
        mdia = {k: (a, b) for k, a, b in _boxes(moov, *trak[b"mdia"])}
        if b"hdlr" not in mdia or b"minf" not in mdia:
            continue
        hs = mdia[b"hdlr"][0]
        if moov[hs + 8:hs + 12] != b"vide":
            continue
        ms = mdia[b"mdhd"][0]
        version, _ = _full(moov, ms)
        timescale = struct.unpack(
            ">I", moov[ms + (20 if version == 1 else 12):][:4])[0]
        minf = {k: (a, b) for k, a, b in _boxes(moov, *mdia[b"minf"])}
        if b"stbl" not in minf:
            raise VideoError(f"{path}: video track without stbl")
        stbl = moov[minf[b"stbl"][0]:minf[b"stbl"][1]]
        boxes, samples, stts = _sample_table(stbl, path)
        ss, se = boxes[b"stsd"]
        entries = list(_boxes(stbl, ss + 8, se))
        if not entries:
            raise VideoError(f"{path}: empty stsd")
        codec, es, ee = entries[0]
        name = codec.decode("latin-1")
        if codec not in (b"mp4v", b"avc1", b"avc3"):
            what = SAMPLE_ENTRIES.get(codec)
            raise VideoError(
                f"{path}: video codec {name!r}"
                + (f" ({what})" if what else "") + " is not supported; only "
                "MPEG-4 Part 2 (mp4v) and H.264 (avc1, avc3) are read from "
                "MP4/QuickTime files")
        width, height = struct.unpack(">HH", stbl[es + 24:es + 28])
        config = b""
        nal_length_size = 0
        children = {k: (a, b) for k, a, b in _boxes(stbl, es + 78, ee)}
        if codec == b"mp4v":
            if b"esds" in children:
                config = _esds(stbl, *children[b"esds"], path)
        elif b"avcC" not in children:
            raise VideoError(f"{path}: video codec {name!r} without an avcC "
                             "box")
        else:
            config, nal_length_size = _avcc(stbl, *children[b"avcC"], path)
        total = sum(c * d for c, d in stts)
        count = sum(c for c, _ in stts)
        fps = count * timescale / total if total else 0.0
        skip = _edit_skip(moov, trak.get(b"edts"), timescale, stts, path)
        return Mp4Info(path, width, height, fps, config, samples, skip,
                       "mpeg4" if codec == b"mp4v" else "h264",
                       nal_length_size)
    raise VideoError(f"{path}: no video track")


def _avcc(data: bytes, s: int, e: int, path: str) -> Tuple[bytes, int]:
    """The parameter sets of an `avcC` box (each with a length prefix of
    the stream's NAL length size) and that size."""
    if e - s < 7 or data[s] != 1:
        raise VideoError(f"{path}: malformed avcC box")
    size = (data[s + 4] & 3) + 1
    out = []
    at = s + 5
    for count_mask in (31, 255):
        n = data[at] & count_mask
        at += 1
        for _ in range(n):
            ln = struct.unpack(">H", data[at:at + 2])[0]
            unit = data[at + 2:at + 2 + ln]
            if len(unit) != ln:
                raise VideoError(f"{path}: avcC parameter set cut short")
            if ln >= 1 << (8 * size):
                raise VideoError(f"{path}: avcC parameter set longer than "
                                 f"its NAL length size {size}")
            out.append(ln.to_bytes(size, "big") + bytes(unit))
            at += 2 + ln
    return b"".join(out), size


def _edit_skip(moov: bytes, edts, timescale: int, stts, path: str) -> int:
    """Samples before the edit list's start (FFmpeg's demuxer drops
    them); refuses edit lists other than one edit."""
    if edts is None:
        return 0
    for k, a, b in _boxes(moov, *edts):
        if k != b"elst":
            continue
        version, _ = _full(moov, a)
        n = struct.unpack(">I", moov[a + 4:a + 8])[0]
        if n == 0:
            return 0
        if n > 1:
            raise VideoError(f"{path}: an edit list of {n} edits is not "
                             "supported")
        if version == 1:
            media_time = struct.unpack(">q", moov[a + 16:a + 24])[0]
        else:
            media_time = struct.unpack(">i", moov[a + 12:a + 16])[0]
        if media_time < 0:
            raise VideoError(f"{path}: an empty edit is not supported")
        t = skip = 0
        for count, delta in stts:
            for _ in range(count):
                if t >= media_time:
                    return skip
                t += delta
                skip += 1
        return skip
    return 0


def mp4_samples(path: str, info: Mp4Info = None) -> Iterator[bytes]:
    """The bytes of each sample of the video track, in decode order."""
    path = os.fspath(path)
    info = info or mp4_info(path)
    with open(path, "rb") as f:
        for off, size in info.samples:
            f.seek(off)
            data = f.read(size)
            if len(data) != size:
                raise VideoError(f"{path}: sample at {off} cut short")
            yield data


# ---------------------------------------------------------------- writing

_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _fullbox(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def _desc(tag: int, body: bytes) -> bytes:
    """An MPEG-4 descriptor with the 4-byte size libavformat writes."""
    n = len(body)
    size = bytes([0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F])
    return bytes([tag]) + size + body


def esds_box(config: bytes, avg_bitrate: int = 0, max_bitrate: int = 0,
             buffer_size: int = 0) -> bytes:
    """The `esds` of an MPEG-4 Visual track with `config` (the VOS/VOL
    headers) as its DecoderSpecificInfo."""
    dcd = (bytes([0x20, 0x11]) + buffer_size.to_bytes(3, "big")
           + struct.pack(">II", max_bitrate, avg_bitrate)
           + _desc(5, config))
    es = struct.pack(">HB", 1, 0) + _desc(4, dcd) + _desc(6, b"\x02")
    return _fullbox(b"esds", 0, 0, _desc(3, es))


class Mp4Writer:
    """One MPEG-4 Visual track written as samples come: `ftyp` (`brand`:
    "isom", "M4V " or "qt  "), an 8-byte `free` (`wide` for QuickTime)
    that becomes the 64-bit header of `mdat` if the media passes 4 GiB,
    then `mdat` and, at `close()`, `moov`.  Only the per-sample sizes,
    offsets and key flags are kept (16 bytes a frame).  The frame rate
    is `res`/`inc` ticks (the track's timescale and sample duration)."""

    def __init__(self, out: BinaryIO, brand: bytes, width: int, height: int,
                 res: int, inc: int, config: bytes):
        self.out, self.brand = out, brand
        self.width, self.height, self.res, self.inc = width, height, res, inc
        self.config = config
        if brand == b"isom":
            compat = b"isomiso2mp41"
        elif brand == b"M4V ":
            compat = b"M4V isomiso2"
        else:
            compat = b"qt  "
        out.write(_box(b"ftyp", brand, struct.pack(">I", 0x200), compat))
        self.free_at = out.tell()
        out.write(_box(b"wide" if brand == b"qt  " else b"free"))
        self.mdat_at = out.tell()
        out.write(struct.pack(">I4s", 0, b"mdat"))
        self.sizes: List[int] = []
        self.offsets: List[int] = []
        self.keys: List[int] = []

    def write(self, sample: bytes, key: bool) -> None:
        self.offsets.append(self.out.tell())
        self.sizes.append(len(sample))
        if key:
            self.keys.append(len(self.sizes))
        self.out.write(sample)

    def sample_entry(self) -> bytes:
        """The `mp4v` visual sample entry with its `esds`."""
        return _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                    struct.pack(">HHIIIH", self.width, self.height,
                                0x480000, 0x480000, 0, 1),
                    bytes(32), struct.pack(">Hh", 0x18, -1),
                    esds_box(self.config))

    def _moov(self) -> bytes:
        n = len(self.sizes)
        media_dur = n * self.inc
        movie_dur = (media_dur * 1000 + self.res // 2) // self.res
        mvhd = _fullbox(b"mvhd", 0, 0, struct.pack(
            ">IIIIIH10x", 0, 0, 1000, movie_dur, 0x10000, 0x100),
            _MATRIX, bytes(24), struct.pack(">I", 2))
        tkhd = _fullbox(b"tkhd", 0, 3, struct.pack(
            ">IIIIIQhhhH", 0, 0, 1, 0, movie_dur, 0, 0, 0, 0, 0),
            _MATRIX, struct.pack(">II", self.width << 16, self.height << 16))
        elst = _fullbox(b"elst", 0, 0, struct.pack(">IIiI", 1, movie_dur, 0,
                                                   0x10000))
        mdhd = _fullbox(b"mdhd", 0, 0, struct.pack(
            ">IIIIHH", 0, 0, self.res, media_dur, 0x55C4, 0))
        hdlr = _fullbox(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"),
                        b"VideoHandler\0")
        vmhd = _fullbox(b"vmhd", 0, 1, bytes(8))
        dinf = _box(b"dinf", _fullbox(b"dref", 0, 0, struct.pack(">I", 1),
                                      _fullbox(b"url ", 0, 1)))
        stsd = _fullbox(b"stsd", 0, 0, struct.pack(">I", 1),
                        self.sample_entry())
        stts = _fullbox(b"stts", 0, 0, struct.pack(">III", 1, n, self.inc)
                        if n else struct.pack(">I", 0))
        stss = _fullbox(b"stss", 0, 0, struct.pack(f">I{len(self.keys)}I",
                                                   len(self.keys), *self.keys))
        stsc = _fullbox(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))
        stsz = _fullbox(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n,
                                                   *self.sizes))
        if self.offsets and self.offsets[-1] > 0xFFFFFFFF:
            stco = _fullbox(b"co64", 0, 0, struct.pack(f">I{n}Q", n,
                                                       *self.offsets))
        else:
            stco = _fullbox(b"stco", 0, 0, struct.pack(f">I{n}I", n,
                                                       *self.offsets))
        stbl = _box(b"stbl", stsd, stts, stss, stsc, stsz, stco)
        minf = _box(b"minf", vmhd, dinf, stbl)
        mdia = _box(b"mdia", mdhd, hdlr, minf)
        trak = _box(b"trak", tkhd, _box(b"edts", elst), mdia)
        return _box(b"moov", mvhd, trak)

    def close(self) -> None:
        out = self.out
        end = out.tell()
        size = end - self.mdat_at
        if size <= 0xFFFFFFFF:
            out.seek(self.mdat_at)
            out.write(struct.pack(">I", size))
        else:  # the free box and mdat's header become a 64-bit header
            out.seek(self.free_at)
            out.write(struct.pack(">I4sQ", 1, b"mdat", end - self.free_at))
        out.seek(end)
        out.write(self._moov())
