"""Video file reading without OpenCV (the video half of JAX's
`detect/stream.py:frame_source`, which reads with `cv2.VideoCapture`):
Motion-JPEG in AVI; MPEG-4 Part 2 Simple Profile in AVI or in an ISO
base media file (MP4, M4V, MOV; `data/mp4.py`); H.264 (progressive
8-bit 4:2:0 Constrained Baseline, Main and High, I and P slices;
`data/h264.py`) in AVI, in MP4/M4V/MOV (`avc1`, `avc3`) or as a raw
Annex B stream (`.h264`, `.264` or any name: told by its first bytes, a
start code and an access unit delimiter, SPS or SEI, as libavformat's
probe tells it).

`open_video(path)` tells the container by the file's bytes and returns
a `VideoStream`: its size and frame rate, its packets (`packets()`,
streamed, never holding the file) and a decoder of them
(`decoder()`), so that demuxing and decoding can be timed apart;
`read_video(path)` gives the BGR frames.  `avi_info(path)` reads a
RIFF/AVI file's headers and refuses, naming the file and the fourcc, a
first video stream that is neither Motion-JPEG, MPEG-4 Part 2
(`FMP4`, `XVID`, `DIVX`, `DX50`, `MP4V`, in any case) nor H.264 (the
fourccs libavformat's RIFF table maps to it: `H264`, `X264`, `AVC1`,
`DAVC`, ..., in any case; Annex B access units in the chunks);
`avi_frames(path)` streams the `##dc`/`##db` chunks of that stream in
the order of the `movi` lists (inside `rec ` lists too), then those of
the OpenDML `AVIX` continuation RIFFs; other streams' chunks, `JUNK` and
index chunks are skipped.  In an MPEG-4 AVI the VOL headers come in the
first chunk, and a chunk that packs several VOPs (DivX's packed
bitstream) is refused.

Motion-JPEG frames decode with `images.decode_jpeg`, which takes frames
without a DHT segment (the standard tables); its yardstick is OpenCV's
own Motion-JPEG reader (`cv2.CAP_OPENCV_MJPEG`), which returns
`cv2.imdecode` of each chunk (`cv2.VideoCapture(path)` with OpenCV's
default backend decodes through FFmpeg, whose JPEG decoder rounds
otherwise, by up to ~20 levels).  MPEG-4 decodes with `data/mpeg4.py`,
whose yardstick is `cv2.VideoCapture(path)` itself (FFmpeg's decoder and
its swscale conversion to BGR).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import BinaryIO, Iterator, List, Optional, Tuple

import numpy as np

from .images import decode_jpeg

# The Motion-JPEG fourcc (the stream header's handler or the bitmap
# header's compression, in any case), as OpenCV's own MJPEG reader
# takes it.
MJPEG_FOURCCS = (b"MJPG",)
# MPEG-4 Part 2 fourccs (compared upper-cased): FFmpeg's mpeg4 encoder
# (`FMP4`), Xvid, DivX 4/5, and `mp4v`/`MP4V`.
MPEG4_FOURCCS = (b"FMP4", b"XVID", b"DIVX", b"DX50", b"MP4V")
# H.264 fourccs (compared upper-cased), as libavformat's RIFF table
# (riff.c, ff_codec_bmp_tags) maps them
H264_FOURCCS = (b"H264", b"X264", b"AVC1", b"DAVC", b"SMV2", b"VSSH",
                b"Q264", b"V264", b"GAVC", b"UMSV", b"TSHD", b"INMC")
# libavformat's raw H.264 demuxer gives 25 fps to a stream it cannot time
ANNEXB_FPS = 25.0


class VideoError(ValueError):
    """A video file the port does not read."""


@dataclass
class AviInfo:
    path: str
    width: int
    height: int
    fps: float
    frames: int          # the header's count (of the first RIFF)
    stream: int          # index of the video stream
    fourcc: str
    codec: str = "mjpeg"  # or "mpeg4", "h264"


def _read_chunk_header(f: BinaryIO) -> Tuple[bytes, int]:
    head = f.read(8)
    if len(head) < 8:
        return b"", -1
    fourcc, size = struct.unpack("<4sI", head)
    return fourcc, size


def _fourcc(b: bytes) -> str:
    return b.decode("latin-1")


def _parse_hdrl(f: BinaryIO, end: int, path: str) -> AviInfo:
    """The first video stream of an `hdrl` list ending at `end`."""
    stream = -1
    found = None
    while f.tell() + 8 <= end:
        fourcc, size = _read_chunk_header(f)
        at = f.tell()
        if fourcc == b"LIST" and f.read(4) == b"strl":
            stream += 1
            strh = strf = None
            while f.tell() + 8 <= at + size:
                cc, sz = _read_chunk_header(f)
                body = f.read(sz)
                if cc == b"strh":
                    strh = body
                elif cc == b"strf":
                    strf = body
                f.seek(sz & 1, os.SEEK_CUR)
            if found is None and strh is not None and strh[:4] == b"vids":
                found = (stream, strh, strf)
        f.seek(at + size + (size & 1))
    if found is None:
        raise VideoError(f"{path}: no video stream")
    stream, strh, strf = found
    handler = strh[4:8]
    compression = strf[16:20] if strf is not None and len(strf) >= 20 \
        else b"\0\0\0\0"
    codec = fourcc = None
    for cc in (compression, handler):
        if cc.upper() in MJPEG_FOURCCS:
            codec, fourcc = "mjpeg", cc
            break
        if cc.upper() in MPEG4_FOURCCS:
            codec, fourcc = "mpeg4", cc
            break
        if cc.upper() in H264_FOURCCS:
            codec, fourcc = "h264", cc
            break
    if codec is None:
        raise VideoError(
            f"{path}: video codec {_fourcc(handler)!r} (compression "
            f"{_fourcc(compression)!r}) is not supported; only Motion-JPEG, "
            "MPEG-4 Part 2 and H.264 AVI are read")
    scale, rate, _, length = struct.unpack("<IIII", strh[20:36])
    width, height = struct.unpack("<ii", strf[4:12])
    return AviInfo(path, width, abs(height), rate / scale if scale else 0.0,
                   length, stream, _fourcc(fourcc), codec)


def avi_info(path: str) -> AviInfo:
    """The headers of the Motion-JPEG or MPEG-4 AVI at `path`; raises
    `VideoError` naming the file for anything else."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        head = f.read(12)
        if head[4:8] == b"ftyp":
            raise VideoError(
                f"{path}: an MP4/QuickTime file (brand "
                f"{_fourcc(head[8:12])!r}), not an AVI")
        if head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            raise VideoError(f"{path}: not an AVI (RIFF 'AVI ') file")
        while True:
            fourcc, size = _read_chunk_header(f)
            if size < 0:
                raise VideoError(f"{path}: no 'hdrl' list")
            at = f.tell()
            if fourcc == b"LIST" and f.read(4) == b"hdrl":
                return _parse_hdrl(f, at + size, path)
            f.seek(at + size + (size & 1))


def _movi_chunks(f: BinaryIO, end: int, ids: Tuple[bytes, ...]
                 ) -> Iterator[bytes]:
    """The bytes of the frame chunks in [f.tell(), end), one at a
    time."""
    while f.tell() + 8 <= end:
        fourcc, size = _read_chunk_header(f)
        at = f.tell()
        if fourcc == b"LIST":
            if f.read(4) == b"rec ":
                yield from _movi_chunks(f, at + size, ids)
        elif fourcc in ids and size > 0:
            yield f.read(size)
        f.seek(at + size + (size & 1))


def _riff_movi(f: BinaryIO, end: int, ids) -> Iterator[bytes]:
    """The frame chunks of every `movi` list of one RIFF."""
    while f.tell() + 8 <= end:
        fourcc, size = _read_chunk_header(f)
        at = f.tell()
        if fourcc == b"LIST" and f.read(4) == b"movi":
            yield from _movi_chunks(f, min(at + size, end), ids)
        f.seek(at + size + (size & 1))


def avi_frames(path: str, info: AviInfo = None) -> Iterator[bytes]:
    """The JPEG bytes of each frame of the video stream, in order."""
    path = os.fspath(path)
    info = info or avi_info(path)
    ids = (f"{info.stream:02d}dc".encode(), f"{info.stream:02d}db".encode())
    with open(path, "rb") as f:
        total = os.fstat(f.fileno()).st_size
        pos = 0
        while pos + 12 <= total:
            f.seek(pos)
            riff, size = _read_chunk_header(f)
            kind = f.read(4)
            if riff != b"RIFF" or kind not in (b"AVI ", b"AVIX"):
                break
            end = min(pos + 8 + size, total)
            yield from _riff_movi(f, end, ids)
            pos = pos + 8 + size + (size & 1)


class _JpegFrames:
    """Motion-JPEG chunks -> BGR frames."""

    def __init__(self, path: str):
        self.path, self.n = path, 0

    def decode(self, data: bytes) -> List[np.ndarray]:
        img = decode_jpeg(data, f"{self.path} frame {self.n}")
        self.n += 1
        return [img]

    def flush(self) -> List[np.ndarray]:
        return []


class _Mpeg4Frames:
    """MPEG-4 chunks/samples -> BGR frames; the pictures of the first
    `skip` samples (before an MP4 edit list's start) are decoded but not
    shown, as FFmpeg's demuxer discards them."""

    def __init__(self, path: str, config: bytes, fourcc: str, skip: int):
        from .mpeg4 import Mpeg4Decoder
        self.dec = Mpeg4Decoder(path, config, fourcc)
        self.skip = skip

    def _show(self, planes) -> List[np.ndarray]:
        from .mpeg4 import yuv420_to_bgr
        return [] if planes is None else [yuv420_to_bgr(*planes)]

    def decode(self, data: bytes) -> List[np.ndarray]:
        planes = self.dec.decode(data)
        if self.skip:
            self.skip -= 1
            return []
        return self._show(planes)

    def flush(self) -> List[np.ndarray]:
        return self._show(self.dec.flush())


class _H264Frames:
    """H.264 samples, chunks or pieces of an Annex B stream -> BGR
    frames; the first `skip` pictures (before an MP4 edit list's start)
    are decoded but not shown, as FFmpeg's demuxer discards them."""

    def __init__(self, path: str, nal_length_size: int, config: bytes,
                 size: Tuple[int, int], skip: int):
        from .h264 import H264Decoder
        self.dec = H264Decoder(path, nal_length_size, config, size)
        self.skip = skip

    def _show(self, pictures) -> List[np.ndarray]:
        out = []
        for planes in pictures:
            if self.skip:
                self.skip -= 1
                continue
            out.append(self.dec.to_bgr(planes))
        return out

    def decode(self, data: bytes) -> List[np.ndarray]:
        return self._show(self.dec.decode(data))

    def flush(self) -> List[np.ndarray]:
        return self._show(self.dec.flush())


def is_annexb(head: bytes) -> bool:
    """Whether `head` starts an H.264 Annex B byte stream: a start code,
    then an access unit delimiter, SPS or SEI NAL unit."""
    for sc in (b"\0\0\0\1", b"\0\0\1"):
        if head.startswith(sc) and len(head) > len(sc):
            nal = head[len(sc)]
            return not nal & 0x80 and (nal & 31) in (6, 7, 9)
    return False


@dataclass
class VideoStream:
    """A video file's first video stream: `container` "avi", "mp4" or
    "h264" (a raw Annex B stream), `codec` "mjpeg", "mpeg4" or "h264",
    its size and frame rate."""
    path: str
    container: str
    codec: str
    width: int
    height: int
    fps: float
    avi: Optional[AviInfo] = None
    mp4: Optional[object] = None   # data.mp4.Mp4Info

    def packets(self) -> Iterator[bytes]:
        """The stream's chunks (AVI), samples (MP4) or, for a raw stream,
        pieces of about 1 MiB cut between NAL units, in order."""
        if self.container == "avi":
            return avi_frames(self.path, self.avi)
        if self.container == "h264":
            return _annexb_pieces(self.path)
        from .mp4 import mp4_samples
        return mp4_samples(self.path, self.mp4)

    def decoder(self):
        """A decoder of `packets()`: `.decode(packet)` and, at the end,
        `.flush()` give lists of (H, W, 3) uint8 BGR frames."""
        if self.codec == "mjpeg":
            return _JpegFrames(self.path)
        size = (self.width, self.height)
        if self.codec == "h264":
            if self.container == "mp4":
                return _H264Frames(self.path, self.mp4.nal_length_size,
                                   self.mp4.config, size, self.mp4.skip)
            return _H264Frames(self.path, 0, b"",
                               size if self.container == "avi" else (0, 0),
                               0)
        if self.container == "avi":
            return _Mpeg4Frames(self.path, b"", self.avi.fourcc, 0)
        return _Mpeg4Frames(self.path, self.mp4.config, "", self.mp4.skip)


def _annexb_pieces(path: str) -> Iterator[bytes]:
    from .h264 import annexb_chunks
    with open(path, "rb") as f:
        yield from annexb_chunks(f)


def open_video(path: str) -> VideoStream:
    """The video stream of the AVI, MP4/M4V/MOV or raw H.264 file at
    `path` (told apart by the file's bytes); raises `VideoError` naming
    the file for any other file, container or codec."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        head = f.read(12)
        if is_annexb(head):
            from .h264 import probe_size
            w, h = probe_size(path, head + f.read(1 << 16))
            return VideoStream(path, "h264", "h264", w, h, ANNEXB_FPS)
    if head[4:8] == b"ftyp":
        from .mp4 import mp4_info
        info = mp4_info(path)
        return VideoStream(path, "mp4", info.codec, info.width, info.height,
                           info.fps, mp4=info)
    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        info = avi_info(path)
        return VideoStream(path, "avi", info.codec, info.width, info.height,
                           info.fps, avi=info)
    raise VideoError(f"{path}: neither an AVI, an MP4/QuickTime file nor an "
                     "H.264 Annex B stream; only Motion-JPEG AVI, MPEG-4 "
                     "Part 2 in AVI or MP4, and H.264 in AVI, MP4 or Annex B "
                     "are read")


def read_video(path: str, max_frames: int = 0
               ) -> Iterator[Tuple[int, np.ndarray]]:
    """(frame index, (H, W, 3) uint8 BGR) for each frame of the video at
    `path` (at most `max_frames` when > 0); a frame the decoder refuses
    raises (`images.ImageError` or `VideoError`) naming the file and the
    frame."""
    stream = open_video(path)
    dec = stream.decoder()
    i = 0
    for data in stream.packets():
        for img in dec.decode(data):
            if max_frames and i >= max_frames:
                return
            yield i, img
            i += 1
    for img in dec.flush():
        if max_frames and i >= max_frames:
            return
        yield i, img
        i += 1
