"""Motion-JPEG AVI reading without OpenCV (the video half of JAX's
`detect/stream.py:frame_source`, which reads with `cv2.VideoCapture`).

`avi_info(path)` reads a RIFF/AVI file's headers and refuses, naming the
file and the fourcc, a first video stream that is not Motion-JPEG
(MPEG-4, H.264, ...); `avi_frames(path)` then streams its frames chunk
by chunk, never holding the file: the `##dc`/`##db` chunks of that
stream in the order of the `movi` lists (inside `rec ` lists too), then
those of the OpenDML `AVIX` continuation RIFFs; other streams' chunks,
`JUNK` and index chunks are skipped.  Each frame decodes with
`images.decode_jpeg`, which takes frames without a DHT segment (the
standard tables).  The yardstick is OpenCV's own Motion-JPEG reader
(`cv2.CAP_OPENCV_MJPEG`), which returns `cv2.imdecode` of each chunk;
`cv2.VideoCapture(path)` with OpenCV's default backend decodes through
FFmpeg, whose JPEG decoder rounds otherwise (by up to ~20 levels).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import BinaryIO, Iterator, Tuple

import numpy as np

from .images import decode_jpeg

# The Motion-JPEG fourcc (the stream header's handler or the bitmap
# header's compression, in any case), as OpenCV's own MJPEG reader
# takes it.
MJPEG_FOURCCS = (b"MJPG",)


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
    if handler.upper() not in MJPEG_FOURCCS and \
            compression.upper() not in MJPEG_FOURCCS:
        raise VideoError(
            f"{path}: video codec {_fourcc(handler)!r} (compression "
            f"{_fourcc(compression)!r}) is not supported; only Motion-JPEG "
            "AVI is read")
    scale, rate, _, length = struct.unpack("<IIII", strh[20:36])
    width, height = struct.unpack("<ii", strf[4:12])
    return AviInfo(path, width, abs(height), rate / scale if scale else 0.0,
                   length, stream,
                   _fourcc(compression if compression.upper()
                           in MJPEG_FOURCCS else handler))


def avi_info(path: str) -> AviInfo:
    """The headers of the Motion-JPEG AVI at `path`; raises `VideoError`
    naming the file for anything else."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        head = f.read(12)
        if head[4:8] == b"ftyp":
            raise VideoError(
                f"{path}: an MP4/QuickTime file (brand "
                f"{_fourcc(head[8:12])!r}); only Motion-JPEG AVI is read")
        if head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            raise VideoError(f"{path}: not an AVI (RIFF 'AVI ') file; only "
                             "Motion-JPEG AVI is read")
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


def read_video(path: str, max_frames: int = 0
               ) -> Iterator[Tuple[int, np.ndarray]]:
    """(frame index, (H, W, 3) uint8 BGR) for each frame of the
    Motion-JPEG AVI at `path` (at most `max_frames` when > 0); a frame
    the decoder refuses raises `images.ImageError` naming the file and
    the frame."""
    info = avi_info(path)
    for i, data in enumerate(avi_frames(path, info)):
        if max_frames and i >= max_frames:
            return
        yield i, decode_jpeg(data, f"{path} frame {i}")
