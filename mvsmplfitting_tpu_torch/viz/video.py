"""Video export of per-frame overlays (port of `viz/video.py`; the
reference's cv2 video writer, `module_utils.py:621`).

JAX opens `cv2.VideoWriter(path, fourcc "mp4v")` and falls back to
Motion-JPEG at the `.avi` name when that does not open
(`video.py:24-26`, `detect/stream.py:75-78`).  The port writes what
this does with OpenCV 5.0.0 and its FFmpeg (`writer_target`):
* `.mp4`, `.m4v`, `.m4a` and `.mov` (any case): MPEG-4 Part 2 Simple
  Profile (`data/mpeg4.py:Mpeg4Encoder`) in an ISO base media file at
  that name, brand `isom`, `M4V ` or `qt  ` (`data/mp4.py:Mp4Writer`);
* `.avi`: the same video in an AVI with fourcc `mp4v` (the stream
  header's handler and the bitmap header's compression), the headers in
  the first chunk, the I-VOPs marked as key frames;
* the extensions where cv2 writes MPEG-4 into a container the port has
  no muxer for (`NO_MUXER`: Matroska, 3GPP, MPEG-PS/TS, ASF, ...):
  `VideoError` naming the container, rather than another file;
* any other name (`.webm`, unknown extensions, none), where cv2's
  `mp4v` writer does not open: Motion-JPEG frames
  (`data/images.py:encode_jpeg`, quality 95) in an AVI at the `.avi`
  name, JAX's fallback.
As cv2 does, an MPEG-4 video of an odd width or height is one pixel
narrower or shorter: the frames' last column or row is dropped.
`AviWriter` appends frame by frame and patches the header at close, so
a long stream is never held in memory; `VideoWriter` is the streaming
CLI's `cv2.VideoWriter`.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Sequence

import numpy as np
import torch

from ..data.images import encode_jpeg, read_image
from ..data.mp4 import BRANDS, Mp4Writer
from ..data.video import VideoError
from ..detect.preprocess import resize_linear_u8

AVIF_HASINDEX = 0x10
AVIIF_KEYFRAME = 0x10
JPEG_QUALITY = 95
# Extensions at which cv2's `mp4v` writer opens a container the port has
# no muxer for (probed with OpenCV 5.0.0 / libavformat 62.12.101).
NO_MUXER = {".mkv": "Matroska", ".mka": "Matroska", ".3gp": "3GPP",
            ".3g2": "3GPP2", ".mpg": "MPEG program stream",
            ".mpeg": "MPEG program stream", ".vob": "MPEG program stream",
            ".ts": "MPEG transport stream", ".m2ts": "MPEG transport stream",
            ".mts": "MPEG transport stream", ".wmv": "ASF", ".asf": "ASF",
            ".nut": "NUT", ".rm": "RealMedia", ".ismv": "ISMV",
            ".isma": "ISMV", ".yuv": "raw MPEG-4 video", ".wtv": "WTV"}


def writer_target(path: str):
    """(container, codec, path) that cv2's `mp4v` writer (and JAX's
    fallback) gives the name `path`: ("mp4", "mpeg4", path), ("avi",
    "mpeg4", path) or ("avi", "mjpeg", the `.avi` name); raises
    `VideoError` where cv2 would write a container the port has no
    muxer for."""
    ext = os.path.splitext(path)[1].lower()
    if ext in BRANDS:
        return "mp4", "mpeg4", path
    if ext == ".avi":
        return "avi", "mpeg4", path
    if ext in NO_MUXER:
        raise VideoError(f"{path}: cv2 writes MPEG-4 in {NO_MUXER[ext]} at "
                         f"this name; there is no {NO_MUXER[ext]} muxer "
                         "(write .mp4, .m4v, .mov or .avi)")
    return "avi", "mjpeg", os.path.splitext(path)[0] + ".avi"


def _chunk(fourcc: bytes, data: bytes) -> bytes:
    pad = b"\0" if len(data) % 2 else b""
    return fourcc + struct.pack("<I", len(data)) + data + pad


def _list(kind: bytes, data: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", len(data) + 4) + kind + data


def _rate(fps: float):
    """(scale, rate) with rate / scale == fps."""
    if float(fps).is_integer():
        return 1, int(fps)
    return 1000, int(round(fps * 1000))


def _headers(width: int, height: int, fps: float, n: int,
             biggest: int, fourcc: bytes = b"MJPG") -> bytes:
    """RIFF header, `hdrl` and the `movi` list's header for `n` frames
    whose largest is `biggest` bytes; the sizes are patched at close."""
    scale, rate = _rate(fps)
    avih = struct.pack("<14I", int(round(1e6 / fps)), 0, 0, AVIF_HASINDEX,
                       n, 0, 1, biggest, width, height, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", fourcc, 0, 0, 0, 0,
                       scale, rate, 0, n, biggest, 0xFFFFFFFF, 0, 0, 0,
                       width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, fourcc,
                       width * height * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    return (b"RIFF" + struct.pack("<I", 0) + b"AVI " + hdrl + b"LIST"
            + struct.pack("<I", 0) + b"movi")


class AviWriter:
    """An AVI of one video stream (`fourcc` b"MJPG" or b"mp4v") written
    as frames come: each `write(data, key)` appends one `00dc` chunk to
    the file; `close()` appends the `idx1` index (16 bytes a frame, the
    only per-frame state kept) and patches the sizes and frame counts of
    the header.  AVI 1.0: a file past 4 GiB raises (there is no OpenDML
    `AVIX` writer)."""

    def __init__(self, out: BinaryIO, width: int, height: int, fps: float,
                 fourcc: bytes = b"MJPG"):
        self.out, self.width, self.height, self.fps = out, width, height, fps
        self.fourcc = fourcc
        self.start = out.tell()
        head = _headers(width, height, fps, 0, 0, fourcc)
        out.write(head)
        self.movi_at = self.start + len(head) - 8   # the movi list's size
        self.index = bytearray()
        self.offset = 4           # from the 'movi' fourcc to the chunk
        self.frames = 0
        self.biggest = 0

    def write(self, data: bytes, key: bool = True) -> None:
        c = _chunk(b"00dc", data)
        if self.offset + len(c) + 16 * (self.frames + 1) > 0xFFFFFFF0:
            raise ValueError("AviWriter: the AVI 1.0 file would pass 4 GiB")
        self.out.write(c)
        self.index += struct.pack("<4sIII", b"00dc",
                                  AVIIF_KEYFRAME if key else 0,
                                  self.offset, len(data))
        self.offset += len(c)
        self.frames += 1
        self.biggest = max(self.biggest, len(data))

    def close(self) -> None:
        out = self.out
        out.write(_chunk(b"idx1", bytes(self.index)))
        end = out.tell()
        head = _headers(self.width, self.height, self.fps, self.frames,
                        self.biggest, self.fourcc)
        out.seek(self.start)
        out.write(head)
        out.seek(self.start + 4)
        out.write(struct.pack("<I", end - self.start - 8))
        out.seek(self.movi_at)
        out.write(struct.pack("<I", self.offset))
        out.seek(end)


class VideoWriter:
    """`cv2.VideoWriter`'s role for the streaming CLI (JAX's
    `detect/stream.py:open_video_writer`): BGR frames of one size written
    frame by frame at the name and in the container and codec
    `writer_target` gives `path` (`self.path` is the file written)."""

    def __init__(self, path: str, fps: float, size_wh):
        self.container, self.codec, self.path = writer_target(path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self.size_wh = tuple(int(v) for v in size_wh)
        w, h = self.size_wh
        if self.codec == "mpeg4":
            from ..data.mpeg4 import Mpeg4Encoder
            w, h = w & ~1, h & ~1
            if w <= 0 or h <= 0:
                raise ValueError(f"{self.path}: a {self.size_wh[0]}x"
                                 f"{self.size_wh[1]} MPEG-4 video")
            self.encoder = Mpeg4Encoder(w, h, fps)
        self.video_wh = (w, h)
        self.file = open(self.path, "wb")
        if self.container == "mp4":
            brand = BRANDS[os.path.splitext(self.path)[1].lower()]
            self.mux = Mp4Writer(self.file, brand, w, h, self.encoder.res,
                                 self.encoder.inc, self.encoder.config())
        else:
            self.mux = AviWriter(self.file, w, h, fps,
                                 b"mp4v" if self.codec == "mpeg4" else b"MJPG")
        self.frames = 0

    def write(self, frame: np.ndarray) -> None:
        h, w = frame.shape[:2]
        if (w, h) != self.size_wh:
            raise ValueError(f"{self.path}: frame {w}x{h}, the video is "
                             f"{self.size_wh[0]}x{self.size_wh[1]}")
        if self.codec == "mjpeg":
            self.mux.write(encode_jpeg(frame, JPEG_QUALITY))
        else:
            vw, vh = self.video_wh
            data, key = self.encoder.encode(
                frame[:vh, :vw], with_headers=self.container == "avi"
                and self.frames == 0)
            self.mux.write(data, key)
        self.frames += 1

    def release(self) -> None:
        if not self.file.closed:
            self.mux.close()
            self.file.close()


def export_video(frame_paths: Sequence[str], out_path: str,
                 fps: float = 30.0) -> str:
    """Stitch overlay images into a video at the name, in the container
    and codec that `writer_target(out_path)` gives; frames of another
    size than the first
    are resized as `cv2.resize(img, (w, h))` resizes them, and a missing
    frame after the first is skipped, as JAX skips the None that
    `cv2.imread` gives it.  A missing first frame, and a file the reader
    refuses, raise.  Returns the path written."""
    if not frame_paths:
        raise ValueError("no frames to export")
    first = read_image(frame_paths[0])
    h, w = first.shape[:2]
    writer = VideoWriter(out_path, fps, (w, h))
    try:
        for i, p in enumerate(frame_paths):
            try:
                img = first if i == 0 else read_image(p)
            except FileNotFoundError:
                continue
            if img.shape[:2] != (h, w):
                img = resize_linear_u8(torch.from_numpy(img), w, h).numpy()
            writer.write(img)
    finally:
        writer.release()
    return writer.path
