"""Video export of per-frame overlays (port of `viz/video.py`; the
reference's cv2 video writer, `module_utils.py:621`).

There is no MPEG-4 encoder without OpenCV, so the port always writes
what JAX writes on an OpenCV build without the `mp4v` codec
(`video.py:24-26`): Motion-JPEG frames (`data/images.py:encode_jpeg`,
quality 95) in an AVI (RIFF) file at the `.avi` name, with an `idx1`
index of key frames.  `MjpegAviWriter` appends frame by frame and
patches the header at close, so a long stream is never held in memory;
`VideoWriter` is the streaming CLI's `cv2.VideoWriter`.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Sequence

import numpy as np
import torch

from ..data.images import encode_jpeg, read_image
from ..detect.preprocess import resize_linear_u8

AVIF_HASINDEX = 0x10
AVIIF_KEYFRAME = 0x10
JPEG_QUALITY = 95


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
             biggest: int) -> bytes:
    """RIFF header, `hdrl` and the `movi` list's header for `n` frames
    whose largest is `biggest` bytes; the sizes are patched at close."""
    scale, rate = _rate(fps)
    avih = struct.pack("<14I", int(round(1e6 / fps)), 0, 0, AVIF_HASINDEX,
                       n, 0, 1, biggest, width, height, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"MJPG", 0, 0, 0, 0,
                       scale, rate, 0, n, biggest, 0xFFFFFFFF, 0, 0, 0,
                       width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG",
                       width * height * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    return (b"RIFF" + struct.pack("<I", 0) + b"AVI " + hdrl + b"LIST"
            + struct.pack("<I", 0) + b"movi")


class MjpegAviWriter:
    """A Motion-JPEG AVI written as frames come: each `write(jpeg)`
    appends one `00dc` chunk to the file; `close()` appends the `idx1`
    index (16 bytes a frame, the only per-frame state kept) and patches
    the sizes and frame counts of the header.  AVI 1.0: a file past 4 GiB
    raises (there is no OpenDML `AVIX` writer)."""

    def __init__(self, out: BinaryIO, width: int, height: int, fps: float):
        self.out, self.width, self.height, self.fps = out, width, height, fps
        self.start = out.tell()
        head = _headers(width, height, fps, 0, 0)
        out.write(head)
        self.movi_at = self.start + len(head) - 8   # the movi list's size
        self.index = bytearray()
        self.offset = 4           # from the 'movi' fourcc to the chunk
        self.frames = 0
        self.biggest = 0

    def write(self, jpeg: bytes) -> None:
        c = _chunk(b"00dc", jpeg)
        if self.offset + len(c) + 16 * (self.frames + 1) > 0xFFFFFFF0:
            raise ValueError("MjpegAviWriter: the AVI 1.0 file would pass "
                             "4 GiB")
        self.out.write(c)
        self.index += struct.pack("<4sIII", b"00dc", AVIIF_KEYFRAME,
                                  self.offset, len(jpeg))
        self.offset += len(c)
        self.frames += 1
        self.biggest = max(self.biggest, len(jpeg))

    def close(self) -> None:
        out = self.out
        out.write(_chunk(b"idx1", bytes(self.index)))
        end = out.tell()
        head = _headers(self.width, self.height, self.fps, self.frames,
                        self.biggest)
        out.seek(self.start)
        out.write(head)
        out.seek(self.start + 4)
        out.write(struct.pack("<I", end - self.start - 8))
        out.seek(self.movi_at)
        out.write(struct.pack("<I", self.offset))
        out.seek(end)


class VideoWriter:
    """`cv2.VideoWriter`'s role for the streaming CLI (JAX's
    `detect/stream.py:open_video_writer`): BGR frames of one size, encoded
    as JPEG (quality 95) into a Motion-JPEG AVI at `path` with its
    extension replaced by `.avi`, frame by frame."""

    def __init__(self, path: str, fps: float, size_wh):
        self.path = os.path.splitext(path)[0] + ".avi"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self.size_wh = tuple(int(v) for v in size_wh)
        self.file = open(self.path, "wb")
        self.avi = MjpegAviWriter(self.file, *self.size_wh, fps)

    def write(self, frame: np.ndarray) -> None:
        h, w = frame.shape[:2]
        if (w, h) != self.size_wh:
            raise ValueError(f"{self.path}: frame {w}x{h}, the video is "
                             f"{self.size_wh[0]}x{self.size_wh[1]}")
        self.avi.write(encode_jpeg(frame, JPEG_QUALITY))

    def release(self) -> None:
        if not self.file.closed:
            self.avi.close()
            self.file.close()


def export_video(frame_paths: Sequence[str], out_path: str,
                 fps: float = 30.0) -> str:
    """Stitch overlay images into a Motion-JPEG AVI at `out_path` with its
    extension replaced by `.avi`; frames of another size than the first
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
