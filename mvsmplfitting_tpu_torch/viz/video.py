"""Video export of per-frame overlays (port of `viz/video.py`; the
reference's cv2 video writer, `module_utils.py:621`).

There is no MPEG-4 encoder without OpenCV, so the port always writes
what JAX writes on an OpenCV build without the `mp4v` codec
(`video.py:24-26`): Motion-JPEG frames (`data/images.py:encode_jpeg`,
quality 95) in an AVI (RIFF) file at the `.avi` name, with an `idx1`
index of key frames.
"""

from __future__ import annotations

import os
import struct
from typing import Sequence

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


def avi_mjpeg(frames: Sequence[bytes], width: int, height: int,
              fps: float) -> bytes:
    """An AVI file holding the JPEG `frames` as one MJPG video stream."""
    scale, rate = _rate(fps)
    n = len(frames)
    biggest = max(len(f) for f in frames)
    avih = struct.pack("<14I", int(round(1e6 / fps)), 0, 0, AVIF_HASINDEX,
                       n, 0, 1, biggest, width, height, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"MJPG", 0, 0, 0, 0,
                       scale, rate, 0, n, biggest, 0xFFFFFFFF, 0, 0, 0,
                       width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, b"MJPG",
                       width * height * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))
    movi, index = [], []
    offset = 4                    # from the 'movi' fourcc to the chunk
    for f in frames:
        index.append(struct.pack("<4sIII", b"00dc", AVIIF_KEYFRAME, offset,
                                 len(f)))
        c = _chunk(b"00dc", f)
        movi.append(c)
        offset += len(c)
    body = hdrl + _list(b"movi", b"".join(movi)) + _chunk(
        b"idx1", b"".join(index))
    return b"RIFF" + struct.pack("<I", len(body) + 4) + b"AVI " + body


def export_video(frame_paths: Sequence[str], out_path: str,
                 fps: float = 30.0) -> str:
    """Stitch overlay images into a Motion-JPEG AVI at `out_path` with its
    extension replaced by `.avi`; frames of another size than the first
    are resized as `cv2.resize(img, (w, h))` resizes them.  Returns the
    path written."""
    if not frame_paths:
        raise ValueError("no frames to export")
    first = read_image(frame_paths[0])
    h, w = first.shape[:2]
    out_path = os.path.splitext(out_path)[0] + ".avi"
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    frames = []
    for i, p in enumerate(frame_paths):
        img = first if i == 0 else read_image(p)
        if img.shape[:2] != (h, w):
            img = resize_linear_u8(torch.from_numpy(img), w, h).numpy()
        frames.append(encode_jpeg(img, JPEG_QUALITY))
    with open(out_path, "wb") as f:
        f.write(avi_mjpeg(frames, w, h, fps))
    return out_path
