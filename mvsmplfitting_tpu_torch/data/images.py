"""Image reading without OpenCV: `read_image(path)` as `cv2.imread(path)`.

The JAX pipeline reads its camera images with `cv2.imread`
(`detect/predictor.py:305-307`); the port runs where neither OpenCV nor
Pillow is installed, so it decodes the two formats the reference's
cameras and tools write itself, to the bytes `cv2.imread` (with its
default `IMREAD_COLOR`) returns: an (H, W, 3) uint8 BGR array.

* JPEG: baseline (sequential Huffman, 8-bit) files, gray or three
  components, any integral chroma subsampling, restart intervals,
  decoded by `csrc/image_decode.cpp`, which repeats libjpeg's default
  decompression in the same integer arithmetic (islow IDCT, fancy
  upsampling, fixed-point YCbCr -> BGR).  The EXIF orientation tag is
  applied, as `imread` does.  Progressive, lossless, arithmetic-coded
  and 12-bit files raise `ImageError` naming the file.
* PNG: non-interlaced gray, gray+alpha, RGB, RGBA and palette images at
  every bit depth; zlib through Python's `zlib`, the row filters in
  `csrc/image_decode.cpp`; alpha is dropped, 16-bit samples keep their
  high byte and 1/2/4-bit gray scales to 0-255, as `IMREAD_COLOR` does.
  Interlaced files and PNGs with an EXIF orientation other than 1 raise.

The host library is built with g++ at first use into `build/host/` at
the repository root (listed in `.gitignore`), named by a hash of its
source and flags; a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np

from ..utils.host_build import HostLibrary


class ImageError(ValueError):
    """An image that `read_image` cannot or will not decode."""


def _declare_decode(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.jpeg_info.argtypes = [u8p, ctypes.c_size_t, ip, ip, ip,
                              ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_decode_bgr.argtypes = [u8p, ctypes.c_size_t, u8p,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_int]
    lib.png_unfilter.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_char_p,
                                 ctypes.c_int]
    for f in (lib.jpeg_info, lib.jpeg_decode_bgr, lib.png_unfilter):
        f.restype = ctypes.c_int


_DECODER = HostLibrary("image_decode", _declare_decode)
SOURCE = _DECODER.source


def library_path() -> Path:
    return _DECODER.path()


def load_library() -> ctypes.CDLL:
    """The decoder library, built on first use."""
    return _DECODER.load()


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _err_buf():
    return ctypes.create_string_buffer(512)


# ---- EXIF orientation ------------------------------------------------------

def exif_orientation(tiff: bytes) -> int:
    """The Orientation tag (0x0112) of an EXIF TIFF block, 1 if absent."""
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    (ifd,) = struct.unpack(e + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (count,) = struct.unpack(e + "H", tiff[ifd:ifd + 2])
    for i in range(count):
        entry = tiff[ifd + 2 + 12 * i: ifd + 14 + 12 * i]
        if len(entry) < 12:
            break
        tag, typ, _ = struct.unpack(e + "HHI", entry[:8])
        if tag == 0x0112 and typ == 3:
            (val,) = struct.unpack(e + "H", entry[8:10])
            return int(val)
    return 1


def _jpeg_exif(data: bytes) -> bytes:
    """The TIFF block of a JPEG's first APP1 "Exif" segment, or b""."""
    p = 2
    while p + 4 <= len(data):
        if data[p] != 0xFF:
            return b""
        marker = data[p + 1]
        if marker == 0xFF:
            p += 1
            continue
        if marker in (0xDA, 0xD9):
            return b""
        (length,) = struct.unpack(">H", data[p + 2:p + 4])
        body = data[p + 4:p + 2 + length]
        if marker == 0xE1 and body[:6] == b"Exif\0\0":
            return body[6:]
        p += 2 + length
    return b""


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """The EXIF orientation transform, as OpenCV's `imread` applies it."""
    if orientation == 2:
        img = img[:, ::-1]
    elif orientation == 3:
        img = img[::-1, ::-1]
    elif orientation == 4:
        img = img[::-1]
    elif orientation == 5:
        img = img.transpose(1, 0, 2)
    elif orientation == 6:
        img = img.transpose(1, 0, 2)[:, ::-1]
    elif orientation == 7:
        img = img.transpose(1, 0, 2)[::-1, ::-1]
    elif orientation == 8:
        img = img.transpose(1, 0, 2)[::-1]
    return np.ascontiguousarray(img)


# ---- JPEG ------------------------------------------------------------------

def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    lib = load_library()
    buf = np.frombuffer(data, np.uint8)
    w, h, nc = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _err_buf()
    if lib.jpeg_info(_ptr(buf), buf.size, ctypes.byref(w), ctypes.byref(h),
                     ctypes.byref(nc), err, len(err)):
        raise ImageError(f"{name}: {err.value.decode()}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.jpeg_decode_bgr(_ptr(buf), buf.size, _ptr(out), w.value, h.value,
                           err, len(err)):
        raise ImageError(f"{name}: {err.value.decode()}")
    return apply_orientation(out, exif_orientation(_jpeg_exif(data)))


# ---- PNG -------------------------------------------------------------------

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    if not data.startswith(PNG_SIGNATURE):
        raise ImageError(f"{name}: not a PNG file")
    p = len(PNG_SIGNATURE)
    header, palette, idat, exif = None, None, [], b""
    while p + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[p:p + 8])
        body = data[p + 8:p + 8 + length]
        if len(body) < length:
            raise ImageError(f"{name}: truncated {ctype!r} chunk")
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"eXIf":
            exif = body
        elif ctype == b"IEND":
            break
        p += 12 + length
    if header is None:
        raise ImageError(f"{name}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if interlace:
        raise ImageError(f"{name}: interlaced PNG is not supported")
    if color not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ImageError(f"{name}: bad PNG color type {color} / depth "
                         f"{depth}")
    if exif and exif_orientation(exif) != 1:
        raise ImageError(f"{name}: PNG with an EXIF orientation other than "
                         "1 is not supported")
    ch = _CHANNELS[color]
    bits = ch * depth
    rowbytes = (width * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (rowbytes + 1):
        raise ImageError(f"{name}: image data too short")
    raw = np.ascontiguousarray(raw[:height * (rowbytes + 1)])
    rows = np.empty((height, rowbytes), np.uint8)
    err = _err_buf()
    if load_library().png_unfilter(_ptr(raw), _ptr(rows), height, rowbytes,
                                   max(1, bits // 8), err, len(err)):
        raise ImageError(f"{name}: {err.value.decode()}")
    if depth == 16:
        samples = rows.reshape(height, width * ch, 2)[..., 0]  # high byte
    elif depth == 8:
        samples = rows
    else:
        samples = np.unpackbits(rows, axis=1)
        samples = samples.reshape(height, rowbytes * 8 // depth, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (samples * weights).sum(-1).astype(np.uint8)[:, :width]
        if color == 0:
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
    samples = samples.reshape(height, width, ch)
    if color == 3:
        if palette is None:
            raise ImageError(f"{name}: palette image without PLTE")
        rgb = palette[np.minimum(samples[..., 0], len(palette) - 1)]
    elif color in (0, 4):
        rgb = np.repeat(samples[..., :1], 3, axis=2)
    else:
        rgb = samples[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def read_image(path: str) -> np.ndarray:
    """The image at `path` as (H, W, 3) uint8 BGR, as `cv2.imread(path)`
    returns it; raises `ImageError` naming the file where the format is
    not supported."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data, path)
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data, path)
    raise ImageError(f"{path}: neither a JPEG nor a PNG file")


def image_hw(path) -> Tuple[int, int]:
    """(height, width) of the image `read_image` gives for `path`, from
    the file's headers alone: a JPEG's SOF segment turned by its EXIF
    orientation as the reader turns the pixels (5-8 swap the sides), a
    PNG's IHDR.  Raises `ImageError` where no size is found."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        head = f.read(24)
        if head.startswith(PNG_SIGNATURE) and head[12:16] == b"IHDR":
            w, h = struct.unpack(">II", head[16:24])
            return int(h), int(w)
        if head[:2] != b"\xff\xd8":
            raise ImageError(f"{path}: neither a JPEG nor a PNG file")
        f.seek(2)
        exif, size = None, None
        while True:
            marker = f.read(2)
            if len(marker) < 2 or marker[0] != 0xFF:
                break
            code = marker[1]
            if code == 0xFF:
                f.seek(-1, os.SEEK_CUR)
                continue
            if code in (0xD8, 0x01) or 0xD0 <= code <= 0xD7:
                continue
            if code in (0xDA, 0xD9):
                break
            (length,) = struct.unpack(">H", f.read(2))
            body = f.read(length - 2)
            if code == 0xE1 and exif is None and body[:6] == b"Exif\0\0":
                exif = body[6:]         # the first, as `_jpeg_exif` takes
            elif (size is None and 0xC0 <= code <= 0xCF
                  and code not in (0xC4, 0xC8, 0xCC)):
                size = struct.unpack(">HH", body[1:5])
    if size is None:
        raise ImageError(f"{path}: no JPEG frame header")
    orientation = exif_orientation(exif) if exif else 1
    h, w = size
    return (w, h) if orientation in (5, 6, 7, 8) else (h, w)


# ---- JPEG writing ----------------------------------------------------------

def _declare_encode(lib: ctypes.CDLL) -> None:
    lib.jpeg_encode_bgr.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.c_int64]
    lib.jpeg_encode_bgr.restype = ctypes.c_int64


_ENCODER = HostLibrary("jpeg_encode", _declare_encode)
JPEG_EXTENSIONS = (".jpg", ".jpeg")


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """`cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])`'s
    bytes for an (H, W, 3) uint8 BGR image (`csrc/jpeg_encode.cpp`)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("encode_jpeg takes an (H, W, 3) uint8 BGR image, "
                         f"got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    if not (0 < h <= 65535 and 0 < w <= 65535):
        raise ValueError(f"encode_jpeg: image size {w}x{h} outside JPEG's "
                         "1-65535")
    lib = _ENCODER.load()
    cap = h * w + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode_bgr(_ptr(img), w, h, int(quality), _ptr(out), cap)
        if n <= cap:
            return out[:n].tobytes()
        cap = n


def write_image(path: str, img: np.ndarray, quality: int = 95) -> None:
    """`cv2.imwrite(path, img)` for `.jpg`/`.jpeg` paths (the same bytes;
    `quality` as `IMWRITE_JPEG_QUALITY`); any other extension raises
    `ImageError` naming the file."""
    path = os.fspath(path)
    if os.path.splitext(path)[1].lower() not in JPEG_EXTENSIONS:
        raise ImageError(f"{path}: only JPEG (.jpg, .jpeg) is written")
    data = encode_jpeg(img, quality)
    with open(path, "wb") as f:
        f.write(data)
