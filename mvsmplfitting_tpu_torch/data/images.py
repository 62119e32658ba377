"""Image reading without OpenCV: `read_image(path)` as `cv2.imread(path)`.

The JAX pipeline reads every image with `cv2.imread` (the keypoint CLI,
the folder-of-frames source, the training datasets, the overlays and
the GUI); the port runs where neither OpenCV nor Pillow is installed, so
it decodes the formats below itself, to the bytes `cv2.imread` (with its
default `IMREAD_COLOR`) returns: an (H, W, 3) uint8 BGR array.  The
format is found from the file's first bytes, not its name, as `imread`
finds it.

* JPEG: baseline and progressive (Huffman, 8-bit) files, gray or three
  components, any integral chroma subsampling, restart intervals,
  decoded by `csrc/image_decode.cpp`, which repeats libjpeg's default
  decompression in the same integer arithmetic (islow IDCT, fancy
  upsampling, fixed-point YCbCr -> BGR); a progressive file's scans are
  gathered into whole-image coefficients first.  The EXIF orientation
  tag is applied, as `imread` does.  Refused, naming the file:
  lossless, hierarchical, arithmetic-coded and 12-bit files, CMYK/YCCK
  (four components), files of more than one frame, and progressive
  files that leave a coefficient unsent or unrefined (libjpeg would
  smooth their blocks).
* PNG: gray, gray+alpha, RGB, RGBA and palette images at every bit
  depth, plain or Adam7-interlaced (each pass unfiltered on its own);
  zlib through Python's `zlib`, the row filters in
  `csrc/image_decode.cpp`; alpha is dropped, 16-bit samples keep their
  high byte and 1/2/4-bit gray scales to 0-255, as `IMREAD_COLOR` does.
  An eXIf chunk's orientation is applied, as for JPEG.
* BMP (`decode_bmp`, numpy: the work is reshaping rows and looking up
  tables, which numpy does whole): BITMAPINFOHEADER and the V2-V5
  headers, 1/4/8-bit palettes, 16 bits (5-5-5, or 5-6-5 bit fields
  after a BITMAPINFOHEADER), 24 and 32 bits, 32-bit bit fields of whole
  bytes, bottom-up and top-down rows.  Refused, naming the file: RLE4
  and RLE8, other bit fields, OS/2 headers.
* Every other format (WebP, TIFF, GIF, ...) raises `ImageError` naming
  the file.

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
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))   # x0, y0, dx, dy


def _png_chunks(data: bytes, name: str):
    """(IHDR fields, PLTE (N, 3) or None, the IDAT bytes, the first eXIf
    body or b"")."""
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
        elif ctype == b"eXIf" and not exif:
            exif = body
        elif ctype == b"IEND":
            break
        p += 12 + length
    if header is None:
        raise ImageError(f"{name}: no IHDR chunk")
    return header, palette, b"".join(idat), exif


def _png_pass(raw: np.ndarray, width: int, height: int, depth: int,
              ch: int, name: str) -> np.ndarray:
    """One image (or one Adam7 pass) of filtered rows -> (height, width,
    ch) uint8 samples: 16-bit samples keep their high byte, sub-byte
    ones are unpacked (not yet scaled)."""
    bits = ch * depth
    rowbytes = (width * bits + 7) // 8
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
    return samples.reshape(height, width, ch)


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    header, palette, idat, exif = _png_chunks(data, name)
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ImageError(f"{name}: bad PNG color type {color} / depth "
                         f"{depth}")
    if interlace not in (0, 1):
        raise ImageError(f"{name}: unknown PNG interlace method {interlace}")
    ch = _CHANNELS[color]
    bits = ch * depth
    # Adam7's passes each hold every dy-th row from y0 and every dx-th
    # column from x0, filtered on their own; an empty pass has no bytes.
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [((width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy)
             for x0, y0, dx, dy in passes]
    sizes = [(w, h) if w > 0 and h > 0 else (0, 0) for w, h in sizes]
    need = sum(h * ((w * bits + 7) // 8 + 1) for w, h in sizes)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size < need:
        raise ImageError(f"{name}: image data too short")
    samples = np.empty((height, width, ch), np.uint8)
    at = 0
    for (x0, y0, dx, dy), (w, h) in zip(passes, sizes):
        if not w:
            continue
        n = h * ((w * bits + 7) // 8 + 1)
        samples[y0::dy, x0::dx] = _png_pass(
            np.ascontiguousarray(raw[at:at + n]), w, h, depth, ch, name)
        at += n
    if depth < 8 and color == 0:
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    if color == 3:
        if palette is None:
            raise ImageError(f"{name}: palette image without PLTE")
        rgb = palette[np.minimum(samples[..., 0], len(palette) - 1)]
    elif color in (0, 4):
        rgb = np.repeat(samples[..., :1], 3, axis=2)
    else:
        rgb = samples[..., :3]
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    return apply_orientation(bgr, exif_orientation(exif)) if exif else bgr


# ---- BMP -------------------------------------------------------------------

BMP_HEADERS = {40: "BITMAPINFOHEADER", 52: "BITMAPV2INFOHEADER",
               56: "BITMAPV3INFOHEADER", 108: "BITMAPV4HEADER",
               124: "BITMAPV5HEADER"}
BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3
_BMP_555 = (0x7C00, 0x3E0, 0x1F)
_BMP_565 = (0xF800, 0x7E0, 0x1F)


def _bmp_header(data: bytes, name: str):
    """(pixel data offset, header size, width, height, bits a pixel,
    compression, colors used) of a BMP file, its header checked."""
    if len(data) < 30 or data[:2] != b"BM":
        raise ImageError(f"{name}: not a BMP file")
    off, hsize = struct.unpack("<II", data[10:18])
    if hsize not in BMP_HEADERS:
        raise ImageError(f"{name}: BMP header of {hsize} bytes is not "
                         "supported (BITMAPINFOHEADER, V2-V5 only)")
    if len(data) < 14 + hsize:
        raise ImageError(f"{name}: truncated BMP header")
    width, height, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
    (used,) = struct.unpack("<I", data[46:50])
    if comp in (BI_RLE8, BI_RLE4):
        raise ImageError(f"{name}: RLE-compressed BMP is not supported")
    if comp not in (BI_RGB, BI_BITFIELDS) or bpp not in (1, 4, 8, 16, 24,
                                                         32):
        raise ImageError(f"{name}: BMP with {bpp} bits a pixel and "
                         f"compression {comp} is not supported")
    if comp == BI_BITFIELDS and bpp not in (16, 32):
        raise ImageError(f"{name}: bit fields at {bpp} bits a pixel")
    if width <= 0 or height == 0:
        raise ImageError(f"{name}: bad BMP size {width}x{height}")
    return off, hsize, width, height, bpp, comp, used


def decode_bmp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A BMP as (H, W, 3) uint8 BGR, as `cv2.imread` gives it: rows
    bottom-up for a positive height and top-down for a negative one,
    each padded to 4 bytes; 1/4/8-bit palette indices (entries past the
    palette are black), 24-bit BGR, 32-bit BGRx, 16 bits as 5-5-5 or
    5-6-5 shifted up (OpenCV does not repeat the high bits), and 32-bit
    bit fields behind a V3-V5 header where each mask is one byte.
    RLE4/RLE8 and other bit fields raise `ImageError`."""
    off, hsize, width, height, bpp, comp, used = _bmp_header(data, name)
    h = abs(height)
    stride = (width * bpp + 31) // 32 * 4
    if off < 14 + hsize or off + stride * h > len(data):
        raise ImageError(f"{name}: truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * h, off).reshape(h, stride)
    if height > 0:
        rows = rows[::-1]
    if bpp <= 8:
        n = 1 << bpp
        start = 14 + hsize
        count = min(used or n, n, (off - start) // 4)
        palette = np.zeros((n, 3), np.uint8)
        palette[:count] = np.frombuffer(data, np.uint8, 4 * count,
                                        start).reshape(count, 4)[:, :3]
        idx = np.unpackbits(rows, axis=1).reshape(h, stride * 8 // bpp, bpp)
        weights = (1 << np.arange(bpp - 1, -1, -1)).astype(np.int64)
        idx = (idx * weights).sum(-1)[:, :width]
        return palette[idx]
    if bpp == 24:
        return np.ascontiguousarray(rows[:, :3 * width].reshape(h, width, 3))
    if bpp == 16:
        masks = _BMP_555
        if comp == BI_BITFIELDS:
            masks = struct.unpack("<III", data[54:66]) if hsize == 40 else ()
            if masks not in (_BMP_555, _BMP_565):
                raise ImageError(f"{name}: 16-bit BMP bit fields other than "
                                 "5-5-5 and 5-6-5 after a "
                                 "BITMAPINFOHEADER are not supported")
        t = rows[:, :2 * width].copy().view("<u2").astype(np.int32)
        if masks == _BMP_565:
            g, r = (t >> 3) & 0xFC, (t >> 8) & 0xF8
        else:
            g, r = (t >> 2) & 0xF8, (t >> 7) & 0xF8
        return np.stack([(t << 3) & 0xF8, g, r], -1).astype(np.uint8)
    px = rows[:, :4 * width].reshape(h, width, 4)
    order = [0, 1, 2]
    if comp == BI_BITFIELDS and hsize >= 56:
        masks = struct.unpack("<III", data[54:66])
        if any(masks):
            byte = {0xFF << (8 * k): k for k in range(4)}
            if not all(m in byte for m in masks):
                raise ImageError(f"{name}: 32-bit BMP bit fields other than "
                                 "whole bytes are not supported")
            order = [byte[m] for m in masks[::-1]]       # B, G, R
    return np.ascontiguousarray(px[..., order])


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
    if data[:2] == b"BM":
        return decode_bmp(data, path)
    raise ImageError(f"{path}: not a JPEG, PNG or BMP file")


def _turned(hw: Tuple[int, int], orientation: int) -> Tuple[int, int]:
    h, w = hw
    return (w, h) if orientation in (5, 6, 7, 8) else (h, w)


def image_hw(path) -> Tuple[int, int]:
    """(height, width) of the image `read_image` gives for `path`, from
    the file's headers alone: a JPEG's SOF segment and a PNG's IHDR, each
    turned by its EXIF orientation as the reader turns the pixels (5-8
    swap the sides), a BMP's header (the height's magnitude).  Raises
    `ImageError` where no size is found."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        head = f.read(24)
        if head.startswith(PNG_SIGNATURE) and head[12:16] == b"IHDR":
            w, h = struct.unpack(">II", head[16:24])
            return _turned((int(h), int(w)), _png_orientation(f))
        if head[:2] == b"BM":
            head += f.read(14 + max(BMP_HEADERS) - len(head))
            _, _, w, h, *_ = _bmp_header(head, path)
            return abs(h), w
        if head[:2] != b"\xff\xd8":
            raise ImageError(f"{path}: not a JPEG, PNG or BMP file")
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
    return _turned(size, exif_orientation(exif) if exif else 1)


def _png_orientation(f) -> int:
    """The orientation of a PNG's first eXIf chunk (1 if none), read by
    seeking from chunk to chunk of the open file `f`."""
    f.seek(len(PNG_SIGNATURE))
    while True:
        head = f.read(8)
        if len(head) < 8:
            return 1
        length, ctype = struct.unpack(">I4s", head)
        if ctype == b"IEND":
            return 1
        if ctype == b"eXIf":
            return exif_orientation(f.read(length))
        f.seek(length + 4, os.SEEK_CUR)


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
