"""H.264 video without FFmpeg: the codec half of what `cv2.VideoCapture`
does for JAX's `detect/stream.py` when a file holds H.264.

`H264Decoder` decodes the access units of an MP4 track (length-prefixed
NAL units after the `avcC` parameter sets), of an AVI stream or of a raw
Annex B stream (`csrc/h264_decode.cpp`: progressive 8-bit 4:2:0
Constrained Baseline, Main and High, I and P slices, CAVLC and CABAC;
the pictures libavcodec's h264 decoder gives, and the BGR of the
swscale conversion OpenCV asks for, `csrc/yuv420_bgr.h`).  The library
builds with g++ at first use (`utils/host_build.py`).  A stream or tool
outside that scope raises `VideoError` naming the file, the frame and
what was refused; libavcodec would conceal errors, this decoder refuses
them.
"""

from __future__ import annotations

import ctypes
from typing import Iterable, List, Tuple

import numpy as np

from ..utils.host_build import HostLibrary
from .video import VideoError

_u8p = ctypes.POINTER(ctypes.c_uint8)
_ERR = 512


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mvsf_h264_new.argtypes = [ci, ci]
    lib.mvsf_h264_new.restype = vp
    lib.mvsf_h264_free.argtypes = [vp]
    lib.mvsf_h264_free.restype = None
    lib.mvsf_h264_decode.argtypes = [vp, _u8p, ctypes.c_int64, ci,
                                     ctypes.c_char_p, ci]
    lib.mvsf_h264_decode.restype = ci
    lib.mvsf_h264_flush.argtypes = [vp, ctypes.c_char_p, ci]
    lib.mvsf_h264_flush.restype = ci
    lib.mvsf_h264_pictures.argtypes = [vp]
    lib.mvsf_h264_pictures.restype = ci
    lib.mvsf_h264_size.argtypes = [vp] + [ctypes.POINTER(ci)] * 4
    lib.mvsf_h264_size.restype = None
    lib.mvsf_h264_pop.argtypes = [vp, _u8p, _u8p, _u8p]
    lib.mvsf_h264_pop.restype = ci
    lib.mvsf_h264_yuv420_to_bgr.argtypes = [_u8p, _u8p, _u8p, ci, ci, ci,
                                            ci, _u8p]
    lib.mvsf_h264_yuv420_to_bgr.restype = None
    lib.mvsf_h264_probe.argtypes = [_u8p, ctypes.c_int64,
                                    ctypes.POINTER(ci), ctypes.POINTER(ci),
                                    ctypes.c_char_p, ci]
    lib.mvsf_h264_probe.restype = ci


_DECODER = HostLibrary("h264_decode", _declare)

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def _buf(data: bytes):
    return ctypes.cast(ctypes.c_char_p(data), _u8p)


class H264Decoder:
    """One H.264 stream: `decode(data)` takes NAL units (an MP4 sample,
    an AVI chunk, or a piece of an Annex B stream cut anywhere between
    NAL units) and gives the planes of the pictures it completed, in
    output order (a picture completes when the next one begins);
    `flush()` those left at the end.  `nal_length_size` is 1, 2 or 4 for length-prefixed NAL units
    (MP4), 0 for Annex B start codes; `config` is NAL units of that
    framing to read first (the `avcC` parameter sets); `size` the
    container's width and height (libavcodec crops the right and bottom
    to it when the SPS crops neither the top nor the left)."""

    def __init__(self, path: str, nal_length_size: int = 0,
                 config: bytes = b"", size: Tuple[int, int] = (0, 0)):
        self._lib = _DECODER.load()
        self.path = path
        self.nal_length_size = int(nal_length_size)
        self._h = self._lib.mvsf_h264_new(int(size[0]), int(size[1]))
        self._err = ctypes.create_string_buffer(_ERR)
        if config:
            self._check(self._lib.mvsf_h264_decode(
                self._h, _buf(config), len(config), self.nal_length_size,
                self._err, _ERR))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.mvsf_h264_free(h)
            self._h = None

    def _check(self, got: int) -> int:
        if got < 0:
            frame = self._lib.mvsf_h264_pictures(self._h)
            raise VideoError(f"{self.path} frame {frame}: "
                             f"{self._err.value.decode()}")
        return got

    def _format(self) -> Tuple[int, int, int, int]:
        v = [ctypes.c_int() for _ in range(4)]
        self._lib.mvsf_h264_size(self._h, *map(ctypes.byref, v))
        return tuple(x.value for x in v)

    def size(self) -> Tuple[int, int]:
        """(width, height) of the frames (cropped; (0, 0) before one)."""
        return self._format()[:2]

    def _take(self, n: int) -> List[Planes]:
        out = []
        w, h = self.size()
        c = ((h + 1) // 2, (w + 1) // 2)
        for _ in range(n):
            y = np.empty((h, w), np.uint8)
            u, v = np.empty(c, np.uint8), np.empty(c, np.uint8)
            if not self._lib.mvsf_h264_pop(self._h, _ptr(y), _ptr(u),
                                           _ptr(v)):
                break
            out.append((y, u, v))
        return out

    def decode(self, data: bytes) -> List[Planes]:
        n = self._check(self._lib.mvsf_h264_decode(
            self._h, _buf(data), len(data), self.nal_length_size, self._err,
            _ERR))
        return self._take(n)

    def flush(self) -> List[Planes]:
        return self._take(self._check(self._lib.mvsf_h264_flush(
            self._h, self._err, _ERR)))

    def to_bgr(self, planes: Planes) -> np.ndarray:
        """(H, W, 3) uint8 BGR of one picture, as swscale converts it for
        OpenCV with the stream's chroma location and matrix (BT.601, or
        BT.709 where the VUI names it; bitwise)."""
        y, u, v = (np.ascontiguousarray(p, np.uint8) for p in planes)
        h, w = y.shape
        _, _, loc, matrix = self._format()
        out = np.empty((h, w, 3), np.uint8)
        self._lib.mvsf_h264_yuv420_to_bgr(_ptr(y), _ptr(u), _ptr(v), w, h,
                                          loc, matrix, _ptr(out))
        return out


def probe_size(path: str, head: bytes) -> Tuple[int, int]:
    """(width, height) that the first SPS in `head` (the start of a raw
    Annex B stream) gives, cropped."""
    lib = _DECODER.load()
    w, h = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR)
    got = lib.mvsf_h264_probe(_buf(head), len(head), ctypes.byref(w),
                              ctypes.byref(h), err, _ERR)
    if got < 0:
        raise VideoError(f"{path} frame 0: {err.value.decode()}")
    if got > 0:
        raise VideoError(f"{path}: an H.264 stream without a sequence "
                         "parameter set in its first "
                         f"{len(head)} bytes")
    return w.value, h.value


def annexb_chunks(f, size: int = 1 << 20) -> Iterable[bytes]:
    """An Annex B byte stream read `size` bytes at a time, each piece cut
    before a start code so that no NAL unit is split."""
    rest = b""
    while True:
        data = f.read(size)
        if not data:
            if rest:
                yield rest
            return
        buf = rest + data
        cut = buf.rfind(b"\0\0\1", max(len(rest) - 3, 0))
        if cut <= 0:
            rest = buf
            continue
        while cut > 0 and buf[cut - 1] == 0:
            cut -= 1
        if cut == 0:
            rest = buf
            continue
        yield buf[:cut]
        rest = buf[cut:]
