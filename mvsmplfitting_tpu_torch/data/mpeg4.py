"""MPEG-4 Part 2 Simple Profile video without FFmpeg: the codec half of
what `cv2.VideoCapture` and `cv2.VideoWriter(..., fourcc "mp4v")` do for
JAX's `detect/stream.py` and `viz/video.py`.

`Mpeg4Decoder` decodes the chunks of an AVI stream or the samples of an
MP4 track (`csrc/mpeg4_decode.cpp`: the same pictures as libavcodec's
mpeg4 decoder, and the same BGR as the swscale conversion OpenCV asks
for, at any size).  `Mpeg4Encoder` writes Simple
Profile (`csrc/mpeg4_encode.cpp`): an I-VOP every 12 frames, P-VOPs
with a small full- and half-pel search on luma between them, and the
fixed quantiser 3 for every macroblock (cv2's writer, rate controlled by
FFmpeg, lands near quantiser 4 on the repo's clips; 3 keeps the port's
files within a few percent of cv2's sizes and above their PSNR).  Both libraries build with g++ at first use
(`utils/host_build.py`).  A stream or tool outside Simple Profile raises
`VideoError` naming the file, the frame and what was refused.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..utils.host_build import HostLibrary
from .video import VideoError

# test-mode tools of the encoder (csrc/mpeg4_encode.cpp kTool*)
TOOL_FOUR_MV = 1
TOOL_INTRA_IN_P = 2
TOOL_NOT_CODED = 4
TOOL_DQUANT = 8
TOOL_PACKETS = 16
TOOL_OUTSIDE = 32
TOOL_NVOP = 64
TOOL_DC_THR = 128

_u8p = ctypes.POINTER(ctypes.c_uint8)
_ERR = 512


def _declare_decode(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    lib.mvsf_m4v_dec_new.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mvsf_m4v_dec_new.restype = vp
    lib.mvsf_m4v_dec_free.argtypes = [vp]
    lib.mvsf_m4v_dec_free.restype = None
    lib.mvsf_m4v_dec_config.argtypes = [vp, _u8p, ctypes.c_int64,
                                        ctypes.c_char_p, ctypes.c_int]
    lib.mvsf_m4v_dec_config.restype = ctypes.c_int
    lib.mvsf_m4v_dec_size.argtypes = [vp, ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
    lib.mvsf_m4v_dec_size.restype = None
    lib.mvsf_m4v_decode.argtypes = [vp, _u8p, ctypes.c_int64, _u8p, _u8p,
                                    _u8p, ctypes.c_char_p, ctypes.c_int]
    lib.mvsf_m4v_decode.restype = ctypes.c_int
    lib.mvsf_m4v_flush.argtypes = [vp, _u8p, _u8p, _u8p]
    lib.mvsf_m4v_flush.restype = ctypes.c_int
    lib.mvsf_yuv420_to_bgr.argtypes = [_u8p, _u8p, _u8p, ctypes.c_int,
                                       ctypes.c_int, _u8p]
    lib.mvsf_yuv420_to_bgr.restype = None


def _declare_encode(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    lib.mvsf_m4v_enc_new.argtypes = [ctypes.c_int] * 4 + [ctypes.c_uint32] * 2
    lib.mvsf_m4v_enc_new.restype = vp
    lib.mvsf_m4v_enc_free.argtypes = [vp]
    lib.mvsf_m4v_enc_free.restype = None
    lib.mvsf_m4v_enc_config.argtypes = [vp, _u8p, ctypes.c_int64]
    lib.mvsf_m4v_enc_config.restype = ctypes.c_int64
    lib.mvsf_m4v_encode.argtypes = [vp, _u8p, ctypes.c_int64, ctypes.c_int,
                                    _u8p, ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_char_p, ctypes.c_int]
    lib.mvsf_m4v_encode.restype = ctypes.c_int64


_DECODER = HostLibrary("mpeg4_decode", _declare_decode)
_ENCODER = HostLibrary("mpeg4_encode", _declare_encode)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def _buf(data: bytes):
    return ctypes.cast(ctypes.c_char_p(data), _u8p)


Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]


def yuv420_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR of 4:2:0 planes, as swscale converts them for
    OpenCV (bitwise)."""
    lib = _DECODER.load()
    h, w = y.shape
    y = np.ascontiguousarray(y, np.uint8)
    u = np.ascontiguousarray(u, np.uint8)
    v = np.ascontiguousarray(v, np.uint8)
    if u.shape != ((h + 1) // 2, (w + 1) // 2) or v.shape != u.shape:
        raise ValueError(f"chroma planes {u.shape}/{v.shape} for a {w}x{h} "
                         "picture")
    out = np.empty((h, w, 3), np.uint8)
    lib.mvsf_yuv420_to_bgr(_ptr(y), _ptr(u), _ptr(v), w, h, _ptr(out))
    return out


class Mpeg4Decoder:
    """One MPEG-4 Part 2 stream: `decode(chunk)` gives the planes of the
    picture a chunk (AVI) or sample (MP4) holds, or None (headers only,
    or a VOP with vop_coded = 0, of which FFmpeg shows nothing);
    `flush()` gives FFmpeg's repeat of the last picture when the stream
    ends with such a VOP.  `config` is the MP4 esds's VOS/VOL headers
    (AVI carries them in the first chunk); `fourcc` the AVI's, which
    makes libavcodec treat an unmarked stream as Xvid's or DivX's (and
    this decoder refuse it)."""

    def __init__(self, path: str, config: bytes = b"", fourcc: str = ""):
        self._lib = _DECODER.load()
        self.path = path
        tag = fourcc.upper()
        self._h = self._lib.mvsf_m4v_dec_new(
            int(tag in ("XVID", "XVIX", "RMP4", "ZMP4", "SIPP")),
            int(tag == "DIVX"))
        self._err = ctypes.create_string_buffer(_ERR)
        self.frames = 0
        if config:
            if self._lib.mvsf_m4v_dec_config(self._h, _buf(config),
                                             len(config), self._err,
                                             _ERR) != 0:
                raise VideoError(f"{path}: {self._err.value.decode()}")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.mvsf_m4v_dec_free(h)
            self._h = None

    def size(self) -> Tuple[int, int]:
        """(width, height) of the VOL read so far ((0, 0) before one)."""
        w, h = ctypes.c_int(), ctypes.c_int()
        self._lib.mvsf_m4v_dec_size(self._h, ctypes.byref(w), ctypes.byref(h))
        return w.value, h.value

    def _planes(self, w: int, h: int) -> Planes:
        c = ((h + 1) // 2, (w + 1) // 2)
        return (np.empty((h, w), np.uint8), np.empty(c, np.uint8),
                np.empty(c, np.uint8))

    def decode(self, chunk: bytes) -> Optional[Planes]:
        if self._lib.mvsf_m4v_dec_config(self._h, _buf(chunk), len(chunk),
                                         self._err, _ERR) != 0:
            raise VideoError(f"{self.path} frame {self.frames}: "
                             f"{self._err.value.decode()}")
        w, h = self.size()
        if not w:
            raise VideoError(f"{self.path} frame {self.frames}: MPEG-4 data "
                             "before any VOL header")
        y, u, v = self._planes(w, h)
        got = self._lib.mvsf_m4v_decode(self._h, _buf(chunk), len(chunk),
                                        _ptr(y), _ptr(u), _ptr(v),
                                        self._err, _ERR)
        if got < 0:
            raise VideoError(f"{self.path} frame {self.frames}: "
                             f"{self._err.value.decode()}")
        if got == 0:
            return None
        self.frames += 1
        return y, u, v

    def flush(self) -> Optional[Planes]:
        w, h = self.size()
        if not w:
            return None
        y, u, v = self._planes(w, h)
        if not self._lib.mvsf_m4v_flush(self._h, _ptr(y), _ptr(u), _ptr(v)):
            return None
        self.frames += 1
        return y, u, v


class Mpeg4Encoder:
    """Simple Profile MPEG-4 of (H, W, 3) uint8 BGR frames of one size at
    `fps` (`res`/`inc` ticks: whole frame rates exactly, others to a
    thousandth).  `config()` is the VOS/VO/VOL headers (the MP4 esds);
    `encode(frame, with_headers)` one VOP (after the headers when asked:
    an AVI's first chunk) and whether it is an I-VOP.  `tools` (the
    TOOL_* bits, 0 normally) and `seed` drive the test mode."""

    def __init__(self, width: int, height: int, fps: float, tools: int = 0,
                 seed: int = 0):
        self._lib = _ENCODER.load()
        self.width, self.height = int(width), int(height)
        self.res, self.inc = time_base(fps)
        self._h = self._lib.mvsf_m4v_enc_new(self.width, self.height,
                                             self.res, self.inc, int(tools),
                                             int(seed))
        if not self._h:
            raise ValueError(f"MPEG-4 encoder: cannot encode {width}x{height} "
                             f"at {fps} fps")
        self._err = ctypes.create_string_buffer(_ERR)
        self._out = np.empty(self.width * self.height * 4 + 65536, np.uint8)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.mvsf_m4v_enc_free(h)
            self._h = None

    def config(self) -> bytes:
        n = self._lib.mvsf_m4v_enc_config(self._h, _ptr(self._out),
                                          len(self._out))
        return bytes(self._out[:n])

    def encode(self, frame: np.ndarray, with_headers: bool = False
               ) -> Tuple[bytes, bool]:
        frame = np.ascontiguousarray(frame, np.uint8)
        if frame.shape != (self.height, self.width, 3):
            raise ValueError(f"MPEG-4 encoder: frame {frame.shape}, the "
                             f"video is {self.width}x{self.height}")
        key = ctypes.c_int()
        n = self._lib.mvsf_m4v_encode(self._h, _ptr(frame), frame.strides[0],
                                      int(with_headers), _ptr(self._out),
                                      len(self._out), ctypes.byref(key),
                                      self._err, _ERR)
        if n <= 0:
            raise ValueError("MPEG-4 encoder: " + (
                self._err.value.decode() or f"VOP of {-n} bytes overflowed "
                "its buffer"))
        return bytes(self._out[:n]), bool(key.value)


def time_base(fps: float) -> Tuple[int, int]:
    """(vop_time_increment_resolution, ticks a frame) for `fps`."""
    fps = float(fps)
    if fps <= 0:
        raise ValueError(f"frame rate {fps}")
    if fps.is_integer() and fps <= 65535:
        return int(fps), 1
    res = int(round(fps * 1000))
    if res > 65535:
        raise ValueError(f"frame rate {fps}: more than 65.535 fps with a "
                         "fraction")
    return res, 1000
