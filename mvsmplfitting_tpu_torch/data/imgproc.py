"""The OpenCV calls of the training augmentation, without OpenCV.

JAX's `detect/augment.py`, `augment3d.py`, `dataset.py` and `ops/crop.py`
call `cv2.warpAffine`, `cv2.resize` and `cv2.cvtColor`; the card's
machine has no OpenCV, so the port repeats the arithmetic of OpenCV
5.0.0's own code paths and gets its values bitwise:

* `warp_affine`: `cv2.warpAffine(img, M, (w, h), flags=INTER_LINEAR,
  borderValue=(v,) * 3)` on uint8 or float32 images (`csrc/imgproc.cpp`);
* `resize_linear`: `cv2.resize(..., INTER_LINEAR)` on float32
  (`csrc/imgproc.cpp`);
* `resize_cubic`: `cv2.resize(..., INTER_CUBIC)` on float64 (numpy:
  float32 cubic coefficients with A = -0.75, taps clamped to the image,
  the horizontal then the vertical four-tap sums in double);
* `resize_nearest`: `cv2.resize(..., INTER_NEAREST)` (numpy: source
  index floor(d * src / dst), clamped);
* `rgb_to_hsv`, `hsv_to_rgb`: `cv2.cvtColor` COLOR_RGB2HSV /
  COLOR_HSV2RGB on float32, H in [0, 360) (`csrc/imgproc.cpp`).

OpenCV 5's float warp and resize are not its older fixed-point paths:
the source position is float (double for resize), not quantised to
1/32 pixel.  Where its SIMD loop and its scalar tail round
differently (the warp's positions, the hue), the library repeats both
on the same pixels.  One part is not bitwise: `resize_linear`'s border
columns of an enlargement (see there).  `tests/test_torch_augment.py` holds each routine
to cv2; `tools/make_imgproc_fixtures.py` records goldens for the
card's host, which has no OpenCV.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from ..utils.host_build import HostLibrary

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f64p = ctypes.POINTER(ctypes.c_double)
_int = ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    lib.warp_affine_f32.argtypes = [_f32p, _int, _int, _int, _f32p, _int,
                                    _int, _f64p, ctypes.c_float]
    lib.warp_affine_u8.argtypes = [_u8p, _int, _int, _int, _u8p, _int, _int,
                                   _f64p, ctypes.c_float]
    lib.resize_linear_f32.argtypes = [_f32p, _int, _int, _int, _f32p, _int,
                                      _int]
    lib.rgb2hsv_f32.argtypes = [_f32p, _f32p, _int, _int]
    lib.hsv2rgb_f32.argtypes = [_f32p, _f32p, ctypes.c_int64]
    for name in ("warp_affine_f32", "warp_affine_u8", "resize_linear_f32",
                 "rgb2hsv_f32", "hsv2rgb_f32"):
        getattr(lib, name).restype = None


LIBRARY = HostLibrary("imgproc", _declare, ("-ffp-contract=off",))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u8p if a.dtype == np.uint8 else _f32p)


def _image(img: np.ndarray, dtypes) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype not in dtypes or img.ndim not in (2, 3) or (
            img.ndim == 3 and not 1 <= img.shape[2] <= 4):
        raise ValueError(f"expected an (H, W) or (H, W, 1-4) image of "
                         f"{[np.dtype(d).name for d in dtypes]}, got "
                         f"{img.shape} {img.dtype}")
    if img.shape[0] < 1 or img.shape[1] < 1:
        raise ValueError(f"empty image {img.shape}")
    return img


def _out_shape(img: np.ndarray, w: int, h: int):
    """cv2's output shape: a one-channel (H, W, 1) image comes back 2-D."""
    return (h, w) if img.ndim == 2 or img.shape[2] == 1 else (h, w,
                                                             img.shape[2])


def _size(out_wh: Sequence[int]):
    w, h = int(out_wh[0]), int(out_wh[1])
    if w < 1 or h < 1:
        raise ValueError(f"output size must be positive, got {(w, h)}")
    return w, h


def warp_affine(img: np.ndarray, M, out_wh: Sequence[int],
                border_value: float = 0.0) -> np.ndarray:
    """`cv2.warpAffine(img, M, out_wh, flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=(border_value,) * 3)`; `M`
    maps source to output pixels (2x3, any float dtype), uint8 or
    float32 in and out."""
    img = _image(img, (np.uint8, np.float32))
    w, h = _size(out_wh)
    m = np.ascontiguousarray(np.asarray(M, np.float64).reshape(2, 3))
    cn = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty(_out_shape(img, w, h), img.dtype)
    fn = (LIBRARY.load().warp_affine_u8 if img.dtype == np.uint8
          else LIBRARY.load().warp_affine_f32)
    border = float(border_value)
    if img.dtype == np.uint8:       # cv::Scalar saturated to the depth
        border = float(min(255, max(0, int(np.rint(border)))))
    fn(_ptr(img), img.shape[0], img.shape[1], cn, _ptr(out), h, w,
       m.ctypes.data_as(_f64p), border)
    return out


def resize_linear(img: np.ndarray, out_wh: Sequence[int]) -> np.ndarray:
    """`cv2.resize(img, out_wh, interpolation=INTER_LINEAR)` on float32:
    bitwise, except in the output columns left of the first or right of
    the last source pixel centre of an enlargement in x, where it is
    within one ulp of the output's largest magnitude.  A source one
    pixel high or wide (which OpenCV takes another way) is refused."""
    img = _image(img, (np.float32,))
    w, h = _size(out_wh)
    if img.shape[0] < 2 or img.shape[1] < 2:
        raise ValueError(f"resize_linear: a source of {img.shape[:2]} "
                         "pixels is not supported (at least 2 x 2)")
    cn = 1 if img.ndim == 2 else img.shape[2]
    out = np.empty(_out_shape(img, w, h), np.float32)
    LIBRARY.load().resize_linear_f32(_ptr(img), img.shape[0], img.shape[1],
                                     cn, _ptr(out), h, w)
    return out


def _cubic_coeffs(f: np.float32):
    """OpenCV's `interpolateCubic` in float32 (A = -0.75)."""
    F = np.float32
    A, x, one = F(-0.75), F(f), F(1)
    c0 = ((A * (x + one) - F(5) * A) * (x + one) + F(8) * A) * (x + one) \
        - F(4) * A
    c1 = ((A + F(2)) * x - (A + F(3))) * x * x + one
    c2 = ((A + F(2)) * (one - x) - (A + F(3))) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    return [np.float64(c) for c in (c0, c1, c2, c3)]


def _cubic_taps(dst: int, src: int):
    scale = 1.0 / (dst / src)
    idx = np.empty((dst, 4), np.int64)
    coef = np.empty((dst, 4), np.float64)
    for d in range(dst):
        f = np.float32((d + 0.5) * scale - 0.5)
        s = int(np.floor(f))
        coef[d] = _cubic_coeffs(np.float32(f - np.float32(s)))
        idx[d] = np.clip(np.arange(s - 1, s + 3), 0, src - 1)
    return idx, coef


def resize_cubic(img: np.ndarray, out_wh: Sequence[int]) -> np.ndarray:
    """`cv2.resize(img, out_wh, interpolation=INTER_CUBIC)` on float64
    (what `ops/crop.py` resizes: numpy's default zeros canvas)."""
    img = _image(img, (np.float64,))
    w, h = _size(out_wh)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    ix, cx = _cubic_taps(w, img.shape[1])
    iy, cy = _cubic_taps(h, img.shape[0])
    extra = (None,) * (img.ndim - 2)
    hor = img[:, ix[:, 0]] * cx[(None, slice(None), 0) + extra]
    for k in range(1, 4):
        hor = hor + img[:, ix[:, k]] * cx[(None, slice(None), k) + extra]
    out = hor[iy[:, 0]] * cy[(slice(None), None, 0) + extra]
    for k in range(1, 4):
        out = out + hor[iy[:, k]] * cy[(slice(None), None, k) + extra]
    return out


def resize_nearest(img: np.ndarray, out_wh: Sequence[int]) -> np.ndarray:
    """`cv2.resize(img, out_wh, interpolation=INTER_NEAREST)`."""
    img = np.asarray(img)
    w, h = _size(out_wh)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    H, W = img.shape[:2]
    sx = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))).astype(np.int64),
                    W - 1)
    sy = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))).astype(np.int64),
                    H - 1)
    return np.ascontiguousarray(img[sy][:, sx])


def _rgb(img: np.ndarray) -> np.ndarray:
    img = _image(img, (np.float32,))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) float32 image, got "
                         f"{img.shape}")
    return img


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, COLOR_RGB2HSV)` on float32 (H in [0, 360))."""
    img = _rgb(img)
    out = np.empty_like(img)
    LIBRARY.load().rgb2hsv_f32(_ptr(img), _ptr(out), img.shape[0],
                               img.shape[1])
    return out


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """`cv2.cvtColor(img, COLOR_HSV2RGB)` on float32 (H in [0, 360))."""
    img = _rgb(img)
    out = np.empty_like(img)
    LIBRARY.load().hsv2rgb_f32(_ptr(img), _ptr(out),
                               img.shape[0] * img.shape[1])
    return out
