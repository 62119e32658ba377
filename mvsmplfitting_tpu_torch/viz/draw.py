"""OpenCV's drawing primitives without OpenCV (`csrc/draw.cpp`).

The JAX package draws its overlays and skeletons with `cv2`; the card's
machine has neither OpenCV nor Pillow, so the port draws with a host
library that repeats `imgproc/src/drawing.cpp`'s integer arithmetic and
leaves the same bytes.  Every function works in place on a C-contiguous
(H, W, 3) uint8 image and returns it, as the cv2 call does; colors are
BGR tuples (saturated to 0-255 after rounding, as `cv::Scalar` is),
points are integer (x, y) pairs (OpenCV's `shift` 0), and the line type
is LINE_8 or LINE_AA: the calls the overlays, `vis_frame` and the GUI
make.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ..utils.host_build import HostLibrary

LINE_8 = 8
LINE_AA = 16
MAX_THICKNESS = 32767

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_int = ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    lib.draw_line.argtypes = [_u8p, _int, _int, _int, _int, _int, _int,
                              _u8p, _int, _int]
    lib.draw_fill_convex_poly.argtypes = [_u8p, _int, _int, _i32p, _int,
                                          _u8p, _int]
    lib.draw_circle.argtypes = [_u8p, _int, _int, _int, _int, _int, _u8p,
                                _int, _int]
    lib.draw_rectangle.argtypes = [_u8p, _int, _int, _int, _int, _int,
                                   _int, _u8p, _int, _int]
    lib.draw_ellipse2poly.argtypes = [_int] * 8 + [_i32p, _int]
    lib.draw_ellipse2poly.restype = _int
    lib.draw_add_weighted.argtypes = [_u8p, ctypes.c_double, _u8p,
                                      ctypes.c_double, ctypes.c_double,
                                      _u8p, ctypes.c_int64]
    lib.draw_fill_faces.argtypes = [_u8p, _int, _int, _i32p, _f64p, _i64p,
                                    ctypes.c_int64]
    lib.draw_blend_changed.argtypes = [_u8p, _u8p, ctypes.c_double, _u8p,
                                       ctypes.c_int64]
    for name in ("draw_line", "draw_fill_convex_poly", "draw_circle",
                 "draw_rectangle", "draw_add_weighted", "draw_fill_faces",
                 "draw_blend_changed"):
        getattr(lib, name).restype = None


# -ffp-contract=off: the float64 blend must round each product and sum
# as numpy does, and addWeighted's multiply-adds are written as fma().
LIBRARY = HostLibrary("draw", _declare, ("-ffp-contract=off",))


def _img(img: np.ndarray) -> np.ndarray:
    if (not isinstance(img, np.ndarray) or img.dtype != np.uint8
            or img.ndim != 3 or img.shape[2] != 3
            or not img.flags.c_contiguous or not img.flags.writeable):
        raise ValueError("expected a writeable C-contiguous (H, W, 3) uint8 "
                         f"image, got {getattr(img, 'shape', type(img))} "
                         f"{getattr(img, 'dtype', '')}")
    return img


def _color(color) -> np.ndarray:
    """cv::Scalar -> raw bytes: each channel rounded half to even and
    saturated to 0-255; missing channels are 0."""
    c = [float(v) for v in (tuple(color) + (0.0, 0.0, 0.0))[:3]]
    return np.asarray([min(255, max(0, int(np.rint(v)))) for v in c],
                      np.uint8)


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def _xy(pt) -> Tuple[int, int]:
    return int(pt[0]), int(pt[1])


def _check_line_type(line_type: int) -> int:
    if line_type not in (LINE_8, LINE_AA):
        raise ValueError(f"unsupported line type {line_type}: LINE_8 (8) "
                         "or LINE_AA (16)")
    return line_type


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1,
         line_type: int = LINE_8) -> np.ndarray:
    """cv2.line."""
    _img(img)
    if not 0 < thickness <= MAX_THICKNESS:
        raise ValueError(f"line thickness {thickness} outside (0, 32767]")
    c = _color(color)
    LIBRARY.load().draw_line(_u8(img), img.shape[0], img.shape[1],
                             *_xy(pt1), *_xy(pt2), _u8(c), int(thickness),
                             _check_line_type(line_type))
    return img


def fill_convex_poly(img: np.ndarray, pts, color,
                     line_type: int = LINE_8) -> np.ndarray:
    """cv2.fillConvexPoly; `pts` is (N, 2) (or (N, 1, 2)) integers."""
    _img(img)
    p = np.ascontiguousarray(np.asarray(pts).reshape(-1, 2), np.int32)
    c = _color(color)
    LIBRARY.load().draw_fill_convex_poly(
        _u8(img), img.shape[0], img.shape[1], p.ctypes.data_as(_i32p),
        len(p), _u8(c), _check_line_type(line_type))
    return img


def circle(img: np.ndarray, center, radius: int, color,
           thickness: int = 1, line_type: int = LINE_8) -> np.ndarray:
    """cv2.circle; thickness < 0 fills."""
    _img(img)
    if radius < 0 or thickness > MAX_THICKNESS:
        raise ValueError(f"bad circle radius {radius} or thickness "
                         f"{thickness}")
    c = _color(color)
    LIBRARY.load().draw_circle(_u8(img), img.shape[0], img.shape[1],
                               *_xy(center), int(radius), _u8(c),
                               int(thickness), _check_line_type(line_type))
    return img


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 1,
              line_type: int = LINE_8) -> np.ndarray:
    """cv2.rectangle; thickness < 0 fills."""
    _img(img)
    if thickness > MAX_THICKNESS:
        raise ValueError(f"bad rectangle thickness {thickness}")
    c = _color(color)
    LIBRARY.load().draw_rectangle(_u8(img), img.shape[0], img.shape[1],
                                  *_xy(pt1), *_xy(pt2), _u8(c),
                                  int(thickness),
                                  _check_line_type(line_type))
    return img


def ellipse2poly(center, axes, angle: int, arc_start: int, arc_end: int,
                 delta: int) -> np.ndarray:
    """cv2.ellipse2Poly: (N, 2) int32 points."""
    if not 0 < delta <= 180:
        raise ValueError(f"ellipse2Poly delta {delta} outside (0, 180]")
    lib = LIBRARY.load()
    args = (*_xy(center), *_xy(axes), int(angle), int(arc_start),
            int(arc_end), int(delta))
    cap = 2 * (360 // delta + 2) + 4
    out = np.empty((cap, 2), np.int32)
    n = lib.draw_ellipse2poly(*args, out.ctypes.data_as(_i32p), cap)
    return out[:n].copy()


def add_weighted(src1: np.ndarray, alpha: float, src2: np.ndarray,
                 beta: float, gamma: float) -> np.ndarray:
    """cv2.addWeighted on two uint8 arrays of one shape: a new array."""
    a = np.ascontiguousarray(src1)
    b = np.ascontiguousarray(src2)
    if a.dtype != np.uint8 or b.dtype != np.uint8 or a.shape != b.shape:
        raise ValueError("add_weighted takes two uint8 arrays of one shape")
    out = np.empty_like(a)
    LIBRARY.load().draw_add_weighted(_u8(a), float(alpha), _u8(b),
                                     float(beta), float(gamma), _u8(out),
                                     a.size)
    return out


def fill_faces(layer: np.ndarray, pts: np.ndarray, colors: np.ndarray,
               order: np.ndarray) -> np.ndarray:
    """The overlay's painter's loop in one call: for f in `order`,
    `cv2.fillConvexPoly(layer, pts[f], tuple(int(v) for v in colors[f]),
    lineType=cv2.LINE_AA)`.  pts (F, 3, 2) int32, colors (F, 3) float64,
    order (N,) indices into F."""
    _img(layer)
    p = np.ascontiguousarray(pts, np.int32)
    c = np.ascontiguousarray(colors, np.float64)
    o = np.ascontiguousarray(order, np.int64)
    F = p.shape[0]
    if p.shape != (F, 3, 2) or c.shape != (F, 3):
        raise ValueError(f"fill_faces takes pts (F, 3, 2) and colors (F, 3), "
                         f"got {p.shape} and {c.shape}")
    if o.size and (o.min() < 0 or o.max() >= F):
        raise ValueError("fill_faces: face order out of range")
    LIBRARY.load().draw_fill_faces(
        _u8(layer), layer.shape[0], layer.shape[1], p.ctypes.data_as(_i32p),
        c.ctypes.data_as(_f64p), o.ctypes.data_as(_i64p), o.size)
    return layer


def blend_changed(img: np.ndarray, layer: np.ndarray,
                  alpha: float) -> np.ndarray:
    """`np.where(any(layer != img, -1), alpha * layer + (1 - alpha) * img,
    img).astype(uint8)` in float64, as the overlay blends."""
    a = np.ascontiguousarray(img)
    b = np.ascontiguousarray(layer)
    if a.dtype != np.uint8 or b.shape != a.shape or b.dtype != np.uint8:
        raise ValueError("blend_changed takes two uint8 images of one shape")
    out = np.empty_like(a)
    LIBRARY.load().draw_blend_changed(_u8(a), _u8(b), float(alpha),
                                      _u8(out), a.size // 3)
    return out

