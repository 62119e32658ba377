"""Pre- and post-processing of the keypoint front end on the device (port
of `detect/preprocess.py`).

* `letterbox`: YOLOX's ratio-keeping top-left resize with 114 padding
  on raw 0-255 BGR (`yolox/data/data_augment.py:189-211`).  JAX resizes
  with `cv2.resize(..., INTER_LINEAR)`; `resize_linear_u8` repeats
  OpenCV's fixed-point uint8 path on the device (11-bit weights from
  half-pixel centres, the horizontal pass in int32, the vertical pass
  as `((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2`),
  so the result is cv2's bytes.
* `bbox_to_center_scale` (host numpy) and `crop_affine`: AlphaPose's
  aspect-clipped, 1.25x-padded isotropic crop as one bilinear gather
  on JAX's sampling grid, zeros outside.
* `heatmap_to_coords`: argmax (first index on ties), the quarter-pixel
  step toward the larger neighbour at interior points, the inverse box
  transform; `heatmap_to_coords_integral` the soft-argmax variant.
* `flip_heatmap`: un-flip mirrored heatmaps with JAX's intended
  one-pixel shift.

Images are (H, W, 3) uint8 tensors; crops and heatmaps are NCHW.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

INTER_RESIZE_COEF_SCALE = 2048     # OpenCV's 11-bit interpolation weights


def _linear_taps(dst: int, src: int, clamp_low_weight: bool,
                 inv_scale: Optional[float] = None):
    """OpenCV's INTER_LINEAR source indices and fixed-point weights for
    one axis (`imgproc/src/resize.cpp`, `resize()`'s coefficient loops).
    The source step is `1 / inv_scale`, `inv_scale` defaulting to
    `dst / src` (a given output size); `cv2.resize`'s `fx`/`fy` pass it.

    `fx` is computed in double and rounded to float, floored, and its
    fraction rounded half to even times 2048.  Horizontally a tap left of
    0 or at/after the last sample collapses to that sample with weight
    (2048, 0); vertically the weights stay and the rows are clamped.
    """
    scale = 1.0 / (dst / src if inv_scale is None else inv_scale)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_low_weight:
        lo = s < 0
        f[lo], s[lo] = 0, 0
        hi = s >= src - 1
        f[hi], s[hi] = 0, src - 1
    w0 = np.rint((np.float32(1) - f) * np.float32(INTER_RESIZE_COEF_SCALE))
    w1 = np.rint(f * np.float32(INTER_RESIZE_COEF_SCALE))
    s0 = np.clip(s, 0, src - 1)
    s1 = np.clip(s + 1, 0, src - 1)
    return s0, s1, w0.astype(np.int32), w1.astype(np.int32)


def resize_linear_u8(img: torch.Tensor, out_w: int, out_h: int,
                     fx: Optional[float] = None, fy: Optional[float] = None
                     ) -> torch.Tensor:
    """`cv2.resize(img, (out_w, out_h), interpolation=INTER_LINEAR)` for
    an (H, W, C) uint8 tensor, in integer arithmetic on its device; with
    `fx`/`fy` the taps step by `1 / fx` and `1 / fy`, as OpenCV's do when
    the scale factors are given (`resize_linear_u8_by`)."""
    h, w = img.shape[:2]
    dev = img.device

    def t(a):
        return torch.as_tensor(a, device=dev)

    x0, x1, a0, a1 = (t(a) for a in _linear_taps(out_w, w, True, fx))
    y0, y1, b0, b1 = (t(a) for a in _linear_taps(out_h, h, False, fy))
    src = img.to(torch.int32)
    hor = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    s0 = hor[y0] >> 4
    s1 = hor[y1] >> 4
    out = (((b0[:, None, None] * s0) >> 16)
           + ((b1[:, None, None] * s1) >> 16) + 2) >> 2
    return out.clamp_(0, 255).to(torch.uint8)


def resize_area_half_u8(img: torch.Tensor) -> torch.Tensor:
    """`cv2.resize(img, None, fx=0.5, fy=0.5)` for an (H, W, C) uint8
    tensor, on its device: OpenCV sends an exact halving to its INTER_AREA
    fast path (`resizeAreaFast_`).  The output is `round(side * 0.5)`
    half to even on each axis.  A whole 2x2 block gives
    `(a + b + c + d + 2) >> 2`; where a side is 3 mod 4 the last output
    row or column covers one source row or column, and gives the mean of
    its two samples rounded half to even (the corner: its one sample)."""
    h, w = img.shape[:2]
    oh, ow = round(h * 0.5), round(w * 0.5)
    if oh == 0 or ow == 0:
        raise ValueError(f"resize_area_half_u8: a {h}x{w} image halves to "
                         "nothing")
    h2, w2 = h // 2, w // 2
    x = img.to(torch.int32)
    out = torch.empty((oh, ow) + tuple(img.shape[2:]), dtype=torch.int32,
                      device=img.device)
    blocks = (x[0:2 * h2:2, 0:2 * w2:2] + x[1:2 * h2:2, 0:2 * w2:2]
              + x[0:2 * h2:2, 1:2 * w2:2] + x[1:2 * h2:2, 1:2 * w2:2])
    out[:h2, :w2] = ((blocks + 2) >> 2)[:oh, :ow]

    def pair_mean(s):                       # s / 2 rounded half to even
        half = s >> 1
        return half + (s & half & 1)

    if ow > w2:
        out[:h2, w2] = pair_mean(x[0:2 * h2:2, w - 1] + x[1:2 * h2:2, w - 1])
    if oh > h2:
        out[h2, :w2] = pair_mean(x[h - 1, 0:2 * w2:2]
                                 + x[h - 1, 1:2 * w2:2])[:ow]
        if ow > w2:
            out[h2, w2] = x[h - 1, w - 1]
    return out.to(torch.uint8)


def resize_linear_u8_by(img: torch.Tensor, fx: float, fy: float
                        ) -> torch.Tensor:
    """`cv2.resize(img, None, fx=fx, fy=fy)` (INTER_LINEAR): the output
    size is `w * fx`, `h * fy` rounded half to even, and the taps step by
    `1 / fx`, `1 / fy` (not `w / out_w`, which can pick other taps).  An
    exact halving goes where OpenCV sends it, to INTER_AREA
    (`resize_area_half_u8`)."""
    h, w = img.shape[:2]
    eps = sys.float_info.epsilon
    if abs(1.0 / fx - 2.0) < eps and abs(1.0 / fy - 2.0) < eps:
        return resize_area_half_u8(img)
    out_w, out_h = round(w * fx), round(h * fy)
    return resize_linear_u8(img, out_w, out_h, fx, fy)


def letterbox(img: torch.Tensor, input_hw: Tuple[int, int] = (800, 1440),
              pad_value: float = 114.0) -> Tuple[torch.Tensor, float]:
    """(H, W, 3) uint8 BGR -> ((3, ih, iw) float32 BGR, ratio): resized
    keeping the aspect ratio into the top-left corner, padded bottom and
    right with `pad_value`."""
    ih, iw = input_hw
    h, w = img.shape[:2]
    r = min(ih / h, iw / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    out = torch.full((3, ih, iw), pad_value, dtype=torch.float32,
                     device=img.device)
    out[:, :nh, :nw] = resize_linear_u8(img, nw, nh).permute(2, 0, 1)
    return out, r


def bbox_to_center_scale(xyxy: np.ndarray, aspect_ratio: float = 0.75,
                         scale_mult: float = 1.25
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Boxes (M, 4) -> centers (M, 2), scales (M, 2) (w, h in pixels)."""
    xyxy = np.asarray(xyxy, np.float32)
    w = xyxy[:, 2] - xyxy[:, 0]
    h = xyxy[:, 3] - xyxy[:, 1]
    cx = xyxy[:, 0] + 0.5 * w
    cy = xyxy[:, 1] + 0.5 * h
    wide = w > aspect_ratio * h
    h = np.where(wide, w / aspect_ratio, h)
    w = np.where(~wide & (w < aspect_ratio * h), h * aspect_ratio, w)
    scale = np.stack([w, h], -1) * scale_mult
    return np.stack([cx, cy], -1), scale


def crop_affine(img: torch.Tensor, centers: torch.Tensor,
                scales: torch.Tensor,
                out_hw: Tuple[int, int] = (256, 192)) -> torch.Tensor:
    """Isotropic crops with bilinear sampling, zeros outside.

    img: (C, H, W) float; centers, scales: (M, 2).  Returns (M, C,
    out_h, out_w).  Crop pixel (i, j) samples the source at
    ((j - out_w/2) * s + cx, (i - out_h/2) * s + cy), s = scale_w /
    out_w: JAX's grid, which is not `grid_sample`'s."""
    oh, ow = out_hw
    C, H, W = img.shape
    dev, f32 = img.device, torch.float32
    centers = centers.to(dev, f32)
    ratio = (scales[:, 0].to(dev, f32) / ow)[:, None]            # (M, 1)
    xs = (torch.arange(ow, device=dev, dtype=f32) - ow * 0.5) * ratio \
        + centers[:, 0:1]                                       # (M, ow)
    ys = (torch.arange(oh, device=dev, dtype=f32) - oh * 0.5) * ratio \
        + centers[:, 1:2]                                       # (M, oh)
    M = xs.shape[0]
    xg = xs[:, None, :].expand(M, oh, ow)
    yg = ys[:, :, None].expand(M, oh, ow)
    x0 = torch.floor(xg)
    y0 = torch.floor(yg)
    fx = (xg - x0)[:, None]
    fy = (yg - y0)[:, None]
    flat = img.reshape(C, H * W)

    def pix(yi, xi):
        # Out-of-image (and non-finite) taps read pixel 0 and are zeroed.
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        zero = torch.zeros((), dtype=yi.dtype, device=dev)
        idx = (torch.where(inb, yi, zero).long() * W
               + torch.where(inb, xi, zero).long())             # (M, oh, ow)
        v = flat[:, idx.reshape(-1)].reshape(C, M, oh, ow).transpose(0, 1)
        return torch.where(inb[:, None], v, torch.zeros((), dtype=v.dtype,
                                                        device=dev))

    return ((1 - fx) * (1 - fy) * pix(y0, x0)
            + fx * (1 - fy) * pix(y0, x0 + 1)
            + (1 - fx) * fy * pix(y0 + 1, x0)
            + fx * fy * pix(y0 + 1, x0 + 1))


# RGB means (`simple_transform.py:98-100`), the reference's only norm.
ALPHAPOSE_MEAN = (0.406, 0.457, 0.480)


def normalize_crops(crops: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB crops (M, 3, h, w) -> mean-subtracted."""
    mean = torch.tensor(ALPHAPOSE_MEAN, dtype=crops.dtype,
                        device=crops.device)
    return crops - mean[:, None, None]


def heatmap_to_coords(hms: torch.Tensor, centers: torch.Tensor,
                      scales: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heatmaps (M, J, h, w) -> image coords (M, J, 2), maxima (M, J).

    centers/scales describe each crop's source box, so the inverse
    transform is the isotropic scale back about the box center
    (`transforms.py:710-714`)."""
    M, J, h, w = hms.shape
    dev = hms.device
    flat = hms.reshape(M, J, h * w)
    idx = torch.argmax(flat, dim=-1)
    maxval = torch.gather(flat, -1, idx[..., None])[..., 0]
    px = (idx % w).to(torch.float32)
    py = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    pxi = torch.round(px).long().clamp(0, w - 1)
    pyi = torch.round(py).long().clamp(0, h - 1)

    def at(yy, xx):
        i = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        return torch.gather(flat, -1, i[..., None])[..., 0]

    dx = at(pyi, pxi + 1) - at(pyi, pxi - 1)
    dy = at(pyi + 1, pxi) - at(pyi - 1, pxi)
    interior = (pxi > 1) & (pxi < w - 1) & (pyi > 1) & (pyi < h - 1)
    zero = torch.zeros((), device=dev)
    px = px + torch.where(interior, torch.sign(dx) * 0.25, zero)
    py = py + torch.where(interior, torch.sign(dy) * 0.25, zero)
    # Zero out non-positive maxima, as `get_max_pred` (`:732-735`).
    mask = (maxval > 0).to(torch.float32)
    px = px * mask
    py = py * mask
    centers = centers.to(dev, torch.float32)
    ratio = (scales[:, 0].to(dev, torch.float32) / w)[:, None]
    x_img = (px - w * 0.5) * ratio + centers[:, 0:1]
    y_img = (py - h * 0.5) * ratio + centers[:, 1:2]
    return torch.stack([x_img, y_img], dim=-1), maxval


def decode_margins(hms: torch.Tensor) -> torch.Tensor:
    """(M, J) smallest of each heatmap's top-two margin and the two
    neighbour differences that set `heatmap_to_coords`' quarter-pixel
    step: where it is within round-off, two runs of the same net (another
    device, another dtype) may decode the joint a step apart."""
    M, J, h, w = hms.shape
    flat = hms.reshape(M, J, h * w)
    top2 = flat.topk(2, dim=-1).values
    idx = flat.argmax(-1)
    py = torch.div(idx, w, rounding_mode="floor")
    px = idx % w

    def at(yy, xx):
        i = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        return torch.gather(flat, -1, i[..., None])[..., 0]

    dx = (at(py, px + 1) - at(py, px - 1)).abs()
    dy = (at(py + 1, px) - at(py - 1, px)).abs()
    return torch.minimum(top2[..., 0] - top2[..., 1], torch.minimum(dx, dy))


def heatmap_to_coords_integral(hms: torch.Tensor, centers: torch.Tensor,
                               scales: torch.Tensor,
                               norm_type: str = "softmax"
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integral-regression (soft-argmax) decode, the reference's
    `heatmap_to_coord_simple_regress` (`transforms.py:591-691`):
    normalize each heatmap, take the coordinate expectation, map it back
    through the box transform.  Softmax gives confidence 1; sigmoid the
    map's maximum before normalization."""
    M, J, h, w = hms.shape
    dev = hms.device
    hm = hms.reshape(M, J, h * w)
    if norm_type == "softmax":
        norm = torch.softmax(hm, dim=-1)
        conf = torch.ones((M, J), dtype=hms.dtype, device=dev)
    else:
        norm = torch.sigmoid(hm)
        conf = norm.amax(dim=-1)
    p = norm / norm.sum(-1, keepdim=True).clamp_min(1e-9)
    idx = torch.arange(h * w, device=dev)
    ix = (idx % w).to(torch.float32)
    iy = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    px = (p * ix).sum(-1)
    py = (p * iy).sum(-1)
    centers = centers.to(dev, torch.float32)
    ratio = (scales[:, 0].to(dev, torch.float32) / w)[:, None]
    x_img = (px - w * 0.5) * ratio + centers[:, 0:1]
    y_img = (py - h * 0.5) * ratio + centers[:, 1:2]
    return torch.stack([x_img, y_img], dim=-1), conf


# Laterally symmetric joints swapped under a horizontal flip.  The
# reference's predictor uses the COCO-17 pairs whatever the joint count
# (`alphapose_core/alphapose_core.py:249-253`).
COCO_FLIP_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8),
                   (9, 10), (11, 12), (13, 14), (15, 16))
HALPE26_FLIP_PAIRS = COCO_FLIP_PAIRS + ((20, 21), (22, 23), (24, 25))
MPII16_FLIP_PAIRS = ((0, 5), (1, 4), (2, 3),
                     (10, 15), (11, 14), (12, 13))


def flip_pairs_for(num_joints: int, fmt: Optional[str] = None):
    """The flip-pair table of a format (by name, else by joint count,
    from the skeleton registry); pairs past the heatmaps' channels are
    refused up front."""
    from ..viz.skeletons import skeleton_for
    pairs = skeleton_for(num_joints, fmt).flip_pairs
    top = max((max(a, b) for a, b in pairs), default=-1)
    if top >= num_joints:
        raise ValueError(
            f"format {fmt!r} flip pairs reach joint {top}; the model "
            f"outputs only {num_joints} joints")
    return pairs


def flip_heatmap(hms: torch.Tensor,
                 joint_pairs: Sequence[Tuple[int, int]] = COCO_FLIP_PAIRS,
                 shift: bool = True) -> torch.Tensor:
    """Un-flip heatmaps (B, J, h, w) predicted on mirrored crops
    (`alphapose/utils/transforms.py:491-523`): flip the width axis, swap
    each pair's channels, then (shift=True) move one pixel right,
    repeating column 0 (JAX's intended shift; the reference's in-place
    overlapping copy is undefined)."""
    out = hms.flip(3)
    perm = list(range(hms.shape[1]))
    for a, b in joint_pairs:
        perm[a], perm[b] = perm[b], perm[a]
    out = out[:, perm]
    if shift:
        out = torch.cat([out[..., :1], out[..., :-1]], dim=3)
    return out
