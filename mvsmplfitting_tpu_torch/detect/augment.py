"""Training-time data augmentation of the detection stack, on the host
(port of `detect/augment.py`).

JAX's numpy carried over as it is, so that the same
`np.random.Generator` draws come in the same order; its OpenCV calls
(`cv2.warpAffine`, `cv2.resize` INTER_LINEAR, `cv2.cvtColor` RGB<->HSV,
all on float32) go to `data/imgproc.py`, which repeats OpenCV 5.0.0's
arithmetic without OpenCV.  The device only sees the finished
fixed-shape batches.

AlphaPose pose training (`alphapose/utils/presets/simple_transform.py:
200-268` train branch, helpers `:271-312` and
`alphapose/utils/transforms.py:526-552,762-801`):
- half-body crop selection, scale jitter
  ``clip(randn*sf + 1, 1-sf, 1+sf)``, rotation
  ``clip(randn*rf, -2rf, 2rf)`` drawn 60% of the time, horizontal flip
  with left/right joint swapping (including the reference's
  ``x *= vis`` zeroing quirk), the center/scale/rot three-point affine,
  and joint warping gated on visibility.

YOLOX detection training (`yolox/data/datasets/mosaicdetection.py:
16-160`, `yolox/data/data_augment.py:23-186`):
- 4-image mosaic on a 114-gray 2Hx2W canvas with scale-preserving
  resizes and border label filtering, the T@S@R@C random affine with
  its ``box_candidates`` filter (note the reference compares post-warp
  boxes against PRE-warp boxes scaled by the affine's scale only),
  CopyPaste-style MixUp of a letterboxed co-sample
  (`mosaicdetection.py:162-241`), HSV gain jitter, and horizontal
  mirror.

Padded label tensors for `yolox_loss.yolox_losses` come out of
``labels_to_padded``.

Every function that takes an image also takes a `ShapeOnly` in its
place: it then makes every random draw it makes for an image of that
shape, computes the labels and joints, and touches no pixel.  A
data-parallel rank replays the other ranks' rows so, which keeps its
generator in step with the one-process stream: no draw reads a pixel
value, only image shapes, boxes and joints.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..data import imgproc

# COCO-17 left/right pairs (AlphaPose `joint_pairs` for coco bodies).
COCO17_FLIP_PAIRS: Tuple[Tuple[int, int], ...] = (
    (1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14),
    (15, 16))
# COCO upper-body joint ids (half-body split, SimpleTransform init).
COCO17_UPPER_BODY_IDS: Tuple[int, ...] = (0, 1, 2, 3, 4, 5, 6, 7, 8,
                                          9, 10)


class ShapeOnly:
    """An image's shape without its pixels (see the module docstring);
    the functions return a `ShapeOnly` where they would return an
    image."""
    __slots__ = ("shape",)

    def __init__(self, shape):
        self.shape = tuple(int(v) for v in shape)


def _pixels(img) -> bool:
    return not isinstance(img, ShapeOnly)


# ---------------------------------------------------------------------------
# Affine construction (`transforms.py:762-796`, without cv2's solver)

def get_affine_transform(center, scale, rot_deg: float,
                         out_wh: Sequence[int],
                         shift=(0.0, 0.0), inv: bool = False
                         ) -> np.ndarray:
    """2x3 affine from (center, pixel scale, rotation) to the output
    crop — same three-point construction as the reference, solved in
    closed form instead of via ``cv2.getAffineTransform``."""
    center = np.asarray(center, np.float64)
    scale = np.asarray(scale, np.float64)
    if scale.ndim == 0:
        scale = np.array([float(scale), float(scale)])
    shift = np.asarray(shift, np.float64)
    dst_w, dst_h = float(out_wh[0]), float(out_wh[1])

    rot = np.pi * rot_deg / 180.0
    sn, cs = np.sin(rot), np.cos(rot)
    src_dir = np.array([0.0 * cs - (-0.5 * scale[0]) * sn,
                        0.0 * sn + (-0.5 * scale[0]) * cs])
    dst_dir = np.array([0.0, -0.5 * dst_w])

    def third(a, b):
        d = a - b
        return b + np.array([-d[1], d[0]])

    src = np.zeros((3, 2))
    dst = np.zeros((3, 2))
    src[0] = center + scale * shift
    src[1] = center + src_dir + scale * shift
    src[2] = third(src[0], src[1])
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    dst[2] = third(dst[0], dst[1])

    if inv:
        src, dst = dst, src
    # solve [x y 1] @ A.T = dst for the 2x3 A
    ones = np.concatenate([src, np.ones((3, 1))], axis=1)
    sol = np.linalg.solve(ones, dst)          # (3, 2)
    return np.ascontiguousarray(sol.T).astype(np.float32)


def apply_affine(points: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine to (..., 2) points (`transforms.py:798-801`)."""
    p = np.asarray(points, np.float32)
    return p @ trans[:, :2].T + trans[:, 2]


def warp_affine(img: np.ndarray, trans: np.ndarray,
                out_wh: Sequence[int],
                border_value: float = 0.0) -> np.ndarray:
    """cv2.warpAffine with bilinear sampling and a constant border
    (`data/imgproc.py:warp_affine`)."""
    return imgproc.warp_affine(img, trans, (int(out_wh[0]), int(out_wh[1])),
                               border_value)


# ---------------------------------------------------------------------------
# Pose augmentation (SimpleTransform train branch)

def flip_joints(joints: np.ndarray, vis: np.ndarray, width: int,
                pairs: Sequence[Tuple[int, int]] = COCO17_FLIP_PAIRS):
    """Horizontal flip with left/right swap (`transforms.py:526-552`).

    joints (J, 2), vis (J,).  Keeps the reference's final
    ``coords *= visibility`` zeroing quirk (x AND y,
    `transforms.py:551`).
    """
    j = np.asarray(joints, np.float32).copy()
    v = np.asarray(vis, np.float32).copy()
    j[:, 0] = width - j[:, 0] - 1.0
    for a, b in pairs:
        if a >= len(j) or b >= len(j):
            continue      # pair table wider than this skeleton
        j[[a, b]] = j[[b, a]]
        v[[a, b]] = v[[b, a]]
    j *= v[:, None]
    return j, v


def half_body_center_scale(rng: np.random.Generator, joints: np.ndarray,
                           vis: np.ndarray,
                           upper_ids: Sequence[int] =
                           COCO17_UPPER_BODY_IDS,
                           aspect_ratio: float = 0.75):
    """Half-body crop target (`simple_transform.py:271-312`): pick the
    upper or lower visible joints (the reference's ``randn() < 0.5``
    coin — randn, not rand, so upper wins ~69% of the time — kept),
    return (center, pixel scale * 1.5) or None."""
    vis = np.asarray(vis) > 0
    upper = [joints[i] for i in range(len(joints))
             if vis[i] and i in set(upper_ids)]
    lower = [joints[i] for i in range(len(joints))
             if vis[i] and i not in set(upper_ids)]
    if rng.standard_normal() < 0.5 and len(upper) > 2:
        sel = upper
    else:
        sel = lower if len(lower) > 2 else upper
    if len(sel) < 2:
        return None
    sel = np.asarray(sel, np.float32)
    center = sel.mean(axis=0)
    w = sel[:, 0].max() - sel[:, 0].min()
    h = sel[:, 1].max() - sel[:, 1].min()
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    return center, np.array([w, h], np.float32) * 1.5


@dataclass
class PoseAugConfig:
    """SimpleTransform train knobs (`DATASET.TRAIN.AUG` in the
    reference configs: SCALE_FACTOR 0.3, ROT_FACTOR 40, FLIP true,
    NUM_JOINTS_HALF_BODY 11, PROB_HALF_BODY)."""
    scale_factor: float = 0.3
    rot_factor: float = 40.0
    flip: bool = True
    num_joints_half_body: int = 11
    prob_half_body: float = -1.0
    input_hw: Tuple[int, int] = (256, 192)
    aspect_ratio: float = 0.75
    flip_pairs: Sequence[Tuple[int, int]] = COCO17_FLIP_PAIRS
    upper_body_ids: Sequence[int] = COCO17_UPPER_BODY_IDS


def pose_train_sample(rng: np.random.Generator, img: np.ndarray,
                      bbox_xyxy: np.ndarray, joints: np.ndarray,
                      vis: np.ndarray,
                      cfg: PoseAugConfig = PoseAugConfig()):
    """One augmented training crop (`simple_transform.py:200-268`).

    img (H, W, 3) float/uint8; joints (J, 2) pixel coords; vis (J,).
    Returns (crop (in_h, in_w, 3), joints_t (J, 2), vis_t (J,)):
    feed through `train.heatmap_targets` for the MSE criterion.
    """
    from .preprocess import bbox_to_center_scale

    H, W = img.shape[:2]
    joints = np.asarray(joints, np.float32).copy()
    vis = np.asarray(vis, np.float32).copy()
    center, scale = bbox_to_center_scale(
        np.asarray(bbox_xyxy, np.float32)[None],
        aspect_ratio=cfg.aspect_ratio)
    center, scale = center[0], scale[0]

    if (vis.sum() > cfg.num_joints_half_body
            and rng.uniform() < cfg.prob_half_body):
        hb = half_body_center_scale(rng, joints, vis,
                                    cfg.upper_body_ids,
                                    cfg.aspect_ratio)
        if hb is not None:
            center, scale = hb

    sf = cfg.scale_factor
    scale = scale * np.clip(rng.standard_normal() * sf + 1.0,
                            1.0 - sf, 1.0 + sf)
    rf = cfg.rot_factor
    rot = (float(np.clip(rng.standard_normal() * rf, -2 * rf, 2 * rf))
           if rng.uniform() <= 0.6 else 0.0)

    if cfg.flip and rng.uniform() > 0.5:
        if _pixels(img):
            img = np.ascontiguousarray(img[:, ::-1])
        joints, vis = flip_joints(joints, vis, W, cfg.flip_pairs)
        center = center.copy()
        center[0] = W - center[0] - 1.0

    in_h, in_w = cfg.input_hw
    trans = get_affine_transform(center, scale, rot, (in_w, in_h))
    crop = (warp_affine(np.asarray(img, np.float32), trans, (in_w, in_h))
            if _pixels(img) else ShapeOnly((in_h, in_w, 3)))
    warped = apply_affine(joints, trans)
    joints_t = np.where((vis > 0)[:, None], warped, joints)
    return crop, joints_t.astype(np.float32), vis


# ---------------------------------------------------------------------------
# YOLOX augmentation (mosaic + random affine + hsv + mirror)

def mosaic_window(i: int, xc: int, yc: int, w: int, h: int,
                  input_h: int, input_w: int):
    """Quadrant window arithmetic (``get_mosaic_coordinate``,
    `mosaicdetection.py:16-34`): returns the canvas window (l_x1, l_y1,
    l_x2, l_y2) and matching source window (s_x1, s_y1, s_x2, s_y2)."""
    if i == 0:      # top-left, anchored at (xc, yc)
        l = (max(xc - w, 0), max(yc - h, 0), xc, yc)
    elif i == 1:    # top-right
        l = (xc, max(yc - h, 0), min(xc + w, input_w * 2), yc)
    elif i == 2:    # bottom-left
        l = (max(xc - w, 0), yc, xc, min(input_h * 2, yc + h))
    else:           # bottom-right
        l = (xc, yc, min(xc + w, input_w * 2), min(input_h * 2, yc + h))
    lx1, ly1, lx2, ly2 = l
    sx1 = w - (lx2 - lx1) if i in (0, 2) else 0
    sy1 = h - (ly2 - ly1) if i in (0, 1) else 0
    return l, (sx1, sy1, sx1 + (lx2 - lx1), sy1 + (ly2 - ly1))


def mosaic4(rng: np.random.Generator, images: Sequence[np.ndarray],
            labels_list: Sequence[np.ndarray],
            input_hw: Tuple[int, int]):
    """4-image mosaic (`mosaicdetection.py:77-135` + the quadrant
    arithmetic of ``get_mosaic_coordinate`` `:16-34`).

    labels are (Mi, 5) xyxy+cls rows.  Returns the (2H, 2W, 3) canvas
    and the concatenated, border-filtered labels.
    """
    input_h, input_w = input_hw
    yc = int(rng.uniform(0.5 * input_h, 1.5 * input_h))
    xc = int(rng.uniform(0.5 * input_w, 1.5 * input_w))
    pixels = all(_pixels(im) for im in images)
    canvas = (np.full((input_h * 2, input_w * 2, 3), 114.0, np.float32)
              if pixels else ShapeOnly((input_h * 2, input_w * 2, 3)))
    out_labels: List[np.ndarray] = []

    for i, (img, labels) in enumerate(zip(images, labels_list)):
        h0, w0 = img.shape[:2]
        s = min(input_h / h0, input_w / w0)
        if pixels:
            img = imgproc.resize_linear(np.asarray(img, np.float32),
                                        (int(w0 * s), int(h0 * s)))
            h, w = img.shape[:2]
        else:
            h, w = int(h0 * s), int(w0 * s)
        (lx1, ly1, lx2, ly2), (sx1, sy1, sx2, sy2) = mosaic_window(
            i, xc, yc, w, h, input_h, input_w)
        if pixels:
            canvas[ly1:ly2, lx1:lx2] = img[sy1:sy2, sx1:sx2]

        if labels.size:
            lab = np.asarray(labels, np.float32).copy()
            padw, padh = lx1 - sx1, ly1 - sy1
            lab[:, 0] = s * labels[:, 0] + padw
            lab[:, 1] = s * labels[:, 1] + padh
            lab[:, 2] = s * labels[:, 2] + padw
            lab[:, 3] = s * labels[:, 3] + padh
            out_labels.append(lab)

    if out_labels:
        lab = np.concatenate(out_labels, axis=0)
        keep = ((lab[:, 0] < 2 * input_w) & (lab[:, 2] > 0)
                & (lab[:, 1] < 2 * input_h) & (lab[:, 3] > 0))
        lab = lab[keep]
    else:
        lab = np.zeros((0, 5), np.float32)
    return canvas, lab


def box_candidates(box1: np.ndarray, box2: np.ndarray, wh_thr=2,
                   ar_thr=20, area_thr=0.2) -> np.ndarray:
    """Post-affine box filter (`data_augment.py:39-51`); boxes (4, M)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + 1e-16) > area_thr) & (ar < ar_thr))


def random_affine(rng: np.random.Generator, img: np.ndarray,
                  targets: np.ndarray, degrees: float = 10.0,
                  translate: float = 0.1,
                  scale_range: Tuple[float, float] = (0.5, 1.5),
                  shear: float = 2.0,
                  out_hw: Optional[Tuple[int, int]] = None):
    """``random_perspective`` with perspective=0
    (`data_augment.py:54-147`): M = T @ S @ R @ C about the INPUT
    image's center, translation/warp/filters in the OUTPUT dims (the
    reference's negative ``border`` maps the 2Hx2W mosaic canvas
    straight to HxW), 114-gray border, corner-warped boxes, candidate
    filter against the PRE-warp boxes scaled by the affine scale only
    (the reference's ``box1 * s``)."""
    ih, iw = img.shape[:2]
    h, w = out_hw if out_hw is not None else (ih, iw)
    C = np.eye(3)
    C[0, 2], C[1, 2] = -iw / 2, -ih / 2
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(*scale_range)
    cs, sn = s * np.cos(a * np.pi / 180), s * np.sin(a * np.pi / 180)
    R[0, :2], R[1, :2] = [cs, sn], [-sn, cs]
    S = np.eye(3)
    S[0, 1] = np.tan(rng.uniform(-shear, shear) * np.pi / 180)
    S[1, 0] = np.tan(rng.uniform(-shear, shear) * np.pi / 180)
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * w
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * h
    M = T @ S @ R @ C

    out = (imgproc.warp_affine(np.asarray(img, np.float32), M[:2], (w, h),
                               114.0)
           if _pixels(img) else ShapeOnly((h, w, 3)))
    if targets.size:
        n = targets.shape[0]
        corners = targets[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
        warped = corners @ M[:2, :2].T + M[:2, 2]
        warped = warped.reshape(n, 4, 2)
        xy = np.concatenate([warped.min(axis=1), warped.max(axis=1)],
                            axis=1)
        keep = box_candidates(targets[:, :4].T * s, xy.T)
        targets = targets[keep].copy()
        targets[:, :4] = xy[keep]
        targets = targets[(targets[:, 0] < w) & (targets[:, 2] > 0)
                          & (targets[:, 1] < h) & (targets[:, 3] > 0)]
    return out, targets


def augment_hsv(rng: np.random.Generator, img: np.ndarray,
                hgain=0.015, sgain=0.7, vgain=0.4) -> np.ndarray:
    """HSV gain jitter (`data_augment.py:23-37`): hue shifted mod 180,
    sat/val scaled and clipped.  img float RGB in [0, 255]."""
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    if not _pixels(img):
        return img
    hsv = imgproc.rgb_to_hsv(np.asarray(img, np.float32) / 255.0)
    hsv[..., 0] = (hsv[..., 0] / 2.0 * r[0]) % 180.0 * 2.0  # cv2 H/2
    hsv[..., 1] = np.clip(hsv[..., 1] * r[1], 0, 1)
    # V is in [0,1] here (float cvtColor); the reference's uint8 LUT is
    # clip(x*r, 0, 255) — saturate at 1.0, NOT at the unreachable 255.
    hsv[..., 2] = np.clip(hsv[..., 2] * r[2], 0, 1)
    return imgproc.hsv_to_rgb(hsv) * 255.0


def mirror_boxes(rng: np.random.Generator, img: np.ndarray,
                 boxes: np.ndarray, prob: float = 0.5):
    """Horizontal mirror (`data_augment.py:180-186`)."""
    h, w = img.shape[:2]
    if rng.uniform() < prob:
        if _pixels(img):
            img = np.ascontiguousarray(img[:, ::-1])
        boxes = boxes.copy()
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
    return img, boxes


def labels_to_padded(labels_xyxy_cls: np.ndarray, max_labels: int
                     ) -> np.ndarray:
    """(M, 5) xyxy+cls -> (max_labels, 5) [cls, cx, cy, w, h] rows for
    `yolox_loss.yolox_losses` (zero rows pad), the ``TrainTransform``
    output contract (`data_augment.py:214-271`)."""
    out = np.zeros((max_labels, 5), np.float32)
    lab = np.asarray(labels_xyxy_cls, np.float32)[:max_labels]
    if lab.size:
        out[:lab.shape[0], 0] = lab[:, 4]
        out[:lab.shape[0], 1] = (lab[:, 0] + lab[:, 2]) / 2
        out[:lab.shape[0], 2] = (lab[:, 1] + lab[:, 3]) / 2
        out[:lab.shape[0], 3] = lab[:, 2] - lab[:, 0]
        out[:lab.shape[0], 4] = lab[:, 3] - lab[:, 1]
    return out


def mixup(rng: np.random.Generator, origin_img: np.ndarray,
          origin_labels: np.ndarray, cp_img: np.ndarray,
          cp_labels: np.ndarray, input_hw: Tuple[int, int],
          mixup_scale: Tuple[float, float] = (0.5, 1.5)):
    """CopyPaste-style MixUp (`mosaicdetection.py:162-241`).

    Blends a letterboxed, jit-scaled, optionally mirrored co-sample
    into the post-affine mosaic image at 0.5/0.5 and concatenates its
    surviving labels.  The caller supplies the co-sample (``cp_img``,
    ``cp_labels`` (M, 5+) xyxy + class [+ extra] rows, M >= 1 — the
    reference's resample-until-annotated loop is the dataset's job).

    Reference quirks kept: the uint8 truncation round-trip of the
    padded canvas (`:194-197`), no box clipping after the offset shift
    (`:216-225` commented out), wh_thr=5 candidate filter, draw order
    (jit, flip, y_offset, x_offset), and the no-op return when no
    co-box survives (image NOT blended, `:228`).
    """
    jit_factor = float(rng.uniform(*mixup_scale))
    flip = bool(rng.uniform() > 0.5)
    in_h, in_w = input_hw
    pixels = _pixels(origin_img) and _pixels(cp_img)

    h0, w0 = cp_img.shape[:2]
    r = min(in_h / h0, in_w / w0)
    if pixels:
        cp_canvas = np.full((in_h, in_w, 3), 114.0, np.float32)
        resized = imgproc.resize_linear(np.asarray(cp_img, np.float32),
                                        (int(w0 * r), int(h0 * r)))
        cp_canvas[: int(h0 * r), : int(w0 * r)] = resized
        cp_canvas = imgproc.resize_linear(
            cp_canvas, (int(in_w * jit_factor), int(in_h * jit_factor)))
        oh, ow = cp_canvas.shape[:2]
    else:
        oh, ow = int(in_h * jit_factor), int(in_w * jit_factor)
    r *= jit_factor
    if flip and pixels:
        cp_canvas = cp_canvas[:, ::-1]

    th, tw = origin_img.shape[:2]
    ph, pw = max(oh, th), max(ow, tw)
    y_off = int(rng.integers(0, ph - th)) if ph > th else 0
    x_off = int(rng.integers(0, pw - tw)) if pw > tw else 0
    if pixels:
        padded = np.zeros((ph, pw, 3), np.uint8)
        padded[:oh, :ow] = cp_canvas        # uint8 truncation (quirk)
        cropped = padded[y_off:y_off + th, x_off:x_off + tw]

    lab = np.asarray(cp_labels, np.float32).copy()
    boxes_o = lab[:, :4] * r                 # adjust_box_anns, no clip
    if flip:
        boxes_o[:, 0::2] = ow - boxes_o[:, 0::2][:, ::-1]
    boxes_t = boxes_o.copy()
    boxes_t[:, 0::2] -= x_off
    boxes_t[:, 1::2] -= y_off
    keep = box_candidates(boxes_o.T, boxes_t.T, wh_thr=5)

    origin_labels = np.asarray(origin_labels, np.float32)
    if keep.sum() >= 1:
        new = np.concatenate([boxes_t[keep], lab[keep, 4:]], axis=1)
        new = new[(new[:, 0] < tw) & (new[:, 2] > 0)
                  & (new[:, 1] < th) & (new[:, 3] > 0)]
        origin_labels = np.vstack([origin_labels, new])
        if pixels:
            origin_img = (0.5 * np.asarray(origin_img, np.float32)
                          + 0.5 * cropped.astype(np.float32))
    return origin_img, origin_labels


def yolox_train_sample(rng: np.random.Generator,
                       images: Sequence[np.ndarray],
                       labels_list: Sequence[np.ndarray],
                       input_hw: Tuple[int, int],
                       max_labels: int = 100,
                       degrees: float = 10.0, translate: float = 0.1,
                       scale_range: Tuple[float, float] = (0.5, 1.5),
                       shear: float = 2.0,
                       cp_image: Optional[np.ndarray] = None,
                       cp_labels: Optional[np.ndarray] = None,
                       mixup_scale: Tuple[float, float] = (0.5, 1.5)):
    """Full mosaic pipeline for one training sample
    (`mosaicdetection.py:77-160`): mosaic -> random affine with border
    (-H/2, -W/2) -> mixup (when a co-sample is given and any mosaic
    label survived — the trainer's ``enable_mixup=True`` default,
    `:148-160`) -> hsv -> mirror -> letterbox resize to ``input_hw`` ->
    padded label tensor."""
    input_h, input_w = input_hw
    canvas, lab = mosaic4(rng, images, labels_list, input_hw)
    # the reference's border=(-H/2, -W/2) makes random_perspective map
    # the 2Hx2W canvas straight into an HxW output
    img, lab = random_affine(rng, canvas, lab, degrees, translate,
                             scale_range, shear,
                             out_hw=(input_h, input_w))
    if cp_image is not None and lab.size:
        img, lab = mixup(rng, img, lab, cp_image,
                         np.asarray(cp_labels, np.float32),
                         input_hw, mixup_scale)
    img = augment_hsv(rng, img)
    img, lab = mirror_boxes(rng, img, lab if lab.size else
                            np.zeros((0, 5), np.float32))
    return img, labels_to_padded(lab, max_labels)
