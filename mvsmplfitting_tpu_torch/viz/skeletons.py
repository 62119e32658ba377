"""Per-format skeleton tables and `vis_frame` (port of
`viz/skeletons.py`), drawn with `viz/draw.py` (OpenCV's primitives in
host C++) where JAX draws with cv2.

Rebuild of the reference's drawing surface
(`alphapose_core/alphapose/utils/vis.py`, 865 LoC): `vis_frame` /
`vis_frame_fast` there re-declare one (limb, point-color, line-color)
triple inline per joint count (`vis.py:289-432`).  Here each format is
one :class:`SkeletonSpec` in a registry shared by the stream writers,
the overlay drawing, and the flip/half-body augmentation tables — the
topology constants are the reference's (they are data contracts of the
public keypoint formats), the construction is table-driven instead of
six copies of the drawing loop.

Joint-index topology sources (reference `file:line`):
  - coco17 limbs/colors        `vis.py:291-304`
  - mpii16                     `vis.py:306-312`
  - halpe26 (+feet)            `vis.py:397-417`
  - halpe68 (+hands)           `vis.py:371-395`
  - halpe136 (+face+hands)     `vis.py:316-341`
  - coco-wholebody 133         `vis.py:343-369`
  - single-hand 21(x2)         `vis.py:418-431`
  - flip pairs / lower-body ids: the dataset classes
    (`alphapose/datasets/{mscoco,mpii,halpe_26,halpe_68_noface,
    halpe_136,coco_wholebody,single_hand}.py`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from . import draw

Pair = Tuple[int, int]
Color = Tuple[int, int, int]


def _chain(a: int, b: int) -> Tuple[Pair, ...]:
    """Consecutive-index limb chain a-(a+1)-...-b (inclusive)."""
    return tuple((i, i + 1) for i in range(a, b))


def _hand(root: int, first: int) -> Tuple[Pair, ...]:
    """A 21-joint hand: 5 fingers of 4 joints each, rooted at the
    wrist; finger f starts at ``first + 4*f``."""
    limbs = []
    for f in range(5):
        s = first + 4 * f
        limbs += [(root, s)] + list(_chain(s, s + 3))
    return tuple(limbs)


# --- color tables (BGR, the reference's constants) -------------------
RED: Color = (0, 0, 255)
BLUE: Color = (255, 0, 0)
PURPLE: Color = (255, 0, 255)
WHITE: Color = (255, 255, 255)

# 17 COCO joints + appended neck (`vis.py:298-300`).
_COCO_P = ((0, 255, 255), (0, 191, 255), (0, 255, 102), (0, 77, 255),
           (0, 255, 0), (77, 255, 255), (77, 255, 204), (77, 204, 255),
           (191, 255, 77), (77, 191, 255), (191, 255, 77),
           (204, 77, 255), (77, 255, 204), (191, 77, 255),
           (77, 255, 191), (127, 77, 255), (77, 255, 127), (0, 255, 255))
_COCO_L = ((0, 215, 255), (0, 255, 204), (0, 134, 255), (0, 255, 50),
           (77, 255, 222), (77, 196, 255), (77, 135, 255),
           (191, 255, 77), (77, 255, 77), (77, 222, 255),
           (255, 156, 127), (0, 127, 255), (255, 127, 77),
           (0, 77, 255), (255, 77, 36))
# Halpe body joints 17-19 (head/neck/shoulder-root) + feet 20-25
# (`vis.py:404-409`).
_HALPE_P = _COCO_P[:17] + ((77, 255, 255), (0, 255, 255), (77, 204, 255),
                           (0, 255, 255), (0, 191, 255), (0, 255, 102),
                           (0, 77, 255), (0, 255, 0), (77, 255, 255))
_HALPE_L = ((0, 215, 255), (0, 255, 204), (0, 134, 255), (0, 255, 50),
            (0, 255, 102), (77, 255, 222), (77, 196, 255),
            (77, 135, 255), (191, 255, 77), (77, 255, 77),
            (77, 191, 255), (204, 77, 255), (77, 222, 255),
            (255, 156, 127), (0, 127, 255), (255, 127, 77),
            (0, 77, 255), (255, 77, 36), (0, 77, 255), (0, 77, 255),
            (0, 77, 255), (0, 77, 255), (255, 156, 127), (255, 156, 127))
_MPII_P = (PURPLE, BLUE, BLUE, RED, RED, BLUE, BLUE, RED, RED, PURPLE,
           PURPLE, PURPLE, RED, RED, BLUE, BLUE)
_MPII_L = (PURPLE, BLUE, BLUE, RED, RED, BLUE, BLUE, RED, RED, PURPLE,
           PURPLE, RED, RED, BLUE, BLUE)

# --- limb tables ------------------------------------------------------
_COCO17_LIMBS = ((0, 1), (0, 2), (1, 3), (2, 4), (5, 6), (5, 7), (7, 9),
                 (6, 8), (8, 10), (17, 11), (17, 12), (11, 13), (12, 14),
                 (13, 15), (14, 16))
_MPII16_LIMBS = ((8, 9), (11, 12), (11, 10), (2, 1), (1, 0), (13, 14),
                 (14, 15), (3, 4), (4, 5), (8, 7), (7, 6), (6, 2),
                 (6, 3), (8, 12), (8, 13))
_HALPE_BODY_LIMBS = ((0, 1), (0, 2), (1, 3), (2, 4), (5, 18), (6, 18),
                     (5, 7), (7, 9), (6, 8), (8, 10), (17, 18), (18, 19),
                     (19, 11), (19, 12), (11, 13), (12, 14), (13, 15),
                     (14, 16), (20, 24), (21, 25), (23, 25), (22, 24),
                     (15, 24), (16, 25))
_HALPE136_FACE = (_chain(26, 38) + _chain(38, 42) + _chain(43, 47)
                  + _chain(48, 52) + _chain(53, 56) + _chain(57, 61)
                  + _chain(62, 67) + _chain(68, 73) + _chain(74, 93))
_WB133_BODY = ((0, 1), (0, 2), (1, 3), (2, 4), (5, 7), (7, 9), (6, 8),
               (8, 10), (11, 13), (12, 14), (13, 15), (14, 16), (18, 19),
               (21, 22), (20, 22), (17, 19), (15, 19), (16, 22))
_WB133_FACE = (_chain(23, 39) + _chain(40, 44) + _chain(45, 49)
               + _chain(50, 53) + _chain(54, 58) + _chain(59, 64)
               + _chain(65, 70) + _chain(71, 90))

# --- flip pairs (dataset classes) ------------------------------------
_BODY17_FLIP = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12),
                (13, 14), (15, 16))
HALPE26_FLIP = _BODY17_FLIP + ((20, 21), (22, 23), (24, 25))
# `halpe_136.py:38-45`
HALPE136_FLIP = HALPE26_FLIP + (
    (26, 42), (27, 41), (28, 40), (29, 39), (30, 38), (31, 37),
    (32, 36), (33, 35), (43, 52), (44, 51), (45, 50), (46, 49),
    (47, 48), (62, 71), (63, 70), (64, 69), (65, 68), (66, 73),
    (67, 72), (57, 61), (58, 60), (74, 80), (75, 79), (76, 78),
    (87, 89), (93, 91), (86, 90), (85, 81), (84, 82),
) + tuple((94 + i, 115 + i) for i in range(21))
# `coco_wholebody.py:38-46`
WB133_FLIP = _BODY17_FLIP + (
    (17, 20), (18, 21), (19, 22), (23, 39), (24, 38), (25, 37),
    (26, 36), (27, 35), (28, 34), (29, 33), (30, 32), (40, 49),
    (41, 48), (42, 47), (43, 46), (44, 45), (59, 68), (60, 67),
    (61, 66), (62, 65), (63, 70), (64, 69), (54, 58), (55, 57),
    (71, 77), (72, 76), (73, 75), (84, 86), (90, 88), (83, 87),
    (82, 78), (81, 79),
) + tuple((91 + i, 112 + i) for i in range(21))
# `halpe_68_noface.py:38-41`
HALPE68_FLIP = HALPE26_FLIP + tuple((26 + i, 47 + i) for i in range(21))
MPII16_FLIP = ((0, 5), (1, 4), (2, 3), (10, 15), (11, 14), (12, 13))

_HALPE_LOWER = (11, 12, 13, 14, 15, 16, 20, 21, 22, 23, 24, 25)
_WB_LOWER = (11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22)
_COCO_LOWER = (11, 12, 13, 14, 15, 16)


@dataclass(frozen=True)
class SkeletonSpec:
    """One keypoint format: drawing topology + augmentation tables."""
    name: str
    num_joints: int
    limbs: Tuple[Pair, ...]
    point_colors: Tuple[Color, ...]
    line_colors: Tuple[Color, ...]
    flip_pairs: Tuple[Pair, ...]
    lower_body_ids: Tuple[int, ...] = ()
    # coco17 drawing appends a synthetic neck = mean(shoulders)
    # (`vis.py:219-221`); joints >= num_joints in `limbs` refer to it.
    synthetic_neck: bool = False


SKELETONS = {
    "coco17": SkeletonSpec(
        "coco17", 17, _COCO17_LIMBS, _COCO_P, _COCO_L,
        _BODY17_FLIP, _COCO_LOWER, synthetic_neck=True),
    "mpii16": SkeletonSpec(
        "mpii16", 16, _MPII16_LIMBS, _MPII_P, _MPII_L, MPII16_FLIP),
    "halpe26": SkeletonSpec(
        "halpe26", 26, _HALPE_BODY_LIMBS, _HALPE_P, _HALPE_L,
        HALPE26_FLIP, _HALPE_LOWER),
    "halpe68": SkeletonSpec(
        "halpe68", 68,
        _HALPE_BODY_LIMBS + _hand(26, 27) + _hand(47, 48),
        _HALPE_P, _HALPE_L, HALPE68_FLIP, _HALPE_LOWER),
    "halpe136": SkeletonSpec(
        "halpe136", 136,
        _HALPE_BODY_LIMBS + _HALPE136_FACE + _hand(94, 95)
        + _hand(115, 116),
        _HALPE_P, _HALPE_L, HALPE136_FLIP, _HALPE_LOWER),
    "coco_wholebody133": SkeletonSpec(
        "coco_wholebody133", 133,
        _WB133_BODY + _WB133_FACE + _hand(91, 92) + _hand(112, 113),
        _COCO_P[:17] + ((0, 255, 255), (0, 191, 255), (0, 255, 102),
                        (0, 77, 255), (0, 255, 0), (77, 255, 255)),
        _HALPE_L[:22], WB133_FLIP, _WB_LOWER),
    # Two stacked 21-joint hands (`single_hand.py` loads L+R per item;
    # the vis table spans 42 indices, all white).
    "hand21": SkeletonSpec(
        "hand21", 21, _hand(0, 1) + _hand(21, 22),
        (WHITE,) * 21, (WHITE,) * 21, ()),
}

_BY_COUNT = {s.num_joints: s for s in SKELETONS.values()
             if s.name != "mpii16"}
_BY_COUNT[16] = SKELETONS["mpii16"]


def skeleton_for(num_joints: int,
                 fmt: Optional[str] = None) -> SkeletonSpec:
    """Resolve a format by name, else by joint count (the reference's
    `kp_num` dispatch, `vis.py:285-312`); unknown counts fall back to
    coco17 drawing on the first 17 joints.  An explicitly named but
    unknown format raises (a typo must not silently train/draw with
    the wrong flip/limb tables)."""
    if fmt is not None:
        if fmt not in SKELETONS:
            raise ValueError(f"unknown skeleton format {fmt!r}; "
                             f"known: {sorted(SKELETONS)}")
        return SKELETONS[fmt]
    return _BY_COUNT.get(num_joints, SKELETONS["coco17"])


def get_color_fast(idx: int) -> Color:
    """Per-track color cycle (`vis.py:37-41`)."""
    pool = (RED, (0, 255, 0), BLUE, (255, 255, 0), (0, 255, 255),
            (0, 165, 255), PURPLE, WHITE)
    return pool[idx % 8]


def vis_frame(img: np.ndarray, keypoints: np.ndarray,
              kp_scores: Optional[np.ndarray] = None, *,
              fmt: Optional[str] = None, vis_thresh: float = 0.05,
              track_id: Optional[int] = None, fast: bool = False,
              box: Optional[Sequence[float]] = None) -> np.ndarray:
    """Draw one person's skeleton in place with the reference's
    semantics (`vis.py:434-520`): joints above threshold are circles
    blended at their confidence, limbs filled ellipse sticks of width
    `(s_a + s_b) + 1` blended at `0.5*(s_a+s_b) - 0.1`.  ``fast=True`` is
    `vis_frame_fast` (`vis.py:249-271`): opaque circles and lines of
    thickness `2*int(s_a+s_b) + 1`.  ``track_id`` recolors everything
    from the track pool; ``box`` draws the xyxy detection box.
    `img` is a C-contiguous (H, W, 3) uint8 BGR array."""
    kp = np.asarray(keypoints, np.float64)
    sc = (np.asarray(kp_scores, np.float64) if kp_scores is not None
          else (kp[:, 2] if kp.shape[1] > 2
                else np.ones(len(kp), np.float64)))
    kp = kp[:, :2]
    spec = skeleton_for(len(kp), fmt)
    if spec.synthetic_neck and len(kp) == spec.num_joints:
        kp = np.concatenate([kp, 0.5 * (kp[5:6] + kp[6:7])])
        sc = np.concatenate([sc, 0.5 * (sc[5:6] + sc[6:7])])
    track_color = (get_color_fast(abs(int(track_id)))
                   if track_id is not None else None)

    if box is not None:
        draw.rectangle(img, (int(box[0]), int(box[1])),
                       (int(box[2]), int(box[3])), track_color or BLUE, 2)

    finite = (np.isfinite(kp).all(axis=1)
              & (np.abs(kp) < 1e8).all(axis=1))
    visible = finite & (sc > vis_thresh)
    # Truncation, not rounding: the reference casts with int()
    # (`vis.py:252,454`).
    pts = np.clip(np.nan_to_num(kp), -1e8, 1e8).astype(int)

    for n in range(len(kp)):
        if not visible[n]:
            continue
        in_table = n < len(spec.point_colors)
        color = track_color or (spec.point_colors[n] if in_table
                                else WHITE)
        if fast:
            # Beyond-table joints draw as r1 rings (`vis.py:260`).
            if in_table:
                draw.circle(img, tuple(pts[n]), 3, color, -1)
            else:
                draw.circle(img, tuple(pts[n]), 1, WHITE, 2)
        else:
            bg = img.copy()
            if in_table:
                draw.circle(bg, tuple(pts[n]), 2, color, -1)
                a = float(np.clip(sc[n], 0.0, 1.0))
            else:
                # `vis.py:485-490`: r1 ring, doubled transparency.
                draw.circle(bg, tuple(pts[n]), 1, WHITE, 2)
                a = float(np.clip(sc[n] * 2.0, 0.0, 1.0))
            img[:] = draw.add_weighted(bg, a, img, 1 - a, 0)
    for i, (a, b) in enumerate(spec.limbs):
        if a >= len(kp) or b >= len(kp) or not (visible[a] and visible[b]):
            continue
        in_table = i < len(spec.line_colors)
        color = track_color or (spec.line_colors[i] if in_table
                                else WHITE)
        if fast:
            # Beyond-table limbs are 1-px white lines (`vis.py:271`).
            if in_table:
                draw.line(img, tuple(pts[a]), tuple(pts[b]), color,
                          2 * int(sc[a] + sc[b]) + 1)
            else:
                draw.line(img, tuple(pts[a]), tuple(pts[b]), WHITE, 1)
            continue
        bg = img.copy()
        if in_table:
            mx, my = 0.5 * (pts[a] + pts[b])
            dx, dy = (pts[a] - pts[b]).astype(np.float64)
            length = math.hypot(dx, dy)
            angle = math.degrees(math.atan2(dy, dx))
            stick = draw.ellipse2poly(
                (int(mx), int(my)),
                (int(length / 2), int(sc[a] + sc[b] + 1)),
                int(angle), 0, 360, 1)
            draw.fill_convex_poly(bg, stick, color)
        else:
            # `vis.py:511-512`: thin white line beyond the table.
            draw.line(bg, tuple(pts[a]), tuple(pts[b]), WHITE, 1)
        # The reference's limb alpha branches on the last index of the
        # points loop (`vis.py:513-516`), not on the limb: the soft
        # 0.5*(sa+sb)-0.1 applies only to formats whose joint count fits
        # the point-color table (coco17/mpii16/halpe26); the others draw
        # every limb at min(1, sa+sb).
        if len(kp) - 1 < len(spec.point_colors):
            alpha = float(np.clip(0.5 * (sc[a] + sc[b]) - 0.1, 0.0, 1.0))
        else:
            alpha = float(np.clip(sc[a] + sc[b], 0.0, 1.0))
        img[:] = draw.add_weighted(bg, alpha, img, 1 - alpha, 0)
    return img
