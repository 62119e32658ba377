"""Center/scale crop transforms (`code/utils/module_utils.py:390-486`).

The reference carries the classic MPII-era ``get_transform`` /
``transform`` / ``crop`` / ``uncrop`` quadruple (200*scale box,
1-indexed points, integer truncation) for evaluation-style crops.
Host-side numpy (port of `ops/crop.py`; its `cv2.resize` calls are
`data/imgproc.py`'s, OpenCV 5.0.0's arithmetic without OpenCV), with the
reference's quirks preserved:
1-indexed pixel coordinates in ``transform_point``, int truncation of
transformed points, cubic resize in ``crop`` vs nearest in ``uncrop``,
and rotation padding computed from the corner diagonal.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["get_transform", "transform_point", "crop", "uncrop"]


def get_transform(center, scale, res, rot: float = 0.0) -> np.ndarray:
    """3x3 image-to-crop transform (`module_utils.py:390-414`)."""
    h = 200.0 * float(scale)
    t = np.zeros((3, 3))
    t[0, 0] = res[1] / h
    t[1, 1] = res[0] / h
    t[0, 2] = res[1] * (-float(center[0]) / h + 0.5)
    t[1, 2] = res[0] * (-float(center[1]) / h + 0.5)
    t[2, 2] = 1.0
    if rot != 0:
        rot = -rot  # rotation direction matches the cropped frame
        rot_rad = rot * np.pi / 180.0
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        rot_mat = np.zeros((3, 3))
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
        rot_mat[2, 2] = 1.0
        t_mat = np.eye(3)
        t_mat[0, 2] = -res[1] / 2
        t_mat[1, 2] = -res[0] / 2
        t_inv = t_mat.copy()
        t_inv[:2, 2] *= -1
        t = t_inv @ rot_mat @ t_mat @ t
    return t


def transform_point(pt, center, scale, res, invert: bool = False,
                    rot: float = 0.0) -> np.ndarray:
    """Map a 1-INDEXED pixel location between image and crop frames
    (`module_utils.py:416-423`, including the int truncation)."""
    t = get_transform(center, scale, res, rot=rot)
    if invert:
        t = np.linalg.inv(t)
    new_pt = t @ np.array([pt[0] - 1.0, pt[1] - 1.0, 1.0])
    return new_pt[:2].astype(int) + 1


def crop(img: np.ndarray, center, scale, res: Sequence[int],
         rot: float = 0.0) -> np.ndarray:
    """Crop ``img`` around (center, 200*scale) to ``res``
    (`module_utils.py:425-459`)."""
    import scipy.ndimage

    from ..data.imgproc import resize_cubic

    ul = np.array(transform_point([1, 1], center, scale, res,
                                  invert=True)) - 1
    br = np.array(transform_point([res[0] + 1, res[1] + 1], center,
                                  scale, res, invert=True)) - 1

    pad = int(np.linalg.norm(br - ul) / 2 - float(br[1] - ul[1]) / 2)
    if rot != 0:
        ul -= pad
        br += pad

    new_shape = [br[1] - ul[1], br[0] - ul[0]]
    if img.ndim > 2:
        new_shape += [img.shape[2]]
    new_img = np.zeros(new_shape)

    new_x = max(0, -ul[0]), min(br[0], img.shape[1]) - ul[0]
    new_y = max(0, -ul[1]), min(br[1], img.shape[0]) - ul[1]
    old_x = max(0, ul[0]), min(img.shape[1], br[0])
    old_y = max(0, ul[1]), min(img.shape[0], br[1])
    new_img[new_y[0]:new_y[1], new_x[0]:new_x[1]] = \
        img[old_y[0]:old_y[1], old_x[0]:old_x[1]]

    if rot != 0:
        new_img = scipy.ndimage.rotate(new_img, rot, reshape=False)
        new_img = new_img[pad:-pad, pad:-pad]

    return resize_cubic(new_img, tuple(res))


def uncrop(img: np.ndarray, center, scale,
           orig_shape: Tuple[int, ...]) -> np.ndarray:
    """Paste a crop back into the original frame
    (`module_utils.py:461-486`; nearest-neighbor, uint8).

    Parity note: the reference's version is dead code with two latent
    bugs — it overwrites its zero canvas with the resized crop and
    returns that instead of the full-frame paste, and it hands
    ``crop_shape`` to ``cv2.resize`` in (h, w) order.  This implements
    the evidently intended semantics (resize the crop to its source
    box, paste into a zeroed original-size canvas) rather than the
    broken literal behavior.
    """
    from ..data.imgproc import resize_nearest

    res = img.shape[:2]
    ul = np.array(transform_point([1, 1], center, scale, res,
                                  invert=True)) - 1
    br = np.array(transform_point([res[0] + 1, res[1] + 1], center,
                                  scale, res, invert=True)) - 1
    crop_shape = (br[1] - ul[1], br[0] - ul[0])

    new_img = np.zeros(orig_shape, dtype=np.uint8)
    new_x = max(0, -ul[0]), min(br[0], orig_shape[1]) - ul[0]
    new_y = max(0, -ul[1]), min(br[1], orig_shape[0]) - ul[1]
    old_x = max(0, ul[0]), min(orig_shape[1], br[0])
    old_y = max(0, ul[1]), min(orig_shape[0], br[1])
    big = resize_nearest(img, (crop_shape[1], crop_shape[0]))
    new_img[old_y[0]:old_y[1], old_x[0]:old_x[1]] = \
        big[new_y[0]:new_y[1], new_x[0]:new_x[1]]
    return new_img
