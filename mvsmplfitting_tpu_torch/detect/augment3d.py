"""3D-SMPL training-target transform for HybrIK, on the host (port of
`detect/augment3d.py`: JAX's numpy carried over as it is, so that the
same `np.random.Generator` draws come in the same order; its
`cv2.warpAffine` is `augment.warp_affine`, OpenCV 5.0.0's arithmetic in
`data/imgproc.py`).

Behavioral rebuild of the reference's
`alphapose_core/alphapose/utils/presets/simple_transform_3d_smpl.py`
(`SimpleTransform3DSMPL.__call__`, the `3d_data_w_smpl` branch,
`:308-515`) plus its numpy helpers from
`alphapose_core/alphapose/utils/transforms.py` — the piece that makes
the HybrIK network *trainable*: it turns a labeled person (bbox, 17
H36M + 29 SMPL image/cam joints, SMPL beta/theta, twist phi) into the
integral uvd/xyz regression targets, quaternion theta targets, and
camera params the train step consumes.

All of this runs on the host as part of the input pipeline (numpy,
explicit `np.random.Generator`); the device sees only fixed-shape
batches.  The reference ships this transform but no
dataset or criterion for it (its HybrIK dataset classes live upstream
and its `SMPL_layer` import is commented out); the joint-pair tables
below are therefore the published HybrIK ones, recorded here as the
data contract.  Golden tests (`tests/test_augment3d.py`) pin the
deterministic eval path and every stochastic helper against the
reference's own numpy code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np

from .augment import apply_affine, get_affine_transform, warp_affine

# Left/right pairs of the SMPL-24 kinematic tree, the HybrIK 29-joint
# extension (24 + 5 leaves; (25, 26)/(27, 28) are the paired leaves),
# and the H36M 17-joint set.  The twist pairs are the 24-joint pairs
# shifted by -1 (23 twists for joints 1..23, `flip_twist`
# `transforms.py:917-934`).
SMPL24_PAIRS: Tuple[Tuple[int, int], ...] = (
    (1, 2), (4, 5), (7, 8), (10, 11), (13, 14), (16, 17), (18, 19),
    (20, 21), (22, 23))
SMPL29_PAIRS: Tuple[Tuple[int, int], ...] = SMPL24_PAIRS + (
    (25, 26), (27, 28))
H36M17_PAIRS: Tuple[Tuple[int, int], ...] = (
    (1, 4), (2, 5), (3, 6), (11, 14), (12, 15), (13, 16))

# The 3D transform's image normalization is mean AND std
# (`simple_transform_3d_smpl.py:466-475`), unlike the 2D path's
# mean-only (`simple_transform.py:98-100`).
MEAN_3D = np.asarray([0.406, 0.457, 0.480], np.float32)
STD_3D = np.asarray([0.225, 0.224, 0.229], np.float32)


# ---------------------------------------------------------------------------
# numpy helpers (`alphapose/utils/transforms.py`)

def flip_joints_3d(joints_3d: np.ndarray, width: int,
                   pairs: Sequence[Tuple[int, int]]) -> np.ndarray:
    """(J, 3, 2) [coords, vis] horizontal flip + left/right swap,
    ending in the reference's ``coords *= vis`` zeroing
    (`transforms.py:526-552`)."""
    j = joints_3d.copy()
    j[:, 0, 0] = width - j[:, 0, 0] - 1
    for a, b in pairs:
        j[[a, b]] = j[[b, a]]
    j[:, :, 0] *= j[:, :, 1]
    return j


def flip_xyz_joints_3d(joints_3d: np.ndarray,
                       pairs: Sequence[Tuple[int, int]]) -> np.ndarray:
    """(J, 3) metric joints: negate x, swap pairs
    (`transforms.py:832-857`)."""
    j = joints_3d.copy()
    j[:, 0] *= -1
    for a, b in pairs:
        j[[a, b]] = j[[b, a]]
    return j


def flip_thetas(thetas: np.ndarray,
                pairs: Sequence[Tuple[int, int]]) -> np.ndarray:
    """(24, 3) axis-angles under a mirror: negate the y/z components,
    swap left/right joints (`transforms.py:804-829`)."""
    t = thetas.copy()
    t[:, 1] *= -1
    t[:, 2] *= -1
    for a, b in pairs:
        t[[a, b]] = t[[b, a]]
    return t


def flip_twist(twist_phi: np.ndarray, twist_weight: np.ndarray,
               pairs: Sequence[Tuple[int, int]]):
    """(23, 2) (cos, sin) twists: keep cos, negate sin, swap pairs
    shifted by -1 (`transforms.py:917-934`)."""
    phi = np.stack([twist_phi[:, 0], -twist_phi[:, 1]], axis=1)
    w = twist_weight.copy()
    for a, b in pairs:
        phi[[a - 1, b - 1]] = phi[[b - 1, a - 1]]
        w[[a - 1, b - 1]] = w[[b - 1, a - 1]]
    return phi, w


def rodrigues_np(rot_vecs: np.ndarray) -> np.ndarray:
    """(N, 3) axis-angle -> (N, 3, 3), with the reference's +1e-8
    inside the norm (`batch_rodrigues_numpy`,
    `transforms.py:860-890`)."""
    angle = np.linalg.norm(rot_vecs + 1e-8, axis=1, keepdims=True)
    rot_dir = rot_vecs / angle
    cos = np.cos(angle)[:, None, :]
    sin = np.sin(angle)[:, None, :]
    rx, ry, rz = np.split(rot_dir, 3, axis=1)
    zeros = np.zeros_like(rx)
    K = np.concatenate([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                       axis=1).reshape((-1, 3, 3))
    ident = np.eye(3)[None]
    return ident + sin * K + (1 - cos) * np.einsum("bij,bjk->bik", K, K)


def rotmat_to_quat_np(rotmat: np.ndarray) -> np.ndarray:
    """(N, 3, 3) -> (N, 4) (w, x, y, z) quaternions — the reference's
    trace-only branch (`rotmat_to_quat_numpy`, `transforms.py:893-914`;
    it assumes w is well-conditioned, i.e. rotations < pi)."""
    trace = np.einsum("bii->b", rotmat) + 1
    w = np.sqrt(trace.clip(min=1e-8)) / 2
    x = (rotmat[:, 2, 1] - rotmat[:, 1, 2]) / (4 * w)
    y = (rotmat[:, 0, 2] - rotmat[:, 2, 0]) / (4 * w)
    z = (rotmat[:, 1, 0] - rotmat[:, 0, 1]) / (4 * w)
    return np.stack([w, x, y, z], axis=1)


def intrinsic_matrix(f, c, inv: bool = False) -> np.ndarray:
    """K or K^-1 from (fx, fy), (cx, cy) (`get_intrinsic_metrix`,
    `transforms.py:936-951`)."""
    K = np.zeros((3, 3), np.float32)
    if inv:
        K[0, 0], K[1, 1] = 1.0 / f[0], 1.0 / f[1]
        K[0, 2], K[1, 2] = -c[0] / f[0], -c[1] / f[1]
    else:
        K[0, 0], K[1, 1] = f[0], f[1]
        K[0, 2], K[1, 2] = c[0], c[1]
    K[2, 2] = 1
    return K


def box_to_center_scale(bbox, aspect_ratio: float,
                        scale_mult: float = 1.25):
    """xyxy -> (center, pixel scale) with aspect clipping
    (`bbox.py:197-214`, pixel_std 1)."""
    xmin, ymin, xmax, ymax = (float(v) for v in bbox)
    w, h = xmax - xmin, ymax - ymin
    center = np.array([xmin + w * 0.5, ymin + h * 0.5], np.float32)
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    return center, np.array([w, h], np.float32) * scale_mult


def center_scale_to_box(center, scale):
    """Inverse of the above (`bbox.py:217-226`)."""
    w, h = float(scale[0]), float(scale[1])
    xmin = float(center[0]) - w * 0.5
    ymin = float(center[1]) - h * 0.5
    return [xmin, ymin, xmin + w, ymin + h]


def add_dpg(rng: np.random.Generator, bbox, imgwidth, imght):
    """Data-driven proposal generation jitter (`addDPG`,
    `transforms.py:43-73`): 15% random sub-patch crop, else gaussian
    corner noise with the reference's fitted moments."""
    bbox = [float(v) for v in bbox]
    patch_scale = rng.uniform(0, 1)
    width, ht = bbox[2] - bbox[0], bbox[3] - bbox[1]
    if patch_scale > 0.85:
        ratio = ht / width
        if width < ht:
            pw = patch_scale * width
            ph = pw * ratio
        else:
            ph = patch_scale * ht
            pw = ph / ratio
        xmin = bbox[0] + rng.uniform(0, 1) * (width - pw)
        ymin = bbox[1] + rng.uniform(0, 1) * (ht - ph)
        xmax, ymax = xmin + pw + 1, ymin + ph + 1
    else:
        xmin = max(1, min(bbox[0] + rng.normal(-0.0142, 0.1158) * width,
                          imgwidth - 3))
        ymin = max(1, min(bbox[1] + rng.normal(0.0043, 0.068) * ht,
                          imght - 3))
        xmax = min(max(xmin + 2,
                       bbox[2] + rng.normal(0.0154, 0.1337) * width),
                   imgwidth - 3)
        ymax = min(max(ymin + 2,
                       bbox[3] + rng.normal(-0.0013, 0.0711) * ht),
                   imght - 3)
    return [xmin, ymin, xmax, ymax]


# ---------------------------------------------------------------------------
# target generators (`simple_transform_3d_smpl.py:149-207`)

def integral_uvd_target(joints_3d: np.ndarray, inp_h: int, inp_w: int,
                        depth_norm: float):
    """(J, 3, 2) pixel uvd -> flattened [-0.5, 0.5] targets + weights,
    zeroing the WHOLE joint row when any axis leaves the box
    (`_integral_uvd_target_generator`, `:171-192`)."""
    J = joints_3d.shape[0]
    w = np.ones((J, 3), np.float32)
    w[:, :] = joints_3d[:, 0, 1:2]
    t = np.zeros((J, 3), np.float32)
    t[:, 0] = joints_3d[:, 0, 0] / inp_w - 0.5
    t[:, 1] = joints_3d[:, 1, 0] / inp_h - 0.5
    t[:, 2] = joints_3d[:, 2, 0] / depth_norm
    for axis in range(3):
        w[t[:, axis] > 0.5] = 0
        w[t[:, axis] < -0.5] = 0
    return t.reshape(-1), w.reshape(-1)


def integral_xyz_target(joints_3d: np.ndarray, joints_vis: np.ndarray,
                        bbox_3d_shape):
    """(J, 3) metric joints -> flattened bbox_3d-normalized targets
    (`_integral_xyz_target_generator`, `:194-207`)."""
    t = joints_3d / np.asarray(bbox_3d_shape, np.float32)[None, :3]
    return (t.astype(np.float32).reshape(-1),
            joints_vis.astype(np.float32).reshape(-1))


# ---------------------------------------------------------------------------
# the full train/eval sample

@dataclass
class Hybrik3DConfig:
    """`SimpleTransform3DSMPL` knobs (upstream HybrIK defaults)."""
    scale_factor: float = 0.3
    color_factor: float = 0.2
    occlusion: bool = True
    add_dpg: bool = False
    input_hw: Tuple[int, int] = (256, 256)
    rot: float = 30.0
    bbox_3d_shape: Tuple[float, float, float] = (2000.0, 2000.0, 2000.0)
    scale_mult: float = 1.25
    num_joints_half_body: int = 8
    prob_half_body: float = -1.0
    pairs_17: Tuple = H36M17_PAIRS
    pairs_24: Tuple = SMPL24_PAIRS
    pairs_29: Tuple = SMPL29_PAIRS


def _occlusion_patch(rng: np.random.Generator, src, bbox, imgwidth,
                     imght):
    """Synthetic occluder (`:372-393`): rejection-sample a random-area
    random-aspect patch inside the box, fill with noise."""
    import math
    xmin, ymin, xmax, ymax = bbox
    while True:
        area = rng.uniform(0, 1) * 0.3 * (xmax - xmin) * (ymax - ymin)
        ratio = rng.uniform(0, 1) * (1 / 0.5 - 0.5) + 0.5
        h = math.sqrt(area * ratio)
        w = math.sqrt(area / ratio)
        x0 = rng.uniform(0, 1) * ((xmax - xmin) - w - 1) + xmin
        y0 = rng.uniform(0, 1) * ((ymax - ymin) - h - 1) + ymin
        if x0 >= 0 and y0 >= 0 and x0 + w < imgwidth and y0 + h < imght:
            x0, y0, w, h = int(x0), int(y0), int(w), int(h)
            src[y0:y0 + h, x0:x0 + w] = rng.uniform(
                0, 1, (h, w, 3)) * 255
            return


def hybrik_train_sample(rng: np.random.Generator, src: np.ndarray,
                        label: Dict, cfg: Hybrik3DConfig =
                        Hybrik3DConfig(),
                        train: bool = True) -> Dict[str, np.ndarray]:
    """One `3d_data_w_smpl` sample (`:308-515`).

    src: (H, W, 3) RGB float/uint8 0-255.  label keys: bbox (xyxy),
    joint_img_17/joint_vis_17/joint_relative_17, joint_img_29/
    joint_vis_29/joint_cam_29, beta (10,), theta (24, 3), and
    optionally twist_phi/twist_weight (23, 2), f/c (intrinsics),
    root_cam, width/height.

    Returns the reference's output dict as numpy arrays (image is
    (H, W, 3) float32, mean/std-normalized RGB).
    """
    inp_h, inp_w = cfg.input_hw
    aspect = inp_w / inp_h
    imgwidth = int(label.get("width", src.shape[1]))
    imght = int(label.get("height", src.shape[0]))
    src = np.asarray(src, np.float32)

    bbox = list(label["bbox"])
    j17 = np.zeros((17, 3, 2), np.float32)
    j17[:, :, 0] = label["joint_img_17"]
    j17[:, :, 1] = label["joint_vis_17"]
    j29 = np.zeros((29, 3, 2), np.float32)
    j29[:, :, 0] = label["joint_img_29"]
    j29[:, :, 1] = label["joint_vis_29"]
    vis17 = np.asarray(label["joint_vis_17"], np.float32)
    vis29 = np.asarray(label["joint_vis_29"], np.float32)
    xyz17 = np.asarray(label["joint_relative_17"], np.float32).copy()
    cam29 = np.asarray(label["joint_cam_29"], np.float32)
    xyz24 = (cam29 - cam29[0:1])[:24].copy()
    beta = np.asarray(label["beta"], np.float32).copy()
    theta = np.asarray(label["theta"], np.float32).reshape(24, 3).copy()
    twist_phi = np.asarray(label.get("twist_phi", np.zeros((23, 2))),
                           np.float32).copy()
    twist_weight = np.asarray(
        label.get("twist_weight", np.zeros((23, 2))), np.float32).copy()

    if cfg.add_dpg and train:
        bbox = add_dpg(rng, bbox, imgwidth, imght)
    center, scale = box_to_center_scale(bbox, aspect, cfg.scale_mult)
    box = center_scale_to_box(center, scale)

    if train and (vis17[:, 0].sum() > cfg.num_joints_half_body
                  and rng.uniform() < cfg.prob_half_body):
        hb = _half_body_17(rng, j17[:, :, 0], vis17, aspect)
        if hb is not None:
            center, scale = hb

    if train:
        sf = cfg.scale_factor
        scale = scale * np.clip(rng.standard_normal() * sf + 1,
                                1 - sf, 1 + sf)
        rf = cfg.rot
        r = (float(np.clip(rng.standard_normal() * rf, -2 * rf, 2 * rf))
             if rng.uniform() <= 0.6 else 0.0)
    else:
        r = 0.0

    if train and cfg.occlusion:
        _occlusion_patch(rng, src, box, imgwidth, imght)

    if train and rng.uniform() > 0.5:
        src = src[:, ::-1]
        j17 = flip_joints_3d(j17, imgwidth, cfg.pairs_17)
        j29 = flip_joints_3d(j29, imgwidth, cfg.pairs_29)
        xyz17 = flip_xyz_joints_3d(xyz17, cfg.pairs_17)
        xyz24 = flip_xyz_joints_3d(xyz24, cfg.pairs_24)
        theta = flip_thetas(theta, cfg.pairs_24)
        twist_phi, twist_weight = flip_twist(twist_phi, twist_weight,
                                             cfg.pairs_24)
        center[0] = imgwidth - center[0] - 1

    theta_quat = rotmat_to_quat_np(rodrigues_np(theta)).reshape(96)

    trans = get_affine_transform(center, scale, r, (inp_w, inp_h))
    trans_inv = get_affine_transform(center, scale, r, (inp_w, inp_h),
                                     inv=True).astype(np.float32)
    img = warp_affine(np.ascontiguousarray(src), trans, (inp_w, inp_h))
    for j in (j17, j29):
        vis = j[:, 0, 1] > 0
        j[vis, 0:2, 0] = apply_affine(j[vis, 0:2, 0], trans)

    target_uvd_29, w29 = integral_uvd_target(j29, inp_h, inp_w,
                                             cfg.bbox_3d_shape[2])
    target_xyz_17, w17 = integral_xyz_target(xyz17, vis17,
                                             cfg.bbox_3d_shape)
    target_xyz_24, w24 = integral_xyz_target(xyz24, vis29[:24],
                                             cfg.bbox_3d_shape)
    w29 *= vis29.reshape(-1)
    w24 *= vis29[:24].reshape(-1)
    w17 *= vis17.reshape(-1)

    if train:
        lo, hi = 1 - cfg.color_factor, 1 + cfg.color_factor
        for ch in range(3):
            img[:, :, ch] = np.clip(img[:, :, ch] * rng.uniform(lo, hi),
                                    0, 255)
    img = (img / 255.0 - MEAN_3D) / STD_3D

    f = np.asarray(label.get("f", (1000.0, 1000.0)), np.float32)
    c = np.asarray(label.get("c", (inp_w / 2, inp_h / 2)), np.float32)
    return {
        "image": img.astype(np.float32),
        "target_theta": theta_quat.astype(np.float32),
        "target_theta_weight": np.ones(96, np.float32),
        "target_beta": beta,
        "target_smpl_weight": np.ones(1, np.float32),
        "target_uvd_29": target_uvd_29,
        "target_xyz_24": target_xyz_24,
        "target_weight_29": w29,
        "target_weight_24": w24,
        "target_xyz_17": target_xyz_17,
        "target_weight_17": w17,
        "trans_inv": trans_inv,
        "intrinsic_param": intrinsic_matrix(f, c, inv=True),
        "joint_root": np.asarray(label.get("root_cam", np.zeros(3)),
                                 np.float32),
        "depth_factor": np.asarray([cfg.bbox_3d_shape[2]], np.float32),
        "bbox": np.asarray(center_scale_to_box(center, scale),
                           np.float32),
        "target_twist": twist_phi,
        "target_twist_weight": twist_weight,
    }


def _half_body_17(rng: np.random.Generator, joints, vis, aspect):
    """`half_body_transform` (`:517-560`) over the 17 H36M joints;
    upper-body ids = the published HybrIK h36m set."""
    upper_ids = (0, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16)
    upper = [joints[i] for i in range(17)
             if vis[i, 0] > 0 and i in upper_ids]
    lower = [joints[i] for i in range(17)
             if vis[i, 0] > 0 and i not in upper_ids]
    sel = (upper if rng.standard_normal() < 0.5 and len(upper) > 2
           else (lower if len(lower) > 2 else upper))
    if len(sel) < 2:
        return None
    sel = np.asarray(sel, np.float32)
    center = sel.mean(axis=0)[:2]
    w = sel[:, 0].max() - sel[:, 0].min()
    h = sel[:, 1].max() - sel[:, 1].min()
    if w > aspect * h:
        h = w / aspect
    elif w < aspect * h:
        w = h * aspect
    return center, np.array([w, h], np.float32) * 1.5
