"""Pinhole cameras: projection and parameter file IO (port of
`models/camera.py`).  The V views are a leading axis, shared by every
frame of a batch."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass
class Camera:
    """A batch of V pinhole cameras."""

    rotation: torch.Tensor     # (V, 3, 3) world->cam
    translation: torch.Tensor  # (V, 3)
    focal: torch.Tensor        # (V, 2)  fx, fy
    center: torch.Tensor       # (V, 2)  cx, cy

    @property
    def num_views(self) -> int:
        return self.rotation.shape[0]

    def to(self, device) -> "Camera":
        return Camera(*(t.to(device) for t in dataclasses.astuple(self)))


def project_points(cam: Camera, points: torch.Tensor) -> torch.Tensor:
    """Project world points (..., 3) into every view -> (V, ..., 2)."""
    V = cam.num_views
    ones = (1,) * (points.dim() - 1)
    rot = cam.rotation.reshape((V,) + ones + (3, 3))
    cam_pts = (sum(rot[..., b] * points[None, ..., b, None]
                   for b in range(3))
               + cam.translation.reshape((V,) + ones + (3,)))
    xy = cam_pts[..., :2] / cam_pts[..., 2:3]
    shape = (V,) + ones + (2,)
    return xy * cam.focal.reshape(shape) + cam.center.reshape(shape)


def load_cameras_txt(path: str, device: DeviceLike = None,
                     dtype=torch.float32) -> Camera:
    """Parse the reference's camera text format (`utils.py:352-394`).

    Per camera: an index line, 3 rows of K, a distortion line (ignored),
    3 rows of [R|t].  Rows of 3 numbers are K rows, rows of 4 are [R|t].
    """
    k_rows, e_rows = [], []
    with open(path) as f:
        for line in f:
            words = line.split()
            if len(words) == 3:
                k_rows.append([float(w) for w in words])
            elif len(words) == 4:
                e_rows.append([float(w) for w in words])
    if not k_rows or not e_rows:
        raise ValueError(f"No cameras parsed from {path}")
    K = np.asarray(k_rows, np.float64).reshape(-1, 3, 3)
    E = np.asarray(e_rows, np.float64).reshape(-1, 3, 4)
    if K.shape[0] != E.shape[0]:
        raise ValueError(f"camera file {path}: {K.shape[0]} K blocks but "
                         f"{E.shape[0]} extrinsic blocks")
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    return Camera(rotation=t(E[:, :, :3]), translation=t(E[:, :, 3]),
                  focal=t(np.stack([K[:, 0, 0], K[:, 1, 1]], -1)),
                  center=t(K[:, :2, 2]))


def get_rot_trans(campose, photoscan: bool = False):
    """Split 4x4 camera poses into (translations, rotations) lists
    (`code/utils/module_utils.py:327-338`, used by `init.py:106`).
    ``photoscan=True`` inverts each pose first: the reference's adapter
    for Agisoft-convention extrinsics stored as camera-to-world."""
    trans, rot = [], []
    for cam_pose in campose:
        if photoscan:
            cam_pose = np.linalg.inv(cam_pose)
        trans.append(cam_pose[:3, 3])
        rot.append(cam_pose[:3, :3])
    return trans, rot


def save_cameras_txt(path: str, cam: Camera) -> None:
    """Write cameras in the text format `load_cameras_txt` reads."""
    V = cam.num_views
    focal = cam.focal.detach().cpu().numpy()
    center = cam.center.detach().cpu().numpy()
    K = np.zeros((V, 3, 3), focal.dtype)
    K[:, 0, 0] = focal[:, 0]
    K[:, 1, 1] = focal[:, 1]
    K[:, 0, 2] = center[:, 0]
    K[:, 1, 2] = center[:, 1]
    K[:, 2, 2] = 1.0
    R = cam.rotation.detach().cpu().numpy()
    t = cam.translation.detach().cpu().numpy()
    with open(path, "w") as f:
        for v in range(V):
            f.write(f"{v}\n")
            for row in K[v]:
                f.write(" ".join(str(x) for x in row) + " \n")
            f.write("0 0\n")
            for i in range(3):
                f.write(" ".join(str(x) for x in R[v, i]) +
                        f" {t[v, i]} \n")
            f.write("\n")
