"""Misc geometry utilities (port of `ops/geometry.py`; reference:
`code/utils/utils.py`, `code/utils/module_utils.py`)."""

from __future__ import annotations

from typing import Tuple

import torch


def rel_change(prev_val, curr_val) -> torch.Tensor:
    """Relative objective change (`utils.py:348`)."""
    prev_val = torch.as_tensor(prev_val, dtype=torch.float32)
    curr_val = torch.as_tensor(curr_val, dtype=torch.float32)
    return (prev_val - curr_val) / torch.clamp_min(
        torch.maximum(prev_val.abs(), curr_val.abs()), 1.0)


def estimate_translation_weak(S: torch.Tensor, joints_2d: torch.Tensor,
                              conf: torch.Tensor, fx: float, fy: float,
                              cx: float, cy: float) -> torch.Tensor:
    """Weighted LSQ camera-frame translation from 2D/3D correspondences.

    Solves for t such that perspective projection of (S + t) best
    matches joints_2d under confidence weights: the reference's
    `estimate_translation_from_intri` (`utils.py:222-255`) normal
    equations, assembled as one small dense solve.
    """
    K = S.shape[0]
    f32 = dict(dtype=S.dtype, device=S.device)
    f = torch.tensor([fx, fy], **f32)
    center = torch.tensor([cx, cy], **f32)

    Z = torch.repeat_interleave(S[:, 2], 2)           # (2K,)
    XY = S[:, :2].reshape(-1)
    O = center.repeat(K)
    F = f.repeat(K)
    w = torch.repeat_interleave(torch.sqrt(conf.to(S.dtype)), 2)

    ex = torch.tensor([1.0, 0.0], **f32).repeat(K)
    ey = torch.tensor([0.0, 1.0], **f32).repeat(K)
    obs = joints_2d.reshape(-1)
    Q = torch.stack([F * ex, F * ey, O - obs], dim=1)  # (2K, 3)
    c = (obs - O) * Z - F * XY

    Qw = Q * w[:, None]
    cw = c * w
    A = Qw.T @ Qw + 1e-6 * torch.eye(3, **f32)
    return torch.linalg.solve(A, Qw.T @ cw)


def surface_project(vertices: torch.Tensor, exter: torch.Tensor,
                    intri: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project mesh vertices into one camera
    (`module_utils.py:533-541` ``surface_project``).

    Returns (camera-space points (N, 3), integer pixel coordinates
    (N, 2), truncated to int32 like the reference's
    ``astype(np.int32)``).
    """
    vh = torch.cat([vertices, torch.ones_like(vertices[:, :1])], dim=1)
    cam_pts = exter @ vh.T                             # (4, N)
    mesh_3d = cam_pts.T[:, :3]
    intri_ = torch.cat([intri, torch.zeros((3, 1), dtype=intri.dtype,
                                           device=intri.device)], dim=1)
    proj = (intri_ @ cam_pts) / cam_pts[2]
    mesh_2d = proj[:2].to(torch.int32).T
    return mesh_3d, mesh_2d


def convert_world_coord(pose: torch.Tensor, transl: torch.Tensor,
                        extri: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame SMPL params -> world frame
    (`module_utils.py:289-325` ``convert_world_coord``).

    Rotates the global orientation and translation by the inverse
    extrinsic.  (The reference's in-function SMPL forward computes a
    root joint it never uses, since its root-pivot correction is
    commented out, so the active math is exactly this rotation.)

    Args: pose (F, 72) axis-angle, transl (F, 3), extri (4, 4).
    Returns (pose', transl') in the world frame.
    """
    from .rotations import matrix_to_axis_angle, rodrigues

    inv = torch.linalg.inv(extri)
    R = rodrigues(pose[:, :3])                         # (F, 3, 3)
    new_orient = matrix_to_axis_angle(
        torch.einsum("ij,fjk->fik", inv[:3, :3], R))
    new_pose = torch.cat([new_orient, pose[:, 3:]], dim=1)
    new_trans = torch.einsum("ij,fj->fi", inv[:3, :3], transl) + inv[:3, 3]
    return new_pose, new_trans


def rigid_transform_3d(A: torch.Tensor, B: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kabsch rigid alignment A -> B (`module_utils.py:506-531`).

    Returns (R (3,3), t (3,)) with ``B ~= A @ R.T + t``; reflections
    corrected by flipping the last right-singular vector.
    """
    ca = A.mean(dim=0)
    cb = B.mean(dim=0)
    H = (A - ca).T @ (B - cb)
    U, _, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(Vt.T @ U.T)
    D = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det),
                                torch.sign(det)]))
    R = Vt.T @ D @ U.T
    t = cb - R @ ca
    return R, t
