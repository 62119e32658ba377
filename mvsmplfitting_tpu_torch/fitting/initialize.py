"""Initial guess for a batch of frames (port of `fitting/initialize.py`).

Rest-pose annotation joints -> DLT triangulation of the 2D detections
(several live views) or the torso-height depth heuristic (one view) ->
Umeyama similarity on the 4 torso joints -> (global_orient, transl,
scale); betas and the VPoser latent start at zero.  Annotated 3D joints,
where given, replace the triangulation.  In a sequence, `warm_start`
picks per frame between the previous frame's solution and the fresh
guess.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.camera import Camera
from ..models.smpl import SMPLAssets, SMPLParams, rest_joints
from ..ops.alignment import umeyama
from ..ops.rotations import matrix_to_axis_angle
from ..ops.triangulate import triangulate
from .energy import LATENT_DIM

TORSO = np.asarray([5, 6, 11, 12])  # LShoulder RShoulder LHip RHip


def torso_indices(model_type: str) -> np.ndarray:
    """Shoulder and hip rows in the model's annotation order: 5/6 and
    11/12 in coco17 and lsp14 (`init_guess.py:89-92`), 2/5 and 9/12 in
    SMPL-X's OpenPose BODY_25."""
    if model_type == "smplx":
        return np.asarray([2, 5, 9, 12])
    return TORSO


@dataclasses.dataclass
class InitGuess:
    params: SMPLParams
    z: torch.Tensor         # (B, 32) VPoser latent (zeros)
    joints3d: torch.Tensor  # (B, K, 3) triangulated target joints


def _single_view_depth(cam: Camera, rest: torch.Tensor,
                       pixels: torch.Tensor, view_mask: torch.Tensor,
                       torso: np.ndarray = TORSO) -> torch.Tensor:
    """Torso-height depth heuristic in each frame's first live view
    (`init_guess.py:54-79`): rest joints (K, 3), pixels (B, V, K, 2),
    view_mask (B, V) -> (B, K, 3)."""
    B = pixels.shape[0]
    v = torch.argmax(view_mask, dim=1)                       # first live
    R = cam.rotation[v]                                      # (B, 3, 3)
    t = cam.translation[v]                                   # (B, 3)
    torso3d_c = torch.einsum("mc,bdc->bmd", rest[torso], R) + t[:, None]
    d3 = torch.stack([torso3d_c[:, 0] - torso3d_c[:, 2],
                      torso3d_c[:, 1] - torso3d_c[:, 3]], dim=1)
    h3 = torch.mean(torch.linalg.vector_norm(d3, dim=-1), dim=-1)

    torso2d = pixels[torch.arange(B, device=pixels.device), v][:, torso]
    # sic: the reference uses (t0 - t2) twice (`init_guess.py:66`).
    d2 = torch.stack([torso2d[:, 0] - torso2d[:, 2],
                      torso2d[:, 0] - torso2d[:, 2]], dim=1)
    h2 = torch.mean(torch.linalg.vector_norm(d2, dim=-1), dim=-1)

    est_d = cam.focal[v, 0] * (h3 / torch.clamp_min(h2, 1e-6))
    cam_joints = torch.einsum("kc,bdc->bkd", rest, R) + t[:, None]
    cam_joints = torch.cat([cam_joints[..., :2],
                            cam_joints[..., 2:] + est_d[:, None, None]],
                           dim=-1)
    return (cam_joints - t[:, None]) @ R


def init_guess(assets: SMPLAssets, cam: Camera, pixels: torch.Tensor,
               conf: torch.Tensor, view_mask: torch.Tensor,
               est_scale: bool = True, fixed_scale: float = 1.0,
               gt3d: Optional[torch.Tensor] = None,
               use_torso: bool = True) -> InitGuess:
    """Initial parameters for a batch of frames.

    Args:
      pixels: (B, V, K, 2) 2D keypoints; conf: (B, V, K); view_mask: (B, V).
      gt3d: optional (B, K, 3) annotated 3D joints, used in place of the
        triangulation (`init_guess.py:85-86`).
    """
    B = pixels.shape[0]
    dtype, device = pixels.dtype, pixels.device
    rest = rest_joints(assets)                               # (K, 3)
    torso = torso_indices(assets.model_type)

    n_views = torch.sum(view_mask, dim=1)
    tri = triangulate(cam, pixels, conf, view_mask)
    single = _single_view_depth(cam, rest, pixels, view_mask, torso)
    joints3d = torch.where((n_views > 1)[:, None, None], tri, single)
    if gt3d is not None:
        joints3d = gt3d

    if use_torso:
        src, dst = rest[torso], joints3d[:, torso]
    else:
        src, dst = rest, joints3d
    rot, trans, scale = umeyama(src.expand(B, -1, -1), dst, est_scale)
    orient = matrix_to_axis_angle(rot)
    if not est_scale:
        scale = torch.full_like(scale, fixed_scale)

    def zeros(*s):
        return torch.zeros((B,) + s, dtype=dtype, device=device)

    params = SMPLParams(betas=zeros(assets.num_betas), global_orient=orient,
                        body_pose=zeros(69), transl=trans, scale=scale)
    return InitGuess(params=params, z=zeros(LATENT_DIM), joints3d=joints3d)


def warm_start(prev_params: SMPLParams, prev_z: torch.Tensor,
               prev_loss: torch.Tensor, fresh: InitGuess,
               loss_threshold: float = 5000.0) -> InitGuess:
    """Sequence warm start (`load_init`, `init_guess.py:137-166`): each
    frame reuses the previous frame's solution unless that frame's final
    loss (B,) exceeded the threshold, where the fresh guess wins.  The
    choice is per frame, so one batch can mix both.  An SMPL-H/X block
    that only one side carries is zeros on the other (the fresh guess
    has none)."""
    use_prev = prev_loss <= loss_threshold

    def pick(a, b):
        if a is None and b is None:
            return None
        a = torch.zeros_like(b) if a is None else a
        b = torch.zeros_like(a) if b is None else b
        u = use_prev.reshape((-1,) + (1,) * (a.dim() - 1))
        return torch.where(u, a, b)

    params = SMPLParams(**{
        f.name: pick(getattr(prev_params, f.name),
                     getattr(fresh.params, f.name))
        for f in dataclasses.fields(SMPLParams)})
    return InitGuess(params=params, z=pick(prev_z, fresh.z),
                     joints3d=fresh.joints3d)
