"""HybrIK-style 3D pose and SMPL regressor, NCHW (port of
`detect/hybrik.py`; the reference's
`alphapose/models/simple3dposeSMPLWithCam.py:32-127,186-322`).

* a ResNet-50 backbone -> (N, 2048, H/32, W/32) features;
* 3 x ConvTranspose(k4, s2) + BN + ReLU (256 filters) and a 1x1 conv to
  `num_joints * depth_dim` channels: a 3D heatmap volume per joint;
* `integral_uvd`: a softmax over each joint's whole volume, then the
  expectation along each axis, normalized to [-0.5, 0.5] (`:211-238`);
* an FC head (2048 -> 1024 -> 1024, no activation; dropout is the
  identity at inference) on the pooled features: shape deltas (+ the
  mean shape), 23 twist (cos, sin) pairs and a weak-perspective camera
  (scale, tx, ty) added to (0.9, 0, 0) (`:240-253`);
* `uvd_to_xyz`: the camera's back-projection of the uvd skeleton to
  root-relative xyz (`:284-322`, the branch without boxes).

Sub-modules carry the reference's names (`preact`, `deconv_layers`,
`final_layer`, `fc1`, `fc2`, `decshape`, `decphi`, `deccam`), so its
checkpoints load with `load_state_dict`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from .blocks import BN_EPS, BatchNorm2d
from .simplepose import ResNet


class Simple3DPoseSMPLCam(nn.Module):
    def __init__(self, num_joints: int = 29, depth_dim: int = 64,
                 height_dim: int = 64, width_dim: int = 48,
                 deconv_filters: Sequence[int] = (256, 256, 256),
                 focal_length: float = 1000.0, input_size: float = 256.0,
                 depth_factor: float = 2.0):
        super().__init__()
        self.num_joints = num_joints
        self.depth_dim = depth_dim
        self.height_dim = height_dim
        self.width_dim = width_dim
        self.focal_length = focal_length
        self.input_size = input_size
        self.depth_factor = depth_factor
        self.preact = ResNet()
        layers, cin = [], 2048
        for f in deconv_filters:
            layers += [nn.ConvTranspose2d(cin, f, 4, 2, 1, bias=False),
                       BatchNorm2d(f, eps=BN_EPS), nn.ReLU()]
            cin = f
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = nn.Conv2d(cin, num_joints * depth_dim, 1)
        self.fc1 = nn.Linear(2048, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.decshape = nn.Linear(1024, 10)
        self.decphi = nn.Linear(1024, 23 * 2)
        self.deccam = nn.Linear(1024, 3)

    def forward(self, x: torch.Tensor,
                init_shape: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """x (N, 3, H, W) -> uvd joints (N, J, 3), shape (N, 10), twists
        (N, 23, 2), camera (N, 3) and the volumes' peaks (N, J, 1).
        `init_shape` (10,) is the mean shape added to the deltas (the
        reference loads `h36m_mean_beta.npy`; zeros here)."""
        N = x.shape[0]
        feat = self.preact(x)
        y = self.final_layer(self.deconv_layers(feat))
        vol = y.reshape(N, self.num_joints, self.depth_dim, y.shape[2],
                        y.shape[3])
        uvd, maxvals = integral_uvd(vol, self.width_dim, self.height_dim,
                                    self.depth_dim)
        xc = self.fc2(self.fc1(feat.mean(dim=(2, 3))))
        shape = self.decshape(xc)
        if init_shape is not None:
            shape = shape + init_shape
        return {"pred_uvd_jts": uvd, "pred_shape": shape,
                "pred_phi": self.decphi(xc).reshape(N, 23, 2),
                "pred_camera": self.deccam(xc) + torch.tensor(
                    [0.9, 0.0, 0.0], dtype=xc.dtype, device=xc.device),
                "maxvals": maxvals}


def integral_uvd(vol: torch.Tensor, width_dim: int, height_dim: int,
                 depth_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax integral decode of a (N, J, D, H, W) volume -> (uvd (N, J,
    3) in [-0.5, 0.5], maxvals (N, J, 1))."""
    N, J = vol.shape[:2]
    heat = torch.softmax(vol.reshape(N, J, -1), dim=2)
    maxvals = heat.amax(dim=2, keepdim=True)
    heat = heat.reshape(vol.shape)
    hm_x = heat.sum((2, 3))                           # (N, J, W)
    hm_y = heat.sum((2, 4))                           # (N, J, H)
    hm_z = heat.sum((3, 4))                           # (N, J, D)

    def expect(h, dim):
        r = torch.arange(h.shape[-1], dtype=h.dtype, device=h.device)
        return (h * r).sum(-1) / float(dim) - 0.5

    uvd = torch.stack([expect(hm_x, width_dim), expect(hm_y, height_dim),
                       expect(hm_z, depth_dim)], dim=-1)
    return uvd, maxvals


def uvd_to_xyz(uvd: torch.Tensor, pred_camera: torch.Tensor,
               focal_length: float = 1000.0, input_size: float = 256.0,
               depth_factor: float = 2.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uvd ([-0.5, 0.5]^3) and the weak-perspective camera -> (root-relative
    xyz (N, J, 3) in depth_factor units, camera-frame root (N, 3) in
    meters): camDepth = f / (size * s); xy = (uv * size / f) * (d *
    depth_factor + camDepth) - t."""
    cam_scale = pred_camera[:, None, :1]              # (N, 1, 1)
    cam_trans = pred_camera[:, None, 1:]              # (N, 1, 2)
    cam_depth = focal_length / (input_size * cam_scale + 1e-9)
    z = uvd[..., 2:]
    xy_m = ((uvd[..., :2] * input_size / focal_length)
            * (z * depth_factor + cam_depth) - cam_trans)
    xyz = torch.cat([xy_m / depth_factor, z], dim=-1)
    root = xyz[:, 0, :] * depth_factor
    root = torch.cat([root[:, :2], root[:, 2:] + cam_depth[:, 0]], dim=-1)
    return xyz - xyz[:, :1], root
