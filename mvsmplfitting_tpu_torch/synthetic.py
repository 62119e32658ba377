"""The synthetic multi-view fitting problem (counterpart of the JAX
repository's `__graft_entry__.py:_make_problem`).

Six cameras (by default) orbit the origin at radius 4 and height 0.3,
all looking at the origin; every frame draws its own true pose latent,
shape, orientation, translation and scale from numpy seeded with `seed`,
in the same order as the JAX function, and its observations are the
exact projections of the synthetic body's joints.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .fitting.energy import Observations
from .models import vposer as vposer_lib
from .models.assets import synthetic_smpl
from .models.camera import Camera, project_points
from .models.joint_model import with_joint_model
from .models.smpl import SMPLAssets, SMPLParams, smpl_forward

VPOSER_NPZ = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "vposer_weights.npz")


def orbit_cameras(num_views: int, device: torch.device) -> Camera:
    Rs, ts = [], []
    for v in range(num_views):
        ang = 2 * np.pi * v / num_views
        pos = np.array([4 * np.sin(ang), 0.3, 4 * np.cos(ang)])
        z = -pos / np.linalg.norm(pos)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        Rs.append(R)
        ts.append(-R @ pos)
    f32 = dict(dtype=torch.float32, device=device)
    return Camera(rotation=torch.as_tensor(np.stack(Rs), **f32),
                  translation=torch.as_tensor(np.stack(ts), **f32),
                  focal=torch.full((num_views, 2), 1200.0, **f32),
                  center=torch.full((num_views, 2), 540.0, **f32))


def true_params(num_frames: int, seed: int
                ) -> Tuple[np.ndarray, dict]:
    """The per-frame true latent (F, 32) and parameters, drawn in the JAX
    function's order."""
    rng = np.random.default_rng(seed)
    zs, cols = [], {k: [] for k in ("betas", "global_orient", "transl",
                                    "scale")}
    for _ in range(max(1, num_frames)):
        zs.append(0.3 * rng.standard_normal(32))
        cols["betas"].append(0.5 * rng.standard_normal(10))
        cols["global_orient"].append(0.3 * rng.standard_normal(3))
        cols["transl"].append(0.3 * rng.standard_normal(3))
        cols["scale"].append(1.0 + 0.2 * rng.uniform(-1, 1))
    return (np.asarray(zs, np.float32),
            {k: np.asarray(v, np.float32) for k, v in cols.items()})


def make_problem(num_views: int = 6, num_frames: int = 1, seed: int = 0,
                 device: DeviceLike = None
                 ) -> Tuple[SMPLAssets, vposer_lib.VPoserWeights, Camera,
                            Observations]:
    """(assets with the reduced joint model, VPoser weights, cameras,
    observations (num_frames, V, K, ...)) on `device`."""
    dev = resolve_device(device)
    assets = with_joint_model(synthetic_smpl(device=dev))
    vposer_w = vposer_lib.load_npz(VPOSER_NPZ, device=dev)
    cam = orbit_cameras(num_views, dev)

    z_np, cols = true_params(num_frames, seed)
    B = z_np.shape[0]

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    true = SMPLParams(betas=t(cols["betas"]),
                      global_orient=t(cols["global_orient"]),
                      body_pose=torch.zeros((B, 69), device=dev),
                      transl=t(cols["transl"]), scale=t(cols["scale"]))
    body_pose = vposer_lib.decode(vposer_w, t(z_np))
    _, joints = smpl_forward(assets, true, body_pose)
    gt2d = project_points(cam, joints).transpose(0, 1).contiguous()
    K = gt2d.shape[2]
    obs = Observations(
        gt2d=gt2d,
        conf=torch.ones((B, num_views, K), device=dev),
        view_mask=torch.ones((B, num_views), device=dev),
        joint_weights=torch.ones((B, K), device=dev))
    return assets, vposer_w, cam, obs


def make_people_problem(dx0: float = 0.2, num_views: int = 6,
                        device: DeviceLike = None
                        ) -> Tuple[SMPLAssets, vposer_lib.VPoserWeights,
                                   Camera, Observations]:
    """Two people of one frame at +-dx0 along x (the JAX multi-person
    tests' fixture, `tests/test_multi_person.py:_fixture_people`):
    dx0=0.2 interpenetrates deeply, dx0=0.26 is just clear.  Returns
    (assets, VPoser weights, cameras, observations (2, V, K, ...)), the
    people as the leading axis."""
    dev = resolve_device(device)
    assets = with_joint_model(synthetic_smpl(device=dev))
    vposer_w = vposer_lib.load_npz(VPOSER_NPZ, device=dev)
    cam = orbit_cameras(num_views, dev)
    rng = np.random.default_rng(7)
    zs, betas = [], []
    for _ in range(2):
        zs.append(0.2 * rng.standard_normal(32))
        betas.append(0.3 * rng.standard_normal(10))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    true = SMPLParams(betas=t(betas),
                      global_orient=t([[0.1, 0.2, 0.0]] * 2),
                      body_pose=torch.zeros((2, 69), device=dev),
                      transl=t([[-dx0, -0.1, 0.2], [dx0, -0.1, 0.2]]),
                      scale=t([1.0, 1.0]))
    body_pose = vposer_lib.decode(vposer_w, t(zs))
    _, joints = smpl_forward(assets, true, body_pose)
    gt2d = project_points(cam, joints).transpose(0, 1).contiguous()
    K = gt2d.shape[2]
    obs = Observations(
        gt2d=gt2d,
        conf=torch.ones((2, num_views, K), device=dev),
        view_mask=torch.ones((2, num_views), device=dev),
        joint_weights=torch.ones((2, K), device=dev))
    return assets, vposer_w, cam, obs
