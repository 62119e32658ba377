"""The synthetic multi-view fitting problem (counterpart of the JAX
repository's `__graft_entry__.py:_make_problem`).

Six cameras (by default) orbit the origin at radius 4 and height 0.3,
all looking at the origin; every frame draws its own true pose latent,
shape, orientation, translation and scale from numpy seeded with `seed`,
in the same order as the JAX function, and its observations are the
exact projections of the synthetic body's joints.  SMPL-H and SMPL-X
truths add hand PCA (and, for SMPL-X, expression and jaw) blocks, as
JAX's own SMPL-H/X fit tests do (`tests/test_smplx_family.py:225-265`).
`make_sequence` moves each frame's truth on by a seeded drift per time
step; `make_person_sequence` is one person's frames with one shared shape
(`tests/test_schur.py:31-63`).  `write_workspace` writes any of these
problems to disk in the reference's layout, for the CLI to read.
"""

from __future__ import annotations

import functools
import os
import struct
import zlib
from typing import List, Tuple

import numpy as np
import torch

from .data.keypoints import save_keypoints_json
from .device import DeviceLike, resolve_device
from .fitting.energy import Observations
from .models import vposer as vposer_lib
from .models.assets import synthetic_smpl
from .models.camera import Camera, project_points, save_cameras_txt
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


def true_tail(num_frames: int, seed: int, model_type: str) -> dict:
    """Per-frame SMPL-H/X truth blocks (empty for smpl/smpllsp): hand PCA
    (F, 6) ~ 0.6 N(0, 1) for smplh and smplx; for smplx also expression
    (F, 10) ~ 0.5 N(0, 1), a jaw pose (F, 3) around (0.15, 0, 0.05) and
    zero eye poses.  Drawn from their own stream, so the body draws of
    `true_params` do not change."""
    if model_type not in ("smplh", "smplx"):
        return {}
    rng = np.random.default_rng(seed + 1000)
    F = max(1, num_frames)
    out = {"left_hand_pose": 0.6 * rng.standard_normal((F, 6)),
           "right_hand_pose": 0.6 * rng.standard_normal((F, 6))}
    if model_type == "smplx":
        out["expression"] = 0.5 * rng.standard_normal((F, 10))
        out["jaw_pose"] = (np.asarray([0.15, 0.0, 0.05])
                           + 0.05 * rng.standard_normal((F, 3)))
        out["leye_pose"] = np.zeros((F, 3))
        out["reye_pose"] = np.zeros((F, 3))
    return {k: v.astype(np.float32) for k, v in out.items()}


def observe(assets: SMPLAssets, vposer_w: vposer_lib.VPoserWeights,
            cam: Camera, z: np.ndarray, cols: dict) -> Observations:
    """Exact projections (B, V, K, 2) of the bodies with latents z (B, 32)
    and the parameters `cols` (with any SMPL-H/X blocks of `true_tail`),
    all views live, unit confidences."""
    dev = cam.rotation.device

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    B, V = z.shape[0], cam.rotation.shape[0]
    tail = {k: t(v) for k, v in cols.items()
            if k not in ("betas", "global_orient", "transl", "scale")}
    true = SMPLParams(betas=t(cols["betas"]),
                      global_orient=t(cols["global_orient"]),
                      body_pose=torch.zeros((B, 69), device=dev),
                      transl=t(cols["transl"]), scale=t(cols["scale"]),
                      **tail)
    body_pose = vposer_lib.decode(vposer_w, t(z))
    _, joints = smpl_forward(assets, true, body_pose)
    gt2d = project_points(cam, joints).transpose(0, 1).contiguous()
    K = gt2d.shape[2]
    return Observations(
        gt2d=gt2d,
        conf=torch.ones((B, V, K), device=dev),
        view_mask=torch.ones((B, V), device=dev),
        joint_weights=torch.ones((B, K), device=dev))


def make_problem(num_views: int = 6, num_frames: int = 1, seed: int = 0,
                 device: DeviceLike = None, model_type: str = "smpl"
                 ) -> Tuple[SMPLAssets, vposer_lib.VPoserWeights, Camera,
                            Observations]:
    """(assets with the reduced joint model, VPoser weights, cameras,
    observations (num_frames, V, K, ...)) on `device`: smpl (K=17, coco17),
    smpllsp (K=14, the LSP regressor), smplh (K=17, coco17) or smplx
    (K=25, OpenPose BODY_25), the last two with `true_tail`'s blocks in
    the truth."""
    dev = resolve_device(device)
    assets = with_joint_model(synthetic_smpl(model_type, device=dev))
    vposer_w = vposer_lib.load_npz(VPOSER_NPZ, device=dev)
    cam = orbit_cameras(num_views, dev)
    z_np, cols = true_params(num_frames, seed)
    cols.update(true_tail(num_frames, seed, model_type))
    return assets, vposer_w, cam, observe(assets, vposer_w, cam, z_np, cols)


def person_sequence_truth(num_frames: int, seed: int
                          ) -> Tuple[np.ndarray, dict]:
    """One person's truth over `num_frames` frames, in the draw order of
    JAX's Schur test fixture (`tests/test_schur.py:31-63`): shared betas
    ~ 0.5 N(0, 1) and scale 1.15, then a latent ~ 0.3 N(0, 1) per frame;
    frame f has orientation (0.1 w, 0.3, -0.1) and translation
    (0.05 w, -0.2, 0.3) with w = f for f <= 16 and a triangle wave of
    period 32 beyond, so a long sequence stays inside the camera ring."""
    rng = np.random.default_rng(seed)
    betas = 0.5 * rng.standard_normal(10)
    zs = [0.3 * rng.standard_normal(32) for _ in range(num_frames)]
    f = np.arange(num_frames) % 32
    w = np.minimum(f, 32 - f).astype(np.float64)
    cols = {"betas": np.tile(betas, (num_frames, 1)),
            "global_orient": np.stack([0.1 * w, np.full_like(w, 0.3),
                                       np.full_like(w, -0.1)], -1),
            "transl": np.stack([0.05 * w, np.full_like(w, -0.2),
                                np.full_like(w, 0.3)], -1),
            "scale": np.full(num_frames, 1.15)}
    return (np.asarray(zs, np.float32),
            {k: np.asarray(v, np.float32) for k, v in cols.items()})


def make_person_sequence(num_frames: int, num_views: int = 6, seed: int = 0,
                         device: DeviceLike = None
                         ) -> Tuple[SMPLAssets, vposer_lib.VPoserWeights,
                                    Camera, Observations, dict]:
    """One smpl person seen over `num_frames` frames with one shape:
    (assets with the joint model, VPoser weights, cameras, observations
    (F, V, K, ...), the truth `cols` of `person_sequence_truth`)."""
    dev = resolve_device(device)
    assets = with_joint_model(synthetic_smpl(device=dev))
    vposer_w = vposer_lib.load_npz(VPOSER_NPZ, device=dev)
    cam = orbit_cameras(num_views, dev)
    z_np, cols = person_sequence_truth(num_frames, seed)
    return assets, vposer_w, cam, observe(assets, vposer_w, cam, z_np,
                                          cols), cols


def make_sequence(num_views: int = 6, num_seqs: int = 1, steps: int = 2,
                  seed: int = 0, device: DeviceLike = None,
                  model_type: str = "smpl"
                  ) -> Tuple[SMPLAssets, vposer_lib.VPoserWeights, Camera,
                             List[Observations]]:
    """`num_seqs` sequences in lockstep: step 0 is `make_problem`'s
    frames; each later step moves every sequence's truth by a seeded
    drift (latent += N(0, 0.05), translation += N(0, 0.0115) per axis,
    about 2 cm).  Returns the observations of each step."""
    assets, vposer_w, cam, obs = make_problem(num_views, num_seqs, seed,
                                              device, model_type)
    z, cols = true_params(num_seqs, seed)
    rng = np.random.default_rng(seed + 1)
    out = [obs]
    for _ in range(1, steps):
        z = (z + 0.05 * rng.standard_normal(z.shape)).astype(np.float32)
        step = 0.0115 * rng.standard_normal(cols["transl"].shape)
        cols = dict(cols, transl=(cols["transl"] + step).astype(np.float32))
        out.append(observe(assets, vposer_w, cam, z, cols))
    return assets, vposer_w, cam, out


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


@functools.lru_cache(maxsize=4)
def black_png(height: int, width: int) -> bytes:
    """An all-black 8-bit RGB PNG, written with zlib and struct alone."""
    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = bytes(height * (1 + 3 * width))     # filter byte 0 per row
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows, 6)) + chunk(b"IEND", b""))


def write_workspace(root: str, kind: str = "frames", num_frames: int = 2,
                    num_views: int = 6, seed: int = 0,
                    model_type: str = "smpl", dx0: float = 0.2,
                    serial: str = "0000", image_hw: Tuple[int, int] = (
                        1080, 1920), device: DeviceLike = None) -> dict:
    """Write a synthetic problem in the reference's layout under `root`:
    `camparams.txt` (`save_cameras_txt`), and per frame f and view v
    `data/images/<serial>/Camera<v:02d>/<f:05d>.png` (black, `image_hw`;
    the height sets the data weight 500 / H) and
    `data/keypoints/<serial>/Camera<v:02d>/<f:05d>_keypoints.json` (the
    exact projections, confidence 1, one OpenPose person each).

    kind: "frames" (`make_problem`'s distinct frames), "sequence" (one
    `make_sequence` sequence of `num_frames` steps) or "people" (one
    frame of `make_people_problem(dx0)`'s two bodies, both in every
    view's file, the -x one first).  Returns the paths, the serial and
    the frame names.
    """
    dev = resolve_device(device)
    if kind == "frames":
        _, _, cam, obs = make_problem(num_views, num_frames, seed, dev,
                                      model_type)
        gt2d = obs.gt2d[:, None]
    elif kind == "sequence":
        _, _, cam, steps = make_sequence(num_views, 1, num_frames, seed, dev,
                                         model_type)
        gt2d = torch.cat([o.gt2d for o in steps])[:, None]
    elif kind == "people":
        _, _, cam, obs = make_people_problem(dx0, num_views, dev)
        gt2d = obs.gt2d[None]
    else:
        raise ValueError(f"unknown workspace kind {kind!r}")
    gt2d = gt2d.cpu().numpy()
    F, P, V, K, _ = gt2d.shape
    data = os.path.join(root, "data")
    os.makedirs(root, exist_ok=True)
    cam_param = os.path.join(root, "camparams.txt")
    save_cameras_txt(cam_param, cam)
    png = black_png(*image_hw)
    ones = np.ones((P, K, 1), np.float32)
    for f in range(F):
        for v in range(V):
            sub = os.path.join(serial, f"Camera{v:02d}")
            img_dir = os.path.join(data, "images", sub)
            os.makedirs(img_dir, exist_ok=True)
            with open(os.path.join(img_dir, f"{f:05d}.png"), "wb") as fh:
                fh.write(png)
            save_keypoints_json(
                os.path.join(data, "keypoints", sub,
                             f"{f:05d}_keypoints.json"),
                np.concatenate([gt2d[f, :, v], ones], axis=-1))
    return dict(root=root, data_folder=data, cam_param=cam_param,
                serial=serial, frames=[f"{f:05d}" for f in range(F)])
