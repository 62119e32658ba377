"""Shared helpers of the PyTorch port's tests (`test_torch_*.py`).

Inputs are made by numpy from a seed and handed to both packages; the
JAX package's dataclasses are carried to the port through
`mvsmplfitting_tpu_torch.convert` as dicts of numpy arrays.
"""

import dataclasses
import functools
import os

import numpy as np

VPOSER_NPZ = os.path.join(os.path.dirname(__file__), "..", "assets",
                          "vposer_weights.npz")


def arrays(obj, skip=("joint_model",)):
    """The array fields of a JAX dataclass as a dict of numpy arrays."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name in skip or isinstance(v, (str, tuple, bool, int, float)):
            continue
        out[f.name] = None if v is None else np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def port_assets(model_type="smpl"):
    """The port's synthetic assets with their reduced joint model (CPU)."""
    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl
    from mvsmplfitting_tpu_torch.models.joint_model import with_joint_model
    return with_joint_model(synthetic_smpl(model_type, device="cpu"))


def jax_joint_model(port_jm):
    """A JAX `JointModel` holding the port's constants, so kernel tests
    compare the two packages on identical inputs without the slow float32
    einsum build."""
    import jax.numpy as jnp

    from mvsmplfitting_tpu.models.joint_model import JointModel
    g = {f: jnp.asarray(getattr(port_jm, f).numpy())
         for f in ("H0", "Hb", "Hp", "j0", "JB", "fold", "chain_mask")}
    for f in ("He", "JE", "hand_components", "hand_means"):
        v = getattr(port_jm, f)
        g[f] = None if v is None else jnp.asarray(v.numpy())
    return JointModel(chain_idx=jnp.asarray(port_jm.chain_idx.numpy(),
                                            jnp.int32),
                      parents=port_jm.parents,
                      model_type=port_jm.model_type, **g)


@functools.lru_cache(maxsize=None)
def jax_assets(model_type="smpl"):
    """JAX synthetic assets carrying the port-built joint model."""
    from mvsmplfitting_tpu.models.assets import synthetic_smpl
    assets = synthetic_smpl(model_type)
    return assets.replace(
        joint_model=jax_joint_model(port_assets(model_type).joint_model))


@functools.lru_cache(maxsize=None)
def vposer_pair():
    """(JAX weights, port weights) from the bundled npz."""
    from mvsmplfitting_tpu.models import vposer as jv
    from mvsmplfitting_tpu_torch.models import vposer as tv
    return jv.load_npz(VPOSER_NPZ), tv.load_npz(VPOSER_NPZ, device="cpu")


def jax_observations(obs):
    """The JAX `Observations` holding a port `Observations`' values."""
    import jax.numpy as jnp

    from mvsmplfitting_tpu.fitting.energy import Observations
    return Observations(**{
        f.name: (None if getattr(obs, f.name) is None
                 else jnp.asarray(getattr(obs, f.name).numpy()))
        for f in dataclasses.fields(obs)})


def fit_problem(B, seed=0, model_type="smpl"):
    """B distinct synthetic frames seen by 6 views, as JAX structs, and
    the same values carried into the port by `convert` (CPU).  The pixels
    come from the port's `synthetic.make_problem`; the JAX assets carry
    the port-built joint model."""
    import jax.numpy as jnp

    from mvsmplfitting_tpu.models.camera import Camera as JCamera
    from mvsmplfitting_tpu_torch import convert, synthetic
    _, _, tc, to = synthetic.make_problem(6, B, seed=seed, device="cpu",
                                          model_type=model_type)
    ja = jax_assets(model_type)
    jw, _ = vposer_pair()
    jc = JCamera(**{f: jnp.asarray(getattr(tc, f).numpy())
                    for f in ("rotation", "translation", "focal", "center")})
    jo = jax_observations(to)
    ta = dataclasses.replace(
        convert.smpl_assets(arrays(ja), ja.parents, ja.model_type,
                            device="cpu"),
        joint_model=convert.joint_model(arrays(ja.joint_model), ja.parents,
                                        ja.model_type, device="cpu"))
    return dict(ta=ta, tc=convert.camera(arrays(jc), device="cpu"),
                to=convert.observations(arrays(jo), device="cpu"),
                tw=convert.vposer_weights(arrays(jw), device="cpu"),
                ja=ja, jc=jc, jo=jo, jw=jw)


def rand_joint_inputs(rng, B, J=24, NB=10):
    """theta ~ N(0, 0.4), betas ~ N(0, 1), scale ~ U(0.7, 1.5)."""
    theta = rng.normal(0, 0.4, (B, J * 3)).astype(np.float32)
    betas = rng.normal(0, 1.0, (B, NB)).astype(np.float32)
    scale = rng.uniform(0.7, 1.5, (B,)).astype(np.float32)
    return theta, betas, scale


def icosphere(radius=0.5, center=(0.0, 0.0, 0.0), n=12, tilt=0.1):
    """UV sphere mesh, tilted off the grid axes (the JAX SDF tests'
    fixture, `tests/test_sdf.py:icosphere`): an axis-aligned sphere makes
    the corner parity ray graze shared edges."""
    lats = np.linspace(1e-3, np.pi - 1e-3, n)
    lons = np.linspace(0, 2 * np.pi, n, endpoint=False)
    verts = [[radius * np.sin(la) * np.cos(lo) + center[0],
              radius * np.cos(la) + center[1],
              radius * np.sin(la) * np.sin(lo) + center[2]]
             for la in lats for lo in lons]
    verts.append([center[0], radius + center[1], center[2]])
    verts.append([center[0], -radius + center[1], center[2]])
    top, bot = len(verts) - 2, len(verts) - 1
    faces = []
    for i in range(n - 1):
        for j in range(n):
            a, b = i * n + j, i * n + (j + 1) % n
            c, d = (i + 1) * n + j, (i + 1) * n + (j + 1) % n
            faces += [[a, b, c], [b, d, c]]
    for j in range(n):
        faces.append([top, j, (j + 1) % n])
        faces.append([bot, (n - 1) * n + (j + 1) % n, (n - 1) * n + j])
    verts = np.asarray(verts, np.float32)
    if tilt:
        c, s = np.cos(tilt), np.sin(tilt)
        rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        rx = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        ctr = np.asarray(center, np.float32)
        verts = (verts - ctr) @ (rz @ rx).T + ctr
    return verts, np.asarray(faces, np.int32)


@functools.lru_cache(maxsize=None)
def posed_bodies(num=2, seed=3):
    """`num` posed synthetic smpl bodies (num, 6890, 3) and the faces,
    normalized into [-1, 1]^3 as `ops.sdf.person_grids` does (CPU)."""
    import torch

    from mvsmplfitting_tpu_torch.models import vposer as tv
    from mvsmplfitting_tpu_torch.models.smpl import SMPLParams, smpl_forward
    from mvsmplfitting_tpu_torch.ops.sdf import box_frame
    assets = port_assets("smpl")
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.normal(0, 0.8, (num, 32)).astype(np.float32))
    params = SMPLParams.zeros(num)
    vposer_w = tv.load_npz(VPOSER_NPZ, device="cpu")     # JAX-free
    verts, _ = smpl_forward(assets, params, tv.decode(vposer_w, z))
    centers, scales = box_frame(verts)
    local = (verts - centers[:, None]) / scales[:, None, None]
    return local.contiguous(), assets.faces


def phase_b_walk(tb, m, vox):
    """The two-phase voxelizer's phase-B walk (`csrc/sdf_grid_fast.cu`,
    `sdf_dist_kernel`) for one group of inside voxels `vox` of mesh m,
    with the plain pair function and the kernel's fp32 bounds: chunks by
    increasing squared box gap (lowest index first among equals), stop
    once the next gap reaches worst * (1 + 1e-4) + 1e-9.  Returns (chunks
    visited, the voxels' minima of d^2, mask of the chunks left)."""
    import torch

    from mvsmplfitting_tpu_torch.ops import sdf as S
    from mvsmplfitting_tpu_torch.ops import sdf_kernel as SK
    p = S.voxel_centers(tb.G)[vox]
    lo, hi = p.amin(0), p.amax(0)
    box = tb.boxes[m]
    gap = torch.clamp_min(torch.maximum(box[:, :3] - hi, lo - box[:, 3:]),
                          0.0)
    lb2 = gap[:, 0] * gap[:, 0] + gap[:, 1] * gap[:, 1] + gap[:, 2] * gap[:, 2]
    tri = tb.trib[m].reshape(tb.nc, SK.CHUNK, 9)
    run_min = torch.full((len(vox),), 1e6)
    left = torch.ones(tb.nc, dtype=torch.bool)
    for c in torch.argsort(lb2, stable=True).tolist():
        if not lb2[c] < run_min.max() * (1.0 + 1e-4) + 1e-9:
            break
        comps = [tri[c, :, i][None] for i in range(9)]
        d2 = S._pair_dist_sq(*comps, p[:, 0:1], p[:, 1:2], p[:, 2:3])
        run_min = torch.minimum(run_min, d2.amin(-1))
        left[c] = False
    return int((~left).sum()), run_min, left



def black_png(height, width):
    """The bytes of an all-black RGB PNG (`synthetic.black_png`)."""
    from mvsmplfitting_tpu_torch.synthetic import black_png as png
    return png(height, width)


def jpeg_header(height, width):
    """A JPEG's header segments (SOI, APP0, DQT, SOF0) and EOI, enough
    for a reader of the frame size; no image data."""
    import struct
    app0 = (b"\xff\xe0" + struct.pack(">H", 16)
            + b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    dqt = b"\xff\xdb" + struct.pack(">H", 67) + bytes(65)
    sof = b"\xff\xc0" + struct.pack(">HBHHB", 17, 8, height, width, 3) \
        + bytes(9)
    return b"\xff\xd8" + app0 + dqt + sof + b"\xff\xd9"


def cli_workspace(root, kind="frames", **kw):
    """A workspace in the reference's layout under `root`, written by the
    port's `synthetic.write_workspace` on the CPU: both packages' CLIs
    read these same files (camera text, PNG headers, keypoint JSONs)."""
    from mvsmplfitting_tpu_torch.synthetic import write_workspace
    return write_workspace(str(root), kind=kind, device="cpu", **kw)


def write_config(path, **values):
    """A config file of `key: value` lines (JSON scalars and flow lists,
    which both packages' YAML readers take)."""
    import json
    with open(path, "w") as f:
        for k, v in values.items():
            f.write(f"{k}: {json.dumps(v)}\n")
    return str(path)


def numpy_state(model, seed: int) -> dict:
    """A random state_dict for `model` in its (the reference's) names,
    made with numpy: conv/dense weights N(0, 1/fan_in), biases N(0,
    0.01), BatchNorm weights U(0.5, 1.5), running means N(0, 0.04) and
    variances U(0.5, 1.5)."""
    from torch import nn

    rng = np.random.default_rng(seed)
    out = {}
    for mname, mod in model.named_modules():
        pre = f"{mname}." if mname else ""
        for name, p in mod.named_parameters(recurse=False):
            shape = tuple(p.shape)
            if isinstance(mod, nn.BatchNorm2d) and name == "weight":
                v = rng.uniform(0.5, 1.5, shape)
            elif name == "weight":
                fan_in = nn.init._calculate_fan_in_and_fan_out(p)[0]
                v = rng.standard_normal(shape) / np.sqrt(fan_in)
            else:
                v = 0.1 * rng.standard_normal(shape)
            out[pre + name] = v.astype(np.float32)
        for name, b in mod.named_buffers(recurse=False):
            shape = tuple(b.shape)
            if name == "running_mean":
                v = (0.2 * rng.standard_normal(shape)).astype(np.float32)
            elif name == "running_var":
                v = rng.uniform(0.5, 1.5, shape).astype(np.float32)
            else:
                v = np.zeros(shape, np.int64)
            out[pre + name] = v
    return out


def fixed_yolox_head(sd: dict, level: int = 2, box_scale: float = 1.5,
                     levels: int = 3) -> dict:
    """`sd` (a YOLOX state_dict) with its prediction convs zeroed: every
    anchor of `level` scores sigmoid(2) * sigmoid(3) (above both bands'
    thresholds) with a box `box_scale` strides wide at its grid point,
    every other anchor sigmoid(-8) * sigmoid(3).  The boxes, and so the
    crops, are then the same in both packages whatever the image."""
    out = dict(sd)
    for i in range(levels):
        for pred in ("cls", "reg", "obj"):
            w = out[f"head.{pred}_preds.{i}.weight"]
            out[f"head.{pred}_preds.{i}.weight"] = np.zeros_like(w)
        out[f"head.cls_preds.{i}.bias"] = np.full((1,), 3.0, np.float32)
        out[f"head.obj_preds.{i}.bias"] = np.full(
            (1,), 2.0 if i == level else -8.0, np.float32)
        out[f"head.reg_preds.{i}.bias"] = np.asarray(
            [0.0, 0.0, np.log(box_scale), np.log(box_scale)], np.float32)
    return out


def write_image_tree(root: str, serial: str = "0000", cams: int = 2,
                     frames: int = 2, hw=(120, 160), seed: int = 0) -> list:
    """`root/<serial>/Camera0<v>/<f:03d>.jpg` baseline JPEGs (quality 90)
    of seeded smooth textures, written with OpenCV; returns the paths
    per frame."""
    import cv2

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:hw[0], 0:hw[1]]
    paths = []
    for f in range(frames):
        row = []
        for v in range(cams):
            ph = rng.uniform(0, 6, 3)
            img = np.stack([128 + 90 * np.sin(x / (9.0 + c) + ph[c])
                            * np.cos(y / (13.0 - c) - ph[c])
                            for c in range(3)], -1)
            img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255)
            d = os.path.join(root, serial, f"Camera0{v}")
            os.makedirs(d, exist_ok=True)
            p = os.path.join(d, f"{f:03d}.jpg")
            cv2.imwrite(p, img.astype(np.uint8),
                        [cv2.IMWRITE_JPEG_QUALITY, 90])
            row.append(p)
        paths.append(row)
    return paths


def to_tensors(sd: dict) -> dict:
    """A numpy state_dict as CPU tensors (for `load_state_dict`)."""
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}
