"""SMPL-family asset loading: official pkl files, npz caches and
synthetic models (port of `models/assets.py`).

The official SMPL pickles hold chumpy arrays and scipy sparse matrices;
chumpy is no dependency, so the loader unpickles with a stub class and
keeps plain numpy arrays (the data the reference reads at
`body_models_scale.py:178-180`).  The synthetic model's geometry is
generated by numpy seeded from `seed`, with the same draws in the same
order as the JAX package, so the arrays are equal.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import joints as J
from .smpl import SMPLAssets

NUM_VERTS = 6890
NUM_FACES = 13776


class _ChumpyStub:
    """Stand-in for a chumpy array: keeps its state, `r` its values."""

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})

    @property
    def r(self):
        return np.asarray(self.__dict__.get("x"))


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyStub
        return super().find_class(module, name)


def _to_dense(x) -> np.ndarray:
    if isinstance(x, _ChumpyStub):
        x = x.r
    if hasattr(x, "todense"):  # scipy sparse
        x = np.asarray(x.todense())
    return np.asarray(x)


def load_smpl_pkl(path: str) -> dict:
    """Unpickle an official SMPL model file into plain numpy arrays."""
    with open(path, "rb") as f:
        data = _StubUnpickler(f, encoding="latin1").load()
    return {k: _to_dense(v) if not isinstance(v, (str, int, float)) else v
            for k, v in data.items()}


def _build(raw: dict, model_type: str, gender: str,
           lsp_regressor: Optional[np.ndarray], pose_format: Optional[str],
           device: torch.device, dtype=torch.float32,
           flat_hand_mean: bool = False, num_expr: int = 10) -> SMPLAssets:
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    full_shapedirs = np.asarray(raw["shapedirs"], np.float32)
    # SMPL-X: the expression blend shapes are the shapedirs columns after
    # the 10 shape ones (`body_models.py:914-921`).
    expr_dirs = None
    if model_type == "smplx" and full_shapedirs.shape[-1] > J.NUM_BETAS:
        hi = min(full_shapedirs.shape[-1], J.NUM_BETAS + num_expr)
        expr_dirs = t(full_shapedirs[..., J.NUM_BETAS:hi])
    # MANO hand PCA (pkl keys `hands_components{l,r}`, `hands_mean{l,r}`,
    # `body_models.py:493-513`); zero means under flat_hand_mean.
    hand_components = hand_means = None
    if "hands_componentsl" in raw:
        hand_components = t(np.stack([
            np.asarray(raw["hands_componentsl"], np.float32),
            np.asarray(raw["hands_componentsr"], np.float32)]))
        if flat_hand_mean:
            means = np.zeros((2, 45), np.float32)
        else:
            means = np.stack([np.asarray(raw["hands_meanl"], np.float32),
                              np.asarray(raw["hands_meanr"], np.float32)])
        hand_means = t(means)

    posedirs = np.asarray(raw["posedirs"], np.float32)
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # ((J-1)*9, V*3)
    parents = tuple(int(p) for p in np.asarray(raw["kintree_table"])[0])
    parents = (-1,) + parents[1:]
    fmt = pose_format or J.pose_format_for_model(model_type)
    vertex_set = "smplx" if model_type == "smplx" else "smplh"
    use_feet = model_type == "smplx"   # coco25 has the foot keypoints
    return SMPLAssets(
        v_template=t(raw["v_template"]),
        shapedirs=t(full_shapedirs[..., :J.NUM_BETAS]),
        posedirs=t(posedirs),
        j_regressor=t(_to_dense(raw["J_regressor"])),
        lbs_weights=t(raw["weights"]),
        faces=idx(raw["f"]),
        extra_joint_ids=idx(J.extra_joint_ids(vertex_set, use_feet)),
        joint_map=idx(J.model_to_annotation(model_type, fmt)),
        lsp_regressor=None if lsp_regressor is None else t(lsp_regressor),
        hand_components=hand_components, hand_means=hand_means,
        expr_dirs=expr_dirs,
        parents=parents, model_type=model_type, gender=gender)


def load_smpl(model_folder: str, model_type: str = "smpl",
              gender: str = "neutral",
              lsp_regressor_path: Optional[str] = None,
              pose_format: Optional[str] = None,
              flat_hand_mean: bool = False, num_expr: int = 10,
              device: DeviceLike = None) -> SMPLAssets:
    """Load SMPL-family assets the way the reference resolves them.

    `model_folder` is the directory holding
    `<family>/<FAMILY>_<GENDER>.pkl|npz` (family smpl, smplh or smplx;
    smpllsp uses the smpl files, `body_models_scale.py:82-87`,
    `body_models.py:483-484,717-718`), that file's own directory, or a
    direct path to a pkl/npz.  For smpllsp an LSP 14-joint regressor npz
    (key `joint_regressor`, (14, V)) is required.
    """
    family = "smpl" if model_type == "smpllsp" else model_type
    J.parents_for_model(model_type)   # raises for an unknown type
    dev = resolve_device(device)
    path = model_folder
    if os.path.isdir(path):
        sub = os.path.join(path, family)
        if os.path.isdir(sub):
            path = sub
        base = os.path.join(path, f"{family.upper()}_{gender.upper()}")
        for ext in (".pkl", ".npz"):
            if os.path.exists(base + ext):
                path = base + ext
                break
        else:
            path = base + ".pkl"
    if not os.path.exists(path):
        raise FileNotFoundError(f"{family} model not found: {path}")
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=True) as data:
            raw = {k: data[k] for k in data.files}
        raw = {k: (v.item() if v.dtype == object and v.shape == () else v)
               for k, v in raw.items()}
    else:
        raw = load_smpl_pkl(path)

    lsp = None
    if model_type == "smpllsp":
        if lsp_regressor_path is None:
            raise ValueError("smpllsp requires lsp_regressor_path")
        lsp = np.load(lsp_regressor_path)["joint_regressor"]
    return _build(raw, model_type, gender, lsp, pose_format, dev,
                  flat_hand_mean=flat_hand_mean, num_expr=num_expr)


def synthetic_smpl(model_type: str = "smpl", seed: int = 0,
                   pose_format: Optional[str] = None,
                   flat_hand_mean: bool = False,
                   device: DeviceLike = None) -> SMPLAssets:
    """Deterministic synthetic SMPL-family model at full production shapes
    (6890 vertices and 24 joints for smpl, 52 for smplh; 10475 vertices
    and 55 joints for smplx; the real trees) with generated geometry: an
    ellipsoid mesh, a plausible skeleton, distance-based skinning weights,
    small random blend shapes and, for smplh/smplx, orthonormal MANO-like
    hand bases."""
    J.parents_for_model(model_type)   # raises for an unknown type
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    num_verts = 10475 if model_type == "smplx" else NUM_VERTS

    # UV-sphere grid stretched into a body-like ellipsoid: 6890 = 2 +
    # 84*82; 10475 = 2 + 101*103 + 70 extra points.
    n_lat, n_lon = (101, 103) if model_type == "smplx" else (84, 82)
    lat = np.linspace(1e-2, np.pi - 1e-2, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    lat_g, lon_g = np.meshgrid(lat, lon, indexing="ij")
    xs = 0.25 * np.sin(lat_g) * np.cos(lon_g)
    ys = 0.85 * np.cos(lat_g)
    zs = 0.15 * np.sin(lat_g) * np.sin(lon_g)
    grid = np.stack([xs, ys, zs], -1).reshape(-1, 3)
    poles = np.array([[0.0, 0.9, 0.0], [0.0, -0.9, 0.0]])
    v_template = np.concatenate([poles, grid], 0).astype(np.float32)
    if v_template.shape[0] < num_verts:
        extra = rng.standard_normal((num_verts - v_template.shape[0], 3))
        extra /= np.linalg.norm(extra, axis=1, keepdims=True)
        extra = extra * [0.25, 0.85, 0.15]
        v_template = np.concatenate(
            [v_template, extra.astype(np.float32)], 0)
    assert v_template.shape[0] == num_verts

    def vid(i, j):
        return 2 + i * n_lon + (j % n_lon)

    tris = []
    for j in range(n_lon):
        tris.append([0, vid(0, j), vid(0, j + 1)])
        tris.append([1, vid(n_lat - 1, j + 1), vid(n_lat - 1, j)])
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            tris.append([a, b, c])
            tris.append([b, d, c])
    faces = np.asarray(tris, np.int32)
    if model_type != "smplx":
        faces = faces[:NUM_FACES]

    joint_pos = np.array([
        [0.00, 0.00, 0.0],    # pelvis
        [0.08, -0.05, 0.0],   # L hip
        [-0.08, -0.05, 0.0],  # R hip
        [0.00, 0.10, 0.0],    # spine1
        [0.10, -0.40, 0.0],   # L knee
        [-0.10, -0.40, 0.0],  # R knee
        [0.00, 0.22, 0.0],    # spine2
        [0.09, -0.75, 0.0],   # L ankle
        [-0.09, -0.75, 0.0],  # R ankle
        [0.00, 0.30, 0.0],    # spine3
        [0.11, -0.82, 0.1],   # L foot
        [-0.11, -0.82, 0.1],  # R foot
        [0.00, 0.45, 0.0],    # neck
        [0.08, 0.40, 0.0],    # L collar
        [-0.08, 0.40, 0.0],   # R collar
        [0.00, 0.55, 0.0],    # head
        [0.16, 0.42, 0.0],    # L shoulder
        [-0.16, 0.42, 0.0],   # R shoulder
        [0.22, 0.20, 0.0],    # L elbow
        [-0.22, 0.20, 0.0],   # R elbow
        [0.24, 0.00, 0.0],    # L wrist
        [-0.24, 0.00, 0.0],   # R wrist
        [0.25, -0.06, 0.0],   # L hand
        [-0.25, -0.06, 0.0],  # R hand
    ], np.float32)
    parents = J.parents_for_model(model_type)
    nj = len(parents)
    if nj > 24:
        # SMPL-H / SMPL-X: body joints 0-21 shared with SMPL, then the
        # face joints near the head (SMPL-X) and 5x3 finger chains
        # fanning from each wrist.
        pieces = [joint_pos[:22]]
        if model_type == "smplx":
            head = joint_pos[15]
            pieces.append(np.asarray([
                head + [0.0, -0.04, 0.05],   # jaw
                head + [0.03, 0.02, 0.06],   # left eye
                head + [-0.03, 0.02, 0.06],  # right eye
            ], np.float32))
        for sign in (1.0, -1.0):   # left, right
            wrist = joint_pos[20 if sign > 0 else 21]
            fingers = []
            for f in range(5):
                dz = (f - 2) * 0.012
                for k in range(3):
                    fingers.append(
                        wrist + [sign * 0.02 * (k + 1), -0.01 * k, dz])
            pieces.append(np.asarray(fingers, np.float32))
        joint_pos = np.concatenate(pieces, 0)
    assert joint_pos.shape[0] == nj, (joint_pos.shape, nj)

    # Joint regressor: soft nearest vertices, rows summing to 1.
    d2 = ((joint_pos[:, None, :] - v_template[None, :, :]) ** 2).sum(-1)
    jr = np.exp(-d2 / 0.005)
    j_regressor = (jr / jr.sum(1, keepdims=True)).astype(np.float32)
    # Skinning weights: softmax over inverse distance to the joints.
    w = np.exp(-d2.T / 0.02)
    lbs_weights = (w / w.sum(1, keepdims=True)).astype(np.float32)

    num_pose = 9 * (nj - 1)
    # SMPL-X raw shapedirs carry 10 shape + 10 expression columns, split
    # by `_build` as the real npz's are.
    num_shape_cols = J.NUM_BETAS + (10 if model_type == "smplx" else 0)
    shapedirs = (0.01 * rng.standard_normal((num_verts, 3, num_shape_cols))
                 ).astype(np.float32)
    posedirs = (0.001 * rng.standard_normal((num_pose, num_verts * 3))
                ).astype(np.float32)

    lsp = None
    if model_type == "smpllsp":
        lsp_order = [7, 4, 1, 2, 5, 8, 20, 18, 16, 17, 19, 21, 12, 15]
        lsp = j_regressor[lsp_order]

    raw = {
        "v_template": v_template,
        "shapedirs": shapedirs,
        "posedirs": posedirs.T.reshape(num_verts, 3, num_pose),
        "J_regressor": j_regressor,
        "weights": lbs_weights,
        "f": faces,
        "kintree_table": np.stack([np.asarray(parents), np.arange(nj)]),
    }
    if model_type in ("smplh", "smplx"):
        # MANO-like hand PCA: orthonormal 45-D bases and small mean poses,
        # in the real pkl key layout.
        ql, _ = np.linalg.qr(rng.standard_normal((45, 45)))
        qr_, _ = np.linalg.qr(rng.standard_normal((45, 45)))
        raw["hands_componentsl"] = ql.astype(np.float32)
        raw["hands_componentsr"] = qr_.astype(np.float32)
        raw["hands_meanl"] = (0.1 * rng.standard_normal(45)
                              ).astype(np.float32)
        raw["hands_meanr"] = (0.1 * rng.standard_normal(45)
                              ).astype(np.float32)
    return _build(raw, model_type, "neutral", lsp, pose_format, dev,
                  flat_hand_mean=flat_hand_mean)
