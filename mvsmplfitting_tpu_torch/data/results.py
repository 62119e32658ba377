"""Result writers: per-frame pkl (reference-compatible), OBJ meshes
(port of `data/results.py`).

Matches `save_results` (`code/utils/utils.py:729-890`): the pkl is
protocol 2 with keys betas / global_orient / transl / scale /
body_pose / pose / pose_embedding / loss, and the wrist, foot, and hand
axis-angle components of the decoded pose are zeroed before saving
(dims 18:24, 27:33, 57:, `utils.py:750-753`), because the VPoser
estimate of those joints is unreliable.  OBJ export is a plain text
writer (the reference shells out to trimesh).
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass

import numpy as np


@dataclass
class FitOutputs:
    betas: np.ndarray           # (1, 10)
    global_orient: np.ndarray   # (1, 3)
    transl: np.ndarray          # (1, 3)
    scale: np.ndarray           # (1, 1)
    body_pose: np.ndarray       # (1, 69) decoded, extremities zeroed
    pose_embedding: np.ndarray  # (1, 32)
    loss: float


def zero_extremities(body_pose: np.ndarray) -> np.ndarray:
    """Zero foot (18:24), wrist-adjacent (27:33) and hand (57:) dims."""
    out = np.array(body_pose, np.float32, copy=True)
    out[..., 18:24] = 0.0
    out[..., 27:33] = 0.0
    out[..., 57:] = 0.0
    return out


def result_dict(out: FitOutputs) -> dict:
    body_pose = zero_extremities(out.body_pose).reshape(1, -1)
    orient = np.asarray(out.global_orient, np.float32).reshape(1, 3)
    return {
        "betas": np.asarray(out.betas, np.float32).reshape(1, -1),
        "global_orient": orient,
        "transl": np.asarray(out.transl, np.float32).reshape(1, 3),
        "scale": np.asarray(out.scale, np.float32).reshape(1, 1),
        "body_pose": body_pose,
        "pose": np.hstack([orient, body_pose]),
        "pose_embedding": np.asarray(out.pose_embedding,
                                     np.float32).reshape(1, -1),
        "loss": float(out.loss),
    }


def save_result_pkl(path: str, out: FitOutputs) -> dict:
    """Write `<result_folder>/<serial>/<fn>/000.pkl`, protocol 2."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    result = result_dict(out)
    with open(path, "wb") as f:
        pickle.dump(result, f, protocol=2)
    return result


def load_result_pkl(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Plain OBJ writer (1-based face indices), six decimals per
    coordinate; the whole file is formatted in one pass."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    verts = np.asarray(verts).reshape(-1, 3)
    faces = np.asarray(faces).reshape(-1, 3) + 1
    with open(path, "w") as f:
        f.write(("v %.6f %.6f %.6f\n" * len(verts))
                % tuple(verts.ravel().tolist()))
        f.write(("f %d %d %d\n" * len(faces))
                % tuple(faces.ravel().tolist()))
