"""Joint-set definitions for the smpl and smpllsp models (port of the
smpl/smpllsp arms of `models/joints.py`; the SMPL-H/X arms are not
ported yet).  Public SMPL-family constants; the mapping is a gather."""

from __future__ import annotations

import numpy as np

# SMPL surface-vertex ids of the face keypoints and optional feet /
# hand-tip keypoints (the "smplh" vertex set, used by smpl and smpllsp).
VERTEX_IDS_SMPLH = {
    "nose": 332, "reye": 6260, "leye": 2800, "rear": 4071, "lear": 583,
    "rthumb": 6191, "rindex": 5782, "rmiddle": 5905, "rring": 6016,
    "rpinky": 6133, "lthumb": 2746, "lindex": 2319, "lmiddle": 2445,
    "lring": 2556, "lpinky": 2673, "LBigToe": 3216, "LSmallToe": 3226,
    "LHeel": 3387, "RBigToe": 6617, "RSmallToe": 6624, "RHeel": 6787,
}

# SMPL kinematic tree (24 joints); parents[0] = -1 (root).
SMPL_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    20, 21,
)

NUM_BETAS = 10


def _not_ported(model_type: str):
    return NotImplementedError(
        f"model type {model_type!r} is not ported yet: the port covers "
        "smpl and smpllsp")


def parents_for_model(model_type: str):
    if model_type in ("smpl", "smpllsp"):
        return SMPL_PARENTS
    if model_type in ("smplh", "smplx"):
        raise _not_ported(model_type)
    raise ValueError(f"Unknown model type: {model_type}")


def extra_joint_ids(vertex_id_set: str = "smplh",
                    use_feet_keypoints: bool = False,
                    use_hands: bool = False) -> np.ndarray:
    """Surface-vertex indices appended after the regressed joints."""
    if vertex_id_set != "smplh":
        raise _not_ported(vertex_id_set)
    ids = VERTEX_IDS_SMPLH
    out = [ids["nose"], ids["leye"], ids["reye"], ids["lear"], ids["rear"]]
    if use_feet_keypoints:
        out += [ids["LBigToe"], ids["LSmallToe"], ids["LHeel"],
                ids["RBigToe"], ids["RSmallToe"], ids["RHeel"]]
    if use_hands:
        for hand in "lr":
            for tip in ["thumb", "index", "middle", "ring", "pinky"]:
                out.append(ids[hand + tip])
    return np.asarray(out, dtype=np.int32)


def model_to_annotation(model_type: str, pose_format: str) -> np.ndarray:
    """Gather indices mapping model joints -> annotation joint order."""
    if pose_format == "coco17":
        if model_type != "smpl":
            if model_type == "smplh":
                raise _not_ported(model_type)
            raise ValueError(f"coco17 requires smpl/smplh, got {model_type}")
        nb = len(parents_for_model(model_type))
        return np.array(
            [nb, nb + 1, nb + 2, nb + 3, nb + 4,
             16, 17, 18, 19, 20, 21, 1, 2, 4, 5, 7, 8], dtype=np.int32)
    if pose_format == "lsp14":
        if model_type != "smpllsp":
            raise ValueError(f"lsp14 requires smpllsp, got {model_type}")
        return np.array(
            [14, 15, 16, 17, 18, 9, 8, 10, 7, 11, 6, 3, 2, 4, 1, 5, 0],
            dtype=np.int32)
    if pose_format == "coco25":
        raise _not_ported("smplx")
    raise ValueError(f"Unknown pose format: {pose_format}")


def pose_format_for_model(model_type: str) -> str:
    """Default annotation format per model type (`code/init.py:60-69`)."""
    if model_type == "smpllsp":
        return "lsp14"
    if model_type == "smplx":
        return "coco25"
    return "coco17"


def default_joint_weights(num_joints: int, pose_format: str,
                          use_hip: bool = True) -> np.ndarray:
    """Per-joint data weights: ones, hips (11, 12) zeroed unless the
    model regresses annotated hips (lsp14 with use_hip)."""
    w = np.ones(num_joints, dtype=np.float32)
    if pose_format != "lsp14" or not use_hip:
        w[11] = 0.0
        w[12] = 0.0
    return w
