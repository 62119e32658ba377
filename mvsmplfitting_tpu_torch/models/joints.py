"""Joint-set definitions: extra surface keypoints and annotation mappings
(port of `models/joints.py`).  Public SMPL-family constants; the mapping
is a gather."""

from __future__ import annotations

import numpy as np

# Surface-vertex ids of the face keypoints and optional feet / hand-tip
# keypoints: the "smplh" set (smpl, smpllsp, smplh) and the "smplx" set.
VERTEX_IDS = {
    "smplh": {
        "nose": 332, "reye": 6260, "leye": 2800, "rear": 4071, "lear": 583,
        "rthumb": 6191, "rindex": 5782, "rmiddle": 5905, "rring": 6016,
        "rpinky": 6133, "lthumb": 2746, "lindex": 2319, "lmiddle": 2445,
        "lring": 2556, "lpinky": 2673, "LBigToe": 3216, "LSmallToe": 3226,
        "LHeel": 3387, "RBigToe": 6617, "RSmallToe": 6624, "RHeel": 6787,
    },
    "smplx": {
        "nose": 9120, "reye": 9929, "leye": 9448, "rear": 616, "lear": 6,
        "rthumb": 8079, "rindex": 7669, "rmiddle": 7794, "rring": 7905,
        "rpinky": 8022, "lthumb": 5361, "lindex": 4933, "lmiddle": 5058,
        "lring": 5169, "lpinky": 5286, "LBigToe": 5770, "LSmallToe": 5780,
        "LHeel": 8846, "RBigToe": 8463, "RSmallToe": 8474, "RHeel": 8635,
    },
}

# SMPL kinematic tree (24 joints); parents[0] = -1 (root).
SMPL_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    20, 21,
)


def _hand(parent_wrist: int, start: int):
    """One hand's 5 finger chains of 3 joints, each rooted at the wrist."""
    out = []
    for f in range(5):
        out += [parent_wrist, start + 3 * f, start + 3 * f + 1]
    return tuple(out)


# SMPL-H: the 22 shared body joints + 15 left-hand + 15 right-hand = 52.
SMPLH_PARENTS = SMPL_PARENTS[:22] + _hand(20, 22) + _hand(21, 37)
# SMPL-X: 22 body + jaw, leye, reye (children of the head, 15) + 2 x 15
# hand joints = 55.
SMPLX_PARENTS = (SMPL_PARENTS[:22] + (15, 15, 15) + _hand(20, 25)
                 + _hand(21, 40))

NUM_BETAS = 10


def parents_for_model(model_type: str):
    if model_type in ("smpl", "smpllsp"):
        return SMPL_PARENTS
    if model_type == "smplh":
        return SMPLH_PARENTS
    if model_type == "smplx":
        return SMPLX_PARENTS
    raise ValueError(f"Unknown model type: {model_type}")


def extra_joint_ids(vertex_id_set: str = "smplh",
                    use_feet_keypoints: bool = False,
                    use_hands: bool = False) -> np.ndarray:
    """Surface-vertex indices appended after the regressed joints."""
    ids = VERTEX_IDS[vertex_id_set]
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
    """Gather indices mapping model joints -> annotation joint order:
    coco17 (smpl/smplh), lsp14 (smpllsp), coco25 = OpenPose BODY_25
    (smplx)."""
    if pose_format == "coco17":
        if model_type not in ("smpl", "smplh"):
            raise ValueError(f"coco17 requires smpl/smplh, got {model_type}")
        # The face keypoints follow the model's chain joints; body joint
        # ids 0-21 are shared across the family.
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
        if model_type != "smplx":
            raise ValueError(f"coco25 requires smplx, got {model_type}")
        return np.array(
            [55, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7, 56, 57, 58,
             59, 60, 61, 62, 63, 64, 65], dtype=np.int32)
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
