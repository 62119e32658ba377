"""OpenPose-format keypoint JSON IO (port of `data/keypoints.py`).

The two pipeline stages of the reference communicate only through these
files (`data/keypoints/<serial>/<cam>/<frame>_keypoints.json`, written by
`FileLoaders.save_keypoints` at `code/utils/FileLoaders.py:163-179` and
read by `data_parser.read_keypoints` at `code/utils/data_parser.py:42-90`).
The format is kept exactly as the import/export boundary.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

NUM_BODY_JOINTS = 17  # the reference truncates to 17 (`data_parser.py:54`)


def read_keypoints_json(path: str, num_body_joints: int = NUM_BODY_JOINTS,
                        use_hands: bool = False, use_face: bool = False,
                        use_face_contour: bool = False) -> List[np.ndarray]:
    """Read per-person 2D keypoints; each entry is (K, 3) [x, y, conf].

    Body keypoints are truncated to the first `num_body_joints` rows,
    matching the reference's 17-joint cap; hands (2x21) and the 51 FLAME
    face landmarks are appended when requested.
    """
    with open(path) as f:
        data = json.load(f)

    people = []
    for person in data.get("people", []):
        body = np.asarray(person["pose_keypoints_2d"],
                          np.float32).reshape(-1, 3)[:num_body_joints]
        parts = [body]
        if use_hands:
            for key in ("hand_left_keypoints_2d", "hand_right_keypoints_2d"):
                parts.append(np.asarray(person.get(key, []),
                                        np.float32).reshape(-1, 3))
        if use_face:
            face = np.asarray(person.get("face_keypoints_2d", []),
                              np.float32).reshape(-1, 3)
            parts.append(face[17:17 + 51])
            if use_face_contour:
                parts.append(face[:17])
        people.append(np.concatenate(parts, axis=0))
    return people


def read_joints3d_json(path: str) -> Optional[List[np.ndarray]]:
    """Read per-person 3D joint annotations (K, 4) [x, y, z, conf].

    Returns None when the file carries no 3D block (the common case;
    mirrors `data_parser.read_joints`'s except-None behavior).
    """
    with open(path) as f:
        data = json.load(f)
    people = []
    for person in data.get("people", []):
        if "pose_keypoints_3d" not in person:
            return None
        people.append(np.asarray(person["pose_keypoints_3d"],
                                 np.float32).reshape(-1, 4))
    return people or None


def save_keypoints_json(path: str, poses: np.ndarray,
                        version: float = 1.1) -> None:
    """Write detections as OpenPose JSON (one person per leading index)."""
    poses = np.asarray(poses, float)
    out = {"version": version,
           "people": [{"pose_keypoints_2d": p.flatten().tolist()}
                      for p in poses]}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=2)
