"""Parametric pose NMS (AlphaPose pPose-NMS), host numpy (port of
`detect/pose_nms.py`, kept as it is).

Faithful restatement of `alphapose_core/alphapose/utils/pPose_nms.py`
`pose_nms_body` (`:242-330`) with the same constants (`:13-19`):
greedy highest-score pick, candidates eliminated when the parametric
similarity exceeds gamma or >= matchThreds keypoints fall within the
reference distance (PCK match), then score-weighted merging of the
eliminated cluster (`p_merge_fast`, `:533-570`).  Off by default in the
demo predictor (`alphapose_core.py:35-37`), provided for multi-person
scenes with overlapping detections.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

DELTA1 = 1.0
MU = 1.7
DELTA2 = 2.65
GAMMA = 22.48
SCORE_THRESH = 0.3
MATCH_THRESH = 5
ALPHA = 0.1


def _parametric_distance(pick: int, preds: np.ndarray,
                         scores: np.ndarray) -> np.ndarray:
    """Similarity of every pose to the picked one (`:573-610`)."""
    dist = np.linalg.norm(preds[pick][None] - preds, axis=2)  # (n, K)
    mask = dist <= 1
    score_dists = np.zeros_like(dist)
    pick_scores = scores[pick][None]                           # (1, K)
    sd = np.tanh(pick_scores / DELTA1) * np.tanh(scores / DELTA1)
    score_dists[mask] = sd[mask]
    point_dist = np.exp(-dist / DELTA2)
    return score_dists.sum(axis=1) + MU * point_dist.sum(axis=1)


def _pck_match(pick: int, preds: np.ndarray,
               ref_dist: float) -> np.ndarray:
    dist = np.linalg.norm(preds[pick][None] - preds, axis=2)
    return (dist / min(ref_dist, 7) <= 1).sum(axis=1)


def _merge(ref_pose: np.ndarray, cluster_preds: np.ndarray,
           cluster_scores: np.ndarray, ref_dist: float
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Score-weighted cluster merge (`p_merge_fast`)."""
    dist = np.linalg.norm(ref_pose[None] - cluster_preds, axis=2)
    mask = dist <= min(ref_dist, 15)
    masked = cluster_scores * mask
    denom = masked.sum(axis=0)
    denom = np.where(denom > 0, denom, 1e-9)
    normed = masked / denom
    pose = (cluster_preds * normed[..., None]).sum(axis=0)
    score = (cluster_scores * normed).sum(axis=0)
    return pose, score


def pose_nms(boxes: np.ndarray, box_scores: np.ndarray,
             poses: np.ndarray, pose_scores: np.ndarray,
             area_thresh: float = 0.0
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run pPose-NMS over detections of one image.

    Args:
      boxes: (n, 4) xyxy; box_scores: (n,);
      poses: (n, K, 2); pose_scores: (n, K).

    Returns:
      (kept boxes (m, 4), merged poses (m, K, 2), merged scores (m, K)).
    """
    n = poses.shape[0]
    if n == 0:
        return boxes, poses, pose_scores
    pose_scores = np.where(pose_scores == 0, 1e-5, pose_scores)

    widths = boxes[:, 2] - boxes[:, 0]
    heights = boxes[:, 3] - boxes[:, 1]
    ref_dists = ALPHA * np.maximum(widths, heights)
    human_scores = pose_scores.mean(axis=1)

    alive = np.ones(n, bool)
    picks: List[int] = []
    merge_sets: List[np.ndarray] = []
    while alive.any():
        ids = np.flatnonzero(alive)
        local_pick = int(np.argmax(human_scores[ids]))
        pick = ids[local_pick]
        picks.append(pick)

        simi = _parametric_distance(local_pick, poses[ids],
                                    pose_scores[ids])
        matches = _pck_match(local_pick, poses[ids],
                             float(ref_dists[pick]))
        delete = (simi > GAMMA) | (matches >= MATCH_THRESH)
        if not delete.any():
            delete = np.zeros(len(ids), bool)
            delete[local_pick] = True
        merge_sets.append(ids[delete])
        alive[ids[delete]] = False

    out_boxes, out_poses, out_scores = [], [], []
    for pick, cluster in zip(picks, merge_sets):
        if pose_scores[pick].max() < SCORE_THRESH:
            continue
        pose, score = _merge(poses[pick], poses[cluster],
                             pose_scores[cluster],
                             float(ref_dists[pick]))
        if score.max() < SCORE_THRESH:
            continue
        xmin, ymin = pose.min(axis=0)
        xmax, ymax = pose.max(axis=0)
        if 1.5 ** 2 * (xmax - xmin) * (ymax - ymin) < area_thresh:
            continue
        out_boxes.append(boxes[pick])
        out_poses.append(pose)
        out_scores.append(score)

    if not out_poses:
        return (np.zeros((0, 4), np.float32),
                np.zeros((0,) + poses.shape[1:], np.float32),
                np.zeros((0, poses.shape[1]), np.float32))
    return (np.stack(out_boxes), np.stack(out_poses),
            np.stack(out_scores))


def write_results_json(all_results, outputpath, form=None,
                       for_eval=False,
                       outputfile="alphapose-results.json"):
    """The reference's results-file contract
    (`pPose_nms.py:659-749`): aggregate per-frame person results into

    * default — one `alphapose-results.json` list of
      {image_id, category_id, keypoints xyscore-flat, score, box, idx};
      ``for_eval=True`` parses the numeric COCO image id from the file
      name (`:672`);
    * ``form="cmu"`` / ``"open"`` — CMU-Pose / OpenPose per-image
      dicts (plus a `sep-json/` file per image), with the reference's
      synthetic mid-shoulder neck (flat indices 15/18, 16/19, 17/20 =
      joints 5/6, `:704-706`) and its fixed 18-joint reorder table.

    ``all_results``: [{'imgname': str, 'result': [{'keypoints' (J,2),
    'kp_score' (J,) or (J,1), 'proposal_score' float, optional 'box',
    'idx', 'pred_xyz_jts'}]}].
    """
    import json
    import os

    json_results = []
    json_results_cmu = {}
    indexarr = (0, 51, 18, 24, 30, 15, 21, 27, 36, 42, 48, 33, 39,
                45, 6, 3, 12, 9)
    for im_res in all_results:
        im_name = im_res["imgname"]
        for human in im_res["result"]:
            result = {}
            base = os.path.basename(im_name)
            if for_eval:
                result["image_id"] = int(
                    base.split(".")[0].split("_")[-1])
            else:
                result["image_id"] = base
            result["category_id"] = 1
            kp = np.asarray(human["keypoints"], np.float64)
            sc = np.asarray(human["kp_score"], np.float64).reshape(-1)
            flat = []
            for n in range(len(sc)):
                flat += [float(kp[n, 0]), float(kp[n, 1]),
                         float(sc[n])]
            result["keypoints"] = flat
            result["score"] = float(np.asarray(
                human["proposal_score"]).reshape(-1)[0])
            if "box" in human:
                result["box"] = [float(v) for v in human["box"]]
            if "idx" in human:
                result["idx"] = human["idx"]
            if "pred_xyz_jts" in human:
                result["pred_xyz_jts"] = np.asarray(
                    human["pred_xyz_jts"]).tolist()

            if form in ("cmu", "open"):
                entry = json_results_cmu.setdefault(
                    result["image_id"],
                    {"version": "AlphaPose v0.3",
                     ("bodies" if form == "cmu" else "people"): []})
                ks = list(result["keypoints"])
                # synthetic neck = mean of the shoulders (5, 6)
                ks.append((ks[15] + ks[18]) / 2)
                ks.append((ks[16] + ks[19]) / 2)
                ks.append((ks[17] + ks[20]) / 2)
                joints = []
                for i in indexarr:
                    joints += [ks[i], ks[i + 1], ks[i + 2]]
                key = ("joints" if form == "cmu"
                       else "pose_keypoints_2d")
                group = "bodies" if form == "cmu" else "people"
                entry[group].append({key: joints})
            else:
                json_results.append(result)

    os.makedirs(outputpath, exist_ok=True)
    out = os.path.join(outputpath, outputfile)
    if form in ("cmu", "open"):
        with open(out, "w") as f:
            json.dump(json_results_cmu, f)
        sep = os.path.join(outputpath, "sep-json")
        os.makedirs(sep, exist_ok=True)
        for name, entry in json_results_cmu.items():
            with open(os.path.join(
                    sep, str(name).split(".")[0] + ".json"), "w") as f:
                json.dump(entry, f)
    else:
        with open(out, "w") as f:
            json.dump(json_results, f)
    return out
