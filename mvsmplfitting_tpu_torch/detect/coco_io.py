"""COCO-keypoint annotation / result file IO + native evaluation (port
of `detect/coco_io.py`: the port's own copy of its numpy code).

The reference evaluates through pycocotools (`evaluate_mAP`,
`alphapose_core/alphapose/utils/metrics.py:64-119`) and writes COCO
result jsons from its `writer.py`.  pycocotools is not in this
environment, so this module provides the same file contracts natively:

* `load_coco_annotations`: `person_keypoints_*.json`-style GT ->
  per-image ground truth dicts consumable by `metrics.keypoint_map`
  (keypoints reshaped (M, J, 3) -> xy + COCO visibility v>0, area from
  the annotation or its bbox).
* `save_coco_results` / `load_coco_results`: the COCO results-list
  contract `[{image_id, category_id, keypoints: flat J*3, score}]`.
* `evaluate_coco_map`: GT json + results -> OKS mAP via the native
  implementation in `metrics.py` (0.50:0.05:0.95 protocol).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .metrics import keypoint_map


def load_coco_annotations(path: str, category_id: int = 1
                          ) -> Dict[int, dict]:
    """GT json -> {image_id: {"keypoints", "vis", "areas"}}."""
    with open(path) as f:
        coco = json.load(f)
    out: Dict[int, dict] = {}
    for ann in coco.get("annotations", []):
        if ann.get("category_id", category_id) != category_id:
            continue
        kp = np.asarray(ann["keypoints"], np.float32).reshape(-1, 3)
        area = float(ann.get("area") or 0.0)
        if area <= 0 and "bbox" in ann:
            area = float(ann["bbox"][2]) * float(ann["bbox"][3])
        img = int(ann["image_id"])
        d = out.setdefault(img, {"keypoints": [], "vis": [],
                                 "areas": []})
        d["keypoints"].append(kp[:, :2])
        d["vis"].append(kp[:, 2] > 0)
        d["areas"].append(max(area, 1e-9))
    for d in out.values():
        d["keypoints"] = np.stack(d["keypoints"])
        d["vis"] = np.stack(d["vis"])
        d["areas"] = np.asarray(d["areas"], np.float32)
    return out


def save_coco_results(path: str, image_ids: Sequence[int],
                      keypoints: Sequence[np.ndarray],
                      scores: Sequence[np.ndarray],
                      category_id: int = 1) -> None:
    """Write the COCO results-list json (one entry per detection).

    keypoints[i]: (K_i, J, 2) or (K_i, J, 3); scores[i]: (K_i,).
    Confidence columns default to the detection score when absent.
    """
    results: List[dict] = []
    for img, kps, sc in zip(image_ids, keypoints, scores):
        kps = np.asarray(kps, np.float32)
        sc = np.atleast_1d(np.asarray(sc, np.float32))
        for k in range(kps.shape[0]):
            if kps.shape[-1] == 2:
                flat = np.concatenate(
                    [kps[k], np.full((kps.shape[1], 1), sc[k])],
                    axis=1)
            else:
                flat = kps[k]
            results.append({
                "image_id": int(img),
                "category_id": category_id,
                "keypoints": [round(float(v), 3)
                              for v in flat.reshape(-1)],
                "score": float(sc[k]),
            })
    with open(path, "w") as f:
        json.dump(results, f)


def load_coco_results(path: str) -> Dict[int, dict]:
    """Results json -> {image_id: {"keypoints" (K,J,2), "scores"}}."""
    with open(path) as f:
        results = json.load(f)
    by_img: Dict[int, dict] = {}
    for r in results:
        kp = np.asarray(r["keypoints"], np.float32).reshape(-1, 3)
        d = by_img.setdefault(int(r["image_id"]),
                              {"keypoints": [], "scores": []})
        d["keypoints"].append(kp[:, :2])
        d["scores"].append(float(r.get("score", 1.0)))
    for d in by_img.values():
        d["keypoints"] = np.stack(d["keypoints"])
        d["scores"] = np.asarray(d["scores"], np.float32)
    return by_img


def evaluate_coco_map(ann_path: str,
                      results: Union[str, Dict[int, dict]],
                      sigmas: Optional[np.ndarray] = None) -> float:
    """OKS mAP of a results file/dict against a GT annotation file.

    pycocotools protocol: the evaluated image set is EVERY image listed
    in the GT json (not just annotated ones) — detections on listed but
    annotation-free images count as false positives in the score-sorted
    PR sweep; detections on images absent from the GT json are ignored.
    """
    gt = load_coco_annotations(ann_path)
    if isinstance(results, str):
        results = load_coco_results(results)
    with open(ann_path) as f:
        listed = [int(im["id"])
                  for im in json.load(f).get("images", [])]
    image_ids = sorted(set(listed) | set(gt)) if listed else sorted(gt)

    J = next((g["keypoints"].shape[1] for g in gt.values()), None)
    if J is None:                   # no GT anywhere: infer J from preds
        J = next((np.asarray(p["keypoints"]).shape[1]
                  for p in results.values()
                  if len(p["keypoints"])), 17)
    empty_gt = {"keypoints": np.zeros((0, J, 2), np.float32),
                "vis": np.zeros((0, J), bool),
                "areas": np.zeros((0,), np.float32)}
    empty_pred = {"keypoints": np.zeros((0, J, 2), np.float32),
                  "scores": np.zeros((0,), np.float32)}
    preds, gts = [], []
    for img in image_ids:
        gts.append(gt.get(img, empty_gt))
        preds.append(results.get(img, empty_pred))
    return keypoint_map(preds, gts, sigmas=sigmas)
