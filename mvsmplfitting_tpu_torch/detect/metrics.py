"""Pose-estimation evaluation metrics: heatmap PCK and OKS keypoint AP
(port of `detect/metrics.py`: the port's own copy of its numpy code).

Rebuild of the reference's eval yardsticks
(`alphapose_core/alphapose/utils/metrics.py`):

* `heatmap_pck` == `calc_accuracy` (`metrics.py:125-152`): argmax the
  predicted and label heatmaps (`transforms.py:739-759`), normalize
  distances by (W, H)/10, count the fraction under threshold 0.5 per
  joint (joints whose label coords are <= 1 are invisible and
  excluded, `metrics.py:231-243`), then average over joints that had
  any visible sample.
* `keypoint_oks` / `keypoint_map`: OKS-based AP. The reference defers
  to pycocotools (`evaluate_mAP`, `metrics.py:64-119`) which is not in
  this environment, so the COCO OKS formula and the 0.50:0.05:0.95 AP
  protocol (greedy score-ordered matching per image) are implemented
  natively — same math, no external dep.
* `box_map` == the ``ann_type='bbox'`` branch of `evaluate_mAP`:
  class-aware detection AP over the same IoU sweep (YOLOX training
  validation).  `mask_iou` == `calc_iou` (`metrics.py:35-58`).

Numpy on purpose: this is offline eval, not the fitting hot path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# COCO keypoint per-joint falloff constants (k_i = 2 * sigma_i).
COCO_SIGMAS = np.asarray([
    .026, .025, .025, .035, .035, .079, .079, .072, .072, .062, .062,
    .107, .107, .087, .087, .089, .089], np.float32)


def max_preds(heatmaps: np.ndarray):
    """Argmax decode of (N, J, H, W) heatmaps -> ((N, J, 2) xy, maxvals).

    Matches `transforms.py:739-759` (zeroed where the max is <= 0).
    """
    N, J, _, W = heatmaps.shape
    flat = heatmaps.reshape(N, J, -1)
    idx = np.argmax(flat, 2)
    maxvals = np.max(flat, 2)[..., None]
    preds = np.stack([idx % W, idx // W], -1).astype(np.float32)
    preds *= (maxvals > 0.0)
    return preds, maxvals


def _pck_from_coords(preds: np.ndarray, labels: np.ndarray,
                     norm: np.ndarray, thr: float = 0.5) -> float:
    """`calc_dist` + `dist_acc` + joint averaging (`metrics.py:140-152,
    229-252`): visible = label x AND y > 1."""
    visible = (labels[..., 0] > 1) & (labels[..., 1] > 1)   # (N, J)
    d = np.linalg.norm((preds - labels) / norm[:, None, :], axis=-1)
    acc_sum, cnt = 0.0, 0
    for j in range(preds.shape[1]):
        vis = visible[:, j]
        if vis.sum() > 0:
            acc_sum += float((d[vis, j] < thr).mean())
            cnt += 1
    return acc_sum / cnt if cnt else 0.0


def heatmap_pck(pred_hms: np.ndarray, label_hms: np.ndarray,
                thr: float = 0.5) -> float:
    """PCK between two heatmap batches — `calc_accuracy` parity."""
    pred_hms = np.asarray(pred_hms)
    label_hms = np.asarray(label_hms)
    H, W = pred_hms.shape[2], pred_hms.shape[3]
    preds, _ = max_preds(pred_hms)
    labels, _ = max_preds(label_hms)
    norm = np.ones((pred_hms.shape[0], 2)) * np.asarray([W, H]) / 10
    return _pck_from_coords(preds, labels, norm, thr)


def integral_pck(pred_hms: np.ndarray, labels: np.ndarray,
                 label_masks: np.ndarray, output_3d: bool = False,
                 norm_type: str = "softmax", thr: float = 0.5) -> float:
    """Integral-regression PCK — the reference's
    `calc_integral_accuracy` (`metrics.py:156-225`): soft-argmax the
    predicted heatmaps, map predictions AND the normalized labels into
    heatmap-pixel space via ``(u + 0.5) * size``, zero both through the
    per-coordinate mask, then the same calc_dist/dist_acc protocol as
    `heatmap_pck` (normalize by size/10, visible = label x,y > 1 —
    masked joints land at 0 and drop out of the count).

    pred_hms: (N, J, H, W) or, with ``output_3d``, (N, J*D, H, W) with
    D == H (the reference's depth convention).  labels/label_masks:
    (N, J*dims) normalized coords in [-0.5, 0.5].
    """
    p = np.asarray(pred_hms, np.float64)
    N, H, W = p.shape[0], p.shape[-2], p.shape[-1]
    D = H if output_3d else 1
    J = p.shape[1] // D
    dims = 3 if output_3d else 2
    flat = p.reshape(N, J, D * H * W)
    if norm_type == "softmax":
        flat = flat - flat.max(-1, keepdims=True)
        e = np.exp(flat)
        prob = e / np.maximum(e.sum(-1, keepdims=True), 1e-12)
    else:                                   # sigmoid normalization
        s = 1.0 / (1.0 + np.exp(-flat))
        prob = s / np.maximum(s.sum(-1, keepdims=True), 1e-12)
    vol = prob.reshape(N, J, D, H, W)
    # E[ix] == (x_norm + 0.5) * W exactly (`transforms.py:628-631`).
    ex = (vol.sum(axis=(2, 3)) * np.arange(W)).sum(-1)     # (N, J)
    ey = (vol.sum(axis=(2, 4)) * np.arange(H)).sum(-1)
    coords = [ex, ey]
    sizes = [W, H]
    if output_3d:
        coords.append((vol.sum(axis=(3, 4)) * np.arange(D)).sum(-1))
        sizes.append(D)
    preds = np.stack(coords, axis=-1)                      # (N, J, dims)

    lab = np.asarray(labels, np.float64).reshape(N, J, dims)
    msk = np.asarray(label_masks, np.float64).reshape(N, J, dims)
    lab = (lab + 0.5) * np.asarray(sizes)
    preds = preds * msk
    lab = lab * msk
    norm = np.ones((N, dims)) * np.asarray(sizes) / 10.0
    return _pck_from_coords(preds, lab, norm, thr)


def keypoint_oks(pred: np.ndarray, gt: np.ndarray, area: float,
                 vis: Optional[np.ndarray] = None,
                 sigmas: Optional[np.ndarray] = None) -> float:
    """COCO object-keypoint-similarity of one (J, 2) prediction."""
    sigmas = COCO_SIGMAS if sigmas is None else np.asarray(sigmas)
    if vis is None:
        vis = np.ones(gt.shape[0], bool)
    if vis.sum() == 0:
        return 0.0
    d2 = np.sum((pred - gt) ** 2, -1)
    k2 = (2 * sigmas) ** 2
    e = d2 / (2 * max(area, 1e-9) * k2)
    return float(np.mean(np.exp(-e[vis])))


def keypoint_map(predictions: Sequence[dict], groundtruths: Sequence[dict],
                 sigmas: Optional[np.ndarray] = None,
                 thresholds: Optional[np.ndarray] = None) -> float:
    """OKS mean AP over thresholds 0.50:0.05:0.95.

    Args:
      predictions: per-image dicts {"keypoints": (K, J, 2),
        "scores": (K,)}.
      groundtruths: per-image dicts {"keypoints": (M, J, 2),
        "areas": (M,), optional "vis": (M, J) bool}.

    Greedy matching: predictions sorted by score; each matches its
    highest-OKS unmatched GT if OKS >= threshold (pycocotools
    protocol, minus the size-stratified variants).
    """
    if thresholds is None:
        thresholds = np.arange(0.5, 1.0, 0.05)

    entries = []
    for pred, gt in zip(predictions, groundtruths):
        kps = np.asarray(pred["keypoints"], np.float32)   # (K, J, 2)
        scores = np.asarray(pred.get("scores",
                                     np.ones(len(kps))), np.float32)
        gkps = np.asarray(gt["keypoints"], np.float32)
        areas = np.asarray(gt.get("areas", np.ones(len(gkps))),
                           np.float32)
        viss = gt.get("vis")
        oks_mat = np.zeros((len(kps), len(gkps)))
        for i in range(len(kps)):
            for m in range(len(gkps)):
                v = None if viss is None else np.asarray(viss[m])
                oks_mat[i, m] = keypoint_oks(kps[i], gkps[m],
                                             float(areas[m]), v, sigmas)
        entries.append((oks_mat, scores))
    return _greedy_map(entries, thresholds)


def _greedy_map(entries, thresholds) -> float:
    """Shared AP sweep: per image, (sim (K, M), scores (K,)) pairs.

    Greedy score-ordered matching per threshold across the dataset,
    then 101-point interpolated AP averaged over thresholds — the
    pycocotools protocol minus the size-stratified variants.
    """
    all_scores = []
    all_matches = {t: [] for t in thresholds}
    total_gt = 0
    for sim, scores in entries:
        K, M = sim.shape
        total_gt += M
        order = np.argsort(-np.asarray(scores))
        for t in thresholds:
            used = np.zeros(M, bool)
            for i in order:
                best, best_m = t, -1
                for m in range(M):
                    if not used[m] and sim[i, m] >= best:
                        best, best_m = sim[i, m], m
                matched = best_m >= 0
                if matched:
                    used[best_m] = True
                all_matches[t].append(matched)
        all_scores.extend(np.asarray(scores)[order])

    if total_gt == 0 or not all_scores:
        return 0.0

    order = np.argsort(-np.asarray(all_scores))
    aps = []
    for t in thresholds:
        tp = np.asarray(all_matches[t], float)[order]
        fp = 1.0 - tp
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        recall = ctp / total_gt
        precision = ctp / np.maximum(ctp + cfp, 1e-9)
        ap = 0.0
        for r in np.linspace(0, 1, 101):
            p = precision[recall >= r]
            ap += (p.max() if len(p) else 0.0) / 101
        aps.append(ap)
    return float(np.mean(aps))


def box_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of (K, 4) vs (M, 4) xyxy boxes -> (K, M)."""
    a = np.asarray(a, np.float32).reshape(-1, 4)
    b = np.asarray(b, np.float32).reshape(-1, 4)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * \
        np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * \
        np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter,
                              1e-9)


def box_map(predictions: Sequence[dict], groundtruths: Sequence[dict],
            thresholds: Optional[np.ndarray] = None,
            max_dets: int = 100) -> float:
    """Detection box mean AP, IoU 0.50:0.05:0.95 — the ``bbox`` branch
    of the reference's pycocotools `evaluate_mAP`
    (`alphapose_core/alphapose/utils/metrics.py:65-121`), natively:
    per-class greedy matching (a detection only matches GT of its own
    class), AP averaged over classes present in the ground truth.

    predictions: per-image {"boxes": (K, 4) xyxy, "scores": (K,),
      optional "classes": (K,) int (default all 0)}.
    groundtruths: per-image {"boxes": (M, 4) xyxy,
      optional "classes": (M,)}.
    """
    if thresholds is None:
        thresholds = np.arange(0.5, 1.0, 0.05)

    def cls_of(d, key, n):
        c = d.get("classes")
        return (np.zeros(n, np.int64) if c is None
                else np.asarray(c, np.int64).reshape(-1))

    gt_classes = set()
    for gt in groundtruths:
        gt_classes |= set(cls_of(gt, "classes",
                                 len(gt["boxes"])).tolist())
    if not gt_classes:
        return 0.0

    aps = []
    for cls in sorted(gt_classes):
        entries = []
        for pred, gt in zip(predictions, groundtruths):
            boxes = np.asarray(pred.get("boxes", np.zeros((0, 4))),
                               np.float32).reshape(-1, 4)
            scores = np.asarray(
                pred.get("scores", np.ones(len(boxes))), np.float32)
            pc = cls_of(pred, "classes", len(boxes))
            keep = pc == cls
            boxes, scores = boxes[keep], scores[keep]
            if len(scores) > max_dets:            # COCO maxDets=100
                top = np.argsort(-scores)[:max_dets]
                boxes, scores = boxes[top], scores[top]
            gboxes = np.asarray(gt["boxes"], np.float32).reshape(-1, 4)
            gboxes = gboxes[cls_of(gt, "classes", len(gboxes)) == cls]
            entries.append((box_iou_xyxy(boxes, gboxes), scores))
        aps.append(_greedy_map(entries, thresholds))
    return float(np.mean(aps))


def mask_iou(pred: np.ndarray, target: np.ndarray) -> float:
    """Binary-mask IoU — the reference's `calc_iou`
    (`metrics.py:35-58`): threshold both at 0.5; (H, W) gives one IoU,
    (N, ...) averages per-sample IoUs."""
    pred = np.asarray(pred) >= 0.5
    target = np.asarray(target) >= 0.5
    inter = pred & target
    union = pred | target
    if pred.ndim == 2:
        return float(inter.sum() / np.maximum(union.sum(), 1e-9))
    n = pred.shape[0]
    i = inter.reshape(n, -1).sum(1).astype(np.float64)
    u = union.reshape(n, -1).sum(1).astype(np.float64)
    return float(np.mean(i / np.maximum(u, 1e-9)))
