"""Multi-person prediction <-> ground-truth keypoint association (port of
`ops/match.py`, host numpy as there).

The reference's matching utilities (`code/utils/module_utils.py:237-287`
``pair_by_L2_distance`` / ``matching``) greedily assign each GT person
the nearest predicted 2D pose by confidence-weighted L2 distance.
Reproduced with the reference's exact quirks: geometric-mean confidence
weighting, the 1e5 "taken" sentinel, and the >100000 unmatched gate
(note the gate tests the ORIGINAL loss value, so a column already taken
at 1e5 still matches — greedy order matters, as in the reference).

Host-side numpy — this is dataset bookkeeping, not device math.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["pair_by_l2_distance", "match_people"]


def pair_by_l2_distance(pred: np.ndarray, gt: np.ndarray,
                        src_mapper, gt_mapper) -> np.ndarray:
    """Pairwise confidence-weighted L2 cost (G, P).

    Args:
      pred: (P, Jp, 2|3) predicted keypoints (conf in col 2 when
        present, else treated as 1).
      gt: (G, Jg, 2|3) ground-truth keypoints.
      src_mapper / gt_mapper: index arrays selecting the common joint
        subset from each side (the reference's joint-order adapters).

    Returns (G, P): sum over joints of ||pred - gt||_2 *
    sqrt(pred_conf * gt_conf), matching `module_utils.py:237-259`.
    """
    pred = np.asarray(pred, np.float64)[:, np.asarray(src_mapper)]
    gt = np.asarray(gt, np.float64)[:, np.asarray(gt_mapper)]

    pa = pred[None, :, :, :]   # (1, P, J, C)
    ga = gt[:, None, :, :]     # (G, 1, J, C)
    p_conf = pa[..., 2] if pa.shape[-1] == 3 else np.ones(pa.shape[:3])
    g_conf = ga[..., 2] if ga.shape[-1] == 3 else np.ones(ga.shape[:3])
    conf = np.sqrt(p_conf * g_conf)
    d = np.linalg.norm(pa[..., :2] - ga[..., :2], axis=-1) * conf
    return np.sum(d, axis=-1)


def match_people(gt_joints, pred_poses, gt_mapper, src_mapper
                 ) -> Tuple[List[Optional[np.ndarray]], List[int]]:
    """Greedy GT-order assignment (`module_utils.py:261-287`).

    Each GT row takes its argmin prediction; the taken column is then
    set to the 1e5 sentinel for later rows.  A best cost > 100000
    yields None (no credible prediction) while still consuming the
    column — both reference behaviors.

    Returns (matched predictions per GT, best prediction index per GT).
    """
    gt = np.asarray(gt_joints)
    preds = np.asarray(pred_poses)
    loss = pair_by_l2_distance(preds, gt, src_mapper, gt_mapper)

    matched: List[Optional[np.ndarray]] = []
    best_ids: List[int] = []
    for igt in range(gt.shape[0]):
        best = int(np.argmin(loss[igt]))
        best_ids.append(best)
        matched.append(None if loss[igt][best] > 100000
                       else np.asarray(pred_poses)[best])
        loss[:, best] = 1e5
    return matched, best_ids
