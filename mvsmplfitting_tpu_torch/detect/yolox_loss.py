"""YOLOX training losses with static-shape SimOTA assignment (port of
`detect/yolox_loss.py`).

The reference's `yolo_head.py:255-660` (``get_losses``,
``get_assignments``, ``get_in_boxes_info``, ``dynamic_k_matching``),
`losses.py:10-53` (``IOUloss``) and `boxes.py:75-98` (``bboxes_iou``),
as JAX rebuilt them with fixed shapes, here batched over the images
directly instead of vmapped:

- labels are ``(N, MAXG, 5)`` rows ``[cls, cx, cy, w, h]``; all-zero
  rows are padding;
- the SimOTA cost lives on the full ``(N, G, A)`` grid, with a ``1e9``
  sentinel on non-candidate anchors and padded gts over the reference's
  ``100000.0`` centre-gate penalty, so that the rank test
  ``argsort(argsort(cost)) < k`` picks the anchors the reference's
  per-gt ``topk`` would.  Both argsorts are stable, as `jnp.argsort`
  is: tied costs pick the same anchors on every device;
- the assignment's choices (which anchors, which gt) carry no
  gradient; the matched IoU that scales the cls target does, through the
  predicted boxes, as in JAX (whose assignment has no stop_gradient;
  the reference's runs under `torch.no_grad`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

_BIG = 1e9


def anchor_info(input_hw: Tuple[int, int],
                strides: Sequence[int] = (8, 16, 32),
                dtype=torch.float32, device=None):
    """Per-anchor (x_shift, y_shift, stride) over all levels: grid
    coordinates, row-major per level (`yolo_head.py:170-186,221-236`)."""
    h, w = input_hw
    xs, ys, ss = [], [], []
    for s in strides:
        hs, ws = h // s, w // s
        yy, xx = torch.meshgrid(torch.arange(hs, device=device),
                                torch.arange(ws, device=device),
                                indexing="ij")
        xs.append(xx.reshape(-1))
        ys.append(yy.reshape(-1))
        ss.append(torch.full((hs * ws,), s, device=device))
    return (torch.cat(xs).to(dtype), torch.cat(ys).to(dtype),
            torch.cat(ss).to(dtype))


def bce_with_logits(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Elementwise BCEWithLogitsLoss(reduction='none') in JAX's form."""
    return torch.clamp_min(x, 0.0) - x * t + torch.log1p(
        torch.exp(-torch.abs(x)))


def _bce_probs(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``F.binary_cross_entropy`` on probabilities, logs clamped at -100
    (`yolo_head.py:503-505`, the cls cost)."""
    logp = torch.clamp_min(torch.log(p), -100.0)
    log1mp = torch.clamp_min(torch.log1p(-p), -100.0)
    return -(t * logp + (1.0 - t) * log1mp)


def pairwise_iou_xywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., G, 4) x (..., A, 4) centre-format IoU (no eps in the union,
    `bboxes_iou(..., xyxy=False)`) -> (..., G, A)."""
    a1, b1 = a[..., :, None, :], b[..., None, :, :]
    tl = torch.maximum(a1[..., :2] - a1[..., 2:] / 2,
                       b1[..., :2] - b1[..., 2:] / 2)
    br = torch.minimum(a1[..., :2] + a1[..., 2:] / 2,
                       b1[..., :2] + b1[..., 2:] / 2)
    area_a = torch.prod(a[..., 2:], dim=-1)
    area_b = torch.prod(b[..., 2:], dim=-1)
    en = torch.all(tl < br, dim=-1).to(a.dtype)
    area_i = torch.prod(br - tl, dim=-1) * en
    return area_i / (area_a[..., :, None] + area_b[..., None, :] - area_i)


def iou_loss(pred: torch.Tensor, target: torch.Tensor,
             loss_type: str = "iou") -> torch.Tensor:
    """Matched-pair IoU loss (`IOUloss(reduction='none')`, eps 1e-16 in
    the union) over (M, 4) centre-format boxes."""
    tl = torch.maximum(pred[:, :2] - pred[:, 2:] / 2,
                       target[:, :2] - target[:, 2:] / 2)
    br = torch.minimum(pred[:, :2] + pred[:, 2:] / 2,
                       target[:, :2] + target[:, 2:] / 2)
    area_p = torch.prod(pred[:, 2:], dim=1)
    area_g = torch.prod(target[:, 2:], dim=1)
    en = torch.all(tl < br, dim=1).to(pred.dtype)
    area_i = torch.prod(br - tl, dim=1) * en
    iou = area_i / (area_p + area_g - area_i + 1e-16)
    if loss_type == "iou":
        return 1.0 - iou ** 2
    if loss_type == "giou":
        c_tl = torch.minimum(pred[:, :2] - pred[:, 2:] / 2,
                             target[:, :2] - target[:, 2:] / 2)
        c_br = torch.maximum(pred[:, :2] + pred[:, 2:] / 2,
                             target[:, :2] + target[:, 2:] / 2)
        area_c = torch.prod(c_br - c_tl, dim=1)
        # The reference subtracts area_i, not the union (`losses.py:45`).
        giou = iou - (area_c - area_i) / torch.clamp_min(area_c, 1e-16)
        return 1.0 - torch.clamp(giou, -1.0, 1.0)
    raise ValueError(f"unknown iou loss type {loss_type!r}")


def _in_boxes_info(gt_boxes, gt_valid, x_shifts, y_shifts, strides,
                   img_hw):
    """``get_in_boxes_info`` (`yolo_head.py:537-628`) on the full (N, G,
    A) grid: (fg_candidate (N, A), in_box (N, G, A), in_center)."""
    xc = ((x_shifts + 0.5) * strides)[None, None, :]
    yc = ((y_shifts + 0.5) * strides)[None, None, :]
    st = strides[None, None, :]
    gx, gy = gt_boxes[..., 0:1], gt_boxes[..., 1:2]
    gw, gh = gt_boxes[..., 2:3], gt_boxes[..., 3:4]

    b_l = xc - (gx - 0.5 * gw)
    b_r = (gx + 0.5 * gw) - xc
    b_t = yc - (gy - 0.5 * gh)
    b_b = (gy + 0.5 * gh) - yc
    in_box = torch.minimum(torch.minimum(b_l, b_r),
                           torch.minimum(b_t, b_b)) > 0.0
    in_box = in_box & gt_valid[..., None]

    # Fixed-radius centre gate, gt centres clipped to the image
    # (`yolo_head.py:594-599`).
    r = 2.5
    h, w = img_hw
    cgx = torch.clamp(gx, 0.0, float(w))
    cgy = torch.clamp(gy, 0.0, float(h))
    c_l = xc - (cgx - r * st)
    c_r = (cgx + r * st) - xc
    c_t = yc - (cgy - r * st)
    c_b = (cgy + r * st) - yc
    in_ctr = torch.minimum(torch.minimum(c_l, c_r),
                           torch.minimum(c_t, c_b)) > 0.0
    in_ctr = in_ctr & gt_valid[..., None]

    fg_candidate = in_box.any(dim=1) | in_ctr.any(dim=1)
    return fg_candidate, in_box, in_ctr


@torch.no_grad()
def simota_assign(bbox_pred, obj_logit, cls_logit, labels, x_shifts,
                  y_shifts, strides, img_hw):
    """SimOTA assignment of a batch (``get_assignments`` +
    ``dynamic_k_matching``, `yolo_head.py:440-535,630-660`), shapes fixed.

    Args: bbox_pred (N, A, 4) decoded centre-xywh boxes; obj_logit (N,
    A); cls_logit (N, A, C); labels (N, G, 5), zero rows padding.
    Returns ``fg`` (N, A) bool, ``matched_gt`` (N, A) int64,
    ``pred_iou`` (N, A), ``num_fg`` and ``num_gt`` (N,).
    """
    G = labels.shape[1]
    num_classes = cls_logit.shape[-1]
    gt_valid = torch.sum(labels, dim=2) > 0                    # (N, G)
    gt_boxes = labels[..., 1:5]
    gt_cls = labels[..., 0].to(torch.int64)

    fg_cand, in_box, in_ctr = _in_boxes_info(
        gt_boxes, gt_valid, x_shifts, y_shifts, strides, img_hw)
    both = in_box & in_ctr

    ious = pairwise_iou_xywh(gt_boxes, bbox_pred)              # (N, G, A)
    iou_cost = -torch.log(ious + 1e-8)

    # BCE(sqrt(sigmoid(cls) * sigmoid(obj)), one-hot) summed over classes
    # (`yolo_head.py:498-506`).
    p = torch.sqrt(torch.sigmoid(cls_logit)
                   * torch.sigmoid(obj_logit)[..., None])      # (N, A, C)
    onehot = F.one_hot(gt_cls.clamp_min(0), num_classes).to(
        bbox_pred.dtype)                                       # (N, G, C)
    cls_cost = _bce_probs(p[:, None, :, :],
                          onehot[:, :, None, :]).sum(dim=-1)   # (N, G, A)

    cost = (cls_cost + 3.0 * iou_cost
            + 100000.0 * (~both).to(cls_cost.dtype)
            + _BIG * (~fg_cand).to(cls_cost.dtype)[:, None, :]
            + _BIG * (~gt_valid).to(cls_cost.dtype)[:, :, None])

    # dynamic k: the sum of the top-10 candidate IoUs, truncated, >= 1.
    iou_for_k = torch.where(gt_valid[:, :, None] & fg_cand[:, None, :],
                            ious, torch.zeros_like(ious))
    k_cand = min(10, iou_for_k.shape[2])
    topk = torch.topk(iou_for_k, k_cand, dim=2).values
    dynamic_k = torch.clamp_min(topk.sum(dim=2).to(torch.int32), 1)

    # per-gt "k lowest-cost anchors" as a rank threshold (stable sorts).
    order = torch.argsort(cost, dim=2, stable=True)
    ranks = torch.argsort(order, dim=2, stable=True)
    match = (ranks < dynamic_k[:, :, None]) & (cost < 1e8)

    # anchors claimed by more than one gt keep only the cheapest
    # (`yolo_head.py:646-650`).
    n_match = match.sum(dim=1)                                  # (N, A)
    cost_valid = torch.where(gt_valid[:, :, None], cost,
                             torch.full_like(cost, float("inf")))
    best_gt = torch.argmin(cost_valid, dim=1)                  # (N, A)
    only_best = F.one_hot(best_gt, G).to(torch.bool).transpose(1, 2)
    match = torch.where((n_match > 1)[:, None, :],
                        only_best & match.any(dim=1, keepdim=True), match)

    fg = match.any(dim=1)
    matched_gt = torch.argmax(match.to(torch.int32), dim=1)
    pred_iou = (match.to(ious.dtype) * ious).sum(dim=1)
    return {
        "fg": fg,
        "matched_gt": matched_gt,
        "pred_iou": pred_iou,
        "num_fg": fg.sum(dim=1),
        "num_gt": gt_valid.sum(dim=1),
    }


def yolox_losses(decoded, labels, input_hw,
                 strides: Sequence[int] = (8, 16, 32),
                 origin_reg=None, use_l1: bool = False,
                 iou_type: str = "iou", group=None):
    """Batch YOLOX training loss (``get_losses``, `yolo_head.py:255-425`).

    decoded (N, A, 5+C): decoded boxes with obj/cls LOGITS (the
    ``YOLOX(train_outputs=True)`` output); labels (N, MAXG, 5); origin_reg
    (N, A, 4), the raw reg predictions of the L1 branch.  Returns the
    total / iou / obj / cls / l1 losses, fg ratio and num_fg, with the
    reference's ``reg_weight=5.0`` and ``num_fg = max(total fg, 1)``.

    With a process group (data parallelism) the batch is this rank's
    block: ``num_fg`` and ``num_gts`` are counted over the global batch
    (one all_reduce), so fg_ratio and num_fg are global and the losses
    are this rank's shares of the global ones.
    """
    from ..parallel.data_parallel import global_sum

    bbox_pred = decoded[..., :4]
    obj_logit = decoded[..., 4]
    cls_logit = decoded[..., 5:]
    num_classes = cls_logit.shape[-1]
    x_shifts, y_shifts, stride_arr = anchor_info(
        input_hw, strides, dtype=decoded.dtype, device=decoded.device)
    labels = labels.to(decoded.dtype)

    assign = simota_assign(bbox_pred.detach(), obj_logit.detach(),
                           cls_logit.detach(), labels, x_shifts, y_shifts,
                           stride_arr, input_hw)
    fg = assign["fg"]                                          # (N, A)
    matched = assign["matched_gt"]
    fgf = fg.to(decoded.dtype)
    # JAX's (match * ious).sum(gts), differentiable in the boxes: an
    # anchor keeps at most one gt after the conflict step.
    ious = pairwise_iou_xywh(labels[..., 1:5], bbox_pred)      # (N, G, A)
    pred_iou = torch.gather(ious, 1, matched[:, None, :])[:, 0] * fgf
    counts = global_sum(torch.stack([fg.sum(), assign["num_gt"].sum()])
                        .to(decoded.dtype), group)
    num_fg = torch.clamp_min(counts[0], 1.0)
    num_gts = torch.clamp_min(counts[1], 1.0)

    reg_target = torch.gather(labels[..., 1:5], 1,
                              matched[..., None].expand(-1, -1, 4))
    gt_cls = torch.gather(labels[..., 0].to(torch.int64), 1, matched)

    loss_iou = (iou_loss(bbox_pred.reshape(-1, 4),
                         reg_target.reshape(-1, 4), iou_type)
                .reshape(fg.shape) * fgf).sum() / num_fg
    loss_obj = bce_with_logits(obj_logit, fgf).sum() / num_fg
    cls_target = (F.one_hot(gt_cls.clamp_min(0), num_classes).to(
        decoded.dtype) * pred_iou[..., None])
    loss_cls = (bce_with_logits(cls_logit, cls_target)
                * fgf[..., None]).sum() / num_fg

    if use_l1:
        if origin_reg is None:
            raise ValueError("use_l1 requires origin_reg")
        # get_l1_target (`yolo_head.py:428-434`).
        l1_t = torch.stack([
            reg_target[..., 0] / stride_arr - x_shifts,
            reg_target[..., 1] / stride_arr - y_shifts,
            torch.log(reg_target[..., 2] / stride_arr + 1e-8),
            torch.log(reg_target[..., 3] / stride_arr + 1e-8),
        ], dim=-1)
        loss_l1 = (torch.abs(origin_reg - l1_t)
                   * fgf[..., None]).sum() / num_fg
    else:
        loss_l1 = torch.zeros((), dtype=decoded.dtype, device=decoded.device)

    reg_weight = 5.0
    total = reg_weight * loss_iou + loss_obj + loss_cls + loss_l1
    return {
        "total": total,
        "iou": reg_weight * loss_iou,
        "obj": loss_obj,
        "cls": loss_cls,
        "l1": loss_l1,
        "fg_ratio": num_fg / num_gts,
        "num_fg": num_fg,
    }
