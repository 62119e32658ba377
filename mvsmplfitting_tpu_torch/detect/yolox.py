"""YOLOX person detector, NCHW PyTorch inference (port of
`detect/yolox.py`).

The reference's YOLOX-X build (depth 1.33, width 1.25, one class): the
CSPDarknet backbone, the PAFPN neck and the decoupled anchor-free head,
named as the reference's modules (`backbone.backbone.dark2.1.m.0...`,
`head.cls_convs.0.1...`), then the grid + stride decode on the device.
Box selection (`nms_xyxy`, `postprocess_boxes`) is JAX's host numpy,
kept as it is so that the same candidates come out in the same order.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BaseConv, CSPLayer, Focus, SPPBottleneck, conv_block


def _w(width_mul: float):
    return lambda c: int(c * width_mul)


def _d(depth_mul: float):
    return lambda n: max(round(n * depth_mul), 1)


class CSPDarknet(nn.Module):
    def __init__(self, depth_mul: float = 1.33, width_mul: float = 1.25,
                 depthwise: bool = False):
        super().__init__()
        w, d = _w(width_mul), _d(depth_mul)
        Conv = conv_block(depthwise)
        self.stem = Focus(3, w(64), 3)
        self.dark2 = nn.Sequential(
            Conv(w(64), w(128), 3, 2),
            CSPLayer(w(128), w(128), d(3), depthwise=depthwise))
        self.dark3 = nn.Sequential(
            Conv(w(128), w(256), 3, 2),
            CSPLayer(w(256), w(256), d(9), depthwise=depthwise))
        self.dark4 = nn.Sequential(
            Conv(w(256), w(512), 3, 2),
            CSPLayer(w(512), w(512), d(9), depthwise=depthwise))
        self.dark5 = nn.Sequential(
            Conv(w(512), w(1024), 3, 2),
            SPPBottleneck(w(1024), w(1024)),
            CSPLayer(w(1024), w(1024), d(3), shortcut=False,
                     depthwise=depthwise))

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.dark2(self.stem(x))
        c3 = self.dark3(x)
        c4 = self.dark4(c3)
        c5 = self.dark5(c4)
        return c3, c4, c5


class YOLOPAFPN(nn.Module):
    def __init__(self, depth_mul: float = 1.33, width_mul: float = 1.25,
                 depthwise: bool = False):
        super().__init__()
        w, d = _w(width_mul), _d(depth_mul)
        Conv = conv_block(depthwise)
        self.backbone = CSPDarknet(depth_mul, width_mul, depthwise)
        self.lateral_conv0 = BaseConv(w(1024), w(512), 1, 1)
        self.C3_p4 = CSPLayer(w(1024), w(512), d(3), False,
                              depthwise=depthwise)
        self.reduce_conv1 = BaseConv(w(512), w(256), 1, 1)
        self.C3_p3 = CSPLayer(w(512), w(256), d(3), False,
                              depthwise=depthwise)
        self.bu_conv2 = Conv(w(256), w(256), 3, 2)
        self.C3_n3 = CSPLayer(w(512), w(512), d(3), False,
                              depthwise=depthwise)
        self.bu_conv1 = Conv(w(512), w(512), 3, 2)
        self.C3_n4 = CSPLayer(w(1024), w(1024), d(3), False,
                              depthwise=depthwise)

    def forward(self, x):
        c3, c4, c5 = self.backbone(x)
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        p5 = self.lateral_conv0(c5)
        m4 = self.C3_p4(torch.cat([up(p5), c4], dim=1))
        p4 = self.reduce_conv1(m4)
        out3 = self.C3_p3(torch.cat([up(p4), c3], dim=1))
        out4 = self.C3_n3(torch.cat([self.bu_conv2(out3), p4], dim=1))
        out5 = self.C3_n4(torch.cat([self.bu_conv1(out4), p5], dim=1))
        return out3, out4, out5


class YOLOXHead(nn.Module):
    def __init__(self, num_classes: int = 1, width_mul: float = 1.25,
                 in_channels: Sequence[int] = (256, 512, 1024),
                 depthwise: bool = False):
        super().__init__()
        w = _w(width_mul)
        Conv = conv_block(depthwise)
        self.num_classes = num_classes
        self.stems = nn.ModuleList()
        self.cls_convs = nn.ModuleList()
        self.reg_convs = nn.ModuleList()
        self.cls_preds = nn.ModuleList()
        self.reg_preds = nn.ModuleList()
        self.obj_preds = nn.ModuleList()
        for c in in_channels:
            self.stems.append(BaseConv(w(c), w(256), 1, 1))
            self.cls_convs.append(nn.Sequential(Conv(w(256), w(256), 3, 1),
                                                Conv(w(256), w(256), 3, 1)))
            self.reg_convs.append(nn.Sequential(Conv(w(256), w(256), 3, 1),
                                                Conv(w(256), w(256), 3, 1)))
            self.cls_preds.append(nn.Conv2d(w(256), num_classes, 1))
            self.reg_preds.append(nn.Conv2d(w(256), 4, 1))
            self.obj_preds.append(nn.Conv2d(w(256), 1, 1))

    def forward(self, feats, logits: bool = False) -> torch.Tensor:
        """Raw predictions (N, anchors, 5 + C), obj and cls through the
        sigmoid (left as logits with `logits`, JAX's `apply_sigmoid=False`);
        anchors run level by level, row-major in each."""
        act = (lambda t: t) if logits else torch.sigmoid
        outs = []
        for k, f in enumerate(feats):
            x = self.stems[k](f)
            cls = self.cls_preds[k](self.cls_convs[k](x))
            r = self.reg_convs[k](x)
            out = torch.cat([self.reg_preds[k](r),
                             act(self.obj_preds[k](r)),
                             act(cls)], dim=1)
            outs.append(out.flatten(2))
        return torch.cat(outs, dim=2).transpose(1, 2)


class YOLOX(nn.Module):
    """The full detector: (N, 3, H, W) letterboxed BGR 0-255 ->
    decoded (N, anchors, 5 + C) center-xywh boxes, obj, cls.

    With `train_outputs` (an attribute; the same weights either way) obj
    and cls stay logits and the call returns `(decoded, raw[..., :4])`,
    the pair `yolox_loss.yolox_losses` takes (JAX's
    `YOLOX(train_outputs=True)`, `detect/yolox.py:132-156`)."""

    def __init__(self, num_classes: int = 1, depth_mul: float = 1.33,
                 width_mul: float = 1.25, train_outputs: bool = False):
        super().__init__()
        self.backbone = YOLOPAFPN(depth_mul, width_mul)
        self.head = YOLOXHead(num_classes, width_mul)
        self.train_outputs = train_outputs

    def forward(self, x):
        raw = self.head(self.backbone(x), logits=self.train_outputs)
        decoded = decode_outputs(raw, tuple(x.shape[-2:]))
        if self.train_outputs:
            return decoded, raw[..., :4]
        return decoded


def decode_outputs(raw: torch.Tensor, input_hw: Tuple[int, int],
                   strides: Sequence[int] = (8, 16, 32)) -> torch.Tensor:
    """Grid + stride decode (`yolo_head.py:238-253`): xy offsets and
    log-wh -> center-xywh in input pixels."""
    h, w = input_hw
    grids, strides_full = [], []
    for s in strides:
        hs, ws = h // s, w // s
        yy, xx = torch.meshgrid(torch.arange(hs, device=raw.device),
                                torch.arange(ws, device=raw.device),
                                indexing="ij")
        grids.append(torch.stack([xx, yy], dim=-1).reshape(-1, 2))
        strides_full.append(torch.full((hs * ws, 1), s, device=raw.device))
    grid = torch.cat(grids, 0)[None].to(raw.dtype)
    stride = torch.cat(strides_full, 0)[None].to(raw.dtype)
    xy = (raw[..., :2] + grid) * stride
    wh = torch.exp(raw[..., 2:4]) * stride
    return torch.cat([xy, wh, raw[..., 4:]], dim=-1)


def nms_xyxy(boxes: np.ndarray, scores: np.ndarray,
             iou_thresh: float = 0.45) -> List[int]:
    """Greedy class-agnostic NMS on the host (JAX's `nms_xyxy`)."""
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = (np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0))
        a1 = ((boxes[i, 2] - boxes[i, 0]) *
              (boxes[i, 3] - boxes[i, 1]))
        a2 = ((boxes[rest, 2] - boxes[rest, 0]) *
              (boxes[rest, 3] - boxes[rest, 1]))
        iou = inter / np.maximum(a1 + a2 - inter, 1e-9)
        order = rest[iou <= iou_thresh]
    return keep


def candidate_count(decoded: np.ndarray, conf_thresh: float = 0.1) -> int:
    """How many anchors of one image pass `conf_thresh` (NMS's input)."""
    decoded = np.asarray(decoded)
    score = decoded[:, 4] * decoded[:, 5:].max(axis=-1)
    return int((score >= conf_thresh).sum())


def postprocess_boxes(decoded: np.ndarray, conf_thresh: float = 0.1,
                      nms_thresh: float = 0.45,
                      high_thresh: float = 0.46) -> np.ndarray:
    """One image's decoded predictions -> kept person boxes (M, 5)
    xyxy + score, boxes >= `high_thresh` first, then the
    [conf_thresh, high_thresh) band (`yolox/utils/boxes.py:33-71` and the
    predictor's two-band concatenation, `yolox/yolox.py:54-66`)."""
    decoded = np.asarray(decoded)
    xy, wh = decoded[:, :2], decoded[:, 2:4]
    xyxy = np.concatenate([xy - wh / 2, xy + wh / 2], axis=-1)
    cls_score = decoded[:, 5:].max(axis=-1)
    score = decoded[:, 4] * cls_score
    m = score >= conf_thresh
    if not m.any():
        return np.zeros((0, 5), np.float32)
    boxes, score = xyxy[m], score[m]
    keep = nms_xyxy(boxes, score, nms_thresh)
    boxes, score = boxes[keep], score[keep]
    order = np.concatenate([np.flatnonzero(score >= high_thresh),
                            np.flatnonzero(score < high_thresh)])
    boxes, score = boxes[order], score[order]
    return np.concatenate([boxes, score[:, None]],
                          axis=-1).astype(np.float32)
