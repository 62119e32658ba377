"""RoIAlign as gathers and one weighted sum, NCHW (port of
`detect/roi_align.py`).

Numerics follow the reference's CUDA op
(`alphapose_core/alphapose/utils/roi_align/src/roi_align_kernel.cu:64-124`),
which differs from torchvision's roi_align:

* roi ends are inclusive: ``roi_end = (coord + 1) * spatial_scale``;
* each pooled cell averages ``sample_num x sample_num`` bilinear taps at
  ``start + p*bin + (s+0.5)*bin/n``;
* ``sample_num <= 0`` is adaptive: ``ceil(roi_extent / pooled)`` taps
  per axis, at most `max_samples`; the tap grid is as wide as the
  widest roi needs and the extra taps of narrower rois weigh 0;
* out-of-range taps: 0 outside ``[-1, size]``, else coordinates clamp
  to ``[0, size-1]`` (`roi_align_kernel.cu:17-62`).

Plain PyTorch on any device; no torchvision.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Crop preprocessing constants of `SimpleTransform.align_transform`
# (`simple_transform.py:105-124`): RGB mean subtraction then RoIAlign on
# the aspect-clipped boxes with the adaptive sample count
# (`simple_transform.py:80`: sample_num=-1).
RGB_MEANS = (0.406, 0.457, 0.480)


def _bilinear_kernel_weights(y: torch.Tensor, x: torch.Tensor,
                             height: int, width: int):
    """Corner indices + weights with the CUDA kernel's boundary rules."""
    valid = (y >= -1.0) & (y <= height) & (x >= -1.0) & (x <= width)
    y = torch.clamp_min(y, 0.0)
    x = torch.clamp_min(x, 0.0)
    y_low = torch.clamp_max(y.to(torch.int64), height - 1)
    x_low = torch.clamp_max(x.to(torch.int64), width - 1)
    # y_low >= height-1 -> both corners pinned to height-1 and y snapped.
    y = torch.where(y_low >= height - 1, y_low.to(y.dtype), y)
    x = torch.where(x_low >= width - 1, x_low.to(x.dtype), x)
    y_high = torch.clamp_max(y_low + 1, height - 1)
    x_high = torch.clamp_max(x_low + 1, width - 1)

    ly = y - y_low
    lx = x - x_low
    hy = 1.0 - ly
    hx = 1.0 - lx
    w = torch.stack([hy * hx, hy * lx, ly * hx, ly * lx], dim=-1)
    w = w * valid[..., None]
    iy = torch.stack([y_low, y_low, y_high, y_high], dim=-1)
    ix = torch.stack([x_low, x_high, x_low, x_high], dim=-1)
    return iy, ix, w


def roi_align(features: torch.Tensor, rois: torch.Tensor,
              out_size: Tuple[int, int], spatial_scale: float = 1.0,
              sample_num: int = 0, max_samples: int = 8) -> torch.Tensor:
    """RoIAlign forward.

    Args:
      features: (B, C, H, W) feature map.
      rois: (N, 5) rows [batch_index, x1, y1, x2, y2].
      out_size: (out_h, out_w) pooled size.
      sample_num: taps per axis per cell; <= 0 selects the reference's
        adaptive count, bounded by `max_samples`.

    Returns:
      (N, C, out_h, out_w) pooled features.
    """
    B, C, H, W = features.shape
    N = rois.shape[0]
    out_h, out_w = out_size
    dtype, device = features.dtype, features.device

    batch_idx = rois[:, 0].to(torch.int64)
    start_w = rois[:, 1] * spatial_scale
    start_h = rois[:, 2] * spatial_scale
    end_w = (rois[:, 3] + 1.0) * spatial_scale
    end_h = (rois[:, 4] + 1.0) * spatial_scale
    roi_w = torch.clamp_min(end_w - start_w, 0.0)
    roi_h = torch.clamp_min(end_h - start_h, 0.0)
    bin_h = roi_h / out_h                                      # (N,)
    bin_w = roi_w / out_w

    if sample_num > 0:
        n_h = torch.full_like(bin_h, sample_num)
        n_w = torch.full_like(bin_w, sample_num)
        S = sample_num
    else:
        n_h = torch.clamp_min(torch.clamp_max(torch.ceil(roi_h / out_h),
                                              max_samples), 1.0)
        n_w = torch.clamp_min(torch.clamp_max(torch.ceil(roi_w / out_w),
                                              max_samples), 1.0)
        S = int(torch.maximum(n_h.max(), n_w.max()).item()) if N else 1

    ph = torch.arange(out_h, dtype=dtype, device=device)
    pw = torch.arange(out_w, dtype=dtype, device=device)
    s = torch.arange(S, dtype=dtype, device=device) + 0.5

    # y[n, ph, iy] = start_h + ph*bin + (iy+.5)*bin/n_h  (kernel :105-116)
    y = (start_h[:, None, None] + ph[None, :, None] * bin_h[:, None, None]
         + s[None, None, :] * bin_h[:, None, None] / n_h[:, None, None])
    x = (start_w[:, None, None] + pw[None, :, None] * bin_w[:, None, None]
         + s[None, None, :] * bin_w[:, None, None] / n_w[:, None, None])
    taps = torch.arange(S, device=device)
    tap_h = (taps[None, :] < n_h[:, None]).to(dtype)          # (N, S)
    tap_w = (taps[None, :] < n_w[:, None]).to(dtype)

    grid = (N, out_h, out_w, S, S)
    yy = y[:, :, None, :, None].expand(grid)
    xx = x[:, None, :, None, :].expand(grid)
    iy, ix, w = _bilinear_kernel_weights(yy, xx, H, W)        # (..., 4)
    lin = (iy * W + ix).reshape(N, 1, -1)
    per_roi = features.reshape(B, C, H * W)[batch_idx]        # (N, C, HW)
    vals = torch.gather(per_roi, 2, lin.expand(N, C, lin.shape[-1]))
    vals = vals.reshape((N, C) + tuple(iy.shape[1:]))
    tap = tap_h[:, None, None, :, None] * tap_w[:, None, None, None, :]
    w = w * tap[..., None]
    out = torch.einsum("nhwabk,nchwabk->nchw", w, vals)
    return out / (n_h * n_w)[:, None, None, None]


def clip_aspect_ratio(boxes: torch.Tensor,
                      aspect_ratio: float) -> torch.Tensor:
    """(N,4) xyxy -> (N,5) [0, x1,y1,x2,y2] grown to the aspect ratio
    about the box center (`bbox.py:229-251`)."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    w = x2 - x1
    h = y2 - y1
    cx = x1 + 0.5 * w
    cy = y1 + 0.5 * h
    h = torch.where(w > aspect_ratio * h, w / aspect_ratio, h)
    w = torch.where(w < aspect_ratio * h, h * aspect_ratio, w)
    return torch.stack([torch.zeros_like(w), cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w, cy + 0.5 * h], dim=1)


def align_transform(image: torch.Tensor, boxes: torch.Tensor,
                    out_size: Tuple[int, int], max_samples: int = 8
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoIAlign-based crop of person boxes from one image.

    Args:
      image: (H, W, 3) RGB float in [0, 1].
      boxes: (N, 4) xyxy person boxes.
      out_size: (out_h, out_w) crop size (the model input size).

    Returns:
      crops (N, 3, out_h, out_w) mean-subtracted, and the aspect-clipped
      boxes (N, 4) used (for coordinate back-transform).
    """
    aspect = float(out_size[1]) / float(out_size[0])          # w / h
    img = image - torch.tensor(RGB_MEANS, dtype=image.dtype,
                               device=image.device)
    rois = clip_aspect_ratio(boxes, aspect)
    crops = roi_align(img.permute(2, 0, 1)[None], rois, out_size,
                      spatial_scale=1.0, sample_num=-1,
                      max_samples=max_samples)
    return crops, rois[:, 1:]
