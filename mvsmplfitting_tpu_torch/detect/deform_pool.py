"""Deformable (PS-)RoI pooling as gathers and a masked mean, NCHW (port
of `detect/deform_pool.py`).

Replaces the reference's CUDA extension
(`alphapose_core/alphapose/models/layers/dcn/deform_pool.py:10-252`,
kernel `dcn/src/deform_pool_cuda_kernel.cu:53-144`): every RoI's sample
points form one (N, classes, OH, OW, S, S) coordinate grid, sampled with
one batched bilinear gather, masked-averaged per bin and routed through
the position-sensitive channel map with one channel gather.

Semantics of `DeformablePSROIPoolForwardKernel`
(`deform_pool_cuda_kernel.cu:53-144`):
  - RoI corners are rounded, scaled, then shifted by -0.5; the end
    corner adds +1 before scaling; width/height clamp to >= 0.1.
  - Per output bin (ph, pw): sample_per_part^2 sub-samples; samples
    with w outside [-0.5, W-0.5] (or h likewise) are skipped (they
    reduce the average's count, they are not zeros); in-range samples
    clamp to [0, dim-1] and bilinear-interpolate with floor/ceil
    corners; a bin with no valid sample outputs 0.
  - The per-bin offset comes from a (part_size x part_size) `trans`
    table indexed by floor(ph/OH*P): trans * trans_std * roi_size.
  - Position-sensitive channel routing: output channel ctop at bin
    (ph, pw) reads input channel (ctop*gs + gh)*gs + gw with
    gh = clip(floor(ph*gs/OH)), i.e. data C == out_channels * gs^2.

The pack modules carry the reference's sub-module names (`offset_fc`,
`mask_fc` Sequentials), so its `state_dict` loads as is.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def _bilinear_floor_ceil(flat: torch.Tensor, W: int, y: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """`bilinear_interp` (`deform_pool_cuda_kernel.cu:31-51`): corners
    are floor/ceil (integer coordinates collapse to one texel), the
    coordinates clamped by the caller.

    flat: (N, C, H*W); y/x: (N, P).  Returns (N, C, P).
    """
    y0, x0 = torch.floor(y), torch.floor(x)
    y1, x1 = torch.ceil(y), torch.ceil(x)
    dy, dx = y - y0, x - x0
    C = flat.shape[1]

    def corner(iy, ix, w):
        lin = (iy.to(torch.int64) * W + ix.to(torch.int64))[:, None, :]
        v = torch.gather(flat, 2, lin.expand(-1, C, -1))
        return v * w[:, None, :]

    return (corner(y0, x0, (1 - dx) * (1 - dy))
            + corner(y1, x0, (1 - dx) * dy)
            + corner(y0, x1, dx * (1 - dy))
            + corner(y1, x1, dx * dy))


def deform_roi_pool(data: torch.Tensor, rois: torch.Tensor,
                    trans: Optional[torch.Tensor], *,
                    out_size: int, out_channels: int,
                    spatial_scale: float, no_trans: bool = False,
                    group_size: int = 1,
                    part_size: Optional[int] = None,
                    sample_per_part: int = 4,
                    trans_std: float = 0.0) -> torch.Tensor:
    """Deformable PS-RoI pooling forward.

    Args:
      data: (B, C, H, W) feature map; C == out_channels * group_size**2
        (position-sensitive); group_size=1 is plain deformable RoI
        pooling with C == out_channels.
      rois: (N, 5) rows [batch_idx, x1, y1, x2, y2] in image coordinates
        (before spatial_scale), as the CUDA op.
      trans: (N, num_classes*2, P, P) normalized bin offsets (channel 2k
        is x of class k, 2k+1 its y), or None with no_trans.
      out_size / out_channels / spatial_scale / group_size / part_size
        / sample_per_part / trans_std: as the reference module
        (`deform_pool.py:83-110`); the output is square (`:26-29`).

    Returns:
      (N, out_channels, out_size, out_size).  Gradients flow to `data`
      and `trans`.
    """
    B, C, H, W = data.shape
    N = rois.shape[0]
    OH = OW = int(out_size)
    P = int(out_size if part_size is None else part_size)
    S = int(sample_per_part)
    gs = int(group_size)
    if C != out_channels * gs * gs:
        raise ValueError(f"C={C} != out_channels*group_size^2 = "
                         f"{out_channels}*{gs}^2")

    f32, device = torch.float32, data.device
    rois = rois.to(f32)
    batch_idx = rois[:, 0].to(torch.int64)
    # `deform_pool_cuda_kernel.cu:82-90`
    rs_w = torch.round(rois[:, 1]) * spatial_scale - 0.5
    rs_h = torch.round(rois[:, 2]) * spatial_scale - 0.5
    re_w = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    re_h = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp_min(re_w - rs_w, 0.1)
    roi_h = torch.clamp_min(re_h - rs_h, 0.1)
    bin_w = roi_w / OW                                        # (N,)
    bin_h = roi_h / OH
    sub_w = bin_w / S
    sub_h = bin_h / S

    ph = torch.arange(OH, dtype=f32, device=device)
    pw = torch.arange(OW, dtype=f32, device=device)
    if no_trans or trans is None:
        nc = 1
        tx = torch.zeros((N, 1, OH, OW), dtype=f32, device=device)
        ty = torch.zeros((N, 1, OH, OW), dtype=f32, device=device)
    else:
        nc = trans.shape[1] // 2
        part_h = torch.floor(ph / OH * P).to(torch.int64)     # (OH,)
        part_w = torch.floor(pw / OW * P).to(torch.int64)
        t = trans.to(f32).reshape(N, nc, 2, P, P)
        t = t[:, :, :, part_h][:, :, :, :, part_w]            # (N,nc,2,OH,OW)
        tx = t[:, :, 0] * trans_std
        ty = t[:, :, 1] * trans_std

    # Bin start corners + per-class trans shift (`:106-110`).
    wstart = (pw[None, None, None, :] * bin_w[:, None, None, None]
              + rs_w[:, None, None, None] + tx * roi_w[:, None, None, None])
    hstart = (ph[None, None, :, None] * bin_h[:, None, None, None]
              + rs_h[:, None, None, None] + ty * roi_h[:, None, None, None])

    ss = torch.arange(S, dtype=f32, device=device)
    # (N, nc, OH, OW, S, S): h varies over axis -2, w over axis -1.
    grid = (N, nc, OH, OW, S, S)
    w = (wstart[..., None, None] + ss * sub_w[:, None, None, None, None,
                                              None]).expand(grid)
    h = (hstart[..., None, None] + ss[:, None] * sub_h[:, None, None, None,
                                                       None, None]
         ).expand(grid)
    valid = ((w >= -0.5) & (w <= W - 0.5)
             & (h >= -0.5) & (h <= H - 0.5))                  # `:120-125`
    wc = torch.clamp(w, 0.0, W - 1.0)
    hc = torch.clamp(h, 0.0, H - 1.0)

    flat = data.to(f32)[batch_idx].reshape(N, C, H * W)
    vals = _bilinear_floor_ceil(flat, W, hc.reshape(N, -1),
                                wc.reshape(N, -1))            # (N, C, P)
    vals = vals.reshape((N, C) + grid[1:])                    # (N,C,nc,...)
    vmask = valid.to(f32)
    ssum = torch.sum(vals * vmask[:, None], dim=(5, 6))       # (N,C,nc,OH,OW)
    cnt = torch.sum(vmask, dim=(4, 5))[:, None]
    avg = torch.where(cnt > 0, ssum / torch.clamp_min(cnt, 1.0),
                      torch.zeros_like(ssum))

    # Position-sensitive channel routing (`:112-116,127`): output
    # channel ctop at (ph, pw) reads input channel (ctop*gs+gh)*gs+gw.
    gh = torch.clamp(torch.floor(ph * gs / OH), 0, gs - 1).to(torch.int64)
    gw = torch.clamp(torch.floor(pw * gs / OW), 0, gs - 1).to(torch.int64)
    ctop = torch.arange(out_channels, device=device)
    cmap = ((ctop[:, None, None] * gs + gh[None, :, None]) * gs
            + gw[None, None, :])                              # (out,OH,OW)
    routed = torch.gather(avg, 1, cmap[None, :, None].expand(
        N, out_channels, nc, OH, OW))                         # (N,out,nc,..)

    # Per-output-channel class selection (`:101`): class_id = ctop //
    # (out_channels // num_classes).
    if nc == 1:
        return routed[:, :, 0]
    class_id = ctop // (out_channels // nc)                   # (out,)
    return torch.gather(routed, 2, class_id[None, :, None, None, None]
                        .expand(N, out_channels, 1, OH, OW))[:, :, 0]


def _fc_stack(cin: int, n_layers: int, hidden: int, out: int,
              final_sigmoid: bool = False) -> nn.Sequential:
    """The reference's Linear/ReLU offset (and mask) FC stacks with the
    zero-initialized final Linear (`deform_pool.py:134-147,211-228`), so
    a freshly built pack module starts at plain pooling."""
    seq = []
    for i in range(n_layers):
        last = i == n_layers - 1
        lin = nn.Linear(cin, out if last else hidden)
        seq.append(lin)
        if not last:
            seq.append(nn.ReLU())
        elif final_sigmoid:
            seq.append(nn.Sigmoid())
        cin = hidden
    nn.init.zeros_(lin.weight)
    nn.init.zeros_(lin.bias)
    return nn.Sequential(*seq)


class DeformRoIPoolingPack(nn.Module):
    """`DeformRoIPoolingPack` (`deform_pool.py:113-172`): plain pool ->
    FC offset head -> deformable pool."""

    def __init__(self, spatial_scale: float, out_size: int,
                 out_channels: int, no_trans: bool = False,
                 group_size: int = 1, part_size: Optional[int] = None,
                 sample_per_part: int = 4, trans_std: float = 0.0,
                 num_offset_fcs: int = 3, deform_fc_channels: int = 1024):
        super().__init__()
        self.spatial_scale = spatial_scale
        self.out_size = out_size
        self.out_channels = out_channels
        self.no_trans = no_trans
        self.group_size = group_size
        self.part_size = part_size
        self.sample_per_part = sample_per_part
        self.trans_std = trans_std
        if not no_trans:
            self.offset_fc = _fc_stack(out_size * out_size * out_channels,
                                       num_offset_fcs, deform_fc_channels,
                                       out_size * out_size * 2)

    def _pool(self, data, rois, trans, no_trans):
        return deform_roi_pool(
            data, rois, trans, out_size=self.out_size,
            out_channels=self.out_channels, no_trans=no_trans,
            spatial_scale=self.spatial_scale, group_size=self.group_size,
            part_size=self.part_size, sample_per_part=self.sample_per_part,
            trans_std=self.trans_std)

    def _offsets(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        return self.offset_fc(x.reshape(n, -1)).reshape(
            n, 2, self.out_size, self.out_size)

    def forward(self, data: torch.Tensor, rois: torch.Tensor
                ) -> torch.Tensor:
        if self.no_trans:
            return self._pool(data, rois, None, True)
        x = self._pool(data, rois, None, True)
        return self._pool(data, rois, self._offsets(x), False)


class ModulatedDeformRoIPoolingPack(DeformRoIPoolingPack):
    """`ModulatedDeformRoIPoolingPack` (`deform_pool.py:175-252`): adds a
    sigmoid mask FC head multiplying the pooled output."""

    def __init__(self, spatial_scale: float, out_size: int,
                 out_channels: int, no_trans: bool = False,
                 group_size: int = 1, part_size: Optional[int] = None,
                 sample_per_part: int = 4, trans_std: float = 0.0,
                 num_offset_fcs: int = 3, num_mask_fcs: int = 2,
                 deform_fc_channels: int = 1024):
        super().__init__(spatial_scale, out_size, out_channels, no_trans,
                         group_size, part_size, sample_per_part, trans_std,
                         num_offset_fcs, deform_fc_channels)
        if not no_trans:
            self.mask_fc = _fc_stack(out_size * out_size * out_channels,
                                     num_mask_fcs, deform_fc_channels,
                                     out_size * out_size,
                                     final_sigmoid=True)

    def forward(self, data: torch.Tensor, rois: torch.Tensor
                ) -> torch.Tensor:
        if self.no_trans:
            return self._pool(data, rois, None, True)
        n = rois.shape[0]
        x = self._pool(data, rois, None, True)
        mask = self.mask_fc(x.reshape(n, -1)).reshape(
            n, 1, self.out_size, self.out_size)
        return self._pool(data, rois, self._offsets(x), False) * mask
