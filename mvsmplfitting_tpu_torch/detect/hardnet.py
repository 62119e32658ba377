"""HarDNet-68 pose net (harmonic dense blocks), NCHW (port of
`detect/hardnet.py`; the reference's `HarDNetPose`,
`alphapose/models/hardnet.py:397-531`, NUM_LAYERS 68).

A HarDNet base (blocks whose layers link back by powers of two,
`HarDBlock.get_link`, `:100-118`), a bottom block fed [x, avg9x9(x),
x / sum(x)], and three decoder stages that resize by align-corners
bilinear interpolation (the reference's `F.interpolate(...,
align_corners=True)`), concatenate skips and split off side channels
that bypass to the head.  Links and channel counts are computed as the
reference computes them.  Sub-modules carry the reference's names
(`base.3.layers.5.conv`, `last_proj`, `last_blk`, `conv1x1_up.1`,
`denseBlocksUp.2`, `conv_out.0`, `conv_out.2`), so its checkpoints load
with `load_state_dict`.  Average pools count the padding, as flax's and
the reference's `nn.AvgPool2d` do.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BN_EPS, BatchNorm2d


def hard_link(layer: int, base_ch: int, growth_rate: int,
              grmul: float) -> Tuple[int, int, List[int]]:
    """The reference's `HarDBlock.get_link` recursion (`:100-118`):
    (output channels, input channels, linked layers)."""
    if layer == 0:
        return base_ch, 0, []
    out_channels = float(growth_rate)
    link = []
    for i in range(10):
        dv = 2 ** i
        if layer % dv == 0:
            link.append(layer - dv)
            if i > 0:
                out_channels *= grmul
    out_channels = int(int(out_channels + 1) / 2) * 2
    in_channels = sum(hard_link(i, base_ch, growth_rate, grmul)[0]
                      for i in link)
    return out_channels, in_channels, link


class ConvLayer(nn.Sequential):
    """Conv (no bias) -> BN -> ReLU, named `conv` / `norm` / `relu`."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.add_module("conv", nn.Conv2d(cin, cout, kernel, stride,
                                          kernel // 2, bias=False))
        self.add_module("norm", BatchNorm2d(cout, eps=BN_EPS))
        self.add_module("relu", nn.ReLU())


class HarDBlock(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int,
                 grmul: float = 1.7, n_layers: int = 8,
                 keep_base: bool = False):
        super().__init__()
        self.keep_base = keep_base
        self.links = []
        layers = []
        for i in range(n_layers):
            outch, inch, link = hard_link(i + 1, in_channels, growth_rate,
                                          grmul)
            self.links.append(link)
            layers.append(ConvLayer(inch, outch))
        self.layers = nn.ModuleList(layers)
        self.out_channels = self.out_ch(in_channels, growth_rate, grmul,
                                        n_layers, keep_base)

    @staticmethod
    def out_ch(in_channels, growth_rate, grmul, n_layers,
               keep_base=False) -> int:
        total = in_channels if keep_base else 0
        for i in range(n_layers):
            outch, _, _ = hard_link(i + 1, in_channels, growth_rate, grmul)
            if (i % 2 == 0) or (i == n_layers - 1):
                total += outch
        return total

    def forward(self, x):
        layers = [x]
        for link, layer in zip(self.links, self.layers):
            tin = [layers[k] for k in link]
            layers.append(layer(tin[0] if len(tin) == 1
                                else torch.cat(tin, 1)))
        t = len(layers)
        return torch.cat([layers[i] for i in range(t)
                          if (i == 0 and self.keep_base) or (i == t - 1)
                          or (i % 2 == 1)], 1)


def resize_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """Align-corners bilinear resize to `hw` (the reference's
    `F.interpolate(..., mode='bilinear', align_corners=True)`)."""
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=True)


def _attend(x: torch.Tensor, pool: nn.Module) -> torch.Tensor:
    """[x, avg9x9(x), x / (sum(x) + 0.1)] along the channels."""
    return torch.cat([x, pool(x),
                      x / (x.sum(dim=(2, 3), keepdim=True) + 0.1)], 1)


# HarDNet-68 tables (`hardnet.py:306-317,421-431`).
_BASE_CH = (32, 64)
_CH_LIST = (128, 256, 320, 640)
_GR = (14, 16, 20, 40)
_N_LAYERS = (8, 16, 16, 16)
_SKIP_NODES = (1, 3, 8, 11)
_SC = (32, 32, 0)
_GR_UP = (48, 32, 20)
_LAYERS_UP = (8, 8, 4)
_CH_LIST2 = (224 + 32, 96 + 32, 64 + 0)
_SKIP_LV = 2


class HarDNetPose(nn.Module):
    """HarDNet-68 pose net: (N, 3, H, W) -> heatmaps at H/4."""

    def __init__(self, num_joints: int = 17, final_kernel: int = 1):
        super().__init__()
        self.num_joints = num_joints
        base: List[nn.Module] = [ConvLayer(3, _BASE_CH[0], 3, 2),
                                 ConvLayer(_BASE_CH[0], _BASE_CH[1], 3, 1),
                                 nn.AvgPool2d(3, 2, 1)]
        ch = _BASE_CH[1]
        skip_ch = {1: _BASE_CH[1]}
        for i in range(4):
            blk = HarDBlock(ch, _GR[i], 1.7, _N_LAYERS[i])
            base.append(blk)
            ch = blk.out_channels
            if len(base) - 1 in _SKIP_NODES:
                skip_ch[len(base) - 1] = ch
            if i != 3:
                base.append(ConvLayer(ch, _CH_LIST[i], 1))
                ch = _CH_LIST[i]
            if i in (0, 2):
                base.append(nn.AvgPool2d(2, 2))
        self.base = nn.ModuleList(base)
        self.skip_channels = [skip_ch[n] for n in _SKIP_NODES]

        self.last_proj = ConvLayer(ch, 192, 1)
        self.last_pool = nn.AvgPool2d(2, 2)
        self.avg9x9 = nn.AvgPool2d(9, 1, 4)
        self.last_blk = HarDBlock(576, 72, 1.7, 8)
        prev = self.last_blk.out_channels
        up_proj, up_blk = [], []
        for i in range(3):
            cin = prev + (self.skip_channels[3 - i] if i < _SKIP_LV else 0)
            up_proj.append(ConvLayer(cin, _CH_LIST2[i], 1))
            blk = HarDBlock((_CH_LIST2[i] - _SC[i]) * 3, _GR_UP[i], 1.7,
                            _LAYERS_UP[i])
            up_blk.append(blk)
            prev = blk.out_channels
        self.conv1x1_up = nn.ModuleList(up_proj)
        self.denseBlocksUp = nn.ModuleList(up_blk)
        ch = max(128, num_joints * 4)
        self.conv_out = nn.Sequential(
            nn.Conv2d(prev + sum(_SC), ch, 3, 1, 1),
            nn.ReLU(),
            nn.Conv2d(ch, num_joints, final_kernel, 1, final_kernel // 2))

    def forward(self, x):
        xs = []
        for n, layer in enumerate(self.base):
            x = layer(x)
            if n in _SKIP_NODES:
                xs.append(x)
        x = self.last_pool(self.last_proj(x))
        x = self.last_blk(_attend(x, self.avg9x9))
        x_sc = []
        for i in range(3):
            skip = xs[3 - i]
            x = resize_bilinear(x, skip.shape[2:])
            if i < _SKIP_LV:
                x = torch.cat([x, skip], 1)
            x = self.conv1x1_up[i](x)
            if _SC[i] > 0:
                x_sc.append(x[:, -_SC[i]:])
                x = x[:, :-_SC[i]]
            x = self.denseBlocksUp[i](_attend(x, self.avg9x9))
        scs = [x]
        for sc in x_sc:
            scs.insert(0, resize_bilinear(sc, x.shape[2:]))
        return self.conv_out(torch.cat(scs, 1))
