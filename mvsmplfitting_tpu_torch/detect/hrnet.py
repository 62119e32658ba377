"""Pose HRNet (high-resolution net), NCHW (port of `detect/hrnet.py`; the
reference's `alphapose/models/hrnet.py:270-470`, MODEL.TYPE
`PoseHighResolutionNet`).

A stem to 1/4 resolution, a Bottleneck stage, then three multi-branch
stages that keep a high-resolution stream while exchanging information
between resolutions through fuse layers (1x1 conv + nearest upsampling
by an integer factor going up, strided 3x3 convs going down).  The
defaults are HRNet-W32 (channels 32/64/128/256, module counts 1/4/3,
4 BasicBlocks a branch) with a 1x1 head to J heatmaps at input/4.
Sub-modules carry the reference's names (`conv1`, `layer1.0`,
`transition1.1.0.0`, `stage3.2.branches.1.3.conv2`,
`stage4.0.fuse_layers.3.0.2.0`, `final_layer`), so its checkpoints load
with `load_state_dict`; JAX's `convert_hrnet_sd` is the map from these
names to its flax tree.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from .blocks import BN_EPS, BatchNorm2d, ResBottleneck


def conv_bn(cin: int, cout: int, k: int, stride: int, relu: bool
            ) -> nn.Sequential:
    layers = [nn.Conv2d(cin, cout, k, stride, k // 2, bias=False),
              BatchNorm2d(cout, eps=BN_EPS)]
    if relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class BasicBlock(nn.Module):
    """Two 3x3 conv-BN pairs and the identity (`hrnet.py:25-57`)."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=BN_EPS)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes, eps=BN_EPS)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + x)


class HRModule(nn.Module):
    """One high-resolution module: 4 BasicBlocks per branch, then every
    output branch sums all branches brought to its resolution
    (`HighResolutionModule`, `hrnet.py:98-250`)."""

    def __init__(self, channels: Sequence[int], num_blocks: int = 4,
                 multi_scale_output: bool = True):
        super().__init__()
        nb = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(c) for _ in range(num_blocks)])
            for c in channels)
        fuse = []
        for i in range(nb if multi_scale_output else 1):
            row = []
            for j in range(nb):
                if j > i:
                    row.append(nn.Sequential(
                        nn.Conv2d(channels[j], channels[i], 1, bias=False),
                        BatchNorm2d(channels[i], eps=BN_EPS),
                        nn.Upsample(scale_factor=2 ** (j - i),
                                    mode="nearest")))
                elif j < i:
                    row.append(nn.Sequential(*[
                        conv_bn(channels[j], channels[i] if k == i - j - 1
                                else channels[j], 3, 2, k < i - j - 1)
                        for k in range(i - j)]))
                else:
                    row.append(None)
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        outs = [branch(x) for branch, x in zip(self.branches, xs)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                y = outs[j] if layer is None else layer(outs[j])
                acc = y if acc is None else acc + y
            fused.append(F.relu(acc))
        return fused


class PoseHRNet(nn.Module):
    def __init__(self, num_joints: int = 17, width: int = 32,
                 stage_modules: Sequence[int] = (1, 4, 3)):
        super().__init__()
        self.num_joints = num_joints
        w = width
        chans = [(w, 2 * w), (w, 2 * w, 4 * w), (w, 2 * w, 4 * w, 8 * w)]
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm2d(64, eps=BN_EPS)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = BatchNorm2d(64, eps=BN_EPS)
        self.layer1 = nn.Sequential(*[
            ResBottleneck(64 if b == 0 else 256, 64, downsample=b == 0)
            for b in range(4)])
        # Transitions (`_make_transition_layer`): a conv for a branch
        # whose width changes, a strided conv for a new branch, None else.
        self.transition1 = nn.ModuleList([
            conv_bn(256, w, 3, 1, True),
            nn.Sequential(conv_bn(256, 2 * w, 3, 2, True))])
        self.transition2 = nn.ModuleList(
            [None, None, nn.Sequential(conv_bn(2 * w, 4 * w, 3, 2, True))])
        self.transition3 = nn.ModuleList(
            [None, None, None,
             nn.Sequential(conv_bn(4 * w, 8 * w, 3, 2, True))])
        for s, (ch, n) in enumerate(zip(chans, stage_modules)):
            setattr(self, f"stage{s + 2}", nn.Sequential(*[
                HRModule(ch, multi_scale_output=not (s == 2 and m == n - 1))
                for m in range(n)]))
        self.final_layer = nn.Conv2d(w, num_joints, 1)

    def forward(self, x):
        """x: (N, 3, H, W) -> (N, J, H/4, W/4) heatmaps."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.layer1(F.relu(self.bn2(self.conv2(x))))
        xs = [t(x) for t in self.transition1]
        xs = self.stage2(xs)
        xs = self.stage3(xs + [self.transition2[2](xs[-1])])
        xs = self.stage4(xs + [self.transition3[3](xs[-1])])
        return self.final_layer(xs[0])
