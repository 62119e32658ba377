"""FastPose-DUC and FastPose-DUC-dense heatmap nets, NCHW (port of
`detect/fastpose_duc.py`; the reference's `fastpose_duc.py:15-98` and
`fastpose_duc_dense.py:15-135`).

A ResNet backbone (plain, `se=True` SE-ResNet, or `shuffle=True`
ShuffleResnet), three DUC stages (PixelShuffle(2), NUM_CONV - 1
width-keeping 3x3 conv + BN + ReLU blocks, a 3x3 conv + BN + ReLU to the
stage's width: 2048 -> 1024 -> 512 -> conv_dim) and a 3x3 head.  The
dense variant runs a second DUC chain off the same features and appends
its `num_joints_dense - num_joints` heatmaps after the base head's.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .blocks import BN_EPS, BatchNorm2d
from .fastpose import SEResnet
from .simplepose import ResNet


def duc_stage(inplanes: int, outplanes: int, num_conv: int) -> nn.Sequential:
    """`_make_duc_stage`: [PixelShuffle, (conv, bn, relu) x num_conv]."""
    mid = inplanes // 4
    layers = [nn.PixelShuffle(2)]
    for _ in range(num_conv - 1):
        layers += [nn.Conv2d(mid, mid, 3, padding=1, bias=False),
                   BatchNorm2d(mid, eps=BN_EPS), nn.ReLU()]
    layers += [nn.Conv2d(mid, outplanes, 3, padding=1, bias=False),
               BatchNorm2d(outplanes, eps=BN_EPS), nn.ReLU()]
    return nn.Sequential(*layers)


def _backbone(se: bool, shuffle: bool) -> nn.Module:
    """BACKBONE (`fastpose_duc.py:21-29`): 'shuffle' | 'se-resnet' |
    plain resnet."""
    if shuffle:
        return SEResnet(shuffle=True)
    return SEResnet() if se else ResNet()


def _chain(num_convs: Sequence[int], conv_dim: int):
    return (duc_stage(2048, 1024, num_convs[0]),
            duc_stage(1024, 512, num_convs[1]),
            duc_stage(512, conv_dim, num_convs[2]))


class FastPoseDUC(nn.Module):
    def __init__(self, num_joints: int = 17,
                 num_convs: Sequence[int] = (4, 2, 1), conv_dim: int = 256,
                 se: bool = False, shuffle: bool = False):
        super().__init__()
        self.num_joints = num_joints
        self.preact = _backbone(se, shuffle)
        self.duc1, self.duc2, self.duc3 = _chain(num_convs, conv_dim)
        self.conv_out = nn.Conv2d(conv_dim, num_joints, 3, 1, 1)

    def forward(self, x):
        """x: (N, 3, H, W) -> (N, J, H/4, W/4) heatmaps."""
        x = self.duc3(self.duc2(self.duc1(self.preact(x))))
        return self.conv_out(x)


class FastPoseDUCDense(nn.Module):
    def __init__(self, num_joints: int = 17, num_joints_dense: int = 136,
                 num_convs: Sequence[int] = (4, 2, 1), conv_dim: int = 256,
                 se: bool = False, shuffle: bool = False):
        super().__init__()
        self.num_joints = num_joints
        self.num_joints_dense = num_joints_dense
        self.preact = _backbone(se, shuffle)
        self.duc = nn.Sequential(*_chain(num_convs, conv_dim))
        self.duc_dense = nn.Sequential(*_chain(num_convs, conv_dim))
        self.conv_out = nn.Conv2d(conv_dim, num_joints, 3, 1, 1)
        self.conv_out_dense = nn.Conv2d(conv_dim,
                                        num_joints_dense - num_joints,
                                        3, 1, 1)

    def forward(self, x):
        """x: (N, 3, H, W) -> (N, J_dense, H/4, W/4): the base joints,
        then the dense extras (`fastpose_duc_dense.py:117-123`)."""
        feat = self.preact(x)
        return torch.cat([self.conv_out(self.duc(feat)),
                          self.conv_out_dense(self.duc_dense(feat))], dim=1)
