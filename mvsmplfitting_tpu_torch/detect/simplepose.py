"""SimplePose (ResNet-50 + 3 deconv stages) heatmap net, NCHW (port of
`detect/simplepose.py`, the reference's `models/simplepose.py`): the
plain ResNet-50 backbone, three ConvTranspose(k4, s2, p1) + BN + ReLU
stages (`deconv_layers`) and a 1x1 head (`final_layer`), input/4
heatmaps."""

from __future__ import annotations

from typing import Sequence

from torch import nn

from .blocks import BN_EPS, BatchNorm2d, ResNetBackbone


class ResNet(ResNetBackbone):
    """Plain (non-SE) ResNet-50 (`layers/Resnet.py`)."""

    def __init__(self, depths: Sequence[int] = (3, 4, 6, 3)):
        super().__init__(depths, se=False)


class SimplePose(nn.Module):
    def __init__(self, num_joints: int = 26,
                 deconv_filters: Sequence[int] = (256, 256, 256)):
        super().__init__()
        self.num_joints = num_joints
        self.preact = ResNet()
        layers, cin = [], 2048
        for f in deconv_filters:
            layers += [nn.ConvTranspose2d(cin, f, 4, 2, 1, bias=False),
                       BatchNorm2d(f, eps=BN_EPS), nn.ReLU()]
            cin = f
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = nn.Conv2d(cin, num_joints, 1)

    def forward(self, x):
        """x: (N, 3, H, W) -> (N, J, H/4, W/4) heatmaps."""
        return self.final_layer(self.deconv_layers(self.preact(x)))
