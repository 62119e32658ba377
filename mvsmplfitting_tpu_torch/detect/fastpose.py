"""FastPose (SE-ResNet50 + DUC) heatmap pose net, NCHW (port of
`detect/fastpose.py`).

The reference demo's net (`configs/halpe_26/resnet/
256x192_res50_lr1e-3_1x.yaml`): 256x192 crops, the SE-ResNet50
backbone (SE on each stage's first block, reduction 1), PixelShuffle(2),
DUC(512 -> 1024), DUC(256 -> 512), a 3x3 conv to 26 joint heatmaps at
64x48.  Sub-modules are named as the reference's (`preact.layer1.0.se.
fc.0`, `duc1.conv`, `conv_out`; a deformable block's
`preact.layer2.0.conv2_offset` and `conv2.weight`).  The `-dcn-` configs
(`256x192_res50_lr1e-3_2x-dcn.yaml`: STAGE_WITH_DCN [F, T, T, T]) make
stages 2-4 deformable.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from .blocks import DUC, ResNetBackbone


class SEResnet(ResNetBackbone):
    """SE-ResNet (`SE_Resnet.py`); `shuffle=True` is ShuffleResnet.
    `depths` (3, 4, 6, 3) / (3, 4, 23, 3) / (3, 8, 36, 3) are resnet
    50/101/152; `stage_with_dcn` gives the `-dcn-` configs' deformable
    stages."""

    def __init__(self, depths: Sequence[int] = (3, 4, 6, 3),
                 shuffle: bool = False,
                 stage_with_dcn: Sequence[bool] = (False,) * 4,
                 dcn_modulated: bool = False, deformable_groups: int = 1):
        super().__init__(depths, se=True, shuffle=shuffle,
                         stage_with_dcn=stage_with_dcn,
                         dcn_modulated=dcn_modulated,
                         deformable_groups=deformable_groups)


class FastPose(nn.Module):
    def __init__(self, num_joints: int = 26, conv_dim: int = 128,
                 stage_with_dcn: Sequence[bool] = (False,) * 4,
                 dcn_modulated: bool = False, deformable_groups: int = 1):
        super().__init__()
        self.num_joints = num_joints
        self.preact = SEResnet(stage_with_dcn=stage_with_dcn,
                               dcn_modulated=dcn_modulated,
                               deformable_groups=deformable_groups)
        self.suffle1 = nn.PixelShuffle(2)
        self.duc1 = DUC(512, 1024, 2)
        self.duc2 = DUC(256, 512 if conv_dim == 128 else 1024, 2)
        self.conv_out = nn.Conv2d(conv_dim, num_joints, 3, 1, 1)

    def forward(self, x):
        """x: (N, 3, 256, 192) normalized RGB crops -> (N, J, 64, 48)."""
        x = self.suffle1(self.preact(x))
        return self.conv_out(self.duc2(self.duc1(x)))
