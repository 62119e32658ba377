"""YOLOv3-style Darknet-53 + FPN neck, NCHW `nn.Module`s (port of
`detect/yolo_fpn.py`).

The reference's `YOLOFPN` over the classic `Darknet` backbone
(`yolox/models/yolo_fpn.py:12-84`, `yolox/models/darknet.py:10-94`).  No
predictor uses it (the PAFPN of `yolox.py` is the production neck); it
is part of the reference's model surface.  The sub-modules carry the
reference's names (`backbone.stem.0`, `backbone.dark5.<n>`, `out1_cbl`,
`out1.<i>`, ...), so its `state_dict` loads as is;
`weights.yolo_fpn_state_from_flax` carries JAX's parameters across.
Every conv is BaseConv with LeakyReLU 0.1.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BaseConv, SPPBottleneck

DEPTH_BLOCKS = {21: (1, 2, 2, 1), 53: (2, 8, 8, 4)}


def _cbl(cin: int, cout: int, ksize: int, stride: int = 1) -> BaseConv:
    return BaseConv(cin, cout, ksize, stride, act="lrelu")


class ResLayer(nn.Module):
    """Darknet residual block (`network_blocks.py:104-119`): 1x1 halve ->
    3x3 restore -> add."""

    def __init__(self, c: int):
        super().__init__()
        self.layer1 = _cbl(c, c // 2, 1)
        self.layer2 = _cbl(c // 2, c, 3)

    def forward(self, x):
        return x + self.layer2(self.layer1(x))


def _group(cin: int, n: int) -> list:
    """`make_group_layer` (`darknet.py:59-64`): stride-2 channel doubling
    conv, then n residual blocks."""
    return [_cbl(cin, 2 * cin, 3, 2)] + [ResLayer(2 * cin)
                                         for _ in range(n)]


class Darknet(nn.Module):
    """Darknet-21/53 backbone (`darknet.py:10-94`).

    Returns (dark3, dark4, dark5) at strides (8, 16, 32) with (256, 512,
    512) channels at stem_out=32; dark5 ends in the SPP block that halves
    its channels (`darknet.py:54-57,66-80`).
    """

    def __init__(self, depth: int = 53, stem_out: int = 32):
        super().__init__()
        blocks = DEPTH_BLOCKS[depth]
        c = stem_out
        self.stem = nn.Sequential(_cbl(3, c, 3), *_group(c, 1))
        self.dark2 = nn.Sequential(*_group(2 * c, blocks[0]))
        self.dark3 = nn.Sequential(*_group(4 * c, blocks[1]))
        self.dark4 = nn.Sequential(*_group(8 * c, blocks[2]))
        c5 = 32 * c
        # SPP tail (`make_spp_block`, `darknet.py:66-80`).
        self.dark5 = nn.Sequential(
            *_group(16 * c, blocks[3]), _cbl(c5, c5 // 2, 1),
            _cbl(c5 // 2, c5, 3), SPPBottleneck(c5, c5 // 2, act="lrelu"),
            _cbl(c5 // 2, c5, 3), _cbl(c5, c5 // 2, 1))

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.dark2(self.stem(x))
        c3 = self.dark3(x)
        c4 = self.dark4(c3)
        return c3, c4, self.dark5(c4)


def _embedding(cin: int, f0: int, f1: int) -> nn.Sequential:
    """`_make_embedding` (`yolo_fpn.py:41-51`): 1-3-1-3-1 convs."""
    return nn.Sequential(_cbl(cin, f0, 1), _cbl(f0, f1, 3), _cbl(f1, f0, 1),
                         _cbl(f0, f1, 3), _cbl(f1, f0, 1))


class YOLOFPN(nn.Module):
    """YOLOv3 FPN neck (`yolo_fpn.py:12-84`): top-down only, concat +
    5-conv embedding per level.  Returns (out_dark3, out_dark4, dark5)
    at strides (8, 16, 32) with (128, 256, 512) channels."""

    def __init__(self, depth: int = 53):
        super().__init__()
        self.backbone = Darknet(depth)
        self.out1_cbl = _cbl(512, 256, 1)
        self.out1 = _embedding(512 + 256, 256, 512)
        self.out2_cbl = _cbl(256, 128, 1)
        self.out2 = _embedding(256 + 128, 128, 256)

    def forward(self, x):
        c3, c4, c5 = self.backbone(x)
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        out_dark4 = self.out1(torch.cat([up(self.out1_cbl(c5)), c4], dim=1))
        out_dark3 = self.out2(torch.cat([up(self.out2_cbl(out_dark4)), c3],
                                        dim=1))
        return out_dark3, out_dark4, c5
