"""Conv blocks of the detection nets, NCHW `nn.Module`s (port of
`detect/blocks.py`).

The sub-modules carry the names of the reference's torch modules
(`yolox/models/network_blocks.py`, AlphaPose's `SE_Resnet.py`,
`SE_module.py`, `DUC.py`, `ShuffleResnet.py`), so that a reference
`state_dict` loads with `load_state_dict`; JAX's `detect/convert.py` is
the map from those names to its flax trees.  Every BatchNorm is
`BatchNorm2d` with eps 1e-5, as JAX's (`blocks.py:19-30`): in eval mode
`nn.BatchNorm2d` itself, in train mode flax's update.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


class _GroupRef:
    """A process group held by reference: a model's deep copy shares it
    (a `ProcessGroup` cannot be copied)."""
    __slots__ = ("group",)

    def __init__(self, group):
        self.group = group

    def __deepcopy__(self, memo):
        return self


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train mode is flax's `BatchNorm` (JAX's
    `blocks.py:batch_norm`, momentum 0.9): it normalizes by the batch
    statistics and moves `running_mean` and `running_var` 0.1 of the way
    to the batch mean and the BIASED batch variance (`nn.BatchNorm2d`
    folds in the unbiased one).  Eval mode, the state-dict names and
    `num_batches_tracked` are `nn.BatchNorm2d`'s.

    With a process group (`set_batchnorm_group`) the batch is the global
    one, as in JAX's data-parallel step: one all_reduce of the rank's
    (sum, sum of squares, count) a forward, through which the gradient
    flows, so each rank's input gradient holds the other ranks' terms."""

    _group = _GroupRef(None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self._group.group is not None:
            return self._global_forward(x, self._group.group)
        with torch.no_grad():
            # flax's "fast variance": E[x^2] - E[x]^2, floored at 0.
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean,
                                  0.0)
            self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)

    @torch.no_grad()
    def _update_running(self, mean, var) -> None:
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        self.num_batches_tracked.add_(1)

    def _global_forward(self, x: torch.Tensor, group) -> torch.Tensor:
        from ..parallel.data_parallel import global_sum
        C = x.shape[1]
        sums = torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)),
                          x.new_full((1,), x.numel() // C)])
        sums = global_sum(sums, group, kind="bn")
        n = sums[2 * C]
        mean = sums[:C] / n
        var = torch.clamp_min(sums[C:2 * C] / n - mean * mean, 0.0)
        self._update_running(mean.detach(), var.detach())
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[None, :, None, None]) * scale[None, :, None, None]
                + self.bias[None, :, None, None])


def set_batchnorm_group(model: nn.Module, group) -> nn.Module:
    """Every `BatchNorm2d` of `model` takes its train-mode statistics over
    the ranks of `group` (None: this process's batch alone)."""
    ref = _GroupRef(group)
    for mod in model.modules():
        if isinstance(mod, BatchNorm2d):
            mod._group = ref
    return model


def activation(name: str) -> nn.Module:
    if name == "silu":
        return nn.SiLU()
    if name == "relu":
        return nn.ReLU()
    if name == "lrelu":
        return nn.LeakyReLU(0.1)
    raise ValueError(f"unknown activation {name!r}")


class BaseConv(nn.Module):
    """Conv -> BN -> activation (`network_blocks.py` `BaseConv`; JAX's
    `ConvBnAct`)."""

    def __init__(self, cin: int, cout: int, ksize: int, stride: int = 1,
                 groups: int = 1, bias: bool = False, act: str = "silu"):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, ksize, stride, (ksize - 1) // 2,
                              groups=groups, bias=bias)
        self.bn = BatchNorm2d(cout, eps=BN_EPS)
        self.act = activation(act)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class DWConv(nn.Module):
    """Depthwise + pointwise conv pair (`network_blocks.py:44-60`)."""

    def __init__(self, cin: int, cout: int, ksize: int, stride: int = 1,
                 act: str = "silu"):
        super().__init__()
        self.dconv = BaseConv(cin, cin, ksize, stride, groups=cin, act=act)
        self.pconv = BaseConv(cin, cout, 1, 1, act=act)

    def forward(self, x):
        return self.pconv(self.dconv(x))


def conv_block(depthwise: bool):
    return DWConv if depthwise else BaseConv


class Bottleneck(nn.Module):
    """YOLOX CSP bottleneck (`network_blocks.py:63-88`)."""

    def __init__(self, cin: int, cout: int, shortcut: bool = True,
                 expansion: float = 0.5, depthwise: bool = False):
        super().__init__()
        hidden = int(cout * expansion)
        self.conv1 = BaseConv(cin, hidden, 1, 1)
        self.conv2 = conv_block(depthwise)(hidden, cout, 3, 1)
        self.use_add = shortcut and cin == cout

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


class CSPLayer(nn.Module):
    """Cross-stage-partial layer (`network_blocks.py:121-167`)."""

    def __init__(self, cin: int, cout: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False):
        super().__init__()
        hidden = int(cout * expansion)
        self.conv1 = BaseConv(cin, hidden, 1, 1)
        self.conv2 = BaseConv(cin, hidden, 1, 1)
        self.conv3 = BaseConv(2 * hidden, cout, 1, 1)
        self.m = nn.Sequential(*[
            Bottleneck(hidden, hidden, shortcut, 1.0, depthwise)
            for _ in range(n)])

    def forward(self, x):
        a = self.m(self.conv1(x))
        b = self.conv2(x)
        return self.conv3(torch.cat([a, b], dim=1))


class Focus(nn.Module):
    """Space-to-depth stem (`network_blocks.py:170-192`): the
    top-left, bottom-left, top-right, bottom-right order."""

    def __init__(self, cin: int, cout: int, ksize: int = 3,
                 act: str = "silu"):
        super().__init__()
        self.conv = BaseConv(cin * 4, cout, ksize, 1, act=act)

    def forward(self, x):
        tl = x[..., ::2, ::2]
        tr = x[..., ::2, 1::2]
        bl = x[..., 1::2, ::2]
        br = x[..., 1::2, 1::2]
        return self.conv(torch.cat([tl, bl, tr, br], dim=1))


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling (`network_blocks.py:91-118`)."""

    def __init__(self, cin: int, cout: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13),
                 act: str = "silu"):
        super().__init__()
        hidden = cin // 2
        self.conv1 = BaseConv(cin, hidden, 1, 1, act=act)
        self.m = nn.ModuleList([nn.MaxPool2d(k, 1, k // 2)
                                for k in kernel_sizes])
        self.conv2 = BaseConv(hidden * (len(kernel_sizes) + 1), cout, 1, 1,
                              act=act)

    def forward(self, x):
        x = self.conv1(x)
        return self.conv2(torch.cat([x] + [m(x) for m in self.m], dim=1))


# ---------------------------------------------------------------------------
# ResNet blocks (the pose nets' backbones).
# ---------------------------------------------------------------------------

class SELayer(nn.Module):
    """Squeeze-excite with reduction 1 (`SE_module.py:10-24`)."""

    def __init__(self, channels: int, reduction: int = 1):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(channels, channels // reduction),
                                nn.ReLU(),
                                nn.Linear(channels // reduction, channels),
                                nn.Sigmoid())

    def forward(self, x):
        y = self.fc(x.mean(dim=(2, 3)))
        return x * y[:, :, None, None]


class ResBottleneck(nn.Module):
    """ResNet-50 bottleneck with optional SE (`SE_Resnet.py:59-141`);
    `shuffle=True` is the ShuffleResnet variant, whose strided conv2 is
    PixelUnshuffle(stride) + a stride-1 conv (`ShuffleResnet.py:60-123`).
    `dcn=True` makes conv2 deformable (`SE_Resnet.py:72-101,117-127`): a
    3x3 conv `conv2_offset` (with bias) predicts the offsets, and for
    DCNv2 (`dcn_modulated`) the mask as the sigmoid of its last 9*dg
    channels, and `conv2` (a `DeformConv2d`, no bias) samples and
    contracts."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, se: bool = False,
                 shuffle: bool = False, dcn: bool = False,
                 dcn_modulated: bool = False, deformable_groups: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=BN_EPS)
        self.dcn = dcn
        self.dcn_modulated = dcn_modulated
        self.deformable_groups = deformable_groups
        if dcn:
            if shuffle:
                raise ValueError("a deformable conv2 in a ShuffleResnet "
                                 "block is not supported")
            from .deform_conv import DeformConv2d
            offc = deformable_groups * (27 if dcn_modulated else 18)
            self.conv2_offset = nn.Conv2d(planes, offc, 3, stride, 1)
            self.conv2 = DeformConv2d(planes, planes, 3, stride, 1,
                                      deformable_groups)
        elif shuffle and stride > 1:
            self.conv2 = nn.Sequential(
                PixelUnshuffle(stride),
                nn.Conv2d(planes * stride * stride, planes, 3, 1, 1,
                          bias=False))
        else:
            self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes, eps=BN_EPS)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4, eps=BN_EPS)
        self.se = SELayer(planes * 4) if se else None
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
            BatchNorm2d(planes * 4, eps=BN_EPS)) if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        if self.dcn:
            om = self.conv2_offset(out)
            dg = self.deformable_groups
            if self.dcn_modulated:
                out = self.conv2(out, om[:, :18 * dg],
                                 torch.sigmoid(om[:, -9 * dg:]))
            else:
                out = self.conv2(out, om)
        else:
            out = self.conv2(out)
        out = F.relu(self.bn2(out))
        out = self.bn3(self.conv3(out))
        if self.se is not None:
            out = self.se(out)
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetBackbone(nn.Module):
    """The bottleneck ResNet of the pose nets (`SE_Resnet.py`,
    `Resnet.py`, `ShuffleResnet.py`): a 7x7 stem, max pool and four
    stages; `se` puts squeeze-excite on each stage's first block, and
    `stage_with_dcn` makes every conv2 of a stage deformable
    (`SE_Resnet.py:147,171`)."""

    def __init__(self, depths: Sequence[int] = (3, 4, 6, 3),
                 se: bool = False, shuffle: bool = False,
                 stage_with_dcn: Sequence[bool] = (False,) * 4,
                 dcn_modulated: bool = False, deformable_groups: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=BN_EPS)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for s, (planes, stride, blocks) in enumerate(
                zip((64, 128, 256, 512), (1, 2, 2, 2), depths)):
            layers = []
            for b in range(blocks):
                layers.append(ResBottleneck(
                    inplanes, planes, stride if b == 0 else 1,
                    downsample=b == 0, se=se and b == 0, shuffle=shuffle,
                    dcn=bool(stage_with_dcn[s]), dcn_modulated=dcn_modulated,
                    deformable_groups=deformable_groups))
                inplanes = planes * 4
            setattr(self, f"layer{s + 1}", nn.Sequential(*layers))

    def forward(self, x):
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


class PixelUnshuffle(nn.Module):
    """Space-to-depth in the reference's channel order
    (`layers/PixelUnshuffle.py:20-28`): output channel (c*r + i)*r + j
    holds input channel c at offset (i, j), as `F.pixel_unshuffle`."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        return F.pixel_unshuffle(x, self.factor)


class DUC(nn.Module):
    """Dense upsampling conv (`DUC.py:9-29`): conv-BN-ReLU, then
    PixelShuffle."""

    def __init__(self, inplanes: int, planes: int, upscale_factor: int = 2):
        super().__init__()
        self.conv = nn.Conv2d(inplanes, planes, 3, padding=1, bias=False)
        self.bn = BatchNorm2d(planes, eps=BN_EPS)
        self.relu = nn.ReLU()
        self.pixel_shuffle = nn.PixelShuffle(upscale_factor)

    def forward(self, x):
        return self.pixel_shuffle(self.relu(self.bn(self.conv(x))))
