"""Weights of the detection nets: reference checkpoints, flax trees and
seeded random weights.

The port's modules are named as the reference's torch modules, so a
reference checkpoint (`bytetrack_x_mot17.pth.tar` for YOLOX,
`fast_res50_256x192.pth` for FastPose) loads with `load_state_dict`
once `load_checkpoint` has unwrapped it.  `yolox_state_from_flax`,
`pose_state_from_flax`, `hybrik_state_from_flax` and
`yolo_fpn_state_from_flax` invert JAX's converters
(`detect/convert.py:74-515`): they turn a flax `{"params",
"batch_stats"}` tree of arrays back into the reference's `state_dict`,
so weights held by the JAX package carry across.  Conv kernels go (kH,
kW, I, O) -> (O, I, kH, kW), dense kernels are transposed,
transposed-conv kernels flipped back, BatchNorm scale/bias/mean/var
become weight/bias/running_mean/running_var (with `num_batches_tracked`
0).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's state_dict on the CPU, unwrapped from its
    `model` or `state_dict` entry as JAX's `load_torch_state_dict` does
    (`convert.py:74-81`)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def random_state_dict(model: nn.Module, generator: torch.Generator
                      ) -> Dict[str, torch.Tensor]:
    """Seeded random weights for `model` in its own names: conv and dense
    weights N(0, 1/fan_in), biases N(0, 0.1^2), BatchNorm weights U(0.5,
    1.5), biases N(0, 0.1^2), running means N(0, 0.2^2) and variances
    U(0.5, 1.5), so that activations keep their scale through deep nets."""
    g = generator
    out = {}
    bn_types = (nn.BatchNorm2d,)
    for mname, mod in model.named_modules():
        prefix = f"{mname}." if mname else ""
        for pname, p in mod.named_parameters(recurse=False):
            shape = p.shape
            if isinstance(mod, bn_types):
                v = (0.5 + torch.rand(shape, generator=g) if pname == "weight"
                     else 0.1 * torch.randn(shape, generator=g))
            elif pname == "weight":
                fan_in = nn.init._calculate_fan_in_and_fan_out(p)[0]
                v = torch.randn(shape, generator=g) / fan_in ** 0.5
            else:
                v = 0.1 * torch.randn(shape, generator=g)
            out[prefix + pname] = v
        for bname, b in mod.named_buffers(recurse=False):
            if bname == "running_mean":
                v = 0.2 * torch.randn(b.shape, generator=g)
            elif bname == "running_var":
                v = 0.5 + torch.rand(b.shape, generator=g)
            else:
                v = torch.zeros_like(b)
            out[prefix + bname] = v
    return out


# ---- flax trees -> reference state_dicts ----------------------------------

class _Inverse:
    """Reads a flax tree and writes reference-named numpy arrays."""

    def __init__(self, variables: Mapping):
        self.p = variables["params"]
        self.s = variables.get("batch_stats", {})
        self.sd: Dict[str, np.ndarray] = {}

    @staticmethod
    def _at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def has(self, path) -> bool:
        try:
            self._at(self.p, path)
            return True
        except KeyError:
            return False

    def conv(self, path, key: str, bias: bool = False) -> None:
        k = np.asarray(self._at(self.p, path + ("kernel",)))
        self.sd[key + ".weight"] = np.ascontiguousarray(
            k.transpose(3, 2, 0, 1))
        if bias:
            self.sd[key + ".bias"] = np.asarray(
                self._at(self.p, path + ("bias",)))

    def deconv(self, path, key: str) -> None:
        k = np.asarray(self._at(self.p, path + ("kernel",)))
        self.sd[key + ".weight"] = np.ascontiguousarray(
            k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])

    def dense(self, path, key: str) -> None:
        self.sd[key + ".weight"] = np.ascontiguousarray(
            np.asarray(self._at(self.p, path + ("kernel",))).T)
        self.sd[key + ".bias"] = np.asarray(self._at(self.p,
                                                     path + ("bias",)))

    def bn(self, path, key: str) -> None:
        self.sd[key + ".weight"] = np.asarray(self._at(self.p,
                                                       path + ("scale",)))
        self.sd[key + ".bias"] = np.asarray(self._at(self.p,
                                                     path + ("bias",)))
        self.sd[key + ".running_mean"] = np.asarray(
            self._at(self.s, path + ("mean",)))
        self.sd[key + ".running_var"] = np.asarray(
            self._at(self.s, path + ("var",)))
        self.sd[key + ".num_batches_tracked"] = np.zeros((), np.int64)

    def convbn(self, path, key: str) -> None:
        """JAX's ConvBnAct {conv, bn} -> YOLOX BaseConv `.conv` / `.bn`."""
        self.conv(path + ("conv",), key + ".conv")
        self.bn(path + ("bn",), key + ".bn")

    def convbn_numbered(self, path, key: str, n: str) -> None:
        """JAX's ConvBnAct {conv, bn} -> ResNet `.conv<n>` / `.bn<n>`."""
        self.conv(path + ("conv",), f"{key}.conv{n}")
        self.bn(path + ("bn",), f"{key}.bn{n}")

    def csp(self, path, key: str) -> None:
        for c in ("conv1", "conv2", "conv3"):
            self.convbn(path + (c,), f"{key}.{c}")
        i = 0
        while self.has(path + (f"m{i}",)):
            for c in ("conv1", "conv2"):
                self.convbn(path + (f"m{i}", c), f"{key}.m.{i}.{c}")
            i += 1

    def bottleneck(self, path, src: str, conv2: str) -> None:
        """One ResNet bottleneck: conv1/bn1, conv2 (at `conv2`; JAX's
        deformable `conv2` block as `conv2_offset` + `conv2.weight`),
        bn2, conv3/bn3, SE and downsample where present."""
        self.convbn_numbered(path + ("conv1",), src, "1")
        if self.has(path + ("conv2", "kernel")):
            self.conv(path + ("conv2", "conv2_offset"),
                      f"{src}.conv2_offset", bias=True)
            self.conv(path + ("conv2",), f"{src}.conv2")
            self.bn(path + ("bn2",), f"{src}.bn2")
        else:
            self.conv(path + ("conv2", "conv"), conv2)
            self.bn(path + ("conv2", "bn"), f"{src}.bn2")
        self.conv(path + ("conv3",), f"{src}.conv3")
        self.bn(path + ("bn3",), f"{src}.bn3")
        if self.has(path + ("se",)):
            self.dense(path + ("se", "fc1"), f"{src}.se.fc.0")
            self.dense(path + ("se", "fc2"), f"{src}.se.fc.2")
        if self.has(path + ("down_conv",)):
            self.conv(path + ("down_conv",), f"{src}.downsample.0")
            self.bn(path + ("down_bn",), f"{src}.downsample.1")

    def resnet(self, root: str, key: str, shuffle: bool = False) -> None:
        """Inverse of `_resnet_backbone` / the FastPose backbone: stages
        and blocks as the tree holds them, SE, downsample and deformable
        conv2s where present, ShuffleResnet's strided conv2 as
        `conv2.1`."""
        self.convbn_numbered((root, "stem"), key, "1")
        for s in range(4):
            b = 0
            while self.has((root, f"layer{s + 1}_{b}")):
                src = f"{key}.layer{s + 1}.{b}"
                c2 = (f"{src}.conv2.1" if shuffle and s > 0 and b == 0
                      else f"{src}.conv2")
                self.bottleneck((root, f"layer{s + 1}_{b}"), src, c2)
                b += 1

    def hardnet_layer(self, path, key: str) -> None:
        """A HarDNet ConvLayer {conv, norm} -> `.conv` / `.norm`."""
        self.conv(path + ("conv",), key + ".conv")
        self.bn(path + ("norm",), key + ".norm")

    def hardnet_block(self, name: str, key: str) -> None:
        i = 0
        while self.has((name, f"l{i}")):
            self.hardnet_layer((name, f"l{i}"), f"{key}.layers.{i}")
            i += 1

    def deconv_head(self) -> None:
        """SimplePose's `deconv_layers` (ConvTranspose, BN, ReLU)s and
        its 1x1 `final_layer`."""
        i = 0
        while self.has((f"deconv{i + 1}",)):
            self.deconv((f"deconv{i + 1}",), f"deconv_layers.{3 * i}")
            self.bn((f"bn{i + 1}",), f"deconv_layers.{3 * i + 1}")
            i += 1
        self.conv(("final",), "final_layer", bias=True)

    def duc_stage(self, path, key: str) -> None:
        """Inverse of JAX's `_duc_stage`: convs at Sequential positions
        1 + 3i, their BNs at 2 + 3i."""
        n = 0
        while self.has(path + (f"conv{n}",)):
            n += 1
        for i in range(n):
            self.conv(path + (f"conv{i}",), f"{key}.{1 + 3 * i}")
            self.bn(path + (f"bn{i}",), f"{key}.{2 + 3 * i}")
        last = 1 + 3 * n
        self.conv(path + ("conv_out",), f"{key}.{last}")
        self.bn(path + ("bn_out",), f"{key}.{last + 1}")


def yolox_state_from_flax(variables: Mapping, depth_mul: float = 1.33
                          ) -> Dict[str, np.ndarray]:
    """Inverse of JAX's `convert_yolox_sd`: YOLOX flax variables -> the
    reference's state_dict (numpy).  The CSP depths are read from the
    tree; `depth_mul` is accepted for symmetry with the converter."""
    del depth_mul
    t = _Inverse(variables)
    bb, fb = "backbone.backbone", ("fpn", "backbone")
    t.convbn(fb + ("stem", "conv"), bb + ".stem.conv")
    for name in ("dark2", "dark3", "dark4"):
        t.convbn(fb + (f"{name}_conv",), f"{bb}.{name}.0")
        t.csp(fb + (f"{name}_csp",), f"{bb}.{name}.1")
    t.convbn(fb + ("dark5_conv",), bb + ".dark5.0")
    t.convbn(fb + ("dark5_spp", "conv1"), bb + ".dark5.1.conv1")
    t.convbn(fb + ("dark5_spp", "conv2"), bb + ".dark5.1.conv2")
    t.csp(fb + ("dark5_csp",), bb + ".dark5.2")
    for name in ("lateral_conv0", "reduce_conv1", "bu_conv2", "bu_conv1"):
        t.convbn(("fpn", name), f"backbone.{name}")
    for name in ("C3_p4", "C3_p3", "C3_n3", "C3_n4"):
        t.csp(("fpn", name), f"backbone.{name}")
    i = 0
    while t.has(("head", f"stem{i}")):
        t.convbn(("head", f"stem{i}"), f"head.stems.{i}")
        for j in range(2):
            t.convbn(("head", f"cls_conv{i}_{j}"), f"head.cls_convs.{i}.{j}")
            t.convbn(("head", f"reg_conv{i}_{j}"), f"head.reg_convs.{i}.{j}")
        for pred in ("cls", "reg", "obj"):
            t.conv(("head", f"{pred}_pred{i}"), f"head.{pred}_preds.{i}",
                   bias=True)
        i += 1
    return t.sd


def _hrnet_state(t: _Inverse) -> None:
    """Inverse of JAX's `convert_hrnet_sd` (module counts read from the
    tree)."""
    for n in ("1", "2"):
        t.conv((f"stem{n}", "conv"), f"conv{n}")
        t.bn((f"stem{n}", "bn"), f"bn{n}")
    for b in range(4):
        t.bottleneck((f"layer1_{b}",), f"layer1.{b}", f"layer1.{b}.conv2")
    for dst, src in (("t1_b0", "transition1.0"),
                     ("t1_b1", "transition1.1.0"),
                     ("t2_b2", "transition2.2.0"),
                     ("t3_b3", "transition3.3.0")):
        t.conv((dst, "conv"), f"{src}.0")
        t.bn((dst, "bn"), f"{src}.1")
    for stage, nb in ((2, 2), (3, 3), (4, 4)):
        m = 0
        while t.has((f"stage{stage}_m{m}",)):
            dst, src = f"stage{stage}_m{m}", f"stage{stage}.{m}"
            for i in range(nb):
                for blk in range(4):
                    p = (dst, f"branch{i}_block{blk}")
                    s = f"{src}.branches.{i}.{blk}"
                    t.convbn_numbered(p + ("conv1",), s, "1")
                    t.conv(p + ("conv2",), f"{s}.conv2")
                    t.bn(p + ("bn2",), f"{s}.bn2")
            for i in range(nb):
                for j in range(nb):
                    f = f"{src}.fuse_layers.{i}.{j}"
                    if t.has((dst, f"fuse{i}_{j}_conv")):
                        t.conv((dst, f"fuse{i}_{j}_conv"), f"{f}.0")
                        t.bn((dst, f"fuse{i}_{j}_bn"), f"{f}.1")
                    k = 0
                    while t.has((dst, f"fuse{i}_{j}_d{k}_conv")):
                        t.conv((dst, f"fuse{i}_{j}_d{k}_conv"), f"{f}.{k}.0")
                        t.bn((dst, f"fuse{i}_{j}_d{k}_bn"), f"{f}.{k}.1")
                        k += 1
            m += 1
    t.conv(("final",), "final_layer", bias=True)


def _hardnet_state(t: _Inverse) -> None:
    """Inverse of JAX's `convert_hardnet_sd` (arch 68: base Sequential
    positions 0-1 convs, 3/6/8/11 blocks, 4/7/9 projections)."""
    t.hardnet_layer(("base0",), "base.0")
    t.hardnet_layer(("base1",), "base.1")
    for i, (blk, proj) in enumerate(((3, 4), (6, 7), (8, 9), (11, None))):
        t.hardnet_block(f"blk{i}", f"base.{blk}")
        if proj is not None:
            t.hardnet_layer((f"proj{i}",), f"base.{proj}")
    t.hardnet_layer(("last_proj",), "last_proj")
    t.hardnet_block("last_blk", "last_blk")
    for i in range(3):
        t.hardnet_layer((f"up_proj{i}",), f"conv1x1_up.{i}")
        t.hardnet_block(f"up_blk{i}", f"denseBlocksUp.{i}")
    t.conv(("head0",), "conv_out.0", bias=True)
    t.conv(("head1",), "conv_out.2", bias=True)


def pose_state_from_flax(name: str, variables: Mapping,
                         shuffle: bool = False) -> Dict[str, np.ndarray]:
    """Inverse of JAX's pose converters (`convert_fastpose_sd`,
    `convert_simplepose_sd`, `convert_hrnet_sd`, `convert_hardnet_sd`,
    `convert_fastpose_duc_sd`, `convert_fastpose_duc_dense_sd`) for the
    zoo net `name`; `shuffle=True` for a ShuffleResnet backbone.  A
    FastPose tree with deformable blocks (JAX's `DeformConvBlock`, which
    `convert_fastpose_sd` does not fill) gives `conv2_offset` and the
    deformable `conv2.weight` in the reference's names."""
    from .zoo import zoo_key
    key = zoo_key(name)
    t = _Inverse(variables)
    if key == "hrnet":
        _hrnet_state(t)
        return t.sd
    if key == "hardnet":
        _hardnet_state(t)
        return t.sd
    if key not in ("fastpose", "simplepose", "fastpose_duc",
                   "fastpose_duc_dense"):
        raise ValueError(f"unknown pose model {name!r}")
    t.resnet("preact", "preact", shuffle=shuffle)
    if key == "fastpose":
        for duc in ("duc1", "duc2"):
            t.conv((duc, "conv", "conv"), f"{duc}.conv")
            t.bn((duc, "conv", "bn"), f"{duc}.bn")
        t.conv(("conv_out",), "conv_out", bias=True)
    elif key == "simplepose":
        t.deconv_head()
    elif key == "fastpose_duc":
        for k in range(3):
            t.duc_stage((f"duc{k + 1}",), f"duc{k + 1}")
        t.conv(("conv_out",), "conv_out", bias=True)
    else:
        for k in range(3):
            t.duc_stage((f"duc{k + 1}",), f"duc.{k}")
            t.duc_stage((f"duc_dense{k + 1}",), f"duc_dense.{k}")
        t.conv(("conv_out",), "conv_out", bias=True)
        t.conv(("conv_out_dense",), "conv_out_dense", bias=True)
    return t.sd


def hybrik_state_from_flax(variables: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of JAX's `convert_hybrik_sd` (`convert.py:452-468`):
    `Simple3DPoseSMPLCam` flax variables -> the reference's
    `simple3dposeSMPLWithCam` state_dict (numpy)."""
    t = _Inverse(variables)
    t.resnet("preact", "preact")
    t.deconv_head()
    for name in ("fc1", "fc2", "decshape", "decphi", "deccam"):
        t.dense((name,), name)
    return t.sd


def yolo_fpn_state_from_flax(variables: Mapping, depth: int = 53
                             ) -> Dict[str, np.ndarray]:
    """Inverse of JAX's `convert_yolo_fpn_sd` (`convert.py:476-515`):
    `YOLOFPN` flax variables -> the reference's state_dict (numpy), in
    the names `yolo_fpn.YOLOFPN` carries."""
    from .yolo_fpn import DEPTH_BLOCKS
    t = _Inverse(variables)
    bb = ("backbone",)
    t.convbn(bb + ("stem0",), "backbone.stem.0")
    t.convbn(bb + ("stem1_conv",), "backbone.stem.1")
    for layer in ("layer1", "layer2"):
        t.convbn(bb + ("stem1_res0", layer), f"backbone.stem.2.{layer}")
    blocks = DEPTH_BLOCKS[depth]
    for name, n in zip(("dark2", "dark3", "dark4", "dark5"), blocks):
        t.convbn(bb + (f"{name}_conv",), f"backbone.{name}.0")
        for i in range(n):
            for layer in ("layer1", "layer2"):
                t.convbn(bb + (f"{name}_res{i}", layer),
                         f"backbone.{name}.{i + 1}.{layer}")
    for j, src in enumerate(("dark5_spp0", "dark5_spp1", None,
                             "dark5_spp3", "dark5_spp4")):
        key = f"backbone.dark5.{blocks[3] + 1 + j}"
        if src is None:                   # the SPPBottleneck itself
            for c in ("conv1", "conv2"):
                t.convbn(bb + ("dark5_spp2", c), f"{key}.{c}")
        else:
            t.convbn(bb + (src,), key)
    for out in ("out1", "out2"):
        t.convbn((f"{out}_cbl",), f"{out}_cbl")
        for i in range(5):
            t.convbn((f"{out}_{i}",), f"{out}.{i}")
    return t.sd
