"""The pose nets the port added for `--pose_cfg` and `--pose_model`:
deformable convolution, the DCN FastPose, HRNet and HarDNet-68, against
the JAX package (`mvsmplfitting_tpu.detect`) on the same inputs.

Weights are a random state_dict in the reference's names made with numpy
from a seed (`numpy_state`); JAX takes them through its `convert_*_sd`
and the port through `load_state_dict`, and the port's inverses
(`detect/weights.py`) must give the state_dict back.  Forwards are held
at JAX's detect tolerances (`tests/test_detect.py:582,652`: atol 2e-4,
rtol 1e-3).  JAX's `convert_fastpose_sd` does not map a deformable
block's `conv2_offset` (so a reference DCN checkpoint cannot load into
JAX's net); its flax tree is completed here by hand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import numpy_state, to_tensors

from mvsmplfitting_tpu.detect import convert as JC
from mvsmplfitting_tpu.detect import deform_conv as JDC
from mvsmplfitting_tpu_torch.detect import deform_conv as TDC
from mvsmplfitting_tpu_torch.detect import weights as W

ATOL, RTOL = 2e-4, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def nhwc(x):
    return np.asarray(x).transpose(0, 2, 3, 1)


# ---- deformable convolution ----------------------------------------------------

@pytest.mark.parametrize("stride,dg,groups,modulated", [
    (1, 1, 1, False), (2, 2, 1, True), (1, 2, 2, True)])
def test_deform_conv2d_matches_jax(stride, dg, groups, modulated):
    rng = np.random.default_rng(10 + stride + dg + groups)
    B, C, H, Wd, Co = 2, 8, 11, 9, 6
    OH, OW = (H - 1) // stride + 1, (Wd - 1) // stride + 1
    x = rng.standard_normal((B, C, H, Wd)).astype(np.float32)
    # Offsets of a few pixels: a share of the taps leave the image.
    off = (3.0 * rng.standard_normal((B, dg * 18, OH, OW))).astype(np.float32)
    mask = (rng.uniform(0, 1, (B, dg * 9, OH, OW)).astype(np.float32)
            if modulated else None)
    w = rng.standard_normal((Co, C // groups, 3, 3)).astype(np.float32)
    b = rng.standard_normal(Co).astype(np.float32)
    want = jax.jit(lambda *a: JDC.deform_conv2d(
        a[0], a[1], a[2], stride=stride, padding=1, groups=groups,
        deformable_groups=dg, mask=a[3], bias=a[4]))(
        nhwc(x), nhwc(off), w.transpose(2, 3, 1, 0),
        None if mask is None else nhwc(mask), b)
    got = TDC.deform_conv2d(
        torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(w),
        stride, 1, groups=groups, deformable_groups=dg,
        mask=None if mask is None else torch.from_numpy(mask),
        bias=torch.from_numpy(b))
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    # the offsets reach past the image: zero taps are exercised
    oy = np.arange(OH)[:, None] * stride - 1 + off[:, 0::2].reshape(
        B, dg, 9, OH, OW).transpose(0, 1, 3, 4, 2)[..., 0]
    assert ((oy <= -1) | (oy >= H)).mean() > 0.05
    # chunked im2col gives the same result
    small = TDC.COL_BYTES
    try:
        TDC.COL_BYTES = 1
        again = TDC.deform_conv2d(
            torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(w),
            stride, 1, groups=groups, deformable_groups=dg,
            mask=None if mask is None else torch.from_numpy(mask),
            bias=torch.from_numpy(b))
    finally:
        TDC.COL_BYTES = small
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_offset_mask_split_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 27, 5, 4)).astype(
        np.float32)
    got = TDC.dcn_offset_mask_split(torch.from_numpy(x))
    want = JDC.dcn_offset_mask_split(jnp.asarray(nhwc(x)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g.numpy()), np.asarray(w),
                                   atol=1e-6)


# ---- the nets -------------------------------------------------------------------

def dcn_variables(sd):
    """JAX's FastPose variables for a DCN state_dict: `convert_fastpose_sd`
    and, for each deformable block, its `conv2` as JAX's DeformConvBlock
    ({conv2_offset, kernel}) with bn2 beside it."""
    v = JC.convert_fastpose_sd(sd)
    for name, p in v["params"]["preact"].items():
        if not name.startswith("layer"):
            continue
        src = "preact.layer{}.{}".format(*name[len("layer"):].split("_"))
        if src + ".conv2_offset.weight" not in sd:
            continue
        conv2 = p.pop("conv2")
        p["conv2"] = {"conv2_offset": {
            "kernel": np.transpose(sd[src + ".conv2_offset.weight"],
                                   (2, 3, 1, 0)),
            "bias": sd[src + ".conv2_offset.bias"]},
            "kernel": conv2["conv"]["kernel"]}
        p["bn2"] = conv2["bn"]
        st = v["batch_stats"]["preact"][name]
        st["bn2"] = st.pop("conv2")["bn"]
    return v


def _cases():
    from mvsmplfitting_tpu.detect import fastpose as jf
    from mvsmplfitting_tpu.detect import hardnet as jh
    from mvsmplfitting_tpu.detect import hrnet as jr
    from mvsmplfitting_tpu_torch.detect import fastpose as tf
    from mvsmplfitting_tpu_torch.detect import hardnet as th
    from mvsmplfitting_tpu_torch.detect import hrnet as tr
    dcn = (False, True, True, True)
    return {
        # (port net, JAX net, JAX variables from a state_dict, zoo name,
        #  input size)
        "fastpose_dcn": (lambda: tf.FastPose(26, stage_with_dcn=dcn),
                         lambda: jf.FastPose(26, stage_with_dcn=dcn),
                         dcn_variables, "fastpose", (64, 48)),
        "hrnet": (lambda: tr.PoseHRNet(17, width=8, stage_modules=(1, 1, 2)),
                  lambda: jr.PoseHRNet(17, width=8, stage_modules=(1, 1, 2)),
                  lambda sd: JC.convert_hrnet_sd(sd, (1, 1, 2)), "hrnet",
                  (64, 64)),
        "hardnet": (lambda: th.HarDNetPose(17), lambda: jh.HarDNetPose(17),
                    JC.convert_hardnet_sd, "hardnet", (64, 64)),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_net_matches_jax_and_round_trips(case):
    make_port, make_jax, variables_of, zoo, hw = _cases()[case]
    port = make_port()
    sd = numpy_state(port, 5)
    for k in sd:
        if k.endswith("conv2_offset.weight"):
            sd[k] = sd[k] * 4.0        # offsets of a few pixels
    variables = variables_of(sd)
    back = W.pose_state_from_flax(zoo, variables)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    port.load_state_dict(to_tensors(sd))
    port.eval()
    x = np.random.default_rng(6).standard_normal((2, 3) + hw).astype(
        np.float32)
    want = np.asarray(jax.jit(make_jax().apply)(variables,
                                                jnp.asarray(nhwc(x))))
    with torch.no_grad():
        got = nhwc(port(torch.from_numpy(x)).numpy())
    assert got.shape == want.shape and got.shape[-1] == port.num_joints
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_modulated_dcn_bottleneck_matches_jax():
    """A DCNv2 bottleneck (mask = sigmoid of the offset conv's last 9*dg
    channels, two deformable groups, strided, SE and downsample) against
    JAX's `ResBottleneck`."""
    from mvsmplfitting_tpu.detect.blocks import ResBottleneck as JBlock
    from mvsmplfitting_tpu_torch.detect.blocks import ResBottleneck
    port = ResBottleneck(32, 16, 2, downsample=True, se=True, dcn=True,
                         dcn_modulated=True, deformable_groups=2)
    sd = numpy_state(port, 9)
    sd["conv2_offset.weight"] *= 4.0
    port.load_state_dict(to_tensors(sd))
    port.eval()

    def conv(k):
        return {"kernel": np.transpose(sd[k + ".weight"], (2, 3, 1, 0))}

    def bn(k):
        return ({"scale": sd[k + ".weight"], "bias": sd[k + ".bias"]},
                {"mean": sd[k + ".running_mean"],
                 "var": sd[k + ".running_var"]})

    def dense(k):
        return {"kernel": sd[k + ".weight"].T, "bias": sd[k + ".bias"]}

    params = {"conv1": {"conv": conv("conv1"), "bn": bn("bn1")[0]},
              "conv2": {"conv2_offset": dict(conv("conv2_offset"),
                                             bias=sd["conv2_offset.bias"]),
                        "kernel": conv("conv2")["kernel"]},
              "bn2": bn("bn2")[0], "conv3": conv("conv3"),
              "bn3": bn("bn3")[0], "down_conv": conv("downsample.0"),
              "down_bn": bn("downsample.1")[0],
              "se": {"fc1": dense("se.fc.0"), "fc2": dense("se.fc.2")}}
    stats = {"conv1": {"bn": bn("bn1")[1]}, "bn2": bn("bn2")[1],
             "bn3": bn("bn3")[1], "down_bn": bn("downsample.1")[1]}
    x = np.random.default_rng(8).standard_normal((2, 32, 12, 10)).astype(
        np.float32)
    jb = JBlock(16, 2, downsample=True, se=True, dcn=True,
                dcn_modulated=True, deformable_groups=2)
    want = jax.jit(jb.apply)({"params": params, "batch_stats": stats},
                             nhwc(x))
    with torch.no_grad():
        got = nhwc(port(torch.from_numpy(x)).numpy())
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


def test_jax_converter_drops_the_dcn_offsets():
    """JAX's `convert_fastpose_sd` maps no `conv2_offset` weight: the
    deformable conv's offsets of a reference checkpoint are lost there,
    while the port loads them by name."""
    from mvsmplfitting_tpu_torch.detect.fastpose import FastPose
    port = FastPose(26, stage_with_dcn=(False, True, True, True))
    sd = numpy_state(port, 0)
    flat = jax.tree_util.tree_leaves_with_path(JC.convert_fastpose_sd(sd))
    names = {jax.tree_util.keystr(p) for p, _ in flat}
    assert not any("offset" in n for n in names)
    assert sum(k.endswith("conv2_offset.weight") for k in sd) == 13
    port.load_state_dict(to_tensors(sd))


def test_hybrik_inverse_round_trips():
    from mvsmplfitting_tpu_torch.detect.hybrik import Simple3DPoseSMPLCam
    port = Simple3DPoseSMPLCam(num_joints=5, depth_dim=8,
                               deconv_filters=(16, 16, 16))
    sd = numpy_state(port, 7)
    back = W.hybrik_state_from_flax(JC.convert_hybrik_sd(sd))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


def test_zoo_builds_every_net():
    from mvsmplfitting_tpu_torch.detect import zoo
    from mvsmplfitting_tpu_torch.detect.hardnet import HarDNetPose
    from mvsmplfitting_tpu_torch.detect.hrnet import PoseHRNet
    assert isinstance(zoo.build_pose_model("HRNet", 17, width=8), PoseHRNet)
    assert isinstance(zoo.build_pose_model("hardnet", 17), HarDNetPose)
    assert set(zoo.POSE_MODELS) == {"fastpose", "simplepose", "hrnet",
                                    "hardnet", "fastpose_duc",
                                    "fastpose_duc_dense"}
