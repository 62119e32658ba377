"""The port's RoIAlign, deformable RoI pooling and YOLOFPN neck
(`detect/roi_align.py`, `deform_pool.py`, `yolo_fpn.py`) against JAX's,
on the CPU.

The port is NCHW, JAX NHWC: inputs are transposed, outputs compared in
JAX's layout.  Tolerances are JAX's own (`tests/test_roi_dcn.py`,
`tests/test_yolo_fpn.py:62`):
- RoIAlign and deformable pooling: atol 1e-5 (fp32 gathers and sums in
  another order); the aspect-clipped boxes: rtol 1e-6;
- the deformable pack modules with JAX's random FC weights carried
  across: atol 1e-5;
- YOLOFPN (Darknet-21, random weights and BatchNorm statistics, 64x96
  input) through `weights.yolo_fpn_state_from_flax`: rtol 1e-4, atol
  1e-4 on all three feature maps.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsmplfitting_tpu.detect import deform_pool as JD
from mvsmplfitting_tpu.detect.yolo_fpn import YOLOFPN as JYOLOFPN
from mvsmplfitting_tpu_torch.detect import deform_pool as TD
from mvsmplfitting_tpu_torch.detect.weights import yolo_fpn_state_from_flax
from mvsmplfitting_tpu_torch.detect.yolo_fpn import YOLOFPN

# `detect/__init__.py` exports the function `roi_align` under the
# module's name.
JR = importlib.import_module("mvsmplfitting_tpu.detect.roi_align")
TR = importlib.import_module("mvsmplfitting_tpu_torch.detect.roi_align")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


ROIS = np.asarray([[0, 1.2, 0.7, 8.3, 9.9],
                   [1, -2.0, 3.0, 14.0, 12.5],       # out of bounds
                   [0, 4.0, 4.0, 4.0, 4.0],          # degenerate
                   [1, 0.5, 0.5, 30.0, 28.0]],       # wide: 8 taps
                  np.float32)


@pytest.mark.parametrize("sample_num", [2, 0, -1])
def test_roi_align_matches_jax(sample_num):
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 13, 11, 3)).astype(np.float32)
    want = np.asarray(JR.roi_align(jnp.asarray(feats), jnp.asarray(ROIS),
                                   (4, 5), spatial_scale=0.5,
                                   sample_num=sample_num, max_samples=8))
    got = TR.roi_align(_nchw(feats), torch.from_numpy(ROIS), (4, 5),
                       spatial_scale=0.5, sample_num=sample_num,
                       max_samples=8)
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5)


def test_align_transform_matches_jax():
    rng = np.random.default_rng(1)
    img = rng.random((64, 48, 3)).astype(np.float32)
    boxes = np.asarray([[10.0, 5.0, 30.0, 60.0], [0.0, 0.0, 40.0, 10.0],
                        [5.0, 20.0, 45.0, 63.0]], np.float32)
    jc, jb = JR.align_transform(jnp.asarray(img), jnp.asarray(boxes),
                                (32, 24))
    tc, tb = TR.align_transform(torch.from_numpy(img),
                                torch.from_numpy(boxes), (32, 24))
    np.testing.assert_allclose(_nhwc(tc), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6)
    np.testing.assert_allclose(
        TR.clip_aspect_ratio(torch.from_numpy(boxes), 1.0).numpy(),
        np.asarray(JR.clip_aspect_ratio(jnp.asarray(boxes), 1.0)),
        rtol=1e-6)


POOL_CASES = {
    "no_trans": dict(shape=(2, 12, 10, 5), trans=None,
                     kw=dict(out_size=3, out_channels=5, spatial_scale=0.5,
                             no_trans=True)),
    "trans": dict(shape=(1, 16, 16, 4), trans=(2, 5, 5),
                  kw=dict(out_size=4, out_channels=4, spatial_scale=1.0,
                          part_size=5, sample_per_part=2, trans_std=0.2)),
    "group2": dict(shape=(1, 10, 10, 12), trans=None,
                   kw=dict(out_size=4, out_channels=3, spatial_scale=1.0,
                           no_trans=True, group_size=2)),
    "multiclass": dict(shape=(1, 12, 12, 6), trans=(4, 3, 3),
                       kw=dict(out_size=3, out_channels=6, spatial_scale=1.0,
                               trans_std=0.1)),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_deform_roi_pool_matches_jax(case):
    c = POOL_CASES[case]
    rng = np.random.default_rng(2)
    feats = rng.standard_normal(c["shape"]).astype(np.float32)
    rois = np.asarray([[0, 1.2, 0.7, 7.3, 9.9], [0, -3.0, 2.0, 13.0, 14.5],
                       [0, 4.0, 4.0, 4.2, 4.2]], np.float32)
    trans = (None if c["trans"] is None else rng.standard_normal(
        (3,) + c["trans"]).astype(np.float32))
    want = np.asarray(JD.deform_roi_pool(
        jnp.asarray(feats), jnp.asarray(rois),
        None if trans is None else jnp.asarray(trans), **c["kw"]))
    got = TD.deform_roi_pool(
        _nchw(feats), torch.from_numpy(rois),
        None if trans is None else torch.from_numpy(trans), **c["kw"])
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5)


def _fc_from_flax(params, name, n, out_size, channels):
    """JAX's Dense stack -> the torch Sequential's state: kernels
    transposed; the first layer's input rows reordered from JAX's (h, w,
    c) flattening of the pooled features to torch's (c, h, w)."""
    sd = {}
    for i in range(n):
        k = np.asarray(params[f"{name}{i}"]["kernel"])
        if i == 0:
            k = k.reshape(out_size, out_size, channels, -1).transpose(
                2, 0, 1, 3).reshape(k.shape)
        sd[f"{name}.{2 * i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(k.T))
        sd[f"{name}.{2 * i}.bias"] = torch.from_numpy(
            np.asarray(params[f"{name}{i}"]["bias"]))
    return sd


@pytest.mark.parametrize("modulated", [False, True])
def test_deform_pool_packs_match_jax(modulated):
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((1, 12, 12, 4)).astype(np.float32)
    rois = np.asarray([[0, 1.0, 1.0, 9.0, 9.0], [0, 2.0, 0.0, 11.0, 7.0]],
                      np.float32)
    kw = dict(spatial_scale=1.0, out_size=3, out_channels=4,
              trans_std=0.1, deform_fc_channels=16)
    jcls = (JD.ModulatedDeformRoIPoolingPack if modulated
            else JD.DeformRoIPoolingPack)
    jmod = jcls(**kw)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                          jnp.asarray(rois))
    # The zero-initialized last layers would hide the offset path.
    params = jax.tree.map(
        lambda a: jnp.asarray(rng.normal(0, 0.3, a.shape), jnp.float32),
        variables["params"])
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(feats),
                                 jnp.asarray(rois)))
    tcls = (TD.ModulatedDeformRoIPoolingPack if modulated
            else TD.DeformRoIPoolingPack)
    tmod = tcls(**kw)
    sd = _fc_from_flax(params, "offset_fc", 3, 3, 4)
    if modulated:
        sd.update(_fc_from_flax(params, "mask_fc", 2, 3, 4))
    tmod.load_state_dict(sd)
    got = tmod(_nchw(feats), torch.from_numpy(rois))
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5)


def test_yolo_fpn_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 64, 96, 3)).astype(np.float32)
    jmod = JYOLOFPN(depth=21)
    # Shapes only (an eager flax init takes ~17 s here), values by numpy:
    # conv kernels N(0, 1/fan_in), BatchNorm scale U(0.8, 1.2), bias
    # N(0, 0.05), mean N(0, 0.1), var U(0.5, 1.5).
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))

    def draw(path, a):
        key = path[-1].key
        if key == "kernel":
            v = rng.normal(0, np.sqrt(1.0 / np.prod(a.shape[:-1])), a.shape)
        elif key == "scale":
            v = rng.uniform(0.8, 1.2, a.shape)
        elif key in ("bias", "mean"):
            v = rng.normal(0, 0.05 if key == "bias" else 0.1, a.shape)
        else:
            v = rng.uniform(0.5, 1.5, a.shape)
        return jnp.asarray(v, jnp.float32)
    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(draw, shapes["batch_stats"])
    variables = {"params": params, "batch_stats": stats}
    want = jmod.apply(variables, jnp.asarray(x))

    model = YOLOFPN(depth=21).eval()
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in yolo_fpn_state_from_flax(variables, 21).items()}
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(_nchw(x))
    assert len(got) == 3
    for g, w, c in zip(got, want, (128, 256, 512)):
        assert g.shape[1] == c
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
