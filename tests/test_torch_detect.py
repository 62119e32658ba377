"""The port's keypoint nets and their pre- and post-processing against
the JAX package (`mvsmplfitting_tpu.detect`), on the same inputs.

Weights are a random state_dict in the reference's names, made with
numpy from a seed; JAX gets it through its own `convert_*_sd`, the port
through `load_state_dict`, which holds the port's module names to JAX's
converter.  Nets run at JAX's test sizes (YOLOX depth 0.33, width 0.25
at 64x96; pose nets at 64x48) with the tolerance of
`tests/test_detect.py:582,652` (atol 2e-4, rtol 1e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch_port_helpers import numpy_state, to_tensors

from mvsmplfitting_tpu.detect import convert as JC
from mvsmplfitting_tpu.detect import preprocess as JP
from mvsmplfitting_tpu.detect import yolox as JY
from mvsmplfitting_tpu_torch.detect import preprocess as P
from mvsmplfitting_tpu_torch.detect import weights as W
from mvsmplfitting_tpu_torch.detect import yolox as Y

ATOL, RTOL = 2e-4, 1e-3
SMALL_HW = (64, 96)
POSE_HW = (64, 48)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def loaded(model: nn.Module, sd: dict) -> nn.Module:
    model.load_state_dict(to_tensors(sd))
    return model.eval()


def nhwc(x):
    return np.asarray(x).transpose(0, 2, 3, 1)


# ---- the nets ----------------------------------------------------------------

def _pose_cases():
    from mvsmplfitting_tpu.detect import fastpose as jf
    from mvsmplfitting_tpu.detect import fastpose_duc as jd
    from mvsmplfitting_tpu.detect import simplepose as js
    from mvsmplfitting_tpu_torch.detect import fastpose as tf
    from mvsmplfitting_tpu_torch.detect import fastpose_duc as td
    from mvsmplfitting_tpu_torch.detect import simplepose as ts
    D = (64, 64, 64)
    return {
        # (port module, JAX module, JAX converter, zoo name, shuffle)
        "fastpose": (lambda: tf.FastPose(26), lambda: jf.FastPose(26),
                     JC.convert_fastpose_sd, "fastpose", False),
        "simplepose": (lambda: ts.SimplePose(17, D),
                       lambda: js.SimplePose(17, D),
                       JC.convert_simplepose_sd, "simplepose", False),
        "fastpose_duc": (lambda: td.FastPoseDUC(17),
                         lambda: jd.FastPoseDUC(17),
                         JC.convert_fastpose_duc_sd, "fastpose_duc", False),
        "fastpose_duc_se": (
            lambda: td.FastPoseDUC(17, se=True),
            lambda: jd.FastPoseDUC(17, se=True),
            lambda sd: JC.convert_fastpose_duc_sd(sd, se=True),
            "fastpose_duc", False),
        "fastpose_duc_shuffle": (
            lambda: td.FastPoseDUC(17, shuffle=True),
            lambda: jd.FastPoseDUC(17, shuffle=True),
            lambda sd: JC.convert_fastpose_duc_sd(sd, se=True),
            "fastpose_duc", True),
        "fastpose_duc_dense": (
            lambda: td.FastPoseDUCDense(17, 26),
            lambda: jd.FastPoseDUCDense(17, 26),
            JC.convert_fastpose_duc_dense_sd, "fastpose_duc_dense", False),
    }


POSE_CASES = sorted(_pose_cases())


@pytest.fixture(scope="module")
def yolox_pair():
    from mvsmplfitting_tpu.detect.yolox import YOLOX as JYOLOX
    port = Y.YOLOX(depth_mul=0.33, width_mul=0.25)
    sd = numpy_state(port, 0)
    variables = JC.convert_yolox_sd(sd, 0.33)
    apply = jax.jit(JYOLOX(depth_mul=0.33, width_mul=0.25,
                           input_hw=SMALL_HW).apply)
    return loaded(port, sd), sd, variables, apply


def test_yolox_matches_jax(yolox_pair):
    port, _, variables, apply = yolox_pair
    x = np.random.default_rng(1).uniform(0, 255, (2, 3) + SMALL_HW
                                         ).astype(np.float32)
    want = np.asarray(apply(variables, jnp.asarray(nhwc(x))))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    anchors = sum((SMALL_HW[0] // s) * (SMALL_HW[1] // s) for s in (8, 16,
                                                                    32))
    assert got.shape == want.shape == (2, anchors, 6)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_yolox_round_trip(yolox_pair):
    _, sd, variables, _ = yolox_pair
    back = W.yolox_state_from_flax(variables, 0.33)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


@pytest.mark.parametrize("case", POSE_CASES)
def test_pose_net_matches_jax_and_round_trips(case):
    make_port, make_jax, convert, zoo, shuffle = _pose_cases()[case]
    port = make_port()
    sd = numpy_state(port, 2)
    variables = convert(sd)
    back = W.pose_state_from_flax(zoo, variables, shuffle=shuffle)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    port = loaded(port, sd)
    # ShuffleResnet's strided blocks unshuffle: stride-32 clean input.
    hw = (64, 64) if shuffle else POSE_HW
    x = np.random.default_rng(3).standard_normal((2, 3) + hw
                                                 ).astype(np.float32)
    want = np.asarray(jax.jit(make_jax().apply)(variables,
                                                jnp.asarray(nhwc(x))))
    with torch.no_grad():
        got = nhwc(port(torch.from_numpy(x)).numpy())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_zoo_and_refusals():
    """Every net of JAX's zoo builds (HRNet, HarDNet and the deformable
    FastPose too); unknown names are refused."""
    from mvsmplfitting_tpu_torch.detect import fastpose as tf
    from mvsmplfitting_tpu_torch.detect import zoo
    assert isinstance(zoo.build_pose_model("FastPose", 26), tf.FastPose)
    assert set(zoo.POSE_MODELS) == {"fastpose", "simplepose", "hrnet",
                                    "hardnet", "fastpose_duc",
                                    "fastpose_duc_dense"}
    assert not hasattr(zoo, "PENDING")
    for name in ("hrnet", "hardnet"):
        assert zoo.build_pose_model(name).num_joints == 17
    with pytest.raises(ValueError, match="unknown pose model"):
        zoo.build_pose_model("nope")
    with pytest.raises(ValueError, match="unknown pose model"):
        W.pose_state_from_flax("nope", {"params": {}})
    net = tf.FastPose(26, stage_with_dcn=(False, True, True, True))
    assert not hasattr(net.preact.layer1[0], "conv2_offset")
    assert net.preact.layer2[0].conv2_offset.out_channels == 18


def test_load_checkpoint_unwraps(tmp_path):
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3),
          "a.bn.num_batches_tracked": torch.tensor(3)}
    for i, wrap in enumerate(({"model": sd}, {"state_dict": sd}, sd)):
        path = tmp_path / f"c{i}.pth"
        torch.save(dict(wrap, epoch=3) if i < 2 else wrap, path)
        got = W.load_checkpoint(str(path))
        assert set(got) == set(sd)
        for k in sd:
            assert torch.equal(got[k], sd[k])


def test_random_state_dict_is_seeded():
    from mvsmplfitting_tpu_torch.detect.fastpose import FastPose
    m = FastPose(17)
    a = W.random_state_dict(m, torch.Generator().manual_seed(5))
    b = W.random_state_dict(m, torch.Generator().manual_seed(5))
    assert set(a) == set(m.state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    m.load_state_dict(a)


# ---- pre- and post-processing ------------------------------------------------

@pytest.mark.parametrize("src_hw,input_hw", [
    ((1080, 1920), (800, 1440)),      # the reference cameras: r = 0.7407
    ((1600, 2880), (800, 1440)),      # an exact 2x reduction
    ((100, 50), (64, 64)),
    ((121, 163), (64, 96)),
    ((37, 41), (320, 352)),           # enlargement
])
def test_letterbox_matches_jax(src_hw, input_hw):
    rng = np.random.default_rng(src_hw[0])
    img = rng.integers(0, 256, src_hw + (3,), dtype=np.uint8)
    want, r_want = JP.letterbox(img, input_hw)
    got, r_got = P.letterbox(torch.from_numpy(img), input_hw)
    assert r_got == r_want
    assert got.dtype == torch.float32 and got.shape == (3,) + input_hw
    np.testing.assert_array_equal(got.permute(1, 2, 0).numpy(), want)


def test_bbox_to_center_scale_matches_jax():
    boxes = np.random.default_rng(4).uniform(0, 300, (20, 4))
    boxes[:, 2:] += boxes[:, :2]
    for ar in (0.75, 1.0):
        for a, b in zip(P.bbox_to_center_scale(boxes, ar),
                        JP.bbox_to_center_scale(boxes, ar)):
            np.testing.assert_array_equal(a, b)


def test_crop_affine_matches_jax():
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (90, 120, 3)).astype(np.float32)
    boxes = np.asarray([[10, 5, 70, 80], [-20, -10, 40, 60],
                        [80, 40, 150, 120], [30, 30, 33, 35]], np.float32)
    centers, scales = P.bbox_to_center_scale(boxes, 48 / 64)
    want = np.asarray(jax.jit(JP.crop_affine, static_argnums=3)(
        jnp.asarray(img), jnp.asarray(centers), jnp.asarray(scales),
        POSE_HW))
    got = P.crop_affine(torch.from_numpy(img).permute(2, 0, 1),
                        torch.from_numpy(centers), torch.from_numpy(scales),
                        POSE_HW)
    np.testing.assert_allclose(nhwc(got.numpy()), want, atol=1e-5, rtol=0)
    crops = torch.from_numpy(rng.uniform(0, 1, (3, 3) + POSE_HW
                                         ).astype(np.float32))
    np.testing.assert_allclose(
        nhwc(P.normalize_crops(crops).numpy()),
        np.asarray(JP.normalize_crops(nhwc(crops.numpy()))), atol=1e-7)


def _heatmaps(seed):
    rng = np.random.default_rng(seed)
    hm = rng.standard_normal((4, 26, 16, 12)).astype(np.float32)
    hm[0, 0] = 0.0
    hm[0, 0, 5, 7] = hm[0, 0, 9, 2] = 1.0       # a tie: the first wins
    hm[0, 1] = -1.0                             # no positive maximum
    hm[1, 2] = 0.0
    hm[1, 2, 0, 11] = 2.0                       # on the border: no step
    hm[1, 3] = 0.0
    hm[1, 3, 8, 6] = 1.0
    hm[1, 3, 8, 7] = 0.5                        # steps +x
    centers = rng.uniform(50, 200, (4, 2)).astype(np.float32)
    scales = rng.uniform(40, 120, (4, 2)).astype(np.float32)
    return hm, centers, scales


def test_heatmap_to_coords_matches_jax():
    hm, c, s = _heatmaps(6)
    want_xy, want_v = JP.heatmap_to_coords(
        jnp.asarray(nhwc(hm)), jnp.asarray(c), jnp.asarray(s))
    got_xy, got_v = P.heatmap_to_coords(torch.from_numpy(hm),
                                        torch.from_numpy(c),
                                        torch.from_numpy(s))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(got_xy.numpy(), np.asarray(want_xy),
                               atol=1e-4, rtol=1e-6)
    ratio = s[0, 0] / 12
    np.testing.assert_allclose(got_xy[0, 0].numpy(),
                               (np.array([7, 5]) - [6, 8]) * ratio + c[0],
                               rtol=1e-6)
    np.testing.assert_allclose(got_xy[0, 1].numpy(),
                               (np.array([0, 0]) - [6, 8]) * ratio + c[0],
                               rtol=1e-6)


@pytest.mark.parametrize("norm", ["softmax", "sigmoid"])
def test_heatmap_to_coords_integral_matches_jax(norm):
    hm, c, s = _heatmaps(7)
    want = JP.heatmap_to_coords_integral(jnp.asarray(nhwc(hm)),
                                         jnp.asarray(c), jnp.asarray(s), norm)
    got = P.heatmap_to_coords_integral(torch.from_numpy(hm),
                                       torch.from_numpy(c),
                                       torch.from_numpy(s), norm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-5)


@pytest.mark.parametrize("pairs", ["coco", "halpe26"])
@pytest.mark.parametrize("shift", [True, False])
def test_flip_heatmap_matches_jax(pairs, shift):
    table = {"coco": P.COCO_FLIP_PAIRS, "halpe26": P.HALPE26_FLIP_PAIRS}
    hm, _, _ = _heatmaps(8)
    want = JP.flip_heatmap(jnp.asarray(nhwc(hm)), table[pairs], shift)
    got = P.flip_heatmap(torch.from_numpy(hm), table[pairs], shift)
    np.testing.assert_array_equal(nhwc(got.numpy()), np.asarray(want))


def test_flip_pairs_and_skeletons_match_jax():
    from mvsmplfitting_tpu.viz import skeletons as JS
    from mvsmplfitting_tpu_torch.viz import skeletons as S
    assert set(S.SKELETONS) == set(JS.SKELETONS)
    for k in S.SKELETONS:
        assert dataclasses.asdict(S.SKELETONS[k]) == \
            dataclasses.asdict(JS.SKELETONS[k])
    for n in (16, 17, 21, 26, 68, 99, 133, 136):
        assert S.skeleton_for(n).name == JS.skeleton_for(n).name
    assert [S.get_color_fast(i) for i in range(10)] == \
        [JS.get_color_fast(i) for i in range(10)]
    for n, fmt in ((26, None), (26, "halpe26"), (136, "halpe136"),
                   (16, "mpii16"), (17, None)):
        assert P.flip_pairs_for(n, fmt) == JP.flip_pairs_for(n, fmt)
    with pytest.raises(ValueError, match="reach joint"):
        P.flip_pairs_for(17, "halpe26")
    with pytest.raises(ValueError, match="unknown skeleton"):
        S.skeleton_for(17, "nope")


def test_postprocess_boxes_and_nms_bitwise():
    rng = np.random.default_rng(9)
    A = 500
    dec = np.zeros((A, 6), np.float32)
    dec[:, :2] = rng.uniform(0, 400, (A, 2))
    dec[:, 2:4] = rng.uniform(10, 120, (A, 2))
    dec[:, 4:] = rng.uniform(0, 1, (A, 2))
    for conf in (0.1, 0.3, 2.0):
        got = Y.postprocess_boxes(dec, conf)
        want = JY.postprocess_boxes(dec, conf)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert Y.candidate_count(dec, 0.1) == int(
        (dec[:, 4] * dec[:, 5] >= 0.1).sum())
    boxes = np.asarray([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]],
                       np.float32)
    scores = np.asarray([0.9, 0.8, 0.7], np.float32)
    assert Y.nms_xyxy(boxes, scores) == JY.nms_xyxy(boxes, scores) == [0, 2]
    # two bands: a kept box below high_thresh comes after the high ones
    dec2 = np.zeros((3, 6), np.float32)
    dec2[:, :4] = [[10, 10, 5, 5], [100, 100, 5, 5], [200, 200, 5, 5]]
    dec2[:, 4] = 1.0
    dec2[:, 5] = [0.2, 0.9, 0.5]
    np.testing.assert_array_equal(Y.postprocess_boxes(dec2)[:, 4],
                                  np.float32([0.9, 0.5, 0.2]))


def test_decode_outputs_matches_jax():
    raw = np.random.default_rng(10).standard_normal((2, 63, 6)
                                                    ).astype(np.float32)
    want = JY.decode_outputs(jnp.asarray(raw), (32, 96))
    got = Y.decode_outputs(torch.from_numpy(raw), (32, 96))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_pose_nms_and_results_json_bitwise(tmp_path):
    import importlib
    JN = importlib.import_module("mvsmplfitting_tpu.detect.pose_nms")
    from mvsmplfitting_tpu_torch.detect import pose_nms as N
    rng = np.random.default_rng(11)
    base = rng.uniform(0, 200, (3, 17, 2))
    poses = np.concatenate([base + rng.normal(0, 2, base.shape)
                            for _ in range(3)]).astype(np.float32)
    scores = rng.uniform(0.2, 1.0, (9, 17)).astype(np.float32)
    boxes = np.concatenate([poses.min(1), poses.max(1)], 1)
    box_scores = rng.uniform(0.5, 1, 9).astype(np.float32)
    got = N.pose_nms(boxes, box_scores, poses, scores)
    want = JN.pose_nms(boxes, box_scores, poses, scores)
    assert len(got[1]) < 9
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    results = [{"imgname": "x/img_0001.jpg", "result": [
        {"keypoints": got[1][i], "kp_score": got[2][i],
         "proposal_score": 1.5, "box": got[0][i], "idx": i}
        for i in range(len(got[1]))]}]
    for form in (None, "cmu", "open"):
        a = N.write_results_json(results, str(tmp_path / "a"), form)
        b = JN.write_results_json(results, str(tmp_path / "b"), form)
        assert open(a).read() == open(b).read()


def test_conv_flops_counts_each_layer():
    """`utils.profiling.conv_flops`: 2 per multiply-add of every conv,
    transposed conv and dense layer, from the shapes it sees."""
    from mvsmplfitting_tpu_torch.utils.profiling import conv_flops
    net = nn.Sequential(nn.Conv2d(3, 8, 3, 2, 1), nn.Conv2d(8, 8, 3, 1, 1,
                                                            groups=4),
                        nn.ConvTranspose2d(8, 4, 4, 2, 1), nn.Flatten(),
                        nn.Linear(4 * 16 * 16, 5))
    want = 2 * (8 * 8 * 8 * 3 * 9          # conv: out elements x cin x k
                + 8 * 8 * 8 * 2 * 9        # grouped: cin / groups = 2
                + 8 * 8 * 8 * 4 * 16       # transposed: in elements x cout x k
                + 5 * 4 * 16 * 16)         # dense
    assert conv_flops(net, torch.zeros(1, 3, 16, 16)) == want
    yolox = conv_flops(Y.YOLOX().to("meta"),
                       torch.zeros(1, 3, 640, 640, device="meta"))
    assert abs(yolox / 281.9e9 - 1) < 0.01      # YOLOX-X's published count

