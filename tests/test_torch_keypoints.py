"""The keypoint front end as a whole: the port's `KeypointPipeline` against
JAX's on the same seeded images and weights, and the port's keypoint CLI
(`mvsmplfitting_tpu_torch.cli.keypoints`) on the CPU.

The nets run small (YOLOX depth 0.33, width 0.25 at 64x96; FastPose, 26
joints, at 128x96, whose heatmaps are a quarter of the crop) with
YOLOX's prediction convs fixed (`fixed_yolox_head`): six boxes per view
on the stride-32 grid, so both packages crop the same boxes; the nets
themselves are held to JAX in `test_torch_detect.py`.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
from torch_port_helpers import fixed_yolox_head, numpy_state, \
    to_tensors, write_image_tree

from mvsmplfitting_tpu_torch.detect import predictor as TP
from mvsmplfitting_tpu_torch.detect.fastpose import FastPose
from mvsmplfitting_tpu_torch.detect.yolox import YOLOX

DET_HW = (64, 96)
POSE_HW = (128, 96)
J = 26
CAMS = ("Camera00", "Camera01")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    det = fixed_yolox_head(numpy_state(YOLOX(depth_mul=0.33,
                                             width_mul=0.25), 0))
    pose = numpy_state(FastPose(J), 1)
    return det, pose


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kp") / "data")
    paths = write_image_tree(os.path.join(root, "images"), cams=2, frames=2)
    return root, paths


def port_pipeline(det_sd, pose_sd, **pose_kw):
    det = TP.PersonDetector(to_tensors(det_sd), input_hw=DET_HW,
                            depth_mul=0.33, width_mul=0.25, device="cpu")
    pose = TP.PoseEstimator(to_tensors(pose_sd), num_joints=J,
                            input_hw=POSE_HW, device="cpu", **pose_kw)
    return TP.KeypointPipeline(det, pose)


def read_json_tree(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n)) as f:
                people = json.load(f)["people"]
            out[os.path.relpath(os.path.join(d, n), root)] = np.asarray(
                [p["pose_keypoints_2d"] for p in people],
                np.float64).reshape(len(people), -1, 3)
    return out


def ambiguous(pipe, img_path):
    """(P, J) mask of the joints whose decoded coordinate rests on a
    difference under 1e-4 in the port's heatmaps (`decode_margins`)."""
    from mvsmplfitting_tpu_torch.data.images import read_image
    from mvsmplfitting_tpu_torch.detect.preprocess import (
        bbox_to_center_scale, crop_affine, decode_margins)
    img = torch.from_numpy(read_image(img_path))
    boxes = pipe.detector.detect_batch([img])[0]
    c, s = bbox_to_center_scale(boxes[:, :4], POSE_HW[1] / POSE_HW[0])
    crops = crop_affine(TP.rgb01(img), torch.from_numpy(c),
                        torch.from_numpy(s), POSE_HW)
    return (decode_margins(pipe.pose.heatmaps(crops)) < 1e-4).numpy()


def test_pipeline_matches_jax(tmp_path, weights, image_tree):
    from mvsmplfitting_tpu.detect import convert as JC
    from mvsmplfitting_tpu.detect import predictor as JPr
    from mvsmplfitting_tpu.detect.fastpose import FastPose as JFastPose
    det_sd, pose_sd = weights
    _, paths = image_tree
    jpipe = JPr.KeypointPipeline(
        JPr.PersonDetector(JC.convert_yolox_sd(det_sd, 0.33),
                           input_hw=DET_HW, depth_mul=0.33, width_mul=0.25),
        JPr.PoseEstimator(JC.convert_fastpose_sd(pose_sd), num_joints=J,
                          input_hw=POSE_HW, model=JFastPose(J)))
    pipe = port_pipeline(det_sd, pose_sd)
    for f, frame in enumerate(paths):
        jpipe.process_images(frame, str(tmp_path / "jax"), "0000", CAMS)
        pipe.process_images(frame, str(tmp_path / "port"), "0000", CAMS)
    want = read_json_tree(tmp_path / "jax")
    got = read_json_tree(tmp_path / "port")
    assert sorted(got) == sorted(want) and len(got) == 4
    for name in want:
        g, w = got[name], want[name]
        assert g.shape == w.shape == (6, J, 3), name
        np.testing.assert_allclose(g[..., 2], w[..., 2], atol=2e-4,
                                   rtol=1e-3, err_msg=name)
        cam, stem = name.split(os.sep)[1], name.split(os.sep)[2][:3]
        loose = ambiguous(pipe, paths[int(stem)][CAMS.index(cam)])
        close = np.isclose(g[..., :2], w[..., :2], atol=1e-3, rtol=0).all(-1)
        assert (close | loose).all(), (name, np.argwhere(~close))
    assert [s["kept"] for s in pipe.stats] == [6] * 4
    assert all(s["candidates"] == 6 and s["people"] == 6
               for s in pipe.stats)


def test_pose_estimator_options(weights, image_tree):
    """Flip test, pose NMS and bfloat16 on the port's estimator: the
    flip-averaged heatmaps are JAX's formula, pose NMS keeps a subset,
    bfloat16 heatmaps change by under 5% of their largest magnitude, and
    its keypoints stay within JAX's bound of 8 px of fp32
    (`tests/test_detect.py:103-117`) on every joint whose fp32 peak
    clears twice bfloat16's largest change to that heatmap (so its
    argmax cannot move: random weights give flat heatmaps, whose
    near-ties bfloat16 may reorder)."""
    from mvsmplfitting_tpu_torch.data.images import read_image
    from mvsmplfitting_tpu_torch.detect.preprocess import (
        bbox_to_center_scale, crop_affine, flip_heatmap)
    det_sd, pose_sd = weights
    _, paths = image_tree
    img = torch.from_numpy(read_image(paths[0][0]))
    pipe = port_pipeline(det_sd, pose_sd)
    boxes = pipe.detector.detect_batch([img])[0]
    image = TP.rgb01(img)
    base = pipe.pose.estimate(image, boxes)
    crops = torch.rand((3, 3) + POSE_HW, generator=torch.Generator(
    ).manual_seed(0))
    flipped = port_pipeline(det_sd, pose_sd, flip_test=True).pose
    want = 0.5 * (pipe.pose.heatmaps(crops) + flip_heatmap(
        pipe.pose.heatmaps(crops.flip(3))))
    torch.testing.assert_close(flipped.heatmaps(crops), want, atol=1e-6,
                               rtol=1e-5)
    nms = port_pipeline(det_sd, pose_sd, use_pose_nms=True).pose
    assert 1 <= len(nms.estimate(image, boxes)) <= len(base)
    bf16 = port_pipeline(det_sd, pose_sd, bf16=True).pose
    k16 = bf16.estimate(image, boxes)
    assert k16.dtype == np.float32 and k16.shape == base.shape
    c, s = bbox_to_center_scale(boxes[:, :4], POSE_HW[1] / POSE_HW[0])
    crops = crop_affine(image, torch.from_numpy(c), torch.from_numpy(s),
                        POSE_HW)
    flat = pipe.pose.heatmaps(crops).flatten(2)
    change = (bf16.heatmaps(crops).flatten(2) - flat).abs().amax(-1)
    assert (change / flat.abs().amax(-1)).max() < 0.05
    top2 = flat.topk(2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1]) > 2 * change).numpy()
    err = np.abs(k16[..., :2] - base[..., :2]).max(-1)
    assert clear.mean() > 0.2
    assert (err[clear] < 8.0).all()
    empty = pipe.pose.estimate(image, np.zeros((0, 5), np.float32))
    assert empty.shape == (0, J, 3)


# ---- the CLI -------------------------------------------------------------------

@pytest.fixture
def small_cli(monkeypatch):
    """The CLI with the test's small net sizes (the nets' widths and the
    pose net's layers stay the CLI's own)."""
    monkeypatch.setattr(TP, "PersonDetector", functools.partial(
        TP.PersonDetector, input_hw=DET_HW, depth_mul=0.33, width_mul=0.25))
    monkeypatch.setattr(TP, "PoseEstimator", functools.partial(
        TP.PoseEstimator, input_hw=POSE_HW))
    from mvsmplfitting_tpu_torch.cli import keypoints
    return keypoints


def test_cli_writes_the_tree_main_reads(tmp_path, weights, image_tree,
                                        small_cli):
    from mvsmplfitting_tpu_torch.data.dataset import FittingDataset
    from mvsmplfitting_tpu_torch.utils.profiling import StageTimer
    det_sd, pose_sd = weights
    root, paths = image_tree
    yolox_ckpt, pose_ckpt = tmp_path / "yolox.pth.tar", tmp_path / "fp.pth"
    torch.save({"model": to_tensors(det_sd), "epoch": 1}, yolox_ckpt)
    torch.save(to_tensors(pose_sd), pose_ckpt)
    data = tmp_path / "data"
    data.mkdir()
    os.symlink(os.path.join(root, "images"), data / "images")
    timer, stats = StageTimer(), []
    rc = small_cli.main(["--data_folder", str(data), "--yolox_ckpt",
                         str(yolox_ckpt), "--pose_ckpt", str(pose_ckpt),
                         "--device", "cpu"], timer=timer, stats=stats)
    assert rc == 0
    assert set(timer.timings) == {"decode", "letterbox", "detector", "nms",
                                  "crop", "pose", "heatmap", "json"}
    assert len(timer.timings["decode"]) == 2 and len(stats) == 4
    got = read_json_tree(data / "keypoints")
    assert sorted(got) == sorted(
        os.path.join("0000", c, f"{f:03d}_keypoints.json")
        for c in CAMS for f in range(2))
    # the same as the pipeline on the same weights, in this process
    pipe = port_pipeline(det_sd, pose_sd)
    for frame in paths:
        pipe.process_images(frame, str(tmp_path / "direct"), "0000", CAMS)
    direct = read_json_tree(tmp_path / "direct")
    for name in got:
        np.testing.assert_array_equal(got[name], direct[name])
    # and the fitting CLI's dataset reads them back
    ds = FittingDataset(str(data), max_people=2)
    assert len(ds) == 2 and ds.num_views() == 2
    frame = ds[1]
    assert frame.view_mask.tolist() == [1.0, 1.0]
    assert frame.person_mask.tolist() == [[1.0, 1.0], [1.0, 1.0]]
    np.testing.assert_allclose(
        frame.keypoints[1, :2], got[os.path.join(
            "0000", "Camera01", "001_keypoints.json")][:2, :17], rtol=1e-6)
    assert frame.img_hw == (120, 160)


@pytest.mark.parametrize("flags", [["--video", "clip.mp4"], ["--smpl"],
                                   ["--smpl_ckpt", "hybrik.pth"],
                                   ["--pose_cfg", "cfg.yaml"]])
def test_cli_refuses_unported_modes(tmp_path, flags, small_cli, monkeypatch):
    """The streaming, SMPL and config modes are ported; what they cannot
    honour is refused before any net is built: a missing video or config
    file (named), `--smpl`/`--smpl_ckpt` without `--video`."""
    def boom(*a, **k):
        raise AssertionError("loaded a net before refusing")
    monkeypatch.setattr(TP, "PersonDetector", boom)
    monkeypatch.chdir(tmp_path)
    if flags[0] in ("--video", "--pose_cfg"):
        with pytest.raises(FileNotFoundError, match=flags[1]):
            small_cli.main(["--data_folder", str(tmp_path), "--device",
                            "cpu", *flags])
    else:
        with pytest.raises(SystemExit, match="--video"):
            small_cli.main(["--data_folder", str(tmp_path), "--device",
                            "cpu", *flags])


def test_cli_refuses_pending_pose_models(tmp_path, small_cli, monkeypatch):
    """HRNet and HarDNet are no longer pending: the CLI builds them by
    name (and stops here at the detector); an unknown name is refused
    before any net is built."""
    class Built(Exception):
        pass

    def detector(*a, **k):
        raise Built
    monkeypatch.setattr(TP, "PersonDetector", detector)
    os.makedirs(tmp_path / "images")
    for name in ("hrnet", "hardnet"):
        with pytest.raises(Built):
            small_cli.main(["--data_folder", str(tmp_path), "--device",
                            "cpu", "--pose_model", name])
    with pytest.raises(ValueError, match="unknown pose model"):
        small_cli.main(["--data_folder", str(tmp_path), "--device", "cpu",
                        "--pose_model", "nope"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_cli_needs_a_gpu_unless_told_cpu(tmp_path, small_cli):
    os.makedirs(tmp_path / "images")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        small_cli.main(["--data_folder", str(tmp_path)])
    with pytest.raises(SystemExit):
        small_cli.main(["--device", "cpu"])
