"""The port's training CLIs (`mvsmplfitting_tpu_torch.cli.train_pose`,
`cli.train_yolox`) end to end on the CPU, on JAX's own test workspaces
(`tests/test_train_cli.py`: synthetic COCO GT, JPEGs by cv2) and nets
(SimplePose 128x96 with 32-32-32 deconvolutions; YOLOX depth 0.33, width
0.125 at 64x64): 2 steps each, checkpoints and metrics written, finite
losses; each `ema.npz` through JAX's own converter gives JAX's net the
port's outputs (rtol 1e-5); the default device is CUDA and raises
without it; and HybrIK's train step runs on the port's net.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsmplfitting_tpu_torch.cli import train_pose, train_yolox
from mvsmplfitting_tpu_torch.detect import train as T


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def coco_ws(tmp_path_factory):
    """JAX's `coco_ws` and `coco_det_ws` (`tests/test_train_cli.py:11,
    122`): 6 images with one 17-joint person each; 8 images with 1-3
    boxes each."""
    import cv2
    root = tmp_path_factory.mktemp("train_ws")
    img_dir = root / "images"
    os.makedirs(img_dir)
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i in range(6):
        H, W = 120, 90
        cv2.imwrite(str(img_dir / f"im{i}.jpg"),
                    rng.integers(0, 255, (H, W, 3), np.uint8))
        images.append({"id": i, "file_name": f"im{i}.jpg", "width": W,
                       "height": H})
        kp = np.zeros((17, 3), np.float32)
        kp[:, 0] = rng.uniform(15, 75, 17)
        kp[:, 1] = rng.uniform(15, 105, 17)
        kp[:, 2] = (rng.uniform(0, 1, 17) > 0.2) * 2
        anns.append({"id": i, "image_id": i, "category_id": 1,
                     "bbox": [10, 10, 70, 100],
                     "keypoints": [float(v) for v in kp.ravel()]})
    pose = str(root / "pose.json")
    with open(pose, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    rng = np.random.default_rng(7)
    images, anns, aid = [], [], 0
    for i in range(8):
        H, W = 100, 140
        cv2.imwrite(str(img_dir / f"d{i}.jpg"),
                    rng.integers(0, 255, (H, W, 3), np.uint8))
        images.append({"id": i, "file_name": f"d{i}.jpg", "width": W,
                       "height": H})
        for _ in range(int(rng.integers(1, 4))):
            x, y = rng.uniform(0, W - 30), rng.uniform(0, H - 30)
            w, h = rng.uniform(15, 30), rng.uniform(15, 30)
            anns.append({"id": aid, "image_id": i, "category_id": 1,
                         "bbox": [x, y, w, h], "iscrowd": 0,
                         "area": w * h})
            aid += 1
    det = str(root / "det.json")
    with open(det, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return pose, det, str(img_dir)


POSE_ARGS = ["--model", "simplepose", "--num_joints", "17",
             "--input_size", "128x96", "--heatmap_size", "32x24",
             "--batch", "3", "--epochs", "2", "--max_steps", "2",
             "--deconv", "32,32,32", "--device", "cpu"]


def _metrics(out):
    with open(os.path.join(out, "train_metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


@pytest.mark.parametrize("loss_type", ["mse", "integral"])
def test_train_pose_two_steps(coco_ws, tmp_path, loss_type):
    pose, _, img_root = coco_ws
    out = str(tmp_path / "run")
    res = train_pose.main(["--ann", pose, "--img_root", img_root,
                           "--loss_type", loss_type, "--out", out]
                          + POSE_ARGS)
    assert res["steps"] == 2 and np.isfinite(res["losses"]).all()
    for name in ("last.npz", "ema.npz"):
        assert os.path.exists(os.path.join(out, name))
    rows = _metrics(out)
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["lr"] == pytest.approx(1e-3)
               for r in rows)
    last = T.load_checkpoint(os.path.join(out, "last.npz"))
    assert int(last["preact.bn1.num_batches_tracked"]) == 2


def test_pose_checkpoint_loads_into_jax(coco_ws, tmp_path):
    """The port's ema.npz through JAX's `convert_simplepose_sd` gives JAX's
    SimplePose the port's heatmaps."""
    from mvsmplfitting_tpu.detect.convert import convert_simplepose_sd
    from mvsmplfitting_tpu.detect.zoo import build_pose_model as jbuild
    from mvsmplfitting_tpu_torch.detect.zoo import build_pose_model

    pose, _, img_root = coco_ws
    out = str(tmp_path / "run")
    train_pose.main(["--ann", pose, "--img_root", img_root, "--out", out]
                    + POSE_ARGS)
    with np.load(os.path.join(out, "ema.npz")) as d:
        sd = {k: d[k] for k in d.files}
    model = build_pose_model("simplepose", 17, deconv_filters=(32, 32, 32))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    x = np.random.default_rng(1).uniform(0, 1, (2, 128, 96, 3)).astype(
        np.float32)
    with torch.no_grad():
        t = model.eval()(T.nchw(torch.from_numpy(x))).permute(0, 2, 3, 1)
    jm = jbuild("simplepose", 17, deconv_filters=(32, 32, 32))
    j = jax.jit(jm.apply)(convert_simplepose_sd(sd), jnp.asarray(x))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5 * float(np.abs(j).max()))


def test_train_yolox_two_steps_and_checkpoint(coco_ws, tmp_path):
    """Mosaic + mixup for 2 steps, the EMA net's validation mAP, then
    the ema.npz through JAX's `convert_yolox_sd`."""
    from mvsmplfitting_tpu.detect.convert import convert_yolox_sd
    from mvsmplfitting_tpu.detect.yolox import YOLOX as JYOLOX
    from mvsmplfitting_tpu_torch.detect.yolox import YOLOX

    _, det, img_root = coco_ws
    out = str(tmp_path / "yrun")
    res = train_yolox.main(["--ann", det, "--img_root", img_root,
                            "--depth", "0.33", "--width", "0.125",
                            "--input_size", "64x64", "--batch", "2",
                            "--epochs", "1", "--max_steps", "2",
                            "--max_labels", "20", "--out", out,
                            "--val_ann", det, "--eval_interval", "1",
                            "--device", "cpu"])
    assert res["steps"] == 2 and np.isfinite(res["losses"]).all()
    rows = _metrics(out)
    assert all("num_fg" in r for r in rows if "loss" in r)
    maps = [r["val_box_map"] for r in rows if "val_box_map" in r]
    assert maps and all(0.0 <= v <= 1.0 for v in maps)

    with np.load(os.path.join(out, "ema.npz")) as d:
        sd = {k: d[k] for k in d.files}
    model = YOLOX(1, 0.33, 0.125)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    x = np.random.default_rng(2).uniform(0, 255, (1, 64, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        t = model.eval()(T.nchw(torch.from_numpy(x)))
    jm = JYOLOX(num_classes=1, depth_mul=0.33, width_mul=0.125,
                input_hw=(64, 64))
    j = jax.jit(jm.apply)(convert_yolox_sd(sd, 0.33), jnp.asarray(x))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5 * float(np.abs(j).max()))


def test_clis_default_to_cuda(coco_ws, tmp_path):
    """No `--device`: CUDA, and without a card an error, not the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    pose, det, img_root = coco_ws
    with pytest.raises(RuntimeError, match="CUDA"):
        train_pose.main(["--ann", pose, "--img_root", img_root,
                         "--out", str(tmp_path / "p"), "--batch", "3"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_yolox.main(["--ann", det, "--img_root", img_root,
                          "--out", str(tmp_path / "y"), "--batch", "2"])


def test_hybrik_train_step_runs():
    """Two steps of `make_hybrik_train_step` on the port's HybrIK net (a
    64x64 input, 16x16 heatmaps) with theta through the IK: finite
    losses, the parameters moved, BatchNorm counted."""
    from mvsmplfitting_tpu_torch.detect import augment3d as A3
    from mvsmplfitting_tpu_torch.detect.hybrik import Simple3DPoseSMPLCam
    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl

    rng = np.random.default_rng(3)
    cfg = A3.Hybrik3DConfig(input_hw=(64, 64))
    samples = []
    for i in range(2):
        j17 = np.concatenate([rng.uniform(20, 100, (17, 2)),
                              rng.uniform(-400, 400, (17, 1))], 1)
        j29 = np.concatenate([rng.uniform(20, 100, (29, 2)),
                              rng.uniform(-400, 400, (29, 1))], 1)
        label = {"bbox": [15, 15, 110, 110], "joint_img_17": j17,
                 "joint_vis_17": np.ones((17, 3)),
                 "joint_relative_17": rng.normal(0, 300, (17, 3)),
                 "joint_img_29": j29, "joint_vis_29": np.ones((29, 3)),
                 "joint_cam_29": rng.normal(0, 300, (29, 3)),
                 "beta": rng.normal(0, 1, 10),
                 "theta": rng.normal(0, 0.3, (24, 3))}
        samples.append(A3.hybrik_train_sample(
            np.random.default_rng(i), rng.uniform(0, 255, (128, 128, 3)),
            label, cfg))
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples]))
             for k in samples[0]}
    net = Simple3DPoseSMPLCam(height_dim=16, width_dim=16,
                              input_size=64.0)
    T.flax_init(net, torch.Generator().manual_seed(0))
    before = net.fc1.weight.detach().clone()
    opt = T.Optimizer("adam", 1e-3, list(net.parameters()))
    state = T.init_train_state(net, opt)
    step = T.make_hybrik_train_step(assets=synthetic_smpl("smpl",
                                                          device="cpu"))
    for _ in range(2):
        loss, aux = step(state, batch)
        assert torch.isfinite(loss) and "loss_theta" in aux
    assert not torch.equal(before, net.fc1.weight)
    assert int(net.deconv_layers[1].num_batches_tracked) == 2
