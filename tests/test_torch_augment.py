"""The port's host augmentation (`data/imgproc.py`, `detect/augment.py`,
`detect/augment3d.py`, `detect/dataset.py`, `ops/crop.py`) against OpenCV
5.0.0 and the JAX package, on the same inputs.

* Each OpenCV counterpart against cv2 itself, bitwise: `warpAffine`
  (INTER_LINEAR, constant border 0 and 114; uint8 and float32, one and
  three channels; shrink, enlargement, rotation), `resize` INTER_LINEAR
  on float32 (bitwise on shrinks; on enlargements within one ulp of the
  output's largest magnitude, the documented bound), INTER_CUBIC on
  float64, INTER_NEAREST on uint8, and `cvtColor` RGB<->HSV on float32;
  the recorded goldens of `tools/make_imgproc_fixtures.py` still match
  cv2 and the port.
* `pose_train_sample`, `yolox_train_sample` (mosaic, affine, mixup, HSV,
  mirror) and `hybrik_train_sample` from the same seed: bitwise.
* The datasets' batches on a synthetic COCO workspace of JPEGs written
  by cv2 (`read_image` equals `cv2.imread` on them): bitwise.
* `crop` and `uncrop`: bitwise.
"""

import json
import os
import sys

import cv2
import numpy as np
import pytest

from mvsmplfitting_tpu.detect import augment as JA
from mvsmplfitting_tpu.detect import augment3d as J3
from mvsmplfitting_tpu.detect import dataset as JD
from mvsmplfitting_tpu.ops import crop as JC
from mvsmplfitting_tpu_torch.data import imgproc as P
from mvsmplfitting_tpu_torch.detect import augment as TA
from mvsmplfitting_tpu_torch.detect import augment3d as T3
from mvsmplfitting_tpu_torch.detect import dataset as TD
from mvsmplfitting_tpu_torch.ops import crop as TC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rot(deg, scale, tx, ty):
    a = np.deg2rad(deg)
    return np.array([[scale * np.cos(a), scale * np.sin(a), tx],
                     [-scale * np.sin(a), scale * np.cos(a), ty]])


WARP_CASES = {
    # name: (source shape, M, (w, h) out)
    "shrink": ((120, 160, 3), _rot(0.0, 0.4, 3.3, -2.1), (70, 50)),
    "enlarge": ((30, 25, 3), _rot(0.0, 4.2, -7.5, 5.0), (131, 97)),
    "rotate": ((90, 110, 3), _rot(33.0, 1.1, 20.0, -30.0), (140, 120)),
    "shear": ((64, 64, 3), np.array([[0.7, 0.1, 5.0], [-0.05, 0.8, -3.0]]),
              (57, 61)),
    "gray": ((75, 66), _rot(-71.0, 0.9, 40.0, 50.0), (83, 77)),
}


@pytest.mark.parametrize("border", [0.0, 114.0])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("case", sorted(WARP_CASES))
def test_warp_affine_equals_cv2(case, dtype, border):
    shape, M, out_wh = WARP_CASES[case]
    rng = np.random.default_rng(len(case) + len(dtype))
    img = (rng.integers(0, 256, shape, dtype=np.uint8) if dtype == "uint8"
           else rng.uniform(0, 255, shape).astype(np.float32))
    for m in (M, M.astype(np.float32)):
        ref = cv2.warpAffine(img, m, out_wh, flags=cv2.INTER_LINEAR,
                             borderValue=(border,) * 3)
        np.testing.assert_array_equal(P.warp_affine(img, m, out_wh, border),
                                      ref)


@pytest.mark.parametrize("seed", range(4))
def test_resize_linear_equals_cv2(seed):
    """Shrinks bitwise; enlargements within one ulp of the output's
    largest magnitude, and only in the border columns of an enlargement
    in x (ROADMAP C)."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        H, W = (int(v) for v in rng.integers(2, 90, 2))
        ow, oh = (int(v) for v in rng.integers(1, 180, 2))
        img = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
        ref = cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        out = P.resize_linear(img, (ow, oh))
        if ow <= W:
            np.testing.assert_array_equal(out, ref)
            continue
        ulp = np.spacing(np.float32(np.abs(ref).max()))
        assert np.abs(out - ref).max() <= ulp
        sx = (np.arange(ow) + 0.5) * W / ow - 0.5
        inner = (sx >= 0) & (sx < W - 1)
        np.testing.assert_array_equal(out[:, inner], ref[:, inner])
    with pytest.raises(ValueError):
        P.resize_linear(np.zeros((1, 5, 3), np.float32), (9, 3))


def test_resize_cubic_and_nearest_equal_cv2():
    rng = np.random.default_rng(5)
    for _ in range(12):
        H, W = (int(v) for v in rng.integers(2, 90, 2))
        ow, oh = (int(v) for v in rng.integers(1, 140, 2))
        for shape in ((H, W, 3), (H, W)):
            f = rng.uniform(-50, 300, shape)
            np.testing.assert_array_equal(
                P.resize_cubic(f, (ow, oh)),
                cv2.resize(f, (ow, oh), interpolation=cv2.INTER_CUBIC))
            u = rng.integers(0, 256, shape, dtype=np.uint8)
            np.testing.assert_array_equal(
                P.resize_nearest(u, (ow, oh)),
                cv2.resize(u, (ow, oh), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("kind", ["random", "ties", "quantized"])
def test_hsv_round_trip_equals_cv2(kind):
    rng = np.random.default_rng(6)
    for W in (5, 8, 23, 77):
        rgb = rng.uniform(0, 1, (13, W, 3)).astype(np.float32)
        if kind == "ties":
            rgb[:, ::2, 1] = rgb[:, ::2, 0]
            rgb[:, 1::3, 2] = rgb[:, 1::3, 0]
            rgb[0] = rgb[0, :, :1]
        elif kind == "quantized":
            rgb = (np.round(rgb * 8) / 8).astype(np.float32)
        hsv = cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)
        np.testing.assert_array_equal(P.rgb_to_hsv(rgb), hsv)
        r = rng.uniform(-1, 1, 3) * [0.015, 0.7, 0.4] + 1
        hsv[..., 0] = (hsv[..., 0] / 2.0 * r[0]) % 180.0 * 2.0
        hsv[..., 1] = np.clip(hsv[..., 1] * r[1], 0, 1)
        hsv[..., 2] = np.clip(hsv[..., 2] * r[2], 0, 1)
        np.testing.assert_array_equal(P.hsv_to_rgb(hsv),
                                      cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def test_imgproc_goldens_are_current():
    """The committed goldens still equal cv2 here, and the port equals
    them (the bounded case within its bound)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_imgproc_fixtures as F
    fix = os.path.join(ROOT, "tests", "fixtures", "imgproc")
    with open(os.path.join(fix, "golden.json")) as f:
        golden = json.load(f)
    assert golden["opencv"] == cv2.__version__
    assert [c["name"] for c in golden["cases"]] == [
        c["name"] for c in F.cases()]
    bounded = np.load(os.path.join(fix, "bounded.npz"))
    for case in golden["cases"]:
        assert F.sha(F.run_cv2(case)) == case["sha256"], case["name"]
        out = F.run_port(case)
        if case.get("bounded"):
            ref = bounded[case["name"]]
            assert F.sha(ref) == case["sha256"]
            ulp = np.spacing(np.float32(np.abs(ref).max()))
            assert np.abs(out - ref).max() <= ulp, case["name"]
        else:
            assert F.sha(out) == case["sha256"], case["name"]


# ---------------------------------------------------------------------------
# Augmentation samples against JAX's, same seeds

def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        return
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def test_pose_train_sample_equals_jax():
    rng = np.random.default_rng(7)
    for seed in range(12):
        img = rng.uniform(0, 1, (120, 90, 3)).astype(np.float32)
        joints = rng.uniform(5, 85, (17, 2)).astype(np.float32)
        vis = (rng.uniform(0, 1, 17) > 0.2).astype(np.float32)
        box = np.array([10, 10, 80, 110], np.float32)
        kw = dict(input_hw=(64, 48), prob_half_body=0.5)
        _equal(JA.pose_train_sample(np.random.default_rng(seed), img, box,
                                    joints, vis, JA.PoseAugConfig(**kw)),
               TA.pose_train_sample(np.random.default_rng(seed), img, box,
                                    joints, vis, TA.PoseAugConfig(**kw)))


def _mosaic_inputs(rng):
    imgs, labels = [], []
    for _ in range(4):
        H, W = (int(v) for v in rng.integers(50, 160, 2))
        imgs.append(rng.uniform(0, 255, (H, W, 3)).astype(np.float32))
        m = int(rng.integers(1, 4))
        xy = rng.uniform(0, 0.6, (m, 2)) * [W, H]
        wh = rng.uniform(0.2, 0.4, (m, 2)) * [W, H]
        labels.append(np.concatenate([xy, xy + wh, np.zeros((m, 1))],
                                     1).astype(np.float32))
    return imgs, labels


@pytest.mark.parametrize("mixup", [False, True])
def test_yolox_train_sample_equals_jax(mixup):
    rng = np.random.default_rng(8)
    for seed in range(8):
        imgs, labels = _mosaic_inputs(rng)
        cp = rng.uniform(0, 255, (90, 120, 3)).astype(np.float32)
        kw = dict(max_labels=20)
        if mixup:
            kw.update(cp_image=cp,
                      cp_labels=np.array([[5, 8, 70, 80, 0]], np.float32))
        _equal(JA.yolox_train_sample(np.random.default_rng(seed), imgs,
                                     labels, (64, 64), **kw),
               TA.yolox_train_sample(np.random.default_rng(seed), imgs,
                                     labels, (64, 64), **kw))


def _hybrik_label(rng):
    j17 = np.concatenate([rng.uniform(40, 200, (17, 2)),
                          rng.uniform(-500, 500, (17, 1))], 1)
    j29 = np.concatenate([rng.uniform(40, 200, (29, 2)),
                          rng.uniform(-500, 500, (29, 1))], 1)
    return {"bbox": [30, 20, 210, 230], "joint_img_17": j17,
            "joint_vis_17": np.ones((17, 3)) * (rng.uniform(0, 1, (17, 1))
                                                > 0.1),
            "joint_relative_17": rng.normal(0, 300, (17, 3)),
            "joint_img_29": j29, "joint_vis_29": np.ones((29, 3)),
            "joint_cam_29": rng.normal(0, 300, (29, 3)),
            "beta": rng.normal(0, 1, 10),
            "theta": rng.normal(0, 0.3, (24, 3)),
            "twist_phi": rng.normal(0, 1, (23, 2)),
            "twist_weight": np.ones((23, 2))}


@pytest.mark.parametrize("train", [True, False])
def test_hybrik_train_sample_equals_jax(train):
    rng = np.random.default_rng(9)
    for seed in range(6):
        src = rng.uniform(0, 255, (240, 260, 3)).astype(np.float32)
        label = _hybrik_label(rng)
        kw = dict(prob_half_body=0.3, add_dpg=bool(seed % 2))
        _equal(J3.hybrik_train_sample(np.random.default_rng(seed),
                                      src.copy(), label,
                                      J3.Hybrik3DConfig(**kw), train=train),
               T3.hybrik_train_sample(np.random.default_rng(seed),
                                      src.copy(), label,
                                      T3.Hybrik3DConfig(**kw), train=train))


@pytest.mark.parametrize("rot", [0.0, 25.0, -40.0])
def test_crop_and_uncrop_equal_jax(rot):
    rng = np.random.default_rng(10)
    for _ in range(4):
        img = rng.integers(0, 256, (100, 120, 3), dtype=np.uint8)
        c = rng.uniform(30, 90, 2)
        s = float(rng.uniform(0.2, 0.6))
        res = (int(rng.integers(20, 80)),) * 2
        a, b = JC.crop(img, c, s, res, rot), TC.crop(img, c, s, res, rot)
        assert b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            JC.uncrop(a.astype(np.uint8), c, s, img.shape),
            TC.uncrop(a.astype(np.uint8), c, s, img.shape))
        for pt in ([1, 1], [res[0] + 1, res[1] + 1]):
            np.testing.assert_array_equal(
                JC.transform_point(pt, c, s, res, invert=True, rot=rot),
                TC.transform_point(pt, c, s, res, invert=True, rot=rot))


# ---------------------------------------------------------------------------
# Datasets on a synthetic COCO workspace

@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """Person keypoints (17 joints, 6 images; a second file with 26) and
    instances (8 images, 1-3 boxes) in COCO's layout, JPEGs by cv2."""
    root = tmp_path_factory.mktemp("coco")
    img_dir = root / "images"
    os.makedirs(img_dir)
    rng = np.random.default_rng(11)
    files = {}
    for tag, J, n in (("kp17", 17, 6), ("kp26", 26, 4)):
        images, anns = [], []
        for i in range(n):
            H, W = 120, 90
            name = f"{tag}_{i}.jpg"
            cv2.imwrite(str(img_dir / name),
                        rng.integers(0, 255, (H, W, 3), np.uint8))
            images.append({"id": i, "file_name": name, "width": W,
                           "height": H})
            kp = np.zeros((J, 3), np.float32)
            kp[:, 0] = rng.uniform(15, 75, J)
            kp[:, 1] = rng.uniform(15, 105, J)
            kp[:, 2] = (rng.uniform(0, 1, J) > 0.2) * 2
            anns.append({"id": i, "image_id": i, "category_id": 1,
                         "bbox": [10, 10, 70, 100], "score": 0.9,
                         "keypoints": [float(v) for v in kp.ravel()]})
        files[tag] = str(root / f"{tag}.json")
        with open(files[tag], "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": 1, "name": "person"}]}, f)
    images, anns, aid = [], [], 0
    for i in range(8):
        H, W = 100, 140
        name = f"det_{i}.jpg"
        cv2.imwrite(str(img_dir / name),
                    rng.integers(0, 255, (H, W, 3), np.uint8))
        images.append({"id": i, "file_name": name, "width": W, "height": H})
        for _ in range(int(rng.integers(1, 4))):
            x, y = rng.uniform(0, W - 30), rng.uniform(0, H - 30)
            w, h = rng.uniform(15, 30), rng.uniform(15, 30)
            anns.append({"id": aid, "image_id": i, "category_id": 1,
                         "bbox": [x, y, w, h], "iscrowd": 0})
            aid += 1
    files["det"] = str(root / "det.json")
    with open(files["det"], "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)
    return files, str(img_dir)


def _batches_equal(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for u, v in zip(a, b):
        _equal(u._asdict() if hasattr(u, "_asdict") else u,
               v._asdict() if hasattr(v, "_asdict") else v)


def test_pose_eval_dataset_equals_jax(coco):
    files, img_root = coco
    kw = dict(input_size=(64, 48), batch_size=4)
    _batches_equal(JD.CocoPoseEvalDataset(files["kp17"], img_root, **kw),
                   TD.CocoPoseEvalDataset(files["kp17"], img_root, **kw))


@pytest.mark.parametrize("loss_type", ["heatmap", "integral"])
def test_pose_train_dataset_equals_jax(coco, loss_type):
    files, img_root = coco
    kw = dict(input_size=(64, 48), heatmap_size=(16, 12), batch_size=3,
              seed=1, loss_type=loss_type)
    j = JD.CocoPoseTrainDataset(files["kp17"], img_root, **kw)
    t = TD.CocoPoseTrainDataset(files["kp17"], img_root, **kw)
    for _ in range(2):               # two epochs: the reshuffle too
        _batches_equal(j, t)


def test_pose_train_dataset_concatenation_equals_jax(coco):
    """Two GT files of 17 and 26 joints, capped and padded to 20."""
    files, img_root = coco
    kw = dict(input_size=(64, 48), heatmap_size=(16, 12), batch_size=5,
              seed=2, num_joints=20)
    anns = [files["kp17"], files["kp26"]]
    j = JD.CocoPoseTrainDataset(anns, [img_root] * 2, **kw)
    t = TD.CocoPoseTrainDataset(anns, [img_root] * 2, **kw)
    assert t.num_joints == 20 and len(t) == 2
    _batches_equal(j, t)
    with pytest.raises(ValueError):
        TD.CocoPoseTrainDataset(anns, img_root, input_size=(64, 48))


@pytest.mark.parametrize("mode", ["mosaic_mixup", "mosaic", "no_aug"])
def test_det_train_dataset_equals_jax(coco, mode):
    files, img_root = coco
    kw = dict(input_hw=(64, 64), batch_size=4, max_labels=20, seed=3,
              mosaic=mode != "no_aug", enable_mixup=mode == "mosaic_mixup")
    j = JD.CocoDetTrainDataset(files["det"], img_root, **kw)
    t = TD.CocoDetTrainDataset(files["det"], img_root, **kw)
    assert t.num_classes == 1 and len(t) == 2
    _batches_equal(j, t)
