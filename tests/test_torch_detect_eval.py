"""The port's COCO mask API, evaluation metrics and COCO file IO
(`detect/masks.py`, `metrics.py`, `coco_io.py`) against JAX's, on the
CPU.

Both are the same numpy code on the same seeded inputs, so every result
is held exactly: RLE strings and counts, decoded masks, areas, PCK, OKS,
mAP values and the bytes of the written files.
"""

import json

import numpy as np

from mvsmplfitting_tpu.detect import coco_io as JC
from mvsmplfitting_tpu.detect import masks as JM
from mvsmplfitting_tpu.detect import metrics as JMT
from mvsmplfitting_tpu_torch.detect import coco_io as TC
from mvsmplfitting_tpu_torch.detect import masks as TM
from mvsmplfitting_tpu_torch.detect import metrics as TMT


def _polygons(rng, n, h, w):
    out = []
    for _ in range(n):
        k = int(rng.integers(3, 9))
        c = rng.uniform([0, 0], [w, h])
        r = rng.uniform(2, 0.4 * min(h, w))
        a = np.sort(rng.uniform(0, 2 * np.pi, k))
        pts = c + r * np.stack([np.cos(a), np.sin(a)], -1)
        pts += rng.normal(0, 1.5, pts.shape)     # some leave the image
        out.append([float(v) for v in pts.reshape(-1)])
    return out


def test_masks_match_jax():
    rng = np.random.default_rng(0)
    h, w = 37, 53
    for _ in range(6):
        m = (rng.random((h, w)) < rng.uniform(0.05, 0.9)).astype(np.uint8)
        for compress in (True, False):
            got, want = TM.rle_encode(m, compress), JM.rle_encode(m, compress)
            assert got == want
            np.testing.assert_array_equal(TM.rle_decode(got),
                                          JM.rle_decode(want))
        rle = TM.rle_encode(m)
        assert TM.rle_area(rle) == JM.rle_area(rle) == int(m.sum())
        counts = TM.string_to_counts(rle["counts"])
        np.testing.assert_array_equal(counts,
                                      JM.string_to_counts(rle["counts"]))
        assert TM.counts_to_string(counts) == JM.counts_to_string(counts)
    polys = _polygons(rng, 8, h, w)
    rles = []
    for p in polys:
        got, want = TM.poly_to_rle(p, h, w), JM.poly_to_rle(p, h, w)
        assert got == want
        rles.append(got)
    for intersect in (False, True):
        assert (TM.merge_rles(rles[:3], intersect)
                == JM.merge_rles(rles[:3], intersect))
    m = (rng.random((h, w)) < 0.3).astype(np.uint8)
    for segm in (polys[:3], {"counts": TM.rle_encode(m, False)["counts"]},
                 TM.rle_encode(m)):
        np.testing.assert_array_equal(TM.ann_to_mask(segm, h, w),
                                      JM.ann_to_mask(segm, h, w))


def _pose_sets(rng, images=4, J=17):
    preds, gts = [], []
    for i in range(images):
        M = int(rng.integers(0, 4))
        g = rng.uniform(0, 200, (M, J, 2)).astype(np.float32)
        gts.append({"keypoints": g, "vis": rng.random((M, J)) < 0.8,
                    "areas": rng.uniform(500, 5000, M).astype(np.float32)})
        K = int(rng.integers(0, 5))
        p = np.concatenate([g + rng.normal(0, 4, g.shape),
                            rng.uniform(0, 200, (max(K - M, 0), J, 2))]
                           )[:K].astype(np.float32)
        preds.append({"keypoints": p,
                      "scores": rng.random(len(p)).astype(np.float32)})
    return preds, gts


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    N, J, H, W = 3, 17, 16, 12
    pred_hms = rng.random((N, J, H, W)).astype(np.float32)
    label_hms = rng.random((N, J, H, W)).astype(np.float32)
    for a, b in zip(TMT.max_preds(pred_hms), JMT.max_preds(pred_hms)):
        np.testing.assert_array_equal(a, b)
    assert (TMT.heatmap_pck(pred_hms, label_hms)
            == JMT.heatmap_pck(pred_hms, label_hms))
    for out_3d, norm in ((False, "softmax"), (False, "sigmoid"),
                         (True, "softmax")):
        dims = 3 if out_3d else 2
        hms = rng.normal(0, 2, (N, J * (H if out_3d else 1), H, W))
        labels = rng.uniform(-0.5, 0.5, (N, J * dims))
        masks = (rng.random((N, J * dims)) < 0.8).astype(np.float32)
        assert (TMT.integral_pck(hms, labels, masks, out_3d, norm)
                == JMT.integral_pck(hms, labels, masks, out_3d, norm))
    preds, gts = _pose_sets(rng)
    g = gts[next(i for i, x in enumerate(gts) if len(x["areas"]))]
    assert (TMT.keypoint_oks(g["keypoints"][0] + 3, g["keypoints"][0],
                             float(g["areas"][0]), g["vis"][0])
            == JMT.keypoint_oks(g["keypoints"][0] + 3, g["keypoints"][0],
                                float(g["areas"][0]), g["vis"][0]))
    assert TMT.keypoint_map(preds, gts) == JMT.keypoint_map(preds, gts)

    bp, bg = [], []
    for _ in range(4):
        M = int(rng.integers(1, 5))
        xy = rng.uniform(0, 100, (M, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 50, (M, 2))], 1)
        cls = rng.integers(0, 3, M)
        bg.append({"boxes": boxes, "classes": cls})
        bp.append({"boxes": boxes + rng.normal(0, 3, boxes.shape),
                   "scores": rng.random(M), "classes": cls})
    np.testing.assert_array_equal(
        TMT.box_iou_xyxy(bp[0]["boxes"], bg[0]["boxes"]),
        JMT.box_iou_xyxy(bp[0]["boxes"], bg[0]["boxes"]))
    assert TMT.box_map(bp, bg) == JMT.box_map(bp, bg)
    a, b = rng.random((20, 20)) < 0.5, rng.random((20, 20)) < 0.5
    assert TMT.mask_iou(a, b) == JMT.mask_iou(a, b)


def test_coco_io_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    preds, gts = _pose_sets(rng, images=5)
    anns, images = [], []
    for img, g in enumerate(gts):
        images.append({"id": img, "file_name": f"{img:012d}.jpg"})
        for m in range(len(g["areas"])):
            kp = np.concatenate([g["keypoints"][m],
                                 2.0 * g["vis"][m][:, None]], 1)
            anns.append({"image_id": img, "category_id": 1,
                         "keypoints": [float(v) for v in kp.reshape(-1)],
                         "area": float(g["areas"][m]),
                         "bbox": [0.0, 0.0, 10.0, 20.0]})
    anns.append({"image_id": 1, "category_id": 2, "keypoints": [0.0] * 51})
    ann_path = tmp_path / "gt.json"
    ann_path.write_text(json.dumps({"images": images, "annotations": anns}))
    ids = list(range(len(preds)))
    kps = [p["keypoints"] for p in preds]
    scores = [p["scores"] for p in preds]
    TC.save_coco_results(str(tmp_path / "t.json"), ids, kps, scores)
    JC.save_coco_results(str(tmp_path / "j.json"), ids, kps, scores)
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].keys() == b[k].keys()
            for f in a[k]:
                np.testing.assert_array_equal(a[k][f], b[k][f])
    same(TC.load_coco_annotations(str(ann_path)),
         JC.load_coco_annotations(str(ann_path)))
    same(TC.load_coco_results(str(tmp_path / "t.json")),
         JC.load_coco_results(str(tmp_path / "t.json")))
    got = TC.evaluate_coco_map(str(ann_path), str(tmp_path / "t.json"))
    assert got == JC.evaluate_coco_map(str(ann_path),
                                       str(tmp_path / "t.json"))
    assert 0.0 < got <= 1.0
