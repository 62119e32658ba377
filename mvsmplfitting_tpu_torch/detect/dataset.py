"""COCO-style pose datasets, evaluation and training (port of
`detect/dataset.py`; JAX's numpy carried over, its `cv2.imread` replaced
by `data/images.py:read_image` and its `cv2.warpAffine` / `cv2.resize`
by `data/imgproc.py`, OpenCV 5.0.0's arithmetic without OpenCV).

The reference ships 15 torch `data.Dataset` classes
(`alphapose_core/alphapose/datasets/`, e.g. `Mscoco_det` in
`coco_det.py:20-100`) that crop person boxes with `SimpleTransform`
and feed the pose nets for COCO evaluation.  The eval path here is
one class that walks a COCO `person_keypoints` annotation json (or a
detection-results json), crops every person box with the same affine
transform the predictor uses (`preprocess.crop_affine`), and yields
FIXED-SIZE padded batches (static shapes with validity masks) plus the
bookkeeping (image_id, inverse-transform centers/scales) needed to
write COCO results and score OKS mAP with `coco_io`/`metrics`.

`CocoPoseTrainDataset` is the training counterpart (the reference's
`Mscoco`/`Halpe_26` train datasets + `SimpleTransform(train=True)`):
it walks GT keypoint annotations, augments each person crop on the
host (`augment.pose_train_sample`: half-body / scale / rotation /
flip), builds Gaussian heatmap targets, and yields fixed-size batches
for `train.make_pose_train_step`.

Both train datasets serve data-parallel ranks (``rank``/``world``): a
rank yields its contiguous block of each global batch's rows, bitwise
the rows one process yields under the same seed.  Every row's random
draws come from one generator, in row order, so a rank replays the
other ranks' rows on `augment.ShapeOnly` images whose sizes come from
the file headers (`data/images.py:image_hw`): the draws read shapes,
boxes and joints, never pixels, and a rank decodes only its own rows'
images.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from ..parallel.data_parallel import block_rows


def _imread(path: str) -> Optional[np.ndarray]:
    """`cv2.imread(path)`: (H, W, 3) uint8 BGR, or None where the file
    does not exist; a file the reader refuses raises, naming it."""
    from ..data.images import read_image
    if not os.path.isfile(path):
        return None
    return read_image(path)


def _image_shape(path: str):
    """`_imread(path)`'s place in a draw replay: a `ShapeOnly` of the
    decoded image's shape from the headers, or None as `_imread`."""
    from ..data.images import image_hw
    from .augment import ShapeOnly
    if not os.path.isfile(path):
        return None
    return ShapeOnly((*image_hw(path), 3))


class PoseEvalBatch(NamedTuple):
    crops: np.ndarray        # (B, H, W, 3) float32, affine-cropped
    centers: np.ndarray      # (B, 2) crop centers (image coords)
    scales: np.ndarray       # (B, 2) crop scales
    image_ids: np.ndarray    # (B,) int
    scores: np.ndarray       # (B,) detection/annotation score
    valid: np.ndarray        # (B,) 1.0 for real rows, 0.0 padding


class CocoPoseEvalDataset:
    """Iterate padded crop batches from a COCO annotation/results json.

    Args:
      ann_or_det_file: COCO GT (`annotations` with bbox) or a
        detection-results list (`[{image_id, bbox, score}]`).
      img_root: directory with `<file_name>` or `<image_id:012d>.jpg`.
      input_size: crop (H, W) — the pose nets' input.
      batch_size: fixed batch; the tail is padded (valid mask 0).
    """

    def __init__(self, ann_or_det_file: str, img_root: str,
                 input_size: Tuple[int, int] = (256, 192),
                 batch_size: int = 32,
                 min_score: float = 0.0):
        self.img_root = img_root
        self.input_size = input_size
        self.batch_size = batch_size

        with open(ann_or_det_file) as f:
            data = json.load(f)
        self._file_names = {}
        if isinstance(data, dict):
            anns = data.get("annotations", [])
            for im in data.get("images", []):
                self._file_names[int(im["id"])] = im.get("file_name")
        else:
            anns = data
        self.entries: List[dict] = []
        for a in anns:
            if "bbox" not in a:
                continue
            score = float(a.get("score", 1.0))
            if score < min_score:
                continue
            self.entries.append({
                "image_id": int(a["image_id"]),
                "bbox": [float(v) for v in a["bbox"]],   # xywh
                "score": score,
            })

    def __len__(self) -> int:
        return len(self.entries)

    def _img_path(self, image_id: int) -> str:
        name = self._file_names.get(image_id)
        if name is None:
            name = f"{image_id:012d}.jpg"
        return os.path.join(self.img_root, name)

    def __iter__(self) -> Iterator[PoseEvalBatch]:
        # Host-side crops (warpAffine through the same centre/scale affine
        # as `preprocess.crop_affine`): the device only sees the finished
        # fixed-shape batch.
        from .augment import get_affine_transform, warp_affine
        from .preprocess import bbox_to_center_scale

        H, W = self.input_size
        cache_path, cache_img = None, None
        for start in range(0, len(self.entries), self.batch_size):
            chunk = self.entries[start:start + self.batch_size]
            B = self.batch_size
            crops = np.zeros((B, H, W, 3), np.float32)
            centers = np.zeros((B, 2), np.float32)
            scales = np.zeros((B, 2), np.float32)
            ids = np.zeros((B,), np.int64)
            scores = np.zeros((B,), np.float32)
            valid = np.zeros((B,), np.float32)
            for i, e in enumerate(chunk):
                path = self._img_path(e["image_id"])
                if path != cache_path:
                    cache_img = _imread(path)
                    cache_path = path
                if cache_img is None:
                    continue
                x, y, w, h = e["bbox"]
                box = np.asarray([[x, y, x + w, y + h]], np.float32)
                c, s = bbox_to_center_scale(box, W / H)
                img = cache_img[..., ::-1].astype(np.float32) / 255.0
                trans = get_affine_transform(c[0], s[0], 0.0, (W, H))
                crops[i] = warp_affine(img, trans, (W, H))
                centers[i], scales[i] = c[0], s[0]
                ids[i] = e["image_id"]
                scores[i] = e["score"]
                valid[i] = 1.0
            yield PoseEvalBatch(crops, centers, scales, ids, scores,
                                valid)


class CocoPoseTrainDataset:
    """Augmented training batches from a COCO `person_keypoints` GT
    json (reference: the torch train datasets + `SimpleTransform`
    train branch, `alphapose/datasets/mscoco.py` +
    `simple_transform.py:200-268`).

    Yields dicts {'image' (B,H,W,3) in [0,1], 'target' (B,Hm,Wm,J),
    'target_weight' (B,J)} — exactly `train.make_pose_train_step`'s
    batch contract.  Fixed batch size; the tail of an epoch is dropped
    (static shapes; an epoch boundary reshuffles).
    """

    def __init__(self, ann_file, img_root,
                 input_size: Tuple[int, int] = (256, 192),
                 heatmap_size: Tuple[int, int] = (64, 48),
                 batch_size: int = 32, sigma: float = 2.0,
                 aug=None, seed: int = 0, min_keypoints: int = 1,
                 loss_type: str = "heatmap", num_joints: int = 0,
                 rank: int = 0, world: int = 1):
        """``ann_file`` / ``img_root`` may be lists: multiple COCO GT
        jsons concatenate into one shuffled pool (the reference's
        `datasets/concat_dataset.py` + the merged
        `halpe_coco_wholebody_*` classes).  ``num_joints`` > 0
        truncates wider GT rows / zero-pads narrower ones to a common
        width — the merged classes' `keypoints[:num_joints*3]` rule
        (`halpe_coco_wholebody_26.py:118,189`).  ``batch_size`` is the
        global batch; data-parallel ``rank`` of ``world`` yields its
        block of it (see the module docstring)."""
        from .augment import PoseAugConfig
        if loss_type not in ("heatmap", "integral"):
            raise ValueError(f"unknown loss_type {loss_type!r}")
        ann_files = ([ann_file] if isinstance(ann_file, str)
                     else list(ann_file))
        img_roots = ([img_root] * len(ann_files)
                     if isinstance(img_root, str) else list(img_root))
        if len(img_roots) != len(ann_files):
            raise ValueError("img_root list must match ann_file list")
        self.img_roots = img_roots
        self.input_size = input_size
        self.heatmap_size = heatmap_size
        self.batch_size = batch_size
        self.rows = block_rows(batch_size, rank, world)
        self.sigma = sigma
        self.loss_type = loss_type
        self.aug = aug or PoseAugConfig(input_hw=input_size)
        self.rng = np.random.default_rng(seed)

        self._file_names = {}
        self.entries = []
        for src, path in enumerate(ann_files):
            with open(path) as f:
                data = json.load(f)
            for im in data.get("images", []):
                self._file_names[(src, int(im["id"]))] = \
                    im.get("file_name")
            for a in data.get("annotations", []):
                kp = a.get("keypoints")
                if not kp or "bbox" not in a:
                    continue
                kp = np.asarray(kp, np.float32).reshape(-1, 3)
                if num_joints > 0:
                    if len(kp) > num_joints:
                        kp = kp[:num_joints]
                    elif len(kp) < num_joints:
                        kp = np.concatenate(
                            [kp, np.zeros((num_joints - len(kp), 3),
                                          np.float32)])
                if (kp[:, 2] > 0).sum() < min_keypoints:
                    continue
                self.entries.append({
                    "src": src,
                    "image_id": int(a["image_id"]),
                    "bbox": [float(v) for v in a["bbox"]],    # xywh
                    "joints": kp[:, :2],
                    "vis": (kp[:, 2] > 0).astype(np.float32),
                })
        widths = {e["joints"].shape[0] for e in self.entries}
        if len(widths) > 1:
            raise ValueError(
                f"annotation files carry mixed joint counts "
                f"{sorted(widths)}; pass num_joints=<J> to apply the "
                f"truncate/pad rule")
        if self.entries:
            self.num_joints = self.entries[0]["joints"].shape[0]

    def __len__(self) -> int:
        return len(self.entries) // self.batch_size

    def _img_path(self, src: int, image_id: int) -> str:
        name = self._file_names.get((src, image_id))
        if name is None:
            name = f"{image_id:012d}.jpg"
        return os.path.join(self.img_roots[src], name)

    def __iter__(self):
        from .augment import pose_train_sample
        from .train import heatmap_targets_np, integral_targets_np

        order = self.rng.permutation(len(self.entries))
        H, W = self.input_size
        Hm, Wm = self.heatmap_size
        J = self.num_joints
        integral = self.loss_type == "integral"
        n, lo = len(self.rows), self.rows.start
        for start in range(0, len(order) - self.batch_size + 1,
                           self.batch_size):
            imgs = np.zeros((n, H, W, 3), np.float32)
            if integral:
                targets = np.zeros((n, J * 2), np.float32)
                weights = np.zeros((n, J * 2), np.float32)
            else:
                targets = np.zeros((n, Hm, Wm, J), np.float32)
                weights = np.zeros((n, J), np.float32)
            for row, idx in enumerate(order[start:start +
                                            self.batch_size]):
                e = self.entries[idx]
                path = self._img_path(e.get("src", 0), e["image_id"])
                x, y, w, h = e["bbox"]
                box = np.asarray([x, y, x + w, y + h], np.float32)
                if row not in self.rows:
                    # another rank's row: its draws, no pixels
                    shape = _image_shape(path)
                    if shape is not None:
                        pose_train_sample(self.rng, shape, box, e["joints"],
                                          e["vis"], self.aug)
                    continue
                img = _imread(path)
                if img is None:
                    continue
                crop, j_t, v_t = pose_train_sample(
                    self.rng, img[..., ::-1].astype(np.float32) / 255.0,
                    box, e["joints"], e["vis"], self.aug)
                i = row - lo
                imgs[i] = crop
                if integral:
                    t, tw = integral_targets_np(j_t, v_t, (H, W))
                    targets[i], weights[i] = t, tw
                else:
                    t, tw = heatmap_targets_np(j_t, v_t, (Hm, Wm),
                                               (H, W), self.sigma)
                    targets[i] = np.transpose(np.asarray(t), (1, 2, 0))
                    weights[i] = np.asarray(tw)[:, 0]
            yield {"image": imgs, "target": targets,
                   "target_weight": weights}


class CocoDetTrainDataset:
    """Mosaic-augmented detection training batches from a COCO
    `instances` GT json (reference: `yolox/data/datasets/coco.py` +
    `MosaicDetection`, `yolox/data/datasets/mosaicdetection.py:36-160`).

    Yields dicts {'image': (B,H,W,3) float32 BGR 0-255, 'labels':
    (B, max_labels, 5) [cls, cx, cy, w, h] zero-padded} — exactly
    `train.make_yolox_train_step`'s batch contract.  ``mosaic=False``
    is the reference's final `no_aug` epochs mode (plain letterbox
    resize + mirror, `yolox/exp/yolox_base.py` close_mosaic semantics).
    Fixed batch size; the epoch tail is dropped (static shapes).
    """

    def __init__(self, ann_file: str, img_root: str,
                 input_hw: Tuple[int, int] = (640, 640),
                 batch_size: int = 8, max_labels: int = 100,
                 seed: int = 0, mosaic: bool = True,
                 degrees: float = 10.0, translate: float = 0.1,
                 scale_range: Tuple[float, float] = (0.5, 1.5),
                 shear: float = 2.0, mirror_prob: float = 0.5,
                 enable_mixup: bool = True,
                 mixup_scale: Tuple[float, float] = (0.5, 1.5),
                 rank: int = 0, world: int = 1):
        """``batch_size`` is the global batch; data-parallel ``rank`` of
        ``world`` yields its block of it (see the module docstring)."""
        self.img_root = img_root
        self.rows = block_rows(batch_size, rank, world)
        self.input_hw = input_hw
        self.batch_size = batch_size
        self.max_labels = max_labels
        self.mosaic = mosaic
        # MixUp rides the mosaic path only, as in the reference trainer
        # (`mosaicdetection.py:148-160`, enable_mixup=True default;
        # close_mosaic disables both).
        self.enable_mixup = enable_mixup
        self.mixup_scale = mixup_scale
        self.aug = dict(degrees=degrees, translate=translate,
                        scale_range=scale_range, shear=shear)
        self.mirror_prob = mirror_prob
        self.rng = np.random.default_rng(seed)

        with open(ann_file) as f:
            data = json.load(f)
        self._file_names = {int(im["id"]): im.get("file_name")
                            for im in data.get("images", [])}
        cat_ids = sorted(c["id"] for c in data.get("categories", []))
        self.class_of = {cid: i for i, cid in enumerate(cat_ids)}
        self.num_classes = max(len(cat_ids), 1)
        boxes: dict = {}
        for a in data.get("annotations", []):
            if "bbox" not in a or a.get("iscrowd", 0):
                continue
            x, y, w, h = (float(v) for v in a["bbox"])
            if w <= 0 or h <= 0:
                continue
            cls = self.class_of.get(int(a.get("category_id", 1)), 0)
            boxes.setdefault(int(a["image_id"]), []).append(
                [x, y, x + w, y + h, cls])
        self.entries = [
            {"image_id": iid, "labels": np.asarray(lab, np.float32)}
            for iid, lab in sorted(boxes.items())]

    def __len__(self) -> int:
        return len(self.entries) // self.batch_size

    def _load(self, idx: int, pixels: bool = True):
        """(image, labels) of entry `idx`; a missing file is a black
        image of the input size.  ``pixels=False``: a `ShapeOnly` from
        the headers in the image's place."""
        from .augment import ShapeOnly
        e = self.entries[idx]
        name = self._file_names.get(e["image_id"])
        if name is None:
            name = f"{e['image_id']:012d}.jpg"
        path = os.path.join(self.img_root, name)
        if not pixels:
            shape = _image_shape(path)
            return (ShapeOnly((*self.input_hw, 3)) if shape is None
                    else shape), e["labels"]
        img = _imread(path)
        if img is None:
            img = np.zeros((*self.input_hw, 3), np.uint8)
        return img.astype(np.float32), e["labels"]

    def _plain_sample(self, idx: int, pixels: bool = True):
        """letterbox resize + mirror (the no-mosaic TrainTransform
        path, `data_augment.py:189-271`)."""
        from ..data.imgproc import resize_linear
        from .augment import ShapeOnly, labels_to_padded, mirror_boxes
        img, lab = self._load(idx, pixels)
        ih, iw = self.input_hw
        h0, w0 = img.shape[:2]
        r = min(ih / h0, iw / w0)
        if pixels:
            resized = resize_linear(img, (int(w0 * r), int(h0 * r)))
            canvas = np.full((ih, iw, 3), 114.0, np.float32)
            canvas[:resized.shape[0], :resized.shape[1]] = resized
        else:
            canvas = ShapeOnly((ih, iw, 3))
        lab = lab.copy()
        lab[:, :4] *= r
        canvas, lab = mirror_boxes(self.rng, canvas, lab,
                                   self.mirror_prob)
        return canvas, labels_to_padded(lab, self.max_labels)

    def __iter__(self):
        from .augment import yolox_train_sample

        order = self.rng.permutation(len(self.entries))
        H, W = self.input_hw
        n, lo = len(self.rows), self.rows.start
        for start in range(0, len(order) - self.batch_size + 1,
                           self.batch_size):
            imgs = np.zeros((n, H, W, 3), np.float32)
            labels = np.zeros((n, self.max_labels, 5), np.float32)
            for row, idx in enumerate(order[start:start
                                            + self.batch_size]):
                # another rank's row: its draws on the images' shapes
                pixels = row in self.rows
                if self.mosaic:
                    picks = [int(idx)] + [
                        int(v) for v in self.rng.integers(
                            0, len(self.entries), 3)]
                    loaded = [self._load(p, pixels) for p in picks]
                    cp_img = cp_lab = None
                    if self.enable_mixup:
                        # every entry has >= 1 box by construction, so
                        # one draw replaces the reference's
                        # resample-until-annotated loop (`:166-168`).
                        cp_img, cp_lab = self._load(int(
                            self.rng.integers(0, len(self.entries))),
                            pixels)
                    img, lab = yolox_train_sample(
                        self.rng, [im for im, _ in loaded],
                        [lb for _, lb in loaded], self.input_hw,
                        max_labels=self.max_labels,
                        cp_image=cp_img, cp_labels=cp_lab,
                        mixup_scale=self.mixup_scale, **self.aug)
                else:
                    img, lab = self._plain_sample(int(idx), pixels)
                if pixels:
                    imgs[row - lo] = img
                    labels[row - lo] = lab
            yield {"image": imgs, "labels": labels}
