"""The keypoint front end: camera images -> per-person 2D keypoints
(port of `detect/predictor.py:52-316`), and HybrIK's SMPL regression
(`SmplPoseEstimator`).

Per frame, every camera's image is decoded on the host
(`data/images.py`, one thread a view) and copied to the device,
letterboxed there and run through the detector as one batch; box selection (NMS) runs on the host
as in JAX; each view's boxes are cropped on the device and run through
the pose net in chunks of 80; heatmaps are decoded on the device and the
keypoints written as OpenPose JSONs, which the fitting CLI reads.

`bf16=True` casts a net's parameters and inputs to bfloat16 and its
outputs back to float32, as JAX's `cast_floats` / `_make_apply`
(`:28-49`); letterboxing, decoding, NMS and heatmap decoding stay fp32.

Each stage is timed by a `utils.profiling.StageTimer` (host seconds,
synchronized; the nets' forwards also with CUDA events): "decode" (and
the copy to the device), "letterbox", "detector", "nms" (with the copy
of the decoded boxes to the host), "crop", "pose", "heatmap", "json".
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.images import read_image
from ..data.keypoints import save_keypoints_json
from ..device import DeviceLike, resolve_device
from ..utils.profiling import StageTimer
from .fastpose import FastPose
from .preprocess import (COCO_FLIP_PAIRS, bbox_to_center_scale, crop_affine,
                         flip_heatmap, heatmap_to_coords, letterbox,
                         normalize_crops)
from .weights import random_state_dict
from .yolox import YOLOX, candidate_count, postprocess_boxes


def prepare(model: torch.nn.Module, state_dict: Optional[Mapping], seed: int,
            device: torch.device, bf16: bool) -> torch.nn.Module:
    """Loads `state_dict` (or seeded random weights) into `model` and
    moves it to `device` in eval mode, in bfloat16 when asked."""
    if state_dict is None:
        state_dict = random_state_dict(model,
                                       torch.Generator().manual_seed(seed))
    model.load_state_dict(state_dict)
    model = model.to(device).eval()
    return model.to(torch.bfloat16) if bf16 else model


class PersonDetector:
    """YOLOX-X person detector (reference `yolox/yolox.py:19-224`)."""

    def __init__(self, state_dict: Optional[Mapping] = None,
                 input_hw: Tuple[int, int] = (800, 1440),
                 conf_thresh: float = 0.1, nms_thresh: float = 0.45,
                 seed: int = 0, depth_mul: float = 1.33,
                 width_mul: float = 1.25, bf16: bool = False,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.input_hw = tuple(input_hw)
        self.conf_thresh = conf_thresh
        self.nms_thresh = nms_thresh
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        self.model = prepare(YOLOX(depth_mul=depth_mul, width_mul=width_mul),
                             state_dict, seed, self.device, bf16)

    def letterbox_batch(self, imgs: Sequence[torch.Tensor]
                        ) -> Tuple[torch.Tensor, List[float]]:
        """(H, W, 3) uint8 BGR images on the device -> (N, 3, ih, iw)."""
        outs = [letterbox(img, self.input_hw) for img in imgs]
        return torch.stack([o for o, _ in outs]), [r for _, r in outs]

    @torch.inference_mode()
    def forward(self, batch: torch.Tensor) -> torch.Tensor:
        """Letterboxed batch -> decoded (N, anchors, 6), float32."""
        return self.model(batch.to(self.dtype)).float()

    def select(self, decoded: torch.Tensor, ratios: Sequence[float],
               stats: Optional[List[Dict]] = None) -> List[np.ndarray]:
        """Decoded predictions -> per image (M, 5) xyxy + score boxes in
        source pixels; `stats` gets each image's candidate and kept
        counts and NMS host seconds."""
        out = []
        for dec, r in zip(decoded.cpu().numpy(), ratios):
            t0 = time.perf_counter()
            boxes = postprocess_boxes(dec, self.conf_thresh, self.nms_thresh)
            seconds = time.perf_counter() - t0
            boxes[:, :4] /= r
            out.append(boxes)
            if stats is not None:
                stats.append({"candidates": candidate_count(
                    dec, self.conf_thresh), "kept": len(boxes),
                    "nms_s": seconds})
        return out

    def detect_batch(self, imgs: Sequence, timer: Optional[StageTimer] = None,
                     stats: Optional[List[Dict]] = None) -> List[np.ndarray]:
        """BGR uint8 images (numpy or tensors) -> per image (M, 5) boxes."""
        timer = StageTimer() if timer is None else timer
        with timer.time("letterbox") as box:
            batch, ratios = self.letterbox_batch(
                [torch.as_tensor(i).to(self.device) for i in imgs])
            box["sync"] = batch
        with timer.time("detector") as box, \
                timer.device("detector", self.device):
            decoded = self.forward(batch)
            box["sync"] = decoded
        with timer.time("nms"):
            return self.select(decoded, ratios, stats)


class PoseEstimator:
    """Heatmap keypoints (reference `alphapose_core/alphapose_core.py:
    19-226`): FastPose by default, any zoo net through `model`."""

    def __init__(self, state_dict: Optional[Mapping] = None,
                 num_joints: int = 26,
                 input_hw: Tuple[int, int] = (256, 192), seed: int = 0,
                 batch: int = 80, use_pose_nms: bool = False,
                 bf16: bool = False, flip_test: bool = False,
                 joint_pairs=COCO_FLIP_PAIRS,
                 model: Optional[torch.nn.Module] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        model = model if model is not None else FastPose(num_joints)
        self.num_out = getattr(model, "num_joints_dense", model.num_joints)
        self.input_hw = tuple(input_hw)
        self.batch = batch
        # Pose NMS and the flip test are off by default, as in the
        # reference demo (`alphapose_core.py:35-37`).
        self.use_pose_nms = use_pose_nms
        self.flip_test = flip_test
        self.joint_pairs = tuple(joint_pairs)
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        self.model = prepare(model, state_dict, seed, self.device, bf16)

    @torch.inference_mode()
    def heatmaps(self, crops: torch.Tensor) -> torch.Tensor:
        """[0, 1] RGB crops (M, 3, h, w) -> float32 heatmaps, in chunks of
        `batch`, each chunk with its mirror when `flip_test` is on."""
        hms = []
        for i in range(0, crops.shape[0], self.batch):
            chunk = normalize_crops(crops[i:i + self.batch])
            if self.flip_test:
                n = chunk.shape[0]
                hm = self.model(torch.cat([chunk, chunk.flip(3)]).to(
                    self.dtype)).float()
                hm = 0.5 * (hm[:n] + flip_heatmap(hm[n:], self.joint_pairs))
            else:
                hm = self.model(chunk.to(self.dtype)).float()
            hms.append(hm)
        return torch.cat(hms)

    def estimate(self, img_rgb01: torch.Tensor, boxes_xyxy: np.ndarray,
                 timer: Optional[StageTimer] = None) -> np.ndarray:
        """Image ((3, H, W) [0, 1] RGB on the device) + boxes (M, >=4)
        -> keypoints (M, J, 3) [x, y, confidence]."""
        timer = StageTimer() if timer is None else timer
        if len(boxes_xyxy) == 0:
            return np.zeros((0, self.num_out, 3), np.float32)
        ih, iw = self.input_hw
        with timer.time("crop") as box:
            centers, scales = bbox_to_center_scale(boxes_xyxy[:, :4],
                                                   aspect_ratio=iw / ih)
            c = torch.as_tensor(centers, device=self.device)
            s = torch.as_tensor(scales, device=self.device)
            crops = crop_affine(img_rgb01, c, s, self.input_hw)
            box["sync"] = crops
        with timer.time("pose") as box, timer.device("pose", self.device):
            hms = self.heatmaps(crops)
            box["sync"] = hms
        with timer.time("heatmap"):
            coords, conf = heatmap_to_coords(hms, c, s)
            coords, conf = coords.cpu().numpy(), conf.cpu().numpy()
            if self.use_pose_nms and coords.shape[0] > 1:
                from .pose_nms import pose_nms
                scores = (boxes_xyxy[:, 4] if boxes_xyxy.shape[1] > 4
                          else np.ones(len(boxes_xyxy), np.float32))
                _, coords, conf = pose_nms(
                    np.asarray(boxes_xyxy[:, :4], np.float32), scores,
                    coords, conf)
        return np.concatenate([coords, conf[..., None]],
                              axis=-1).astype(np.float32)


class SmplPoseEstimator:
    """HybrIK direct SMPL regression from person crops (port of JAX's
    `detect/predictor.py:164-290`; the reference's `writer_smpl.py` with
    `simple3dposeSMPLWithCam.py`): each box is cropped (256x256 by
    default), `Simple3DPoseSMPLCam` regresses a 29-joint uvd skeleton,
    shape, twists and a weak-perspective camera, and the twist-and-swing
    IK (`models/hybrik.py`) poses the SMPL body.  All of a frame's people
    run as one batch (chunks of `batch`); the IK and skinning run batched
    on the device in float32 (`bf16=True` runs only the net in
    bfloat16).  Stages: "crop", "smpl_net" and "ik" (also by CUDA
    events), "smpl_host" (the copies and the writer's arithmetic)."""

    def __init__(self, state_dict: Optional[Mapping] = None, assets=None,
                 input_hw: Tuple[int, int] = (256, 256), seed: int = 0,
                 batch: int = 16, focal_length: float = 1000.0,
                 depth_factor: float = 2.0, bf16: bool = False,
                 device: DeviceLike = None):
        from ..models.assets import synthetic_smpl
        from .hybrik import Simple3DPoseSMPLCam
        self.device = resolve_device(device)
        ih, iw = input_hw
        self.input_hw = tuple(input_hw)
        self.batch = batch
        self.focal_length = focal_length
        self.depth_factor = depth_factor
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        self.model = prepare(Simple3DPoseSMPLCam(
            width_dim=iw // 4, height_dim=ih // 4,
            focal_length=focal_length, input_size=float(ih),
            depth_factor=depth_factor), state_dict, seed, self.device, bf16)
        # The SMPL pickle is licence-gated: the synthetic body keeps the
        # shapes (pass `load_smpl(...)` assets for human meshes).
        self.assets = (assets if assets is not None
                       else synthetic_smpl(device=self.device))
        self.faces = self.assets.faces.cpu().numpy()

    @torch.inference_mode()
    def regress(self, crops: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[0, 1] RGB crops (M, 3, h, w) -> the net's outputs in float32,
        in chunks of `batch`."""
        outs = [self.model(normalize_crops(crops[i:i + self.batch]).to(
            self.dtype)) for i in range(0, crops.shape[0], self.batch)]
        return {k: torch.cat([o[k] for o in outs]).float() for k in outs[0]}

    @torch.inference_mode()
    def bodies(self, out: Dict[str, torch.Tensor]):
        """The net's outputs -> (camera-frame vertices (M, V, 3),
        root-relative xyz (M, 29, 3) in depth_factor units)."""
        from ..models.hybrik import forward_rotmats, hybrik_ik
        from .hybrik import uvd_to_xyz
        xyz, root = uvd_to_xyz(out["pred_uvd_jts"], out["pred_camera"],
                               self.focal_length, float(self.input_hw[0]),
                               self.depth_factor)
        phis = out["pred_phi"]
        # The twists' (cos, sin) are normalized first
        # (`simple3dposeSMPLWithCam.py`'s HybrIK layer).
        phis = phis / torch.clamp_min(
            torch.linalg.vector_norm(phis, dim=-1, keepdim=True), 1e-8)
        betas = out["pred_shape"]
        rots = hybrik_ik(self.assets, xyz * self.depth_factor, betas, phis)
        verts, _ = forward_rotmats(self.assets, betas, rots)
        return verts + root[:, None, :], xyz

    def estimate(self, img_rgb01: torch.Tensor, boxes_xyxy: np.ndarray,
                 timer: Optional[StageTimer] = None) -> Dict[str, np.ndarray]:
        """Image ((3, H, W) [0, 1] RGB on the device) + boxes (M, >=4) ->
        per person: ``keypoints`` (M, 29, 2) image uv with the
        reference's width-only crop scaling of both axes
        (`writer_smpl.py:108-114`), ``kp_score`` (M, 29, 1) = 1 -
        maxvals (`:116`), ``pred_xyz_jts`` (M, 24, 3) root-relative
        joints in depth_factor units (the writer's `pred_xyz_jts_24`),
        ``verts`` (M, V, 3) camera-frame meshes, ``proposal_score`` (M,)
        = mean(kp) + box + 1.25 max(kp) (`:131`), and the crops'
        ``centers`` / ``scales``."""
        timer = StageTimer() if timer is None else timer
        J = self.model.num_joints
        if len(boxes_xyxy) == 0:
            z = np.zeros
            return {"keypoints": z((0, J, 2), np.float32),
                    "kp_score": z((0, J, 1), np.float32),
                    "pred_xyz_jts": z((0, 24, 3), np.float32),
                    "verts": z((0, self.assets.num_verts, 3), np.float32),
                    "proposal_score": z((0,), np.float32),
                    "centers": z((0, 2), np.float32),
                    "scales": z((0, 2), np.float32)}
        ih, iw = self.input_hw
        with timer.time("crop") as box:
            centers, scales = bbox_to_center_scale(boxes_xyxy[:, :4],
                                                   aspect_ratio=iw / ih)
            crops = crop_affine(img_rgb01,
                                torch.as_tensor(centers, device=self.device),
                                torch.as_tensor(scales, device=self.device),
                                self.input_hw)
            box["sync"] = crops
        with timer.time("smpl_net") as box, \
                timer.device("smpl_net", self.device):
            out = self.regress(crops)
            box["sync"] = out["pred_uvd_jts"]
        with timer.time("ik") as box, timer.device("ik", self.device):
            verts, xyz = self.bodies(out)
            box["sync"] = verts
        with timer.time("smpl_host"):
            uvd = out["pred_uvd_jts"].cpu().numpy()
            kp_score = 1.0 - out["maxvals"].cpu().numpy()
            uv_img = uvd[:, :, :2] * scales[:, None, 0:1] + centers[:, None, :]
            box_score = (boxes_xyxy[:, 4] if boxes_xyxy.shape[1] > 4
                         else np.ones(len(boxes_xyxy), np.float32))
            proposal = (kp_score.mean((1, 2)) + box_score
                        + 1.25 * kp_score.max((1, 2)))
            result = {"keypoints": uv_img.astype(np.float32),
                      "kp_score": kp_score.astype(np.float32),
                      "pred_xyz_jts": xyz[:, :24].cpu().numpy().astype(
                          np.float32),
                      "verts": verts.cpu().numpy().astype(np.float32),
                      "proposal_score": proposal.astype(np.float32),
                      "centers": centers.astype(np.float32),
                      "scales": scales.astype(np.float32)}
        return result


def rgb01(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 BGR -> (3, H, W) float32 RGB in [0, 1]."""
    return img.flip(-1).permute(2, 0, 1).to(torch.float32) / 255.0


class KeypointPipeline:
    """Detector + pose net + JSON writer (= `keypoint_predict.py`)."""

    def __init__(self, detector: Optional[PersonDetector] = None,
                 pose: Optional[PoseEstimator] = None,
                 timer: Optional[StageTimer] = None,
                 device: DeviceLike = None):
        self.detector = detector or PersonDetector(device=device)
        self.pose = pose or PoseEstimator(device=device)
        self.device = self.detector.device
        self.timer = StageTimer() if timer is None else timer
        self.stats: List[Dict] = []     # one record per view

    def process_images(self, img_paths: Sequence[str], keyp_root: str,
                       serial: str, cam_names: Sequence[str]) -> None:
        """Detection + pose for one frame's views; writes
        `<keyp_root>/<serial>/<cam>/<stem>_keypoints.json` per view."""
        timer = self.timer
        with timer.time("decode") as box:
            # One thread a view: the decoder releases the GIL (ctypes).
            with ThreadPoolExecutor(max(1, len(img_paths))) as pool:
                imgs = [torch.from_numpy(i).to(self.device)
                        for i in pool.map(read_image, img_paths)]
            box["sync"] = imgs[-1]
        stats: List[Dict] = []
        boxes_per_view = self.detector.detect_batch(imgs, timer, stats)
        for cam, path, img, boxes, st in zip(cam_names, img_paths, imgs,
                                             boxes_per_view, stats):
            with timer.time("crop") as box:
                image = rgb01(img)
                box["sync"] = image
            kps = self.pose.estimate(image, boxes, timer)
            stem = os.path.splitext(os.path.basename(path))[0]
            with timer.time("json"):
                save_keypoints_json(os.path.join(
                    keyp_root, serial, cam, stem + "_keypoints.json"), kps)
            self.stats.append(dict(st, serial=serial, cam=cam, frame=stem,
                                   people=len(kps)))
